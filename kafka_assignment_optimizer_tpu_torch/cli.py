"""CLI — reassignment JSON in, optimized plan out.

Usage:
    python -m kafka_assignment_optimizer_tpu_torch \\
        --input current.json --broker-list 0-18 --topology topology.json \\
        [--output plan.json] [--rf 3] [--solver auto|milp|native|lp_solve|tpu] [--time-limit S] \\
        [--engine chain|sweep] [--seed 0] [--batch 8] [--sweeps 128] \\
        [--device cuda|cpu] [--no-pipeline] [--megachunk K|auto|off] \\
        [--checkpoint PATH] [--decompose] [--chaos SPEC] [--report] \\
        [--trace] [--flight-dir DIR] [--profile-dir DIR] [--sanitize] \\
        [--distributed] [--emit-lp PATH] \\
        [--emit-waves DIR [--wave-broker-cap N] [--wave-rack-cap N] \\
        [--wave-packer greedy|scored]]
    python -m kafka_assignment_optimizer_tpu_torch --evaluate PLAN.json \\
        --input current.json --broker-list 0-18 [--topology ...]
    python -m kafka_assignment_optimizer_tpu_torch --events EVENTS.json \\
        [--cluster-id NAME] [--watch-dir DIR]

Reads the current assignment from ``--input`` or stdin, writes the plan
(same dialect) to ``--output`` or stdout and, with ``--report``, a solve report to
stderr. ``--evaluate`` audits an existing plan instead (the report on
stdout); ``--events`` replays a cluster-change stream through the watch
manager. Exit codes: 0 feasible plan, 3 infeasible plan (or a fenced
event), 2 error. The host backends (``milp``, ``native``, ``lp_solve``)
ignore ``--device``; ``auto`` picks ``milp`` for small instances and
``tpu`` at scale. ``--profile-dir`` writes a ``torch.profiler`` trace of
the ``tpu`` solve there. ``--emit-waves DIR`` also writes the plan (or
the audited plan) as bandwidth-budgeted move waves, one reassignment
file a wave (``rollout.waves``). ``--distributed`` joins a process group
first (``parallel.distributed``): every process runs the same command and
writes the same plan.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from .api import optimize
from .models.cluster import Assignment, Topology, parse_broker_list

_HOST_SOLVERS = ("milp", "native", "lp_solve")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="kafka_assignment_optimizer_tpu_torch",
        description="Minimal-move, rack-aware Kafka partition reassignment "
        "optimizer on an NVIDIA GPU (PyTorch + CUDA).",
    )
    ap.add_argument("--input", "-i",
                    help="current assignment JSON file (default: stdin)")
    ap.add_argument("--output", "-o",
                    help="write plan JSON here (default: stdout)")
    ap.add_argument("--broker-list",
                    help="target brokers, e.g. '0,1,2' or '0-18' "
                    "(required except with --events)")
    ap.add_argument(
        "--topology",
        help="broker->rack map: JSON file, inline JSON, or 'even-odd' "
        "(the upstream demo topology). Default: one rack.",
    )
    ap.add_argument(
        "--rf",
        help="target replication factor (RF change): an int for all "
        "topics, or an inline/file JSON object mapping topic -> RF "
        '(e.g. \'{"logs": 3}\'; unlisted topics keep their current RF)',
    )
    ap.add_argument("--solver", default="auto",
                    help="auto | milp | native | lp_solve | tpu")
    ap.add_argument("--report", action="store_true",
                    help="print the solve report to stderr")
    ap.add_argument("--indent", type=int, default=2,
                    help="output JSON indent")
    ap.add_argument("--seed", type=int, default=0, help="search RNG seed")
    ap.add_argument("--batch", type=int, help="annealing chains")
    ap.add_argument("--sweeps", type=int,
                    help="annealing rounds (tpu solver)")
    ap.add_argument(
        "--engine",
        choices=["chain", "sweep"],
        help="tpu solver engine: per-move Metropolis chains (the default "
        "below 512 partitions on the CPU) or sweep-parallel proposals",
    )
    ap.add_argument("--time-limit", type=float,
                    help="solver time limit, seconds")
    ap.add_argument("--device", default="cuda",
                    help="solve device: cuda (default) or cpu")
    ap.add_argument(
        "--no-pipeline",
        action="store_true",
        help="disable the double-buffered ladder dispatch (tpu solver): "
        "chunks then run strictly one at a time, with all boundary work "
        "on the critical path; the plan is the same either way",
    )
    ap.add_argument(
        "--megachunk",
        default=None,
        metavar="K|auto|off",
        help="fused ladder megachunks (tpu sweep engine): run K "
        "consecutive schedule chunks as one group, one dispatch per K "
        "chunks (one CUDA-graph replay a chunk on the card), with the same "
        "plan. An int pins the width, 'auto' reads the per-bucket "
        "evidence table, 'off' keeps the per-chunk ladder (same as "
        "KAO_MEGACHUNK)",
    )
    ap.add_argument(
        "--checkpoint",
        metavar="PATH",
        help="warm-start from / save the best plan to this .npz (tpu "
        "solver); re-solves of the same instance never regress below it",
    )
    ap.add_argument(
        "--decompose",
        action="store_true",
        help="force the decomposed map-reduce solve (tpu solver; "
        "docs/DECOMPOSE.md): split the AZ/rack-structured instance into "
        "per-AZ sub-instances, solve them as the lanes of one batch, "
        "stitch and oracle-verify the global plan. Chosen on its own at "
        "KAO_DECOMPOSE_AUTO_PARTS partitions (150,000) and up; "
        "KAO_DECOMPOSE=0 disables it everywhere",
    )
    ap.add_argument(
        "--chaos",
        default=None,
        metavar="SPEC",
        help="arm the fault-injection harness for this solve (same as "
        "KAO_CHAOS; docs/RESILIENCE.md), e.g. 'nan_chunk' or "
        "'seed=7,chunk_overrun:1:-1': the solve must still return a "
        "valid certified-or-degraded plan, with every degradation rung "
        "in the --report output",
    )
    ap.add_argument(
        "--trace",
        action="store_true",
        help="record a span-level solve trace (tpu solver): the solve "
        "report (phase spans + annealing trajectory) is attached to the "
        "stderr report as 'solve_report' (implies --report)",
    )
    ap.add_argument(
        "--flight-dir",
        metavar="DIR",
        help="solve-cost flight recorder: append one compact JSONL "
        "cost+quality record per solve under this directory (same as "
        "KAO_FLIGHT_DIR)",
    )
    ap.add_argument(
        "--sanitize",
        action="store_true",
        help="runtime sanitizer mode (same as KAO_SANITIZE=1): the "
        "ladder's NaN guard, the consumed-state guard and the rebuild "
        "sentinel; trips fail the solve loudly",
    )
    ap.add_argument(
        "--emit-lp",
        metavar="PATH",
        help="also write the lp_solve LP-format equation file",
    )
    ap.add_argument(
        "--evaluate",
        metavar="PLAN.json",
        help="audit an existing plan instead of solving: print its "
        "feasibility, violation counts, moves vs the provable minimum, "
        "and optimality verdict",
    )
    ap.add_argument(
        "--events",
        metavar="FILE",
        help="cluster-watch replay: apply a JSON file of epoch-fenced "
        "change events (a list, or {'cluster_id', 'events': [...]}) "
        "through the watch manager the service runs. The first event of "
        "an unknown cluster must be a 'bootstrap'. Prints the final plan "
        "to stdout and a line per event to stderr",
    )
    ap.add_argument("--cluster-id", default="default",
                    help="cluster name for --events (default: 'default')")
    ap.add_argument(
        "--watch-dir",
        metavar="DIR",
        help="durable plan store for --events: a later replay resumes "
        "at the stored epoch",
    )
    ap.add_argument(
        "--emit-waves",
        metavar="DIR",
        help="streaming rollout (docs/ROLLOUT.md): also decompose the "
        "plan into bandwidth-budgeted move waves and write one "
        "reassignment JSON file per wave (wave-000.json, ...) under "
        "DIR, each in the plan output's schema, applied in file order; "
        "within a wave, leader-changing moves come last",
    )
    ap.add_argument(
        "--wave-broker-cap",
        type=int,
        default=None,
        metavar="N",
        help="--emit-waves: per-wave transfer cap per broker in "
        "transfer units (replica copies in + out; default 4, raised "
        "to the largest single move when below it)",
    )
    ap.add_argument(
        "--wave-rack-cap",
        type=int,
        default=None,
        metavar="N",
        help="--emit-waves: per-wave inbound transfer cap per rack "
        "(default 16)",
    )
    ap.add_argument(
        "--wave-packer",
        choices=["greedy", "scored"],
        default=None,
        help="--emit-waves: wave packer (default greedy; 'scored' "
        "races diverse move orderings and keeps the packing "
        "minimizing makespan x peak cross-rack traffic; same as "
        "KAO_ROLLOUT_PACKER)",
    )
    ap.add_argument(
        "--profile-dir",
        metavar="DIR",
        help="write a torch.profiler trace of the solve here (tpu solver)",
    )
    ap.add_argument(
        "--distributed",
        action="store_true",
        help="join a torch.distributed process group before solving: run "
        "the CLI on EVERY process with the same input (the launcher's "
        "MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK, or "
        "JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/JAX_PROCESS_ID); the "
        "solve mesh then spans every process's shards. No-op without a "
        "cluster environment (parallel/distributed.py)",
    )
    return ap


def _spec_text(spec: str) -> str:
    """Resolve a flag value that may be a file path or inline text."""
    p = Path(spec)
    return p.read_text() if p.exists() else spec


def parse_rf(spec: str | None) -> int | dict | None:
    """``--rf``: an int, inline JSON object, or a JSON file path."""
    if spec is None:
        return None
    try:
        return int(spec)
    except ValueError:
        pass
    try:
        rf = json.loads(_spec_text(spec))
    except json.JSONDecodeError as e:
        raise ValueError(
            f"--rf {spec!r} is neither an int, an existing JSON file, "
            f"nor valid inline JSON ({e})"
        ) from e
    if not isinstance(rf, dict) or not all(
        isinstance(v, int) and not isinstance(v, bool) for v in rf.values()
    ):
        raise ValueError(
            "--rf must be an int or a topic->int JSON object"
        )
    return rf


def _write(args: argparse.Namespace, text: str) -> None:
    """The product JSON: to ``--output`` when given, else stdout."""
    if args.output:
        Path(args.output).write_text(text + "\n")
    else:
        # kao: disable=KAO106 -- the plan JSON on stdout IS the product
        print(text)


def load_topology(spec: str | None, broker_ids: list[int]) -> Topology | None:
    if spec is None:
        return None
    if spec == "even-odd":
        return Topology.even_odd(broker_ids)
    path = Path(spec)
    text = path.read_text() if path.exists() else spec
    return Topology.from_json(text)


def parse_megachunk(spec: str):
    """``--megachunk``: an int width, 'auto', or 'off'. A typo fails
    (exit 2; the engine's resolver is tolerant because it also reads the
    environment)."""
    v = spec.strip().lower()
    if v == "auto":
        return "auto"
    if v in ("off", "0", "none"):
        return "off"
    try:
        return max(1, int(v))
    except ValueError:
        raise ValueError(
            f"--megachunk {spec!r}: expected an integer width, "
            "'auto', or 'off'"
        ) from None


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return _main(args)
    finally:
        if args.distributed:
            from .parallel.distributed import shutdown_distributed

            shutdown_distributed()


def _main(args: argparse.Namespace) -> int:
    if args.sanitize:
        from .analysis import sanitize as _sanitize

        _sanitize.enable()
    if args.chaos:
        from .resilience import chaos as _chaos

        try:
            _chaos.arm(args.chaos)
        except ValueError as e:
            # kao: disable=KAO106 -- "error: ..." on stderr is the CLI's UX contract
            print(f"error: bad --chaos spec: {e}", file=sys.stderr)
            return 2
    try:
        if args.distributed:
            from .parallel.distributed import init_distributed

            init_distributed(device=args.device)
        flight_dir = args.flight_dir or os.environ.get("KAO_FLIGHT_DIR")
        if flight_dir:
            from .obs import flight as _flight

            try:
                _flight.configure(flight_dir)
            except OSError as e:
                raise ValueError(f"--flight-dir {flight_dir!r}: {e}") from e
        if args.events:
            return _run_events(args)
        if not args.broker_list:
            raise ValueError("--broker-list is required (unless --events)")
        text = Path(args.input).read_text() if args.input else sys.stdin.read()
        current = Assignment.from_json(text)
        target_rf = parse_rf(args.rf)
        brokers = parse_broker_list(args.broker_list)
        all_ids = sorted(set(brokers) | set(current.broker_ids()))
        topology = load_topology(args.topology, all_ids)
        if args.evaluate:
            from .api import evaluate

            rep = evaluate(current, brokers,
                           Path(args.evaluate).read_text(), topology,
                           target_rf=target_rf)
            if args.emit_waves:
                # waves for an audited plan (ours or another tool's):
                # the same current -> plan decomposition as a solve's
                rep["waves"] = _emit_waves(
                    args, current,
                    Assignment.from_json(Path(args.evaluate).read_text()),
                    topology,
                )
            _write(args, json.dumps(rep, indent=args.indent, default=str))
            return 0 if rep["feasible"] else 3
        res = optimize(current, brokers, topology, target_rf=target_rf,
                       solver=args.solver, **_solve_kw(args))
        if args.emit_lp:
            from .solvers.lp import emit_lp

            Path(args.emit_lp).write_text(emit_lp(res.instance))
        wave_summary = None
        if args.emit_waves:
            wave_summary = _emit_waves(args, current, res.assignment,
                                       topology)
    except (ValueError, KeyError, OSError, RuntimeError) as e:
        msg = e.args[0] if e.args and isinstance(e.args[0], str) else e
        # kao: disable=KAO106 -- "error: ..." on stderr is the CLI's UX contract
        print(f"error: {msg}", file=sys.stderr)
        return 2
    _write(args, res.assignment.to_json(indent=args.indent))
    rep = res.report()
    if args.trace and "solve_report" in res.solve.stats:
        rep["solve_report"] = res.solve.stats["solve_report"]
    if wave_summary is not None:
        rep["waves"] = wave_summary
    if args.report or args.trace:
        # kao: disable=KAO106 -- --report's stderr JSON is the CLI's UX contract
        print(json.dumps(rep, indent=2, default=str), file=sys.stderr)
    return 0 if rep["feasible"] else 3


def _emit_waves(args: argparse.Namespace, current, plan_assignment,
                topology) -> dict:
    """``--emit-waves DIR``: write one upstream-compatible reassignment
    JSON file per bandwidth-budgeted wave (docs/ROLLOUT.md). File order
    is application order; each file is the dialect
    ``kafka-reassign-partitions --execute`` accepts, so an operator can
    feed the waves to the stock tooling one at a time."""
    from .rollout.exec import wave_json
    from .rollout.waves import (
        DEFAULT_BROKER_CAP,
        DEFAULT_RACK_CAP,
        WaveCaps,
        pack_waves,
    )

    caps = WaveCaps(
        broker=(args.wave_broker_cap if args.wave_broker_cap is not None
                else DEFAULT_BROKER_CAP),
        rack=(args.wave_rack_cap if args.wave_rack_cap is not None
              else DEFAULT_RACK_CAP),
    )
    plan = pack_waves(current, plan_assignment, topology, caps=caps,
                      packer=args.wave_packer, seed=args.seed or 0)
    outdir = Path(args.emit_waves)
    outdir.mkdir(parents=True, exist_ok=True)
    files = []
    for w in plan.waves:
        path = outdir / f"wave-{w.index:03d}.json"
        path.write_text(json.dumps(wave_json(w), indent=2) + "\n")
        files.append(path.name)
    return {
        "dir": str(outdir),
        "files": files,
        "makespan": plan.makespan,
        "caps": plan.caps.to_dict(),
        "packer": plan.packer,
        "peak_broker": plan.peak_broker,
        "peak_rack": plan.peak_rack,
        "peak_cross_rack": plan.peak_cross_rack,
    }


def _solve_kw(args: argparse.Namespace) -> dict:
    """The solver keywords of the command line (``device`` for the
    device engine only)."""
    kw = {"seed": args.seed}
    if args.solver not in _HOST_SOLVERS:
        kw["device"] = args.device
    if args.engine:
        kw["engine"] = args.engine
    if args.time_limit:
        kw["time_limit_s"] = args.time_limit
    if args.batch:
        kw["batch"] = args.batch
    if args.sweeps:
        kw["sweeps"] = args.sweeps
    if args.checkpoint:
        kw["checkpoint"] = args.checkpoint
    if args.profile_dir and args.solver not in _HOST_SOLVERS:
        kw["profile_dir"] = args.profile_dir
    if args.no_pipeline:
        kw["pipeline"] = False
    if args.megachunk is not None:
        kw["megachunk"] = parse_megachunk(args.megachunk)
    if args.decompose:
        kw["decompose"] = True
    if args.trace and args.solver == "tpu":
        kw["trace"] = True
    return kw


def _run_events(args: argparse.Namespace) -> int:
    """``--events``: offline replay of a cluster-change stream through the
    watch state machine — fencing, the durable store and warm-started
    delta solves as the service's delta API runs them, minus the HTTP."""
    from .api import optimize_delta
    from .watch.manager import FencedEpoch, WatchRegistry
    from .watch.store import PlanStore

    doc = json.loads(Path(args.events).read_text())
    if isinstance(doc, dict):
        cluster_id = doc.get("cluster_id", args.cluster_id)
        events = doc.get("events")
    else:
        cluster_id, events = args.cluster_id, doc
    if not isinstance(events, list) or not events:
        raise ValueError(
            "--events file must be a non-empty list of events or "
            "{'cluster_id', 'events': [...]}"
        )
    kw = _solve_kw(args)
    kw.pop("checkpoint", None)
    kw.pop("profile_dir", None)

    def solve_fn(state, prev_plan, budget):
        res = optimize_delta(
            state.assignment, state.brokers, state.topology,
            target_rf=state.rf, prev_plan=prev_plan,
            solver=args.solver, **kw,
        )
        return res.assignment.to_dict(), res.report()

    store = PlanStore(args.watch_dir) if args.watch_dir else None
    reg = WatchRegistry(solve_fn, store, window_s=0.0)
    last_plan = None
    rc = 0
    for i, ev in enumerate(events):
        try:
            out = reg.handle_event(cluster_id, ev)
        except FencedEpoch as e:
            # kao: disable=KAO106 -- per-event stderr lines are the replay's UX contract
            print(f"event[{i}] FENCED: {e}", file=sys.stderr)
            rc = 3
            continue
        rep = out.get("report") or {}
        # kao: disable=KAO106 -- per-event stderr lines are the replay's UX contract
        print(
            f"event[{i}] type={ev.get('type')} epoch={out['epoch']} "
            f"status={out['status']} "
            f"moves={rep.get('replica_moves')} "
            f"feasible={rep.get('feasible')} "
            f"warm={bool(rep.get('solver_warm_started'))}",
            file=sys.stderr,
        )
        if out.get("assignment") is not None:
            last_plan = out["assignment"]
        if rep and not rep.get("feasible", True):
            rc = 3
    if last_plan is None:
        info = reg.get_cluster(cluster_id) or {}
        last_plan = info.get("plan")
    _write(args, json.dumps(last_plan, indent=args.indent))
    return rc
