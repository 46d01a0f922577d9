"""CLI — reassignment JSON in, optimized plan out.

Usage:
    python -m kafka_assignment_optimizer_tpu_torch \\
        --input current.json --broker-list 0-18 --topology topology.json \\
        [--solver auto|milp|native|lp_solve|tpu] [--time-limit S] \\
        [--engine chain|sweep] [--seed 0] [--batch 8] [--sweeps 128] \\
        [--device cuda|cpu] [--no-pipeline] [--megachunk K|off] \\
        [--checkpoint PATH] [--decompose] [--chaos SPEC] [--report]

Reads the current assignment from ``--input`` or stdin, writes the plan
(same dialect) to stdout and, with ``--report``, a solve report to
stderr. Exit codes: 0 feasible plan, 3 infeasible plan, 2 error. The
host backends (``milp``, ``native``, ``lp_solve``) ignore ``--device``;
``auto`` picks ``milp`` for small instances and ``tpu`` at scale.
"""

from __future__ import annotations

import argparse
import json
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
    ap.add_argument("--broker-list", required=True,
                    help="target brokers, e.g. '0,1,2' or '0-18'")
    ap.add_argument(
        "--topology",
        help="broker->rack map: JSON file, inline JSON, or 'even-odd' "
        "(the upstream demo topology). Default: one rack.",
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
        metavar="K|off",
        help="fused ladder megachunks (tpu sweep engine): run K "
        "consecutive schedule chunks as one group, one dispatch per K "
        "chunks, with the same plan; 'off' keeps the per-chunk ladder",
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
    return ap


def load_topology(spec: str | None, broker_ids: list[int]) -> Topology | None:
    if spec is None:
        return None
    if spec == "even-odd":
        return Topology.even_odd(broker_ids)
    path = Path(spec)
    text = path.read_text() if path.exists() else spec
    return Topology.from_json(text)


def parse_megachunk(spec: str):
    """``--megachunk``: an int width or 'off'. A typo fails (exit 2), and
    so does the reference's 'auto', which this package does not offer."""
    v = spec.strip().lower()
    if v in ("off", "0", "none"):
        return "off"
    try:
        return max(1, int(v))
    except ValueError:
        raise ValueError(
            f"--megachunk {spec!r}: expected an integer width or 'off' "
            "('auto' is not supported by this package yet)"
        ) from None


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.chaos:
        from .resilience import chaos as _chaos

        try:
            _chaos.arm(args.chaos)
        except ValueError as e:
            print(f"error: bad --chaos spec: {e}", file=sys.stderr)
            return 2
    try:
        text = Path(args.input).read_text() if args.input else sys.stdin.read()
        current = Assignment.from_json(text)
        brokers = parse_broker_list(args.broker_list)
        all_ids = sorted(set(brokers) | set(current.broker_ids()))
        topology = load_topology(args.topology, all_ids)
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
        if args.no_pipeline:
            kw["pipeline"] = False
        if args.megachunk is not None:
            kw["megachunk"] = parse_megachunk(args.megachunk)
        if args.decompose:
            kw["decompose"] = True
        res = optimize(current, brokers, topology, solver=args.solver, **kw)
    except (ValueError, KeyError, OSError, RuntimeError) as e:
        msg = e.args[0] if e.args and isinstance(e.args[0], str) else e
        print(f"error: {msg}", file=sys.stderr)
        return 2
    print(res.assignment.to_json(indent=args.indent))
    rep = res.report()
    if args.report:
        print(json.dumps(rep, indent=2, default=str), file=sys.stderr)
    return 0 if rep["feasible"] else 3
