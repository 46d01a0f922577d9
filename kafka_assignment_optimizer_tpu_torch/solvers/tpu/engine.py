"""``--solver=tpu`` — the annealing engine, on the card.

Counterpart of ``kafka_assignment_optimizer_tpu.solvers.tpu.engine``
(the reference's name ``"tpu"`` is kept so calls match call for call),
taking the reference's decisions on its solve mesh (``parallel.mesh``:
``n_devices`` chain shards of ``max(1, batch // n_devices)`` chains
each, exchanging their best chain at every snapshot):

0. **The decomposed solve.** AZ/rack-structured instances of 150,000
   partitions or more (or on request: ``decompose=True``,
   ``KAO_DECOMPOSE=1``) solve as map-reduce over per-AZ sub-instances
   through :func:`solve_tpu_batch` (``decompose``); a failed reduce
   falls through to the flat path below (``decompose_to_flat``).
1. **The constructor race.** The LP/flow bounds are prefetched on a
   daemon thread, and one host worker races the annealer: the LP-rounding
   constructor where balance bands bind (or symmetry collapses the
   instance), the exact MILP on tiny instances, greedy + exact leader
   reseat otherwise; a delta-API ``warm_start`` is tried for a
   certificate first. A certified plan returns at once with no device
   touched (``engine "construct"``); an uncertified one competes as the
   warm start.
2. **The ladder.** The sweep engine (``sweep``, through the hand-written
   kernels on the card) or, off the card below 512 partitions, the chain
   engine (``anneal``), in schedule chunks. A sweep solve races the
   portfolio by default: ``portfolio_configs(8)`` as eight lanes of one
   lane stepper (every kernel one launch for all lanes), the first lane
   to certify at a boundary retiring the ladder. Between chunks:
   adoption of a late constructor plan, the boundary optimality
   certificate, the chain engine's reseed and the deadline. The sweep
   ladder is pipelined by default (``pipeline``, ``KAO_NO_PIPELINE``):
   chunk i+1 is enqueued before chunk i is retired, so chunk i's
   boundary work overlaps chunk i+1 on the card; ``megachunk`` K fuses K
   chunks into one group with the certificate's device-side precheck
   between its steps, on the card each step one replay of the bucket's
   step graph (CUDA graphs of the step's pieces, captured once). ``megachunk="auto"`` (or
   True, or the ``KAO_MEGACHUNK`` / ``set_megachunk_default`` process
   default) picks K per bucket from the measured host and device time a
   dispatch (``choose_megachunk_k`` over the evidence its own width-1
   ladders file, each chunk one replay on the card). Both are scheduling
   only: the plans, curves and stats equal the one-chunk-at-a-time
   ladder's.
3. **Certify-first final selection.** Rescore (B1 on the card), then
   moves against the exact move bound, feasibility, weight against the
   weight bound, one exact reseat; polish only when no check certifies.
4. **Verification.** The numpy oracle, the device scorer held to it, and
   ``certify_optimal`` for ``proved_optimal``.

Every step down is a rung of the degradation ladder
(``resilience.ladder``), listed in ``stats["degradations"]``: the
deadline cutting the ladder (``deadline_truncated``), a rejected warm
start (``warm_start_rejected``), a failed decomposition
(``decompose_to_flat``), a fault inside a fused group
(``megachunk_to_chunked``: the per-chunk ladder takes over), the
injected kernel fault (``pallas_to_xla``: the chunk re-runs on the plain
versions; ``pipelined_to_sync`` when speculation drained for it), a
failed checkpoint write (``checkpoint_skipped``), the chain engine's
retry of a defaulted sweep that ends infeasible below 512 partitions
(``sweep_to_chain``), and the host fallback (``anneal_to_construct``):
an injected chaos fault or a ``FloatingPointError`` in the device path
returns the host greedy/reseat plan (or a better checkpoint), verified
and flagged ``stats["degraded"]``; every other error raises.
``checkpoint`` names an ``.npz`` the solve resumes from when it ranks at
least as high as the greedy seed and writes its verified plan to.
:func:`solve_tpu_batch` solves L independent instances in one lane
ladder (no race, no boundary certificate, no polish). ``trace`` records
a span-level solve report (``obs.trace``); an ambient trace (the service
wraps each request in one) collects the solve's spans too. The outermost
solve lands one flight record (``obs.flight``). ``precompile=True`` (the
service's warm-up solves) switches the constructor races, the decomposed
solve and the host fallback off, as in the reference, and records no
flight. The sanitizer (``analysis.sanitize``, ``KAO_SANITIZE=1``) arms
the ladder's NaN, consumed-state and rebuild guards. Every ladder
dispatch feeds the roofline profiler (``obs.prof``: the key's analytic
cost model at its first dispatch, then the enqueue->retire pairing);
``profile_dir`` writes a ``torch.profiler`` trace of the ladder there.
Under a process group (``parallel.distributed``) every process runs the
whole deterministic ladder on its shards, with no constructor race, no
boundary certificate, no portfolio, no deadline and no host fallback, as
the reference's multi-controller solve ("auto" then keeps the per-chunk
ladder). A group whose shards span several cards runs its steps from
the host (a graph belongs to one card), and "auto" takes width 1 there.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; it never moves to the CPU on its own.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from ... import prng
from ...models import instance as _instance_mod
from ...models.instance import ProblemInstance
from ...analysis import sanitize as _san
from ...ops.score_cuda import score, score_lanes
from ...obs import flight as _flight
from ...obs import log as _olog
from ...obs import prof as _oprof
from ...obs import trace as _otrace
from ...parallel import distributed as _dist
from ...parallel.mesh import (
    fetch_global_async,
    init_lane_state,
    init_sweep_state,
    make_mesh,
    make_solve_mesh,
    mesh_spec,
    note_lane_serve,
    note_sharding_evidence,
    solve_lanes,
    solve_lanes_megachunk,
    solve_megachunk,
)
from ...resilience import chaos as _chaos
from ...resilience import ladder as _ladder
from ...resilience.budget import Budget
from ...utils import checkpoint as ckpt
from ..base import SolveResult, register
from . import arrays, bucket
from . import constructor as _constructor
from .anneal import make_solver_fn
from .polish import polish
from .seed import greedy_seed
from .sweep import (
    MEGA_DISARMED_KEY,
    MEGA_DISARMED_MOVES,
    first_argmax,
    make_lane_stepper_fn,
    make_mega_lane_stepper_fn,
    make_mega_stepper_fn,
    make_sweep_stepper_fn,
    out_key,
)

# the pipelined ladder: the sweep engine enqueues chunk i+1 before it
# retires chunk i, so chunk i's boundary work (the fetch of its winners
# and curve, the certificate, the constructor's adoption, the deadline)
# overlaps chunk i+1 on the card. The chunk keys are split up front and
# the sweep state carries its own keys, so it changes no trajectory. Opt
# out per solve (pipeline=False) or for the process (KAO_NO_PIPELINE=1;
# its falsy spellings leave it on)
_PIPELINE_DEFAULT = os.environ.get("KAO_NO_PIPELINE", "").lower() in (
    "", "off", "0", "none", "false",
)


def set_pipeline_default(enabled: bool) -> None:
    """The process default for solves that leave ``pipeline`` at None."""
    global _PIPELINE_DEFAULT
    _PIPELINE_DEFAULT = bool(enabled)


# ladder megachunks: K consecutive sweep chunks as ONE fused group, one
# dispatch per K chunks. On the card each step of a group is one replay of
# its bucket's step graph, CUDA graphs of the step's pieces captured once
# (``sweep.make_mega_lane_stepper_fn``), the state and the ``done`` flag
# carried on the card between the replays, as the reference's group is one
# device-resident scan; a replay's host launch (~8 ms at the adversarial
# bucket) stays under its device time, so the host keeps ahead of the card. KAO_MEGACHUNK=auto|K|off, with the
# reference's conventions: unset keeps the per-chunk ladder, an integer
# pins the fused width, and "auto" opts into the evidence chooser below,
# which measures and then chooses, never a hand-written constant.
def _env_megachunk():
    """Parse KAO_MEGACHUNK: None (unset/off), "auto", or a width >= 1.
    Malformed overrides fall back to unset instead of failing the first
    engine import."""
    raw = os.environ.get("KAO_MEGACHUNK", "").strip().lower()
    if not raw or raw in ("0", "off", "none", "false"):
        return None
    if raw == "auto":
        return "auto"
    try:
        return max(1, int(raw))
    except ValueError:
        return None


_MEGACHUNK_DEFAULT = _env_megachunk()


def set_megachunk_default(value) -> None:
    """Process-wide default for solves that do not pass ``megachunk=``
    (the service's ``--megachunk``): None/"off" keeps the per-chunk
    ladder, "auto" engages the evidence table, an int pins the width."""
    global _MEGACHUNK_DEFAULT
    if isinstance(value, str):
        value = value.strip().lower()
        if value in ("", "0", "off", "none", "false"):
            value = None
        elif value != "auto":
            value = max(1, int(value))
    elif isinstance(value, bool):
        value = "auto" if value else None
    elif value is not None:
        value = max(1, int(value))
    _MEGACHUNK_DEFAULT = value


def megachunk_default():
    """The resolved process default (the service's /healthz)."""
    return _MEGACHUNK_DEFAULT


# per-bucket fusion-width evidence: every sweep ladder files its measured
# dispatch and device split under its warm-chunk identity, and the "auto"
# chooser picks the smallest width that makes a dispatch's host time at
# most MEGA_HOST_FRACTION of a fused group's wall
_MEGA_CANDIDATES = (1, 2, 4, 8)
MEGA_MIN_SOLVES = 16  # evidence quorum before auto departs from 1
MEGA_HOST_FRACTION = 0.05
_MEGA_LOCK = threading.Lock()
_MEGA_EVIDENCE: dict = {}


def note_megachunk_evidence(key: tuple, *, dispatches: int,
                            dispatch_s: float, chunks: int,
                            device_s: float) -> None:
    """File one ladder's measured split under its identity ``key``.
    Totals accumulate; the table is process-local."""
    if dispatches <= 0 or chunks <= 0:
        return
    with _MEGA_LOCK:
        ev = _MEGA_EVIDENCE.setdefault(key, {
            "solves": 0, "dispatches": 0, "dispatch_s": 0.0,
            "chunks": 0, "device_s": 0.0,
        })
        ev["solves"] += 1
        ev["dispatches"] += int(dispatches)
        ev["dispatch_s"] += float(dispatch_s)
        ev["chunks"] += int(chunks)
        ev["device_s"] += float(device_s)


def choose_megachunk_k(key: tuple) -> int:
    """The evidence-driven width for ``key``: with a dispatch's host time
    ``o`` and a chunk's device time ``d``, the smallest candidate K
    holding ``o <= MEGA_HOST_FRACTION * (o + K*d)``. 1 until
    MEGA_MIN_SOLVES solves of evidence exist."""
    with _MEGA_LOCK:
        ev = _MEGA_EVIDENCE.get(key)
        if ev is None or ev["solves"] < MEGA_MIN_SOLVES:
            return 1
        o = ev["dispatch_s"] / max(1, ev["dispatches"])
        d = ev["device_s"] / max(1, ev["chunks"])
    for k in _MEGA_CANDIDATES:
        if o <= MEGA_HOST_FRACTION * (o + k * d):
            return k
    return _MEGA_CANDIDATES[-1]


def megachunk_snapshot() -> dict:
    """The evidence table for /healthz and tests, with the group graphs
    this process holds (``sweep.group_graphs_snapshot``)."""
    from .sweep import group_graphs_snapshot

    with _MEGA_LOCK:
        keys = list(_MEGA_EVIDENCE)
        buckets = {repr(k): dict(v) for k, v in _MEGA_EVIDENCE.items()}
    return {
        "default": _MEGACHUNK_DEFAULT,
        "min_solves": MEGA_MIN_SOLVES,
        "host_fraction": MEGA_HOST_FRACTION,
        "candidates": list(_MEGA_CANDIDATES),
        "buckets": buckets,
        "chosen": {repr(k): choose_megachunk_k(k) for k in keys},
        "graphs": group_graphs_snapshot(),
    }


def reset_megachunk_adapt() -> None:
    """Drop the accumulated fusion evidence (tests, chip_smoke)."""
    with _MEGA_LOCK:
        _MEGA_EVIDENCE.clear()


def _resolve_megachunk(megachunk, engine_mod_supports: bool, multi: bool,
                       n_chunks: int, evidence_key: tuple) -> tuple:
    """Resolve the ``megachunk`` knob to ``(K, mode)``: 1 unless the
    engine fuses and the ladder has more than one chunk. An explicit
    value beats the process default; "auto" reads the evidence table,
    but never under a process group (``multi``), where one process's
    evidence could give the processes different widths."""
    if not engine_mod_supports or n_chunks <= 1:
        return 1, "off"
    v = megachunk if megachunk is not None else _MEGACHUNK_DEFAULT
    if isinstance(v, bool):
        v = "auto" if v else None
    if isinstance(v, str) and v.strip().lower() != "auto":
        try:
            v = max(1, int(v))
        except ValueError:
            v = None
    if v is None or v == 1:
        return 1, "off"
    if v == "auto":
        if multi:
            return 1, "off"
        k = choose_megachunk_k(evidence_key)
        return (max(1, min(k, n_chunks)), "auto")
    return max(1, min(int(v), n_chunks)), "static"


def _ladder_width(megachunk, engine: str, multi: bool, chunks: list,
                  warm_key: tuple, scorer: str, mesh, lanes: int) -> tuple:
    """``(K, mode, evidence key)`` of a sweep ladder
    (:func:`_resolve_megachunk` on the engine's ``SUPPORTS_MEGACHUNK``).
    Where the solve's blocks span several cards a group cannot be one
    graph: "auto" takes 1 there (an explicit width still fuses, its steps
    run from the host)."""
    from . import anneal as _anneal_mod
    from . import sweep as _sweep_mod

    mod = _sweep_mod if engine == "sweep" else _anneal_mod
    key = (*warm_key, int(chunks[0].shape[0]) if chunks else 0, scorer)
    k, mode = _resolve_megachunk(megachunk, mod.SUPPORTS_MEGACHUNK, multi,
                                 len(chunks), key)
    if mode == "auto" and not _one_card(mesh, lanes):
        k = 1
    return k, mode, key


def _one_card(mesh, lanes: int) -> bool:
    """Whether a solve's state is one block on one device: a fused group
    can then be one captured graph."""
    return mesh is None or (not mesh.multi
                            and len(mesh.blocks(max(lanes, 1))) == 1)


def _auto_replays(engine: str, m, mesh) -> bool:
    """Whether "auto" dispatches a chunk of this ladder as one replay of
    the step graph: the sweep engine, its state one block on a card."""
    return (engine == "sweep" and m.a0.device.type == "cuda"
            and _one_card(mesh, m.num_lanes))


def _file_evidence(key: tuple, lad, marks0: dict) -> None:
    """File a sweep ladder's split under ``key`` from the flight ledger's
    windows differenced around it (compile time is its own leaf, so the
    host time a dispatch is compile-free), or from the ladder's own
    tallies when no accounting is active. Only a ladder whose every
    dispatch was one chunk dispatched as "auto" dispatches it
    (``auto_dispatch``, width 1) files: on a card that is one replay of
    the step graph, so neither the default ladder's eager chunks nor a
    fused group's K replays enter the host time ``o`` of a dispatch."""
    if not lad.dispatches or lad.mega_k != 1 or not lad.auto_dispatch:
        return
    marks1 = _flight.ledger_marks()
    ev_n = marks1["dispatches"] - marks0["dispatches"]
    if ev_n > 0:
        ev_disp = marks1["dispatch_s"] - marks0["dispatch_s"]
        ev_dev = marks1["device_s"] - marks0["device_s"]
    else:
        ev_n, ev_disp, ev_dev = lad.dispatches, lad.dispatch_s, lad.device_s
    note_megachunk_evidence(key, dispatches=ev_n, dispatch_s=ev_disp,
                            chunks=lad.chunks_exec, device_s=ev_dev)


_IMIN = int(np.iinfo(np.int32).min)

# below this partition count, off the card, the chain engine is the
# default: per-move chains beat sweeping whole small populations there
_SWEEP_THRESHOLD_PARTS = 512

# how long the solve waits for the constructor worker before annealing
# (seconds): past the aggregation threshold the constructor is the only
# route to a certificate; the middle tier is the greedy + reseat racer's
# at tens of thousands of members. Module-level so tests can pin them.
_CONSTRUCT_WAIT_S = 5.0
_CONSTRUCT_WAIT_BIG_S = 45.0
_CONSTRUCT_WAIT_MID_S = 15.0
_RESEAT_WAIT_MID_MEMBERS = 20_000

# tiny-instance exact race: below these sizes the exact MILP solves in
# milliseconds, so a defaulted solve races it like the LP constructor
_EXACT_RACE_PARTS = 64
_EXACT_RACE_VARS = 20_000  # 2 * brokers * partitions, the MILP var count

# the greedy + exact-reseat racer; tests set it False to pin the
# annealer path
_RESEAT_RACE = True

# the portfolio: a sweep solve that the race did not certify races
# KAO_PORTFOLIO_WIDTH lane configs (arrays.PORTFOLIO_TABLE) as lanes of
# one lane stepper. Opt out per solve (portfolio=False) or for the
# process (KAO_NO_PORTFOLIO=1; its falsy spellings leave it on)
_PORTFOLIO_DEFAULT = os.environ.get("KAO_NO_PORTFOLIO", "").lower() in (
    "", "off", "0", "none", "false",
)


def _env_portfolio_width() -> int:
    """``KAO_PORTFOLIO_WIDTH``, 8 when unset or malformed; 1 means no
    racing."""
    raw = os.environ.get("KAO_PORTFOLIO_WIDTH", "").strip()
    if not raw:
        return 8
    try:
        return max(1, int(raw))
    except ValueError:
        return 8


_PORTFOLIO_WIDTH = _env_portfolio_width()


def set_portfolio_default(enabled: bool) -> None:
    """The process default for solves that leave ``portfolio`` at
    None."""
    global _PORTFOLIO_DEFAULT
    _PORTFOLIO_DEFAULT = bool(enabled)


def portfolio_width_default() -> int:
    """The width a defaulted portfolio solve races."""
    return _PORTFOLIO_WIDTH if _PORTFOLIO_DEFAULT else 1


def _resolve_portfolio_width(portfolio) -> int:
    """The lane count of the ``portfolio`` knob: None defers to the
    process default, a bool toggles the default width, an int names the
    width. 1 (or False) means off."""
    if portfolio is None:
        return _PORTFOLIO_WIDTH if _PORTFOLIO_DEFAULT else 1
    if isinstance(portfolio, bool):
        return _PORTFOLIO_WIDTH if portfolio else 1
    return max(1, int(portfolio))


def resolve_device(device=None) -> torch.device:
    """The solve device: ``cuda`` unless the caller asks for ``cpu``; for
    an explicit list of devices (a mesh's positions,
    ``parallel.mesh.make_mesh``), the first. Raises when the card is
    asked for (or defaulted to) and absent."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty device list")
        devs = [resolve_device(d) for d in device]
        return devs[0]
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected 'cuda' "
                         "or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to solve on "
            "the CPU"
        )
    return dev


class _WarmChunkRegistry:
    """Cross-solve warm per-chunk duration estimates, keyed by what a
    chunk runs (engine, chains, budget knobs, bucket shape, chunk length,
    scorer). The latest solve's warm minimum replaces the entry."""

    def __init__(self, capacity: int = 64):
        self._cap = capacity
        self._lock = threading.Lock()
        self._d: OrderedDict[tuple, float] = OrderedDict()

    def get(self, key: tuple) -> float | None:
        with self._lock:
            v = self._d.get(key)
            if v is not None:
                self._d.move_to_end(key)
            return v

    def update(self, key: tuple, seconds: float) -> None:
        with self._lock:
            self._d.pop(key, None)
            self._d[key] = float(seconds)
            while len(self._d) > self._cap:
                self._d.popitem(last=False)


_WARM_CHUNKS = _WarmChunkRegistry()


def _defaults(inst: ProblemInstance, platform: str,
              engine: str | None) -> dict:
    """Search-effort defaults of the resolved engine. The card (``"gpu"``)
    takes the reference's TPU choices: the sweep engine at every size, 8
    chains x 128 sweeps, or 512 chains for the chain engine. On the CPU
    the chain engine is the default below 512 partitions (32 chains),
    else 8 chains x 64 sweeps."""
    P = inst.num_parts
    on_card = platform == "gpu"
    if engine is not None and engine not in ("chain", "sweep"):
        raise ValueError(
            f"unknown tpu engine {engine!r}; expected 'chain' or 'sweep'"
        )
    engine = engine or (
        "sweep" if (on_card or P >= _SWEEP_THRESHOLD_PARTS) else "chain"
    )
    if engine == "sweep":
        return {"engine": "sweep", "batch": 8,
                "rounds": 128 if on_card else 64, "steps_per_round": 1}
    return {
        "engine": "chain",
        "batch": 512 if on_card else 32,
        "rounds": 24,
        "steps_per_round": max(256, min(4 * P, 20_000)),
    }


@register("tpu")
def solve_tpu(
    inst: ProblemInstance,
    seed: int = 0,
    batch: int | None = None,
    rounds: int | None = None,
    sweeps: int | None = None,  # CLI alias for rounds
    steps_per_round: int | None = None,
    t_hi: float | None = None,
    t_lo: float | None = None,
    n_devices: int | None = None,
    engine: str | None = None,
    checkpoint: str | None = None,
    profile_dir: str | None = None,
    time_limit_s: float | None = None,
    cert_min_savings_s: float = 1.0,
    precompile: bool = False,
    pipeline: bool | None = None,
    portfolio: bool | int | None = None,
    warm_start=None,
    budget: Budget | None = None,
    decompose: bool | None = None,
    megachunk=None,
    device=None,
    trace: bool | str | None = None,
) -> SolveResult:
    """Solve ``inst``: the decomposed solve where it applies, else the
    constructor race, then (unless it certified) the annealing ladder on
    ``device`` (default the card), certify-first final selection and
    verification. ``time_limit_s`` (or a caller's ``budget``) bounds the
    joins and cuts the ladder at chunk boundaries. ``warm_start`` (a
    previous plan adapted to this instance, ``api.optimize_delta``)
    races for a certificate first and competes as the ladder's seed.

    ``trace=True`` (or a trace-ID string) records a span-level solve
    report (``obs.trace``), attached as ``stats["solve_report"]`` and
    registered in the ``/debug/solves`` ring; an ambient trace still
    collects this solve's spans, and its ID lands in ``stats``.

    The degradation-rung collector wraps the whole call: every rung any
    layer takes — the chain retry's and a decomposition's own included —
    lands in ``stats["degradations"]`` exactly once, on the outermost
    solve. The flight recorder wraps it the same way: the outermost
    solve lands one record (a retry or a lane inside another recorded
    solve feeds the outer record); a failed solve lands a failure
    record; ``precompile`` solves land none."""
    prof_tok = _PROFILE_DIR.set(profile_dir)
    nested = _flight.accounting_active()
    acc_tok = None if nested else _flight.start_accounting()
    t0 = time.perf_counter()
    try:
        with _ladder.collect() as rungs:
            res = _solve_tpu_traced(
                inst, trace, seed, batch, rounds, sweeps, steps_per_round,
                t_hi, t_lo, engine, time_limit_s, cert_min_savings_s,
                portfolio, warm_start, budget, decompose, device,
                checkpoint, pipeline, megachunk, precompile, n_devices,
            )
            if rungs:
                res.stats["degradations"] = list(rungs)
    except BaseException as e:
        acc = (_flight.end_accounting(acc_tok) if acc_tok is not None
               else None)
        if acc is not None and not precompile:
            # a solve that raises still lands a record
            _flight.record_failure(inst, acc, time.perf_counter() - t0, e)
        raise
    finally:
        _PROFILE_DIR.reset(prof_tok)
    acc = _flight.end_accounting(acc_tok) if acc_tok is not None else None
    if acc is not None and not precompile:
        _flight.record_solve(res, inst, acc,
                             wall_s=time.perf_counter() - t0)
    return res


def _solve_tpu_traced(inst, trace, *args) -> SolveResult:
    """:func:`_solve_tpu` under its own trace when ``trace`` asks for one;
    a ``FloatingPointError`` (a NaN abort) is counted by the sanitizer
    once before it propagates."""
    tr = _otrace.begin(trace, name="solve_tpu")
    try:
        res = _solve_tpu(inst, *args)
    except BaseException as e:
        if isinstance(e, FloatingPointError):
            _san.note_nan_abort_once(e, "solve_tpu")
        if tr is not None:
            tr.root.set(error=repr(e)[:200])
            _otrace.finish(tr)
        raise
    if tr is None:
        tid = _otrace.current_trace_id()
        if tid:
            res.stats.setdefault("trace_id", tid)
        return res
    res.stats["trace_id"] = tr.trace_id
    res.stats["solve_report"] = _otrace.finish(tr)
    return res


def _solve_tpu(inst, seed, batch, rounds, sweeps, steps_per_round, t_hi,
               t_lo, engine, time_limit_s, cert_min_savings_s, portfolio,
               warm_start, budget, decompose, device, checkpoint, pipeline,
               megachunk, precompile=False, n_devices=None) -> SolveResult:
    t0 = time.perf_counter()
    dev = resolve_device(device)
    if _san.enabled():
        _san.install()
    # a process group (parallel.distributed): every process must take
    # the same decisions in front of every collective, so the solve runs
    # the whole deterministic ladder with no host race, no deadline and
    # no host fallback, as the reference's multi-controller solve
    multi = _dist.process_count() > 1
    if multi:
        time_limit_s, budget = None, Budget(None, t0=t0)
    if budget is None:
        budget = Budget(time_limit_s, t0=t0)
    # None defers to the process default (KAO_NO_PIPELINE)
    pipeline = _PIPELINE_DEFAULT if pipeline is None else bool(pipeline)
    # a structurally invalid warm start is rejected onto the ladder
    # (warm_start_rejected) and the solve proceeds from scratch
    warm_start = _validate_warm_start(inst, warm_start)
    # a previous solve on this instance may have cancelled straggling
    # bound workers (or tagged its constructor path)
    inst._bounds_cancelled = False
    inst._construct_path = None
    inst._flow_big_declines = 0
    # the decomposed rung: AZ/rack-structured instances past the flat
    # ladder's reach (or opted in) solve as map-reduce over per-AZ lanes,
    # stitched and verified against THIS flat instance. None (the split
    # declined, or decompose_to_flat was noted) falls through to the flat
    # path. A warm start and a checkpoint are flat-plan shaped and keep
    # the flat path, and a precompile solve warms the flat path
    if not precompile and warm_start is None and checkpoint is None:
        from ...decompose import maybe_decompose, should_decompose

        if should_decompose(inst, decompose):
            dres = maybe_decompose(
                inst, seed=seed, engine=engine, time_limit_s=time_limit_s,
                budget=budget, portfolio=portfolio, rounds=rounds or sweeps,
                t_hi=t_hi, t_lo=t_lo, device=device, n_devices=n_devices,
            )
            if dres is not None:
                inst.cancel_pending_bounds()
                return dres
    try:
        res = _solve_raced(
            inst, dev, seed, batch, rounds, sweeps, steps_per_round, t_hi,
            t_lo, engine, time_limit_s, cert_min_savings_s, budget, t0,
            portfolio, warm_start, checkpoint, pipeline, megachunk,
            precompile, n_devices, device, multi,
        )
        # a DEFAULTED sweep that ends infeasible on an instance small
        # enough for chains retries the chain engine on what is LEFT of
        # this solve's budget, and keeps the better-ranked plan
        if (
            not res.stats["feasible"]
            and engine is None
            and res.stats["engine"] == "sweep"
            and inst.num_parts < _SWEEP_THRESHOLD_PARTS
            and (multi or not budget.expired())
        ):
            remaining = budget.remaining()
            _ladder.note_rung("sweep_to_chain", parts=inst.num_parts,
                              remaining_s=remaining)
            _olog.warn("engine_fallback_retry", engine="chain",
                       parts=inst.num_parts)
            # the retry's phase spans nest under one "retry" span
            with _otrace.span("retry", engine="chain"):
                res2 = solve_tpu(
                    inst, seed=seed, engine="chain", batch=batch, t_hi=t_hi,
                    t_lo=t_lo, checkpoint=checkpoint,
                    time_limit_s=remaining,
                    cert_min_savings_s=cert_min_savings_s, pipeline=pipeline,
                    warm_start=warm_start, budget=budget, device=device,
                    n_devices=n_devices,
                )

            def rank(r):
                return (r.stats["feasible"], -r.stats["violations"],
                        r.objective, -r.stats["moves"])

            if rank(res2) > rank(res):
                res2.stats["engine_fallback"] = (
                    "chain after infeasible defaulted sweep"
                )
                res = res2
        return res
    finally:
        # straggling bound workers must not escalate further and grind
        # host CPU into the next solve
        inst.cancel_pending_bounds()


def _solve_raced(inst, dev, seed, batch, rounds, sweeps, steps_per_round,
                 t_hi, t_lo, engine, time_limit_s, cert_min_savings_s,
                 budget, t0, portfolio=None, warm_start=None,
                 checkpoint=None, pipeline=True, megachunk=None,
                 precompile=False, n_devices=None, mesh_device=None,
                 multi=False) -> SolveResult:
    """Start the bounds prefetch and the constructor worker this
    instance class races (behind the warm-start certificate when there
    is a warm start; none for a ``precompile`` solve, which exists to
    run the device path, nor under a process group, whose processes
    must not race), then run the solve; a degradable fault in it returns
    the host fallback's plan (never under a process group)."""

    def _bounds_body():
        # the flow/LP bound computation's own span, inside "bounds"
        with _otrace.span("bounds_flow"):
            return inst.move_lower_bound_exact(), inst.weight_upper_bound()

    bounds_fut = _BoundsTask(_otrace.wrap("bounds", _bounds_body))
    knobs_set = any(
        v is not None
        for v in (engine, batch, rounds, sweeps, steps_per_round, t_hi, t_lo)
    )
    members = inst._members()[0].size
    big = members > _instance_mod.AGG_MEMBER_THRESHOLD
    worker_fn = None
    worker_path = None
    if precompile or multi:
        lp_wait_s = 0.0
    elif inst.caps_bind() or big or inst.agg_effective():
        reseat_ok = _RESEAT_RACE and not knobs_set

        def worker_fn():
            return _construct_worker(inst, bounds_fut,
                                     reseat_fallback=reseat_ok)

        worker_path = "lp"
        lp_wait_s = _CONSTRUCT_WAIT_BIG_S if big else _CONSTRUCT_WAIT_S
    elif (
        not knobs_set
        and inst.num_parts <= _EXACT_RACE_PARTS
        and 2 * inst.num_brokers * inst.num_parts <= _EXACT_RACE_VARS
    ):
        def worker_fn():
            return _exact_worker(inst, bounds_fut)

        worker_path = "milp"
        lp_wait_s = _CONSTRUCT_WAIT_S
    elif not knobs_set and _RESEAT_RACE:
        def worker_fn():
            return _reseat_worker(inst, bounds_fut)

        worker_path = "reseat"
        lp_wait_s = (
            _CONSTRUCT_WAIT_MID_S
            if members > _RESEAT_WAIT_MID_MEMBERS
            else _CONSTRUCT_WAIT_S
        )
    else:
        lp_wait_s = 0.0
    if warm_start is not None and not precompile and not multi:
        # the adapted previous plan gets first shot at the certificate,
        # IN FRONT of the race worker this class would run (its
        # fall-through), not instead of it
        inner_fn = worker_fn

        def worker_fn():
            return _warm_certify_worker(inst, bounds_fut, warm_start,
                                        inner_fn)

        worker_path = f"warm+{worker_path}" if worker_path else "warm"
        lp_wait_s = max(lp_wait_s, _CONSTRUCT_WAIT_S)
    lp_fut = (_BoundsTask(_otrace.wrap("construct_worker", worker_fn,
                                       path=worker_path))
              if worker_fn is not None else None)
    try:
        return _solve_inner(
            inst, dev, seed, batch, rounds, sweeps, steps_per_round, t_hi,
            t_lo, engine, time_limit_s, cert_min_savings_s, budget, t0,
            bounds_fut, lp_fut, lp_wait_s, portfolio, warm_start,
            checkpoint, pipeline, megachunk, n_devices,
            dev if mesh_device is None else mesh_device, multi,
        )
    except Exception as e:
        # the ladder's last rung: an injected fault or a NaN abort in the
        # device path still returns a valid, verified plan, flagged
        # degraded. Deliberately narrow (_degradable): a kernel launch or
        # build error, an out-of-memory error, a failed verification, a
        # sanitizer trip and every other fault raise with their own
        # traceback, and a precompile solve exists to run the device
        if precompile or multi or not _degradable(e):
            raise
        return _host_fallback(inst, e, checkpoint, budget, t0,
                              time_limit_s, dev, warm_start=warm_start)


def _chaos_chunk_hooks() -> None:
    """The chaos injection points every chunk dispatch fires, on the
    host before the chunk's first launch, as the reference fires them: a
    kernel fault (``pallas_fault``: the chunk re-runs on the plain
    versions, ``pallas_to_xla``), a NaN surfacing from the chunk
    (``nan_chunk``, as ``FloatingPointError``: the host-fallback rung)
    and a chunk overrun (``chunk_overrun``: exercises the deadline
    gate). ONE helper, so the single-solve and batch ladders never drift
    apart on which faults they fire."""
    _chaos.raise_if("pallas_fault")
    _chaos.raise_if("nan_chunk", FloatingPointError)
    _chaos.sleep_if("chunk_overrun")


def _is_pallas_lowering(e: Exception) -> bool:
    """Whether ``e`` takes the kernel->plain rung (``pallas_to_xla``, the
    reference's name): True for the injected chaos kernel fault only.
    The reference also retries a real Mosaic lowering error, which
    happens while its kernel compiles, before anything runs. A real
    failure of a kernel of this package to build or to launch (an
    ``nvcc`` error, a CUDA launch error) raises instead: retrying it on
    the plain versions would hide a broken kernel behind a solve that
    looks healthy, so it surfaces with its own traceback. The injected
    fault qualifies under every scorer, so CPU solves take the same
    drain-and-retry path a card solve takes."""
    return _chaos.is_pallas_fault(e)


def _degradable(e: BaseException) -> bool:
    """Faults that take the host-fallback rung instead of failing the
    solve: injected chaos faults, and ``FloatingPointError`` (a NaN
    abort) while the sanitizer is NOT armed (armed, the operator asked
    for loud failure, as in the reference). A sanitizer trip never
    degrades. Everything else — a CUDA launch error (a ``RuntimeError``,
    as a ``ChaosFault`` is: never test ``isinstance(e, RuntimeError)``),
    an ``nvcc`` or loader error, ``torch.cuda.OutOfMemoryError``, an
    ``ImportError`` — must surface with its real traceback."""
    if isinstance(e, _san.SanitizerError):
        return False
    if _chaos.is_fault(e):
        return True
    return isinstance(e, FloatingPointError) and not _san.enabled()


def _host_fallback(inst: ProblemInstance, exc: BaseException,
                   checkpoint: str | None, budget: Budget, t0: float,
                   time_limit_req: float | None, dev: torch.device,
                   warm_start=None) -> SolveResult:
    """The ladder's terminal rung (``anneal_to_construct``): the device
    search is unusable, so build the best host-side plan — the greedy
    repair, displaced by a checkpoint that ranks at least as high (crash
    resume), then by a validated warm start that ranks at least as high,
    lifted by the exact leader reseat when feasible — verify it against
    the numpy oracle (and, as every plan of this engine, hold B1 to the
    oracle on it), and return it FLAGGED (``stats["degraded"]``).
    Certification is still attempted, budget permitting: greedy + exact
    reseat is often the proven optimum."""
    _ladder.note_rung("anneal_to_construct", error=repr(exc)[:200])
    with _otrace.span("greedy"):
        a = np.asarray(greedy_seed(inst), dtype=np.int32)
    resumed = False
    warm_used = False
    if checkpoint:
        a_prev = ckpt.load(checkpoint, inst)
        if a_prev is not None and _seed_rank(inst, a_prev) >= \
                _seed_rank(inst, a):
            a = a_prev
            resumed = True
    # a warm start outranking the greedy repair keeps surviving replicas
    # in place even on the degraded path
    if warm_start is not None and _seed_rank(inst, warm_start) >= \
            _seed_rank(inst, a):
        a = warm_start
        warm_used = True
    if inst.is_feasible(a) and not budget.expired():
        a = inst.best_leader_assignment(a)
    bkt_parts, bkt_rf = bucket.bucket_shape(inst)
    viol = _verify(inst, arrays.from_instance(
        inst, dev, num_parts=bkt_parts, max_rf=bkt_rf), a)
    feasible = all(v == 0 for v in viol.values())
    weight = inst.preservation_weight(a)
    proved = False
    if feasible and not budget.expired():
        try:
            proved = inst.certify_optimal(a, allow_tight=False)
        except Exception:
            proved = False
    return SolveResult(
        a=a,
        solver="tpu",
        wall_clock_s=time.perf_counter() - t0,
        objective=int(weight),
        optimal=proved,
        stats={
            "device": str(dev),
            "engine": "host_fallback",
            "degraded": "anneal_to_construct",
            "fault": repr(exc)[:200],
            "feasible": feasible,
            "violations": sum(viol.values()),
            "moves": int(inst.move_count(a)),
            "seed_moves": int(inst.move_count(a)),
            "proved_optimal": proved,
            "resumed_from_checkpoint": resumed,
            "warm_started": warm_used,
            "time_limit_s": time_limit_req,
            "timed_out": False,
            "early_stopped": False,
            "constructed": True,
            "rounds_run": 0,
        },
    )


def _seed_rank(inst, a) -> tuple:
    """The one candidate rank every seed-selection path shares
    (``_pick_seed`` and ``_host_fallback``): feasibility first, then
    fewest violations, then preservation weight, then fewest moves."""
    pen = sum(inst.violations(a).values())
    return (
        pen == 0, -pen, inst.preservation_weight(a),
        -int(inst.move_count(a)),
    )


def _validate_warm_start(inst, a) -> np.ndarray | None:
    """Admission check for a delta-API warm-start candidate: shape,
    integer dtype and the hard structural families (out-of-range slots,
    nulls in valid slots, duplicate brokers within a partition), which
    the annealer's moves preserve rather than repair, must hold. Balance
    bands may be violated (fixing them is the search's job). A candidate
    whose ONLY violation is the leader band gets the exact reseat here,
    at admission, so every consumer (the seed rank, the certify racer,
    the host fallback) sees it at its true rank. A candidate that fails
    is REJECTED onto the degradation ladder (``warm_start_rejected``)
    and the solve proceeds from scratch; returns the validated int32
    array or None."""
    if a is None:
        return None
    reason = None
    arr = np.asarray(a)
    if arr.shape != (inst.num_parts, inst.max_rf):
        reason = (
            f"shape {arr.shape} != {(inst.num_parts, inst.max_rf)}"
        )
    elif not np.issubdtype(arr.dtype, np.integer):
        reason = f"non-integer dtype {arr.dtype}"
    else:
        arr = np.ascontiguousarray(arr, dtype=np.int32)
        viol = inst.violations(arr)
        bad = {
            k: viol[k]
            for k in ("slot_out_of_range", "null_in_valid_slot",
                      "duplicate_in_partition")
            if viol[k]
        }
        if bad:
            reason = f"structural violations {bad}"
        elif viol["leader_balance"] and not any(
            v for k, v in viol.items() if k != "leader_balance"
        ):
            try:
                arr = np.ascontiguousarray(
                    inst.best_leader_assignment(arr), dtype=np.int32
                )
            except Exception:
                pass  # infeasible transportation: admit un-reseated
    if reason is not None:
        _ladder.note_rung("warm_start_rejected", reason=reason[:200])
        _olog.warn("warm_start_rejected", reason=reason[:200])
        return None
    return arr


def _warm_certify_worker(inst: ProblemInstance, bounds_fut, warm_a,
                         inner=None) -> tuple:
    """Constructor-race body for the delta path: after a cluster event
    the adapted previous plan is often already the optimum (a drain
    evicts a few replicas, and the hole-filling refill is move-minimal),
    so try certifying IT before any LP decode, after the bounds prefetch
    (the certificate's bounds are memoized there). The exact leader
    reseat closes the one gap adaptation leaves. When the warm candidate
    does not certify, falls through to ``inner``, the race worker this
    instance class would otherwise have run. Returns ``(plan, certified,
    extends_greedy)``."""
    try:
        bounds_fut.result()
    except Exception:
        pass
    a = np.ascontiguousarray(warm_a, dtype=np.int32)
    viol = inst.violations(a)
    # the exact reseat repairs the leader band (a transportation problem
    # over fixed replica sets), so gate only on the families it cannot
    # touch
    if all(v == 0 for k, v in viol.items() if k != "leader_balance"):
        try:
            with _otrace.span("reseat"):
                a = inst.best_leader_assignment(a)
        except Exception:
            pass  # infeasible transportation: fall through uncertified
        if inst.certify_optimal(a):
            inst._construct_path = "warm"
            return a, True, False
    if inner is not None:
        return inner()
    return None, False, False


def _reseat_worker(inst: ProblemInstance, bounds_fut) -> tuple:
    """Greedy + exact leader reseat: on slack-caps instances the greedy
    repair keeps every keepable member, so the leader arrangement is the
    only gap, and the exact reseat closes it. Returns ``(plan, certified,
    extends_greedy)``; an uncertified plan is still a warm start."""
    with _otrace.span("greedy"):
        a = np.asarray(greedy_seed(inst), dtype=np.int32)
    if not inst.is_feasible(a):
        return None, False, False
    try:
        bounds_fut.result()
    except Exception:
        pass
    with _otrace.span("reseat"):
        a = inst.best_leader_assignment(a)
    inst._construct_path = "reseat"
    if inst.certify_optimal(a):
        return a, True, True
    return a, False, True


def _construct_worker(inst: ProblemInstance, bounds_fut,
                      reseat_fallback: bool = False) -> tuple:
    """Decode the kept-replica LP into a plan (``solvers.lp_round``) and
    certify it, after the bounds prefetch so the two threads never
    duplicate the bound LPs. Past the unaggregated-LP size, where the
    aggregated formulation would refuse, it returns at once (or runs the
    greedy + reseat racer when allowed)."""
    if (
        inst._members()[0].size > _instance_mod.AGG_MEMBER_THRESHOLD
        and not inst.agg_construct_viable()
    ):
        if reseat_fallback:
            return _reseat_worker(inst, bounds_fut)
        return None, False, False
    try:
        bounds_fut.result()
    except Exception:
        pass
    from ..lp_round import construct

    plan = construct(inst)
    if plan is None:
        return None, False, False
    return plan, inst.certify_optimal(plan), False


def _exact_worker(inst: ProblemInstance, bounds_fut) -> tuple:
    """Tiny-instance race: the exact MILP (milliseconds at P <= 64),
    time-limited, its optimum recorded as a weight bound, then
    certified."""
    try:
        bounds_fut.result()
    except Exception:
        pass
    from ..milp import solve_milp

    r = solve_milp(inst, time_limit_s=2 * _CONSTRUCT_WAIT_S)
    if not r.optimal or r.a is None:
        return None, False, False
    plan = np.asarray(r.a, dtype=np.int32)
    if r.objective is not None:
        inst._agg_weight_ub = int(r.objective)
    if inst.certify_optimal(plan):
        inst._construct_path = "milp"
        return plan, True, False
    return plan, False, False


class _BoundsTask:
    """Future-like handle on one host computation running on a daemon
    thread (a non-daemon worker would block interpreter exit for the rest
    of a running LP)."""

    def __init__(self, fn):
        self._ev = threading.Event()
        self._res = None
        self._exc: BaseException | None = None

        def run():
            try:
                self._res = fn()
            except BaseException as e:  # surfaced on result()
                self._exc = e
            finally:
                self._ev.set()

        threading.Thread(target=run, daemon=True).start()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: float | None = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("bounds computation still running")
        if self._exc is not None:
            raise self._exc
        return self._res


def _await_constructor(lp_fut, lp_wait_s, checkpoint, budget: Budget):
    """Join the constructor worker for up to ``lp_wait_s`` (capped by the
    budget). A ``checkpoint``'s directory is created first: an
    unwritable path fails before any solve time is spent, and the
    constructed path, which skips the seed stage, still finds it for the
    write at verification. Returns ``(certified_a, lp_warm,
    lp_warm_extends)``."""
    if lp_fut is None:
        return None, None, False
    if checkpoint:
        from pathlib import Path

        Path(checkpoint).parent.mkdir(parents=True, exist_ok=True)
    lp_warm_extends = False
    try:
        plan, ok, lp_warm_extends = lp_fut.result(
            timeout=budget.cap(lp_wait_s))
        lp_warm_extends = bool(lp_warm_extends)
    except Exception:
        plan, ok = None, False
    # the host time taking a finished constructor plan into the solve
    with _otrace.span("adopt", certified=bool(ok), plan=plan is not None):
        if ok:
            return np.asarray(plan, dtype=np.int32), None, lp_warm_extends
        if plan is not None:
            return None, np.asarray(plan, dtype=np.int32), lp_warm_extends
        return None, None, lp_warm_extends


def _pick_seed(inst, lp_warm, lp_warm_extends, checkpoint=None,
               warm_start=None):
    """The greedy repair, or the reseat racer's extension of it; a
    ``checkpoint`` plan that ranks at least as high (``_seed_rank``: the
    next solve never regresses below the last one); a validated
    delta-API ``warm_start`` that ranks at least as high (it wins ties,
    so surviving replicas stay put unless the greedy repair is better);
    then an uncertified constructor plan that outranks them. Returns
    ``(a_seed, resumed_from_checkpoint, warm_started)``."""
    resumed = False
    warm_used = False
    warm_extends = lp_warm is not None and lp_warm_extends
    if warm_extends:
        a_seed = lp_warm
    else:
        with _otrace.span("greedy"):
            a_seed = greedy_seed(inst)
    assert (a_seed[inst.slot_valid] < inst.num_brokers).all(), (
        "seed left unfilled slots"
    )
    if checkpoint:
        # an unwritable path fails before any solve time is spent
        from pathlib import Path

        Path(checkpoint).parent.mkdir(parents=True, exist_ok=True)
        a_prev = ckpt.load(checkpoint, inst)
        if a_prev is not None and _seed_rank(inst, a_prev) >= \
                _seed_rank(inst, a_seed):
            a_seed = a_prev
            resumed = True
    if warm_start is not None and _seed_rank(inst, warm_start) >= \
            _seed_rank(inst, a_seed):
        a_seed = warm_start
        warm_used = True
    if lp_warm is not None and not warm_extends:
        def _rank(zz):
            return (-sum(inst.violations(zz).values()),
                    inst.preservation_weight(zz), -inst.move_count(zz))

        if _rank(lp_warm) > _rank(a_seed):
            a_seed = lp_warm
            warm_used = False
    return a_seed, resumed, warm_used


def _build_chunks(inst: ProblemInstance, engine: str, rounds: int,
                  t_hi: float, t_lo: float,
                  time_limit_s: float | None) -> list[np.ndarray]:
    """The annealing schedule: one geometric float32 ladder cut into
    chunks, the tail padded with ``t_lo``. The sweep engine is cut into 8
    chunks under a deadline or at 20k+ partitions, else 2, each a
    multiple of the snapshot cadence (so the chunked run replays the uncut
    ladder); the chain engine is cut into 8 only under a deadline."""
    temps_full = arrays.geometric_temps(t_hi, t_lo, rounds)
    if engine == "sweep":
        n_chunks = (
            8 if (time_limit_s is not None or inst.num_parts >= 20_000)
            else 2
        )
        c = 8 * max(1, -(-rounds // (8 * n_chunks)))
    elif time_limit_s is not None:
        c = max(1, -(-rounds // 8))
    else:
        c = rounds
    chunks = [temps_full[i:i + c] for i in range(0, rounds, c)]
    if len(chunks) > 1 and chunks[-1].shape[0] < c:
        pad = np.full(c - chunks[-1].shape[0], t_lo, np.float32)
        chunks[-1] = np.concatenate([chunks[-1], pad])
    return chunks


# the directory a solve_tpu call's profile_dir names (None: no trace); a
# nested solve (the sweep->chain retry) sets its own
_PROFILE_DIR: contextvars.ContextVar = contextvars.ContextVar(
    "kao_profile_dir", default=None)


def _profiled(dev: torch.device):
    """The ladder's ``torch.profiler`` session when the solve asked for
    one (``profile_dir``; the reference's ``jax.profiler.trace``): host
    activity, and the card's kernels when it runs there, written as a
    Chrome trace (``<worker>.<time>.pt.trace.json``) under the directory
    at the session's end."""
    profile_dir = _PROFILE_DIR.get()
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    os.makedirs(profile_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def _prof_key(m, chains: int, steps_per_round: int, engine: str,
              scorer: str, lanes: int, temps, mesh) -> tuple:
    """A ladder dispatch's profiler key (``obs.prof``): ``(devices,
    chains, steps_per_round, engine, scorer, tag)`` with the tag
    ``single``/``lanes``/``mega``/``mega-lanes`` (``@<dc>x<dl>`` on a
    mesh of several shards), and the shapes of the chains (the shard
    axis first on such a mesh) and of the dispatch's temperatures."""
    temps = np.asarray(temps)
    mega = temps.ndim == 2
    tag = ("mega-lanes" if mega and lanes else "mega" if mega
           else "lanes" if lanes else "single")
    P, R = (int(x) for x in m.a0.shape[-2:])
    chains_shape = ((int(lanes),) if lanes else ()) + (int(chains), P, R)
    devices = (str(m.a0.device),)
    if mesh.size > 1:
        tag += "@%dx%d" % mesh_spec(mesh)
        chains_shape = (mesh.size, *chains_shape)
        devices = tuple(str(d) for d in mesh.devices)
    return ((devices, int(chains), int(steps_per_round), engine, scorer,
             tag),
            ((chains_shape, "int32"), (tuple(temps.shape), "float32")))


def _dispatch_desc(m, chains: int, engine: str, temps, mesh) -> dict:
    """What a ladder dispatch launches, for its key's cost model: a sweep
    chunk of c sweeps makes ``sweep.stage_counts(c)`` kernel calls (each
    one launch a mesh block on the card, for all its shards; the plain
    versions compute the same), a fused group of K chunks K times that;
    a chain-engine round launches no kernel. The shape counts every
    shard's lanes. Reads the model's valid slots once (before the
    dispatch, so the read waits for nothing it enqueues)."""
    from ...ops.bench_kernel import dispatch_shape
    from .sweep import _one_lane, stage_counts

    temps = np.asarray(temps)
    launches: dict = {}
    stacked = m if m.num_lanes else _one_lane(m)
    blocks = 1
    if mesh.size > 1:
        blocks = len(mesh.blocks(stacked.num_lanes))
        stacked = arrays.shard_models(stacked, mesh.size)
    if engine == "sweep":
        steps = temps.shape[0] if temps.ndim == 2 else 1
        launches = {k: v * steps * blocks
                    for k, v in stage_counts(temps.shape[-1]).items()}
    return {"launches": launches,
            "shape": dispatch_shape(stacked, chains)}


def _mesh_stats(mesh) -> dict:
    """A solve's mesh in its stats: the axes, the positions' devices and
    the processes."""
    return {"axes": {"chains": mesh.dc, "lanes": mesh.dl},
            "devices": [str(d) if d is not None else "remote"
                        for d in mesh.devices],
            "processes": mesh.processes}


def _sync(dev: torch.device) -> float:
    """Wait for this thread's stream on the device, then read the host
    clock (phase timing). A stream sync, never a device-wide one: the
    service runs solves in several threads, and synchronizing the whole
    device while another thread captures a CUDA graph (the chain
    engine) is an error that would fail this thread's solve."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return time.perf_counter()


class _CurveSlice:
    """A retired chunk's curve, read from its group's asynchronous fetch
    (whose third item is the curve): the whole curve of a one-chunk
    dispatch (``j`` None), or chunk ``j`` of a fused group's ``curves``
    along ``axis``, so one copy a group feeds K per-chunk curves equal to
    the unfused ladder's."""

    def __init__(self, h, j: int | None = None, axis: int = 0):
        self._h, self._j, self._axis = h, j, axis

    def get(self) -> np.ndarray:
        curve = self._h.get()[2]
        return curve if self._j is None else np.take(curve, self._j,
                                                     axis=self._axis)


def _build_marks() -> tuple:
    """``(builds, seconds)`` this process has spent building kernel
    libraries and capturing the chain engine's CUDA graphs: a dispatch
    that moves them paid a build (its compile window, a cache miss)."""
    from ...ops.kernels import cache_stats
    from .anneal import GRAPH_CAPTURES

    st = cache_stats()
    return (st["misses"] + GRAPH_CAPTURES["captures"],
            st["build_s"] + GRAPH_CAPTURES["capture_s"])


@dataclass
class _LadderResult:
    """What the ladder hands to final selection and the stats."""

    pop_a: torch.Tensor | None = None  # [C, (Lp,) P, R] each shard's winners
    pop_k: torch.Tensor | None = None  # [C, (Lp,)]
    fetched: object = None  # the last retired dispatch's host copies
    curves: list = field(default_factory=list)
    rounds_run: int = 0
    timed_out: bool = False
    certified_a: np.ndarray | None = None  # boundary/constructor plan
    constructed: bool = False  # certified_a came from the constructor
    scorer: str | None = None  # the scorer the ladder ended on
    pallas_fallback: str | None = None  # the fault the plain rung took
    tight_fut: object = None  # in-flight tier-1 LP, reused at the end
    pipelined: bool = False  # a speculative dispatch ran
    dispatch_s: float = 0.0  # host time enqueueing chunks or groups
    device_s: float = 0.0  # host time blocked on the card's results
    boundary_overlap_s: float = 0.0  # boundary work behind a chunk in flight
    winner_lane: int | None = None  # the portfolio lane that certified
    certified_at_s: float | None = None  # solve-relative certificate time
    mega_k: int = 1  # the fused width this ladder ran at (1 = unfused)
    mega_groups: int = 0  # fused groups dispatched
    dispatches: int = 0  # chunk or group dispatches
    chunks_exec: int = 0  # schedule chunks that executed
    mega_early_exit: bool = False  # a fused group's certificate held
    # each chunk dispatched as "auto" dispatches a width of 1: one replay
    # of the step graph where the state is one block on a card, an eager
    # chunk elsewhere (only such a ladder feeds the chooser's evidence)
    auto_dispatch: bool = False


def _run_ladder(inst, m, batch, steps_per_round, engine, scorer, chunks,
                seed_dev, key, sweep_state, lp_fut, bounds_fut,
                cert_min_savings_s, budget, warm_key, *, mesh,
                lanes: int = 0, pipeline: bool = True, mega_k: int = 1,
                chain_lanes: tuple | None = None,
                multi: bool = False,
                group_chunks: bool = False) -> _LadderResult:
    """The chunked ladder. Between chunks: adopt a finished certified
    constructor plan; try the optimality certificate on the top winner
    when the ladder left to skip costs more than ``cert_min_savings_s``
    and the bounds are in hand (up to 3 exact reseats over the solve; a
    tight tier-1 LP on its own thread); reseed the chain engine from the
    best; honour the deadline.

    Every dispatch enqueues its chunk and at once starts the copies of
    the chunk's winners and curve to pinned host memory (the
    asynchronous fetch), ahead of any later launch; retiring the chunk
    waits on the fetch's event, which completes after the chunk's last
    launch. The boundary reads those host copies.

    ``pipeline`` (the sweep engine): the ladder runs double-buffered —
    chunk i+1 is enqueued before chunk i is retired, so chunk i's
    boundary work runs while chunk i+1 runs on the card. The chunk keys
    are split up front and the sweep state carries its own keys, so the
    speculative dispatch takes no host decision and the trajectory is
    the synchronous one. The deadline then decides whether to RETIRE the
    chunk in flight, not whether to dispatch it; a chunk abandoned at a
    certificate or the deadline is never read (its launches still run,
    so final selection queues behind at most one chunk). The chain
    engine's reseed is a data dependency: it never speculates.

    The injected kernel fault (``_is_pallas_lowering``) re-runs the
    chunk on the plain versions (``scorer="torch"``, the same device)
    and records ``pallas_to_xla``; pipelined, the failed speculation is
    drained first: chunk i retires with nothing in flight, the chunk is
    retried synchronously (``pipelined_to_sync``), then speculation
    resumes. No state is ever written in place, so a failed dispatch
    leaves its input state intact for the retry.

    ``lanes`` > 0 is the portfolio or a batch: ``m`` is a stacked model,
    the sweep state a lane state, and each chunk runs the lane stepper.
    The certificate's candidates are then the real lanes' winners
    (padding lanes are never read), and the first lane to certify
    retires the ladder as ``winner_lane``. ``bounds_fut`` None turns the
    certificate off (a batch: its lanes are independent instances, so
    every fused group runs disarmed). A batch's chain engine passes
    ``chain_lanes = (lane_seeds [Lp, P, R], keys [Lp, 2])``: each chunk
    is one lane anneal (``mesh.solve_lanes``), and at each boundary
    every lane, padding lanes too, reseeds from its own winner (the best
    of its shards) with the next key of its own stream.

    ``mesh`` is the solve mesh (``parallel.mesh``): every chunk runs its
    C chain shards, and the winners are each shard's (``[C, P, R]``, or
    ``[C, Lp, P, R]`` with lanes), the candidate pool of the certificate
    and of final selection flattened shard-major, a lane's flat index j
    decoding to lane ``j % lanes``. Under a process group (``multi``)
    the boundary certificate and the fused group's exit stay off: every
    process must take the same decisions.

    ``mega_k`` > 1 fuses K consecutive sweep chunks into one group
    (``mesh.solve_megachunk``): one host round trip retires K chunks,
    and an armed group tests the certificate's device-side precheck
    after each step, stopping early when a chain qualifies. On the card,
    with the state on one card, each step of a group is one replay of
    its bucket's step graph, and ``group_chunks`` (the "auto" width)
    dispatches even an unfused chunk as one replay (a disarmed group of
    one step), so the evidence the "auto" chooser reads comes from
    one-replay dispatches (``auto_dispatch``: only width-1 ladders
    dispatched so file it); the per-chunk walkers' decisions (the
    boundary certificate, the deadline) are unchanged. A fused ladder
    keeps the state's keys on the device from group to group. Any fault
    inside a group that the host fallback would take (``_degradable``:
    the injected kernel fault is one) drains to the per-chunk walkers
    (``megachunk_to_chunked``), which re-enter at the first chunk no
    group finished and own the finer recovery."""
    r = _LadderResult(scorer=scorer)
    n = len(chunks)
    reseat_tries = 0
    replays = _auto_replays(engine, m, mesh)
    graph_chunks = group_chunks and replays
    r.auto_dispatch = graph_chunks == replays
    if engine == "sweep" and (graph_chunks or (mega_k > 1 and n > 1)):
        # the fused ladder's keys stay on the device: no group waits for
        # the one before it to hand its keys to the host
        sweep_state = _device_keys(sweep_state)
    deadline = budget.deadline
    # chunk 0's time includes the first launches' setup and a retried
    # chunk's includes the fault: neither feeds the warm estimate
    warm_chunk_s = None
    last_chunk_s = None
    chunk_len = int(chunks[0].shape[0]) if n else 0

    def _wkey(width: int = 1) -> tuple:
        """The warm registry's key, by fused width: a fused group's
        per-chunk time lacks the per-dispatch host time an unfused chunk
        pays, so the two never feed each other's estimate."""
        return (*warm_key, chunk_len, width, r.scorer)

    prior_s = _WARM_CHUNKS.get(_wkey())
    mega_warm_s = None
    mega_prior_s = _WARM_CHUNKS.get(_wkey(mega_k)) if mega_k > 1 else None
    mega_active = False  # a fused walker owns the ladder
    handles: list = []  # the retired chunks' curves, in order

    def _deadline_now():
        if budget.cancelled:
            return time.perf_counter() - 1.0
        return deadline

    def _est_chunk_s():
        cands = ((mega_warm_s, mega_prior_s, last_chunk_s) if mega_active
                 else (warm_chunk_s, prior_s, last_chunk_s))
        for v in cands:
            if v is not None:
                return v
        return None

    # the chunk keys, split up front in the sequential order (the sweep
    # engine ignores them: its keys ride in its state; a batch's chain
    # lanes carry theirs in chain_lanes)
    if n == 1 or key is None:
        subs = [key] * n
    else:
        subs, _k = [], key
        for _ in range(n):
            _k, _s = prng.split(_k)
            subs.append(_s)
    steppers: dict = {}

    def _stepper():
        """The chunk runner of the current scorer (the chain engine has
        one runner whatever the scorer: its CUDA graphs are kept)."""
        name = r.scorer if engine == "sweep" else "chain"
        fn = steppers.get(name)
        if fn is None:
            if engine != "sweep":
                fn = make_solver_fn(batch, steps_per_round, mesh)
            elif graph_chunks:
                fn = _replayed_chunk(
                    (make_mega_lane_stepper_fn if lanes
                     else make_mega_stepper_fn)(
                        batch, scorer=r.scorer, mesh=mesh))
            else:
                fn = (make_lane_stepper_fn if lanes
                      else make_sweep_stepper_fn)(
                    batch, scorer=r.scorer, mesh=mesh)
            steppers[name] = fn
        return fn

    def _pool(x):
        """A host copy of the shards' winners as the candidate pool: the
        real lanes only (padding lanes are never read), shard-major."""
        return x[:, :lanes].reshape(-1, *x.shape[2:]) if lanes else x

    def _launch(fn, key, temps, st):
        """One stepper call under the dispatch accounting: the
        ``dispatch`` span and ledger window (a kernel build or a graph
        capture inside it is its compile window instead, and makes the
        dispatch a cache miss) and, armed, the sanitizer's
        temperature-ladder and consumed-state guards."""
        _san.check_host(temps, "temperature ladder")
        _san.check_state(st, key)
        pkey = _prof_key(m, batch, steps_per_round, engine, r.scorer, lanes,
                         temps, mesh)
        desc = None
        if not _oprof.has_cost_model(pkey):
            with _oprof.accounted():
                desc = _dispatch_desc(m, batch, engine, temps, mesh)
                on_card = m.a0.device.type == "cuda"
                if on_card:
                    # the dispatch's own peak: the allocator's peak reset
                    # here, read above what was allocated at its start
                    mem0 = torch.cuda.memory_allocated(m.a0.device)
                    torch.cuda.reset_peak_memory_stats(m.a0.device)
        b0, s0 = _build_marks()
        td = time.perf_counter()
        with _otrace.span("dispatch") as dsp:
            out = fn()
            b1, s1 = _build_marks()
            cache = ("miss" if b1 > b0
                     else "fallback" if r.pallas_fallback else "hit")
            if dsp is not None:
                dsp.set(cache=cache)
        if desc is not None:
            if on_card:
                desc["peak_hbm_bytes"] = (
                    torch.cuda.max_memory_allocated(m.a0.device) - mem0)
            _oprof.note_cost_model(pkey, desc, s1 - s0)
        _oprof.note_dispatch(pkey, started=td)
        _flight.note_dispatch(cache)
        _flight.note_window("dispatch",
                            max(time.perf_counter() - td - (s1 - s0), 0.0))
        bucket.STATS.record_exec(cache == "hit", compile_s=s1 - s0,
                                 fallback=cache == "fallback")
        _san.consume_state(st)
        return out

    def dispatch(i, st):
        """Enqueue chunk i and start its fetch; returns without waiting
        for the card. The chaos points fire here."""
        _chaos_chunk_hooks()
        td = time.perf_counter()
        if engine == "sweep":
            new_state, top_a, top_k, curve = _launch(
                lambda: _stepper()(m, st, chunks[i]), ("chunk", i),
                chunks[i], st)
        elif chain_lanes is not None:
            new_state = None
            top_a, top_k, curve = _launch(
                lambda: solve_lanes(
                    m, batch, chunks[i], lane_seeds=chain_lanes[0],
                    keys=chain_lanes[1], engine="chain",
                    steps_per_round=steps_per_round, mesh=mesh),
                ("chunk", i), chunks[i], None)
        else:
            new_state = None
            top_a, top_k, curve = _launch(
                lambda: _stepper()(m, seed_dev, subs[i], chunks[i]),
                ("chunk", i), chunks[i], None)
        # each shard's winners, [C, ...]
        h = fetch_global_async((top_a, top_k, curve))
        r.dispatches += 1
        return new_state, top_a, top_k, h, time.perf_counter() - td

    def _note_fallback(i, e) -> None:
        nonlocal warm_chunk_s, prior_s, mega_warm_s, mega_prior_s
        _ladder.note_rung("pallas_to_xla", chunk=i)
        r.pallas_fallback = repr(e)[:500]
        r.scorer = "torch"
        # the plain versions' chunks are slower: restart the warm
        # estimate under the new scorer's key
        warm_chunk_s = None
        prior_s = _WARM_CHUNKS.get(_wkey())
        mega_warm_s = None
        mega_prior_s = (_WARM_CHUNKS.get(_wkey(mega_k)) if mega_k > 1
                        else None)
        _olog.warn("pallas_fallback", chunk=i, error=repr(e)[:200])

    def dispatch_or_fallback(i, st):
        """Dispatch with the kernel->plain retry; only with nothing in
        flight. Returns ``(dispatch tuple, fell_back)``."""
        try:
            return dispatch(i, st), False
        except Exception as e:
            if not _is_pallas_lowering(e):
                raise
            _note_fallback(i, e)
            return dispatch(i, st), True

    def _retire_wait(h) -> float:
        """Wait for a dispatch's copies (and with them its launches): the
        ledger's device window. Armed, the sanitizer's NaN guard then
        checks the float tensors the chunk ran on (one host sync)."""
        tw = time.perf_counter()
        with _otrace.span("device_transfer"):
            h.wait()
        device_s = time.perf_counter() - tw
        _flight.note_device(device_s)
        _san.check_device((m.lam, m.temp_scale, m.comp_enable),
                          "chunk outputs")
        return device_s

    def chunk_attrs(sp, i, disp_s, device_s, overlap_s, h, scorer_ran):
        """A retired chunk's span attributes: its schedule, its dispatch
        and device seconds, and the best-score curve's improvements (the
        copies already on the host)."""
        if sp is None:
            return
        t_np = np.asarray(chunks[i])
        arr = np.asarray(_CurveSlice(h).get())
        best = arr.max(axis=tuple(range(arr.ndim - 1)))
        imp = int((np.diff(best) > 0).sum()) if best.size > 1 else 0
        sp.set(rounds=int(t_np.shape[0]), t_hi=float(t_np[0]),
               t_lo=float(t_np[-1]), scorer=scorer_ran,
               dispatch_s=round(disp_s, 4), device_s=round(device_s, 4),
               boundary_overlap_s=round(overlap_s, 4),
               energy_before=int(best[0]) if best.size else None,
               energy_after=int(best[-1]) if best.size else None,
               accepts=imp, declines=max(0, int(best.size) - 1 - imp))

    def boundary(i) -> bool:
        """Retired chunk i's host work: the constructor's adoption, the
        boundary certificate, the chain engine's reseed. True when the
        ladder should stop (a certified plan exists)."""
        nonlocal seed_dev, reseat_tries, chain_lanes
        if i + 1 >= n:
            return False
        if lp_fut is not None and lp_fut.done():
            try:
                plan, ok, _extends = lp_fut.result()
            except Exception:
                plan, ok = None, False
            if ok:
                with _otrace.span("adopt", certified=True, boundary=i):
                    r.certified_a = np.asarray(plan, dtype=np.int32)
                    r.constructed = True
                return True
        remaining_s = (n - i - 1) * (_est_chunk_s() or 0.0)
        do_cert = (not multi and remaining_s > cert_min_savings_s
                   and bounds_fut is not None and bounds_fut.done())
        if engine != "sweep" or do_cert:
            pa, pk = r.fetched.get()[:2]
            if chain_lanes is not None:
                # each lane's best shard (first index among ties)
                top = pk.argmax(0)
                pa = pa[top, np.arange(pa.shape[1])]
                chain_lanes = (pa, np.stack([prng.split(k)[1]
                                             for k in chain_lanes[1]]))
                return False
            # the real lanes' winners, shard-major: index j is lane
            # j % lanes
            pa, pk = _pool(pa), _pool(pk)
            for j in np.argsort(-pk)[:1] if do_cert else []:
                cand = arrays.unpad_candidate(pa[j], inst)
                mc = inst.move_count(cand)
                if not inst.is_feasible(cand):
                    continue
                lb_exact, ub0 = bounds_fut.result()
                if mc <= lb_exact:
                    w_cand = inst.preservation_weight(cand)
                    if w_cand < ub0 and reseat_tries < 3:
                        reseat_tries += 1
                        cand = inst.best_leader_assignment(cand)
                        w_cand = inst.preservation_weight(cand)
                    if w_cand >= ub0:
                        r.certified_a = cand
                        break
                    if r.tight_fut is None:
                        r.tight_fut = _BoundsTask(
                            lambda: inst.weight_upper_bound(tight=True))
                    elif r.tight_fut.done() and (
                        w_cand >= r.tight_fut.result()
                    ):
                        r.certified_a = cand
                        break
            if r.certified_a is not None:
                if lanes:
                    r.winner_lane = int(j) % lanes
                r.certified_at_s = round(time.perf_counter() - budget.t0, 4)
                return True
            if engine != "sweep":
                seed_dev = r.pop_a[int(np.argmax(pk))]
        return False

    def retire_common(i, pop_a, pop_k, h, disp_s, device_s, chunk_s,
                      fell_back) -> None:
        """The bookkeeping of retired chunk i, once its fetch is done."""
        nonlocal warm_chunk_s, last_chunk_s
        r.pop_a, r.pop_k, r.fetched = pop_a, pop_k, h
        r.rounds_run += int(chunks[i].shape[0])
        r.chunks_exec += 1
        r.dispatch_s += disp_s
        r.device_s += device_s
        last_chunk_s = chunk_s
        if i > 0 and not fell_back:
            warm_chunk_s = (chunk_s if warm_chunk_s is None
                            else min(warm_chunk_s, chunk_s))
        handles.append(_CurveSlice(h))

    def run_sync(start: int = 0) -> None:
        """One chunk at a time, retired before the next dispatch (the
        chain engine, ``pipeline=False``); ``start`` > 0 is a fused
        walker's drain re-entry."""
        nonlocal sweep_state
        for i in range(start, n):
            dl = _deadline_now()
            if dl is not None and i >= 1:
                est = warm_chunk_s if warm_chunk_s is not None else prior_s
                if time.perf_counter() > dl or (
                    est is not None and dl - time.perf_counter() < est * 0.9
                ):
                    r.timed_out = True
                    return
            with _otrace.span("chunk", index=i) as _sp:
                tc = time.perf_counter()
                (new_state, pop_a, pop_k, h, disp_s), fb = (
                    dispatch_or_fallback(i, sweep_state))
                device_s = _retire_wait(h)
                if engine == "sweep":
                    sweep_state = new_state
                retire_common(i, pop_a, pop_k, h, disp_s, device_s,
                              time.perf_counter() - tc, fb)
                chunk_attrs(_sp, i, disp_s, device_s, 0.0, h, r.scorer)
            with _flight.attribute("boundary"):
                stop = boundary(i)
            if stop:
                return
            dl = _deadline_now()
            if dl is not None and time.perf_counter() > dl:
                r.timed_out = i + 1 < n
                return

    def run_pipelined(start: int = 0) -> None:
        """Double-buffered sweep dispatch: chunk i+1 is enqueued before
        chunk i is retired; ``start`` > 0 resumes after a fused group
        drained."""
        nonlocal sweep_state
        r.pipelined = True
        t_mark = time.perf_counter()
        pending, pend_fb = dispatch_or_fallback(start, sweep_state)
        i = start
        while True:
            new_state, pop_a, pop_k, h, disp_s = pending
            # the scorer THIS chunk ran under (a failing speculative
            # dispatch below flips r.scorer first)
            ran_scorer = r.scorer
            nxt = None
            if i + 1 < n:
                # outside chunk i's span, as in the reference: chunk
                # i+1's dispatch span parents under the ladder
                try:
                    nxt = dispatch(i + 1, new_state)
                except Exception as e:
                    if not _is_pallas_lowering(e):
                        raise
                    # drain: retire chunk i with nothing in flight; the
                    # plain retry runs after this boundary
                    _note_fallback(i + 1, e)
            with _otrace.span("chunk", index=i) as _sp:
                device_s = _retire_wait(h)
                sweep_state = new_state
                now = time.perf_counter()
                retire_common(i, pop_a, pop_k, h, disp_s, device_s,
                              now - t_mark, pend_fb)
                t_mark = now
                tb = time.perf_counter()
                with _flight.attribute("boundary"):
                    stop = boundary(i)
                overlap = time.perf_counter() - tb if nxt is not None else 0.0
                r.boundary_overlap_s += overlap
                chunk_attrs(_sp, i, disp_s, device_s, overlap, h,
                            ran_scorer)
            if stop or i + 1 >= n:
                # certified (the chunk in flight is abandoned unread) or
                # done
                return
            dl = _deadline_now()
            if dl is not None:
                now = time.perf_counter()
                est = warm_chunk_s if warm_chunk_s is not None else prior_s
                if now > dl or (est is not None and dl - now < est * 0.9):
                    r.timed_out = True
                    return
            if nxt is not None:
                pending, pend_fb = nxt, False
            else:
                _ladder.note_rung("pipelined_to_sync", chunk=i + 1)
                pending, _ = dispatch_or_fallback(i + 1, sweep_state)
                pend_fb = True
            i += 1

    # ---------------- the fused walkers (mega_k > 1) ----------------

    def _arm_exit(i) -> tuple | None:
        """The device-side exit's thresholds ``(cert_k, cert_mv)``, under
        the boundary certificate's own gate: armed only when skipping the
        ladder past chunk ``i`` saves more than ``cert_min_savings_s`` and
        the bounds are in hand; else None (a disarmed group)."""
        if multi or bounds_fut is None or not bounds_fut.done():
            return None
        remaining_s = (n - i - 1) * (_est_chunk_s() or 0.0)
        if remaining_s <= cert_min_savings_s:
            return None
        try:
            lb_exact, ub0 = bounds_fut.result()
        except Exception:
            return None
        return int(ub0), int(lb_exact)

    def dispatch_mega(i, k, st):
        """Enqueue ONE group over ``chunks[i:i+k]`` and start its fetch.
        A group narrower than ``mega_k`` pads with repeats of its last
        chunk under a cleared ``active``. Returns ``((new_state, pop_a,
        pop_k, fetch), armed, dispatch_s)``; the fetch copies ``(top_a,
        top_k, curves, execd, [cert_a, cert_ok, cert_mv])``."""
        _chaos_chunk_hooks()
        _chaos.raise_if("megachunk_fault")
        td = time.perf_counter()
        group = list(chunks[i:i + k])
        active = [True] * k + [False] * (mega_k - k)
        while len(group) < mega_k:
            group.append(group[-1])
        arm = _arm_exit(i + k - 1)
        cert_k, cert_mv = arm if arm is not None else (None, None)
        fn = solve_lanes_megachunk if lanes else solve_megachunk
        temps = np.stack(group)
        (new_state, top_a, top_k, cert_a, cert_ok, cert_mvs, curves,
         execd) = _launch(
            lambda: fn(m, batch, temps, st, active=np.asarray(active),
                       cert_k=cert_k, cert_mv=cert_mv, scorer=r.scorer,
                       mesh=mesh),
            ("megachunk", i), temps, st)
        # the copies include the device's execd; an armed group also
        # copies its certificate snapshot
        certs = (cert_a, cert_ok, cert_mvs) if arm is not None else ()
        h = fetch_global_async((top_a, top_k, curves, execd, *certs))
        r.dispatches += 1
        return ((new_state, top_a, top_k, h), arm is not None,
                time.perf_counter() - td)

    def _read_exec(h, k, armed) -> tuple:
        """How many of the group's ``k`` chunks executed, from the
        fetched ``execd``, and whether it exited early. A disarmed group
        runs all ``k``."""
        if not armed:
            return k, False
        e = h.get()[3]
        n_exec = int(e.reshape(-1, e.shape[-1])[0][:k].sum())
        return n_exec, n_exec < k

    def _certify_exit(h) -> bool:
        """The host's exact check of a group's flagged exit, as
        ``boundary`` checks: feasibility, the exact move count, the
        weight, one leader reseat. True when the certificate holds."""
        nonlocal reseat_tries
        ca, ok, mv = h.get()[4:]
        if lanes:
            ok, mv, ca = _pool(ok), _pool(mv), _pool(ca)
        else:
            ok, mv = ok.reshape(-1), mv.reshape(-1)
            ca = ca.reshape(-1, *ca.shape[-2:])
        qual = [j for j in range(ok.shape[0]) if ok[j]]
        if not qual:
            return False
        try:
            lb_exact, ub0 = bounds_fut.result()
        except Exception:
            return False
        # the qualifier with the fewest moves, one candidate only
        for j in sorted(qual, key=lambda j: int(mv[j]))[:1]:
            cand = arrays.unpad_candidate(ca[j], inst)
            if not inst.is_feasible(cand):
                continue
            if inst.move_count(cand) > lb_exact:
                continue
            w_cand = inst.preservation_weight(cand)
            if w_cand < ub0 and reseat_tries < 3:
                reseat_tries += 1
                cand = inst.best_leader_assignment(cand)
                w_cand = inst.preservation_weight(cand)
            if w_cand >= ub0:
                r.certified_a = cand
                if lanes:
                    r.winner_lane = int(j) % lanes
                r.certified_at_s = round(time.perf_counter() - budget.t0, 4)
                r.mega_early_exit = True
                return True
        return False

    def retire_mega(i, k, out, disp_s, armed, group_s) -> tuple:
        """Retire one group: wait on its fetch, commit the carried state,
        account the chunks that executed and file its per-chunk time
        under the fused width's own key. Returns ``(n_exec, early)``."""
        nonlocal sweep_state, mega_warm_s, last_chunk_s
        new_state, pop_a, pop_k, h = out
        device_s = _retire_wait(h)
        sweep_state = new_state
        n_exec, early = _read_exec(h, k, armed)
        r.pop_a, r.pop_k, r.fetched = pop_a, pop_k, h
        r.mega_groups += 1
        r.chunks_exec += n_exec
        r.dispatch_s += disp_s
        r.device_s += device_s
        for j in range(n_exec):
            r.rounds_run += int(chunks[i + j].shape[0])
            # curves [C, (Lp,) K, c]: chunk j along the K axis
            handles.append(_CurveSlice(h, j, 2 if lanes else 1))
        per_chunk = group_s / max(1, n_exec)
        last_chunk_s = per_chunk
        if i > 0 and n_exec == k == mega_k:
            mega_warm_s = (per_chunk if mega_warm_s is None
                           else min(mega_warm_s, per_chunk))
        return n_exec, early

    def mega_attrs(sp, k, n_exec, armed, early, disp_s) -> None:
        if sp is not None:
            sp.set(width=k, executed=n_exec, armed=armed, early_exit=early,
                   dispatch_s=round(disp_s, 4))

    def _drain(i, e, to_pipelined: bool) -> None:
        """``megachunk_to_chunked``: the per-chunk ladder re-enters at
        chunk ``i``, the first chunk no group finished."""
        nonlocal mega_active
        mega_active = False
        _ladder.note_rung(
            "megachunk_to_chunked", chunk=i,
            **({"error": repr(e)[:200]} if e is not None
               else {"reason": "exit_uncertified"}))
        if to_pipelined:
            run_pipelined(start=i)
        else:
            run_sync(start=i)

    def run_mega_sync() -> None:
        """One group at a time: dispatch K chunks, retire, boundary."""
        nonlocal mega_active
        mega_active = True
        r.mega_k = mega_k
        i = 0
        while i < n:
            k = min(mega_k, n - i)
            dl = _deadline_now()
            if dl is not None and i >= 1:
                est = _est_chunk_s()
                if time.perf_counter() > dl or (
                    est is not None
                    and dl - time.perf_counter() < est * k * 0.9
                ):
                    r.timed_out = True
                    return
            with _otrace.span("megachunk", index=r.mega_groups,
                              first_chunk=i, width=k) as _sp:
                tg = time.perf_counter()
                try:
                    out, armed, disp_s = dispatch_mega(i, k, sweep_state)
                    n_exec, early = retire_mega(i, k, out, disp_s, armed,
                                                time.perf_counter() - tg)
                except Exception as e:
                    if not _degradable(e):
                        raise
                    _drain(i, e, to_pipelined=False)
                    return
                mega_attrs(_sp, k, n_exec, armed, early, disp_s)
            if early:
                with _flight.attribute("boundary"):
                    certified = _certify_exit(r.fetched)
                if certified:
                    return
                # a flagged exit the host could not certify would flag
                # again at every step: the per-chunk ladder (whose
                # certificate has the reseat and tight tiers) takes the
                # tail from the first chunk not executed
                _drain(i + n_exec, None, to_pipelined=False)
                return
            with _flight.attribute("boundary"):
                stop = boundary(i + k - 1)
            if stop:
                return
            dl = _deadline_now()
            if dl is not None and time.perf_counter() > dl:
                r.timed_out = i + k < n
                return
            i += k

    def run_mega_pipelined() -> None:
        """Double-buffered groups: group g+1 is enqueued before group g
        is retired. When group g exits early with g+1 in flight, g+1 ran
        from g's final state: a certificate that holds abandons g+1
        unread; one that fails adopts g+1 (its trajectory continues
        g's) and then drains to the per-chunk ladder."""
        nonlocal mega_active
        mega_active = True
        r.mega_k = mega_k
        r.pipelined = True
        t_mark = time.perf_counter()
        i = 0
        k = min(mega_k, n)
        try:
            pending = dispatch_mega(i, k, sweep_state)
        except Exception as e:
            if not _degradable(e):
                raise
            _drain(i, e, to_pipelined=True)
            return
        while True:
            out, armed, disp_s = pending
            new_state = out[0]
            j, k_next = i + k, min(mega_k, n - i - k)
            nxt, drain_exc = None, None
            if k_next > 0:
                try:
                    nxt = dispatch_mega(j, k_next, new_state)
                except Exception as e:
                    if not _degradable(e):
                        raise
                    drain_exc = e
            with _otrace.span("megachunk", index=r.mega_groups,
                              first_chunk=i, width=k) as _sp:
                n_exec, early = retire_mega(i, k, out, disp_s, armed,
                                            time.perf_counter() - t_mark)
                h = r.fetched
                t_mark = time.perf_counter()
                tb = time.perf_counter()
                with _flight.attribute("boundary"):
                    stop = early or boundary(i + k - 1)
                if nxt is not None:
                    r.boundary_overlap_s += time.perf_counter() - tb
                mega_attrs(_sp, k, n_exec, armed, early, disp_s)
            if early:
                with _flight.attribute("boundary"):
                    certified = _certify_exit(h)
                if certified:
                    return  # the group in flight is abandoned unread
                if nxt is not None:
                    out2, armed2, disp2 = nxt
                    n2, early2 = retire_mega(j, k_next, out2, disp2, armed2,
                                             time.perf_counter() - t_mark)
                    t_mark = time.perf_counter()
                    if early2 and _certify_exit(r.fetched):
                        return
                    _drain(j + n2, None, to_pipelined=True)
                    return
                _drain(i + n_exec, None, to_pipelined=True)
                return
            if stop or k_next <= 0:
                return
            dl = _deadline_now()
            if dl is not None:
                nowd = time.perf_counter()
                est = _est_chunk_s()
                if nowd > dl or (
                    est is not None and dl - nowd < est * k_next * 0.9
                ):
                    r.timed_out = True
                    return
            if drain_exc is not None:
                _drain(j, drain_exc, to_pipelined=True)
                return
            pending = nxt
            i, k = j, k_next

    with _profiled(m.a0.device):
        if engine == "sweep" and mega_k > 1 and n > 1:
            # the fused ladder; its faults drain to the per-chunk walkers
            if pipeline:
                run_mega_pipelined()
            else:
                run_mega_sync()
        elif pipeline and engine == "sweep" and n > 1:
            run_pipelined()
        else:
            run_sync()
    # every copy was started at its chunk's dispatch: by now on the host
    r.curves = [h.get() for h in handles]
    if warm_chunk_s is not None:
        _WARM_CHUNKS.update(_wkey(), warm_chunk_s)
    if mega_warm_s is not None:
        _WARM_CHUNKS.update(_wkey(mega_k), mega_warm_s)
    return r


def _device_keys(state):
    """A sweep state with its keys as device keys on their blocks'
    devices (one copy each, no wait)."""
    a, best_k, best_mv, best_a, keys = state
    if isinstance(keys, tuple):  # one leaf a block of a multi-block mesh
        keys = tuple(prng.to_device_keys(k, x.device)
                     for k, x in zip(keys, a))
    else:
        keys = prng.to_device_keys(keys, a.device)
    return a, best_k, best_mv, best_a, keys


def _replayed_chunk(group):
    """A chunk stepper ``(m, state, temps) -> (state', top_a, top_k,
    curve)`` made of a fused-group stepper ``group``: each chunk one
    disarmed group of one step, one replay of its bucket's graph."""
    def run(m, st, temps):
        out = group(m, st, np.asarray(temps, np.float32)[None],
                    np.ones(1, bool), MEGA_DISARMED_KEY,
                    MEGA_DISARMED_MOVES)
        return out[0], out[1], out[2], out[6].select(-2, 0)

    return run


def _final_selection(inst, m, pop_a, bounds_fut, lp_fut, budget,
                     lanes: int = 0, multi: bool = False):
    """Exact rescore of the shard winners (B1 on the card, which also
    counts the moves) ranked by feasibility, then weight, then fewest
    moves; then certify FIRST — moves against the exact move bound,
    feasibility, weight against the weight bound, one exact reseat —
    and polish only when no check certified, followed by a reseat;
    last, an uncertified constructor plan may outrank the result.

    ``pop_a`` holds each chain shard's winner (``[C, P, R]``). ``lanes``
    > 0 is the portfolio: the pool is the real lanes' winners of every
    shard (``pop_a [C, Lp, P, R]``, padding lanes dropped, flattened
    shard-major so index j is lane ``j % lanes``), scored with the base
    model ``m``; polish and reseat use it too. Under a process group
    (``multi``) the joins wait without a cap, so every process reaches
    the same verdict.

    Returns ``(best_a, final_cert, lp_plan_won, t_select,
    winner_lane)``: ``final_cert`` names the check that decided
    ("ok"/"ok_reseat" certified, polish skipped); ``t_select`` is the
    host clock when the certify-first attempt ended; ``winner_lane`` the
    portfolio lane of the champion (None without lanes, or when the
    constructor's plan won)."""
    if lanes:
        pop_a = pop_a[:, :lanes].reshape(-1, *pop_a.shape[2:])
    out, _cnt, _lcnt, _rcnt = score(m, pop_a)
    primary, moves = out_key(out), out[:, 5]
    tied = primary == primary.max()
    # the champion's index is the selection's read back from the card
    with _otrace.span("device_transfer"):
        top = int(first_argmax(torch.where(tied, -moves, _IMIN)))
    cand = pop_a[top]
    winner_lane = int(top) % lanes if lanes else None
    certified_final = None
    final_cert = "budget_spent"
    left = budget.remaining()
    if left is None or left > 0:
        join_cap = left if (multi or left is not None) else 15.0
        try:
            lb_exact, ub0 = bounds_fut.result(timeout=join_cap)
        except Exception:
            lb_exact = ub0 = None
        if ub0 is None:
            final_cert = "bounds_unavailable"
        else:
            cand_np = arrays.unpad_candidate(cand, inst)
            if inst.move_count(cand_np) > lb_exact:
                final_cert = "moves_above_lb"
            elif not inst.is_feasible(cand_np):
                final_cert = "infeasible"
            elif inst.preservation_weight(cand_np) >= ub0:
                certified_final = cand_np
                final_cert = "ok"
            else:
                reseated = inst.best_leader_assignment(cand_np)
                if inst.preservation_weight(reseated) >= ub0:
                    certified_final = reseated
                    final_cert = "ok_reseat"
                else:
                    final_cert = "weight_below_ub"
                    # polish from the reseat (never below the champion)
                    cand = torch.from_numpy(
                        arrays.pad_candidate(reseated, m)).to(m.device)
    t_select = _sync(m.device)
    if certified_final is not None:
        return certified_final, final_cert, False, t_select, winner_lane
    best_a = arrays.unpad_candidate(polish(m, cand), inst)
    try:
        _, ub0 = bounds_fut.result(timeout=budget.remaining())
    except Exception:
        ub0 = None
    if (
        inst.is_feasible(best_a)
        and not budget.expired()
        and (ub0 is None or inst.preservation_weight(best_a) < ub0)
    ):
        best_a = inst.best_leader_assignment(best_a)
    lp_won = False
    if lp_fut is not None:
        left = budget.remaining()
        try:
            plan, _ok, _extends = lp_fut.result(
                timeout=10.0 if left is None else left)
        except Exception:
            plan = None
        if plan is not None:
            def rank(zz):
                return (inst.is_feasible(zz), inst.preservation_weight(zz),
                        -inst.move_count(zz))

            plan = np.asarray(plan, dtype=np.int32)
            if rank(plan) > rank(best_a):
                best_a = plan
                lp_won = True
    return (best_a, final_cert, lp_won, t_select,
            None if lp_won else winner_lane)


def _oracle(inst: ProblemInstance, a: np.ndarray) -> tuple[dict, list]:
    """The numpy oracle's violations of plan ``a`` and its scores in B1's
    order: (weight, broker, leader, rack, diversity)."""
    viol = inst.violations(a)
    return viol, [inst.preservation_weight(a), viol["broker_balance"],
                  viol["leader_balance"], viol["rack_balance"],
                  viol["part_rack_diversity"]]


def _verify(inst: ProblemInstance, m: arrays.ModelArrays,
            best_a: np.ndarray) -> dict:
    """The numpy oracle's violation counts of the final plan, checked
    against the device scorer's (B1 on the card) — a disagreement means
    the device path is wrong, and raises."""
    viol, oracle = _oracle(inst, best_a)
    dev_a = torch.from_numpy(arrays.pad_candidate(best_a, m)).to(m.device)
    out = score(m, dev_a[None])[0][0, :5].tolist()
    if out != oracle:
        raise RuntimeError(
            "verification failed: the device scores (weight, broker, "
            f"leader, rack, diversity) {out} disagree with the numpy "
            f"oracle {oracle}"
        )
    return viol


def _solve_inner(inst, dev, seed, batch, rounds, sweeps, steps_per_round,
                 t_hi, t_lo, engine, time_limit_s, cert_min_savings_s,
                 budget, t0, bounds_fut, lp_fut, lp_wait_s,
                 portfolio=None, warm_start=None, checkpoint=None,
                 pipeline=True, megachunk=None, n_devices=None,
                 mesh_device=None, multi=False) -> SolveResult:
    # the phase spans (obs.trace): every stage gets exactly one span on
    # every path; a stage that does not run is a zero-length span marked
    # skipped, as in the reference
    with _otrace.span("constructor") as _sp:
        certified_a, lp_warm, lp_warm_extends = _await_constructor(
            lp_fut, lp_wait_s, checkpoint, budget)
        if _sp is not None:
            _sp.set(skipped=lp_fut is None, wait_budget_s=lp_wait_s,
                    certified=certified_a is not None,
                    warm_start=lp_warm is not None)
    constructed = early_stopped = certified_a is not None
    t_race = time.perf_counter()
    final_cert = None
    steps_per_round_ignored = False
    m = None
    bkt_parts = bkt_rf = None
    lad = _LadderResult()
    chunks: list = []
    mega_mode = "off"
    pw, port_lanes, port_cfgs = 1, 0, []
    mesh, n_dev, chains_per_device = None, 0, 0
    if certified_a is None:
        platform = "gpu" if dev.type == "cuda" else "cpu"
        d = _defaults(inst, platform, engine)
        engine = d["engine"]
        batch = batch or d["batch"]
        rounds = rounds or sweeps or d["rounds"]
        steps_per_round = steps_per_round or d["steps_per_round"]
        if engine == "sweep" and steps_per_round != 1:
            # the sweep engine has no inner step loop: say so in stats
            steps_per_round_ignored = True
            steps_per_round = 1
        if t_hi is None:
            t_hi = 2.0 if engine == "sweep" else 2.5
        if t_lo is None:
            t_lo = 0.02 if engine == "sweep" else 0.05
        scorer = "cuda" if dev.type == "cuda" else "torch"
        # the ledger's host-constructor window: the seed and the model's
        # lowering, the host work ahead of the first dispatch
        with _flight.attribute("constructor"):
            with _otrace.span("seed") as _sp:
                a_seed, resumed, warm_started = _pick_seed(
                    inst, lp_warm, lp_warm_extends, checkpoint, warm_start)
                if _sp is not None:
                    _sp.set(resumed_from_checkpoint=resumed,
                            warm_started=warm_started,
                            warm_start_extends_greedy=bool(lp_warm_extends))
            t_seed = time.perf_counter()
            bkt_parts, bkt_rf = bucket.bucket_shape(inst)
            bucket.STATS.record_bucket(
                (inst.num_brokers, inst.num_racks, bkt_parts, bkt_rf),
                padded=(bkt_parts, bkt_rf) != (inst.num_parts, inst.max_rf))
            m = arrays.from_instance(inst, dev, num_parts=bkt_parts,
                                     max_rf=bkt_rf)
        seed_dev = torch.from_numpy(arrays.pad_candidate(a_seed, m)).to(dev)
        key = prng.PRNGKey(seed)
        chunks = _build_chunks(inst, engine, rounds, t_hi, t_lo,
                               time_limit_s)
        # the solve mesh: C chain shards of max(1, batch // C) chains
        mesh = make_mesh(n_devices, device=mesh_device or dev)
        n_dev = mesh.size
        chains_per_device = max(1, batch // n_dev)
        bkt_key = (inst.num_brokers, inst.num_racks, int(bkt_parts),
                   int(bkt_rf))
        # the portfolio: the sweep engine only, and never under a process
        # group (its first-to-certify exit is a host race)
        pw = (_resolve_portfolio_width(portfolio)
              if engine == "sweep" and not multi else 1)
        if pw > 1:
            # pw configs padded up the lane ladder; padding lanes rerun
            # lane 0's config and are never read. Lane 0 takes the solo
            # key verbatim, lane i fold_in(key, i), padding lane j
            # fold_in(key, pw + j): no two lanes share a stream
            port_cfgs = arrays.portfolio_configs(pw)
            port_lanes = bucket.lane_bucket(pw)
            models = [arrays.with_config(m, c) for c in port_cfgs]
            models += [models[0]] * (port_lanes - pw)
            m_solver = arrays.stack_models(models)
            lane_keys = np.stack(
                [key] + [prng.fold_in(key, i) for i in range(1, pw)]
                + [prng.fold_in(key, pw + j)
                   for j in range(port_lanes - pw)])
            lane_seeds = np.broadcast_to(
                arrays.pad_candidate(a_seed, m),
                (port_lanes, *m.a0.shape))
            note_lane_serve(bkt_key, pw, port_lanes)
            # the portfolio rides the solve mesh with the (chains x
            # lanes) split the chooser picks for its bucket
            mesh = make_solve_mesh(n_devices, lanes=port_lanes,
                                   bucket_key=bkt_key, engine=engine,
                                   multi=multi, device=mesh_device or dev)
            sweep_state = init_lane_state(m_solver, lane_seeds, lane_keys,
                                          chains_per_device, mesh)
            warm_key = ("lanes", port_lanes, engine, chains_per_device,
                        steps_per_round, int(bkt_parts), int(bkt_rf))
        else:
            m_solver = m
            sweep_state = (init_sweep_state(m, seed_dev, key,
                                            chains_per_device, mesh)
                           if engine == "sweep" else None)
            warm_key = (engine, chains_per_device, steps_per_round,
                        int(bkt_parts), int(bkt_rf))
        if n_dev > 1:
            # a sharded ladder's chunks do C times the work: its own
            # estimates, by split
            warm_key = (*warm_key, "%dx%d" % mesh_spec(mesh))
        mega_k, mega_mode, ev_key = _ladder_width(
            megachunk, engine, multi, chunks, warm_key, scorer, mesh,
            port_lanes)
        if port_lanes:
            # the racing geometry, on the report even when the ladder's
            # span is the one timed
            _otrace.mark("portfolio", width=pw, lane_bucket=port_lanes)
        t_lower = _sync(dev)
        marks0 = _flight.ledger_marks()
        with _otrace.span("ladder", engine=engine,
                          chunks=len(chunks)) as _sp:
            lad = _run_ladder(
                inst, m_solver, chains_per_device, steps_per_round, engine,
                scorer, chunks, seed_dev, key, sweep_state, lp_fut,
                bounds_fut, cert_min_savings_s, budget, warm_key,
                lanes=pw if port_lanes else 0, pipeline=pipeline,
                mega_k=mega_k, mesh=mesh, multi=multi,
                group_chunks=mega_mode == "auto",
            )
            if _sp is not None:
                # the funnel's own dispatch and device windows around
                # the ladder (obs.flight), next to the ladder's tallies
                marks1 = _flight.ledger_marks()
                _sp.set(rounds_run=lad.rounds_run, timed_out=lad.timed_out,
                        scorer=lad.scorer, pipelined=lad.pipelined,
                        dispatch_s=round(lad.dispatch_s, 4),
                        device_s=round(lad.device_s, 4),
                        boundary_overlap_s=round(lad.boundary_overlap_s, 4),
                        boundary_certified=lad.certified_a is not None,
                        portfolio_width=pw if port_lanes else None,
                        dispatches=lad.dispatches, megachunk_k=lad.mega_k,
                        ledger_dispatches=(marks1["dispatches"]
                                           - marks0["dispatches"]),
                        ledger_device_s=round(marks1["device_s"]
                                              - marks0["device_s"], 4))
        if engine == "sweep":
            # the "auto" chooser's evidence, under the identity the width
            # was resolved with and the scorer the ladder ended on
            _file_evidence((*ev_key[:-1], lad.scorer), lad, marks0)
        t_ladder = _sync(dev)
        scorer = lad.scorer
        if lad.timed_out:
            # the deadline rung: the ladder returned best-so-far early
            _ladder.note_rung("deadline_truncated",
                              rounds_run=lad.rounds_run)
        if lad.certified_a is not None:
            certified_a = lad.certified_a
            early_stopped = True
            constructed = lad.constructed
    else:
        # the constructed path touches no device at all
        platform = "host"
        engine = "construct"
        batch = rounds = steps_per_round = 0
        scorer = None
        a_seed = certified_a
        resumed = False
        # the delta path's adapted plan can BE the certified plan: the
        # warm-certify race worker tags its win
        warm_started = getattr(inst, "_construct_path", None) == "warm"
        t_seed = t_lower = t_ladder = t_race
        _otrace.mark("seed", skipped=True)
        _otrace.mark("ladder", skipped=True)
    # the best-score trajectory (the max over lanes on the portfolio);
    # the solve report's annealing summary shares it
    curve = (np.concatenate([c.reshape(-1, c.shape[-1]) for c in lad.curves],
                            -1).max(0)
             if lad.curves else np.zeros(0, np.int64))
    if _otrace.active():
        imp = int((np.diff(curve) > 0).sum()) if curve.size > 1 else 0
        _otrace.set_trajectory(
            engine=engine, rounds=int(curve.size),
            energy_curve=_downsample(curve, 64), improved_rounds=imp,
            plateau_rounds=max(0, int(curve.size) - 1 - imp))
    t_select = t_ladder
    winner_lane = lad.winner_lane
    if certified_a is not None:
        _otrace.mark("polish", skipped=True)
        best_a = np.asarray(certified_a, dtype=np.int32)
        t_polish = t_ladder
    else:
        # the "polish" span covers all of final selection: the rescore,
        # the certify-first attempt and (on its failure) polish itself
        with _otrace.span("polish") as _sp:
            best_a, final_cert, lp_won, t_select, winner_lane = (
                _final_selection(inst, m, lad.pop_a, bounds_fut, lp_fut,
                                 budget, lanes=pw if port_lanes else 0,
                                 multi=multi))
            if _sp is not None:
                _sp.set(final_cert=final_cert, lp_plan_won=lp_won)
        constructed = constructed or lp_won
        t_polish = _sync(dev)

    with _otrace.span("verify") as _sp:
        viol = (_verify(inst, m, best_a) if m is not None
                else inst.violations(best_a))
        weight = inst.preservation_weight(best_a)
        feasible = all(v == 0 for v in viol.values())
        moves_final = int(inst.move_count(best_a))
        if checkpoint:
            # persist BEFORE the certification joins below, which may
            # block on a straggling LP: a solve killed there keeps its
            # plan. A failed write (disk full, permissions, the chaos
            # point) is the checkpoint_skipped rung: the verified plan is
            # still returned
            try:
                _chaos.raise_if("checkpoint_write", OSError)
                ckpt.save(checkpoint, inst, best_a, meta={
                    "objective": int(weight), "feasible": feasible,
                    "moves": moves_final, "engine": engine})
            except Exception as e:
                _ladder.note_rung("checkpoint_skipped", error=repr(e)[:200])
        # the optimality certificate: a plan meeting both bounds is a
        # proven optimum; the tier-1 escalation is allowed without a
        # deadline only
        if certified_a is not None:
            proved_optimal = True
        else:
            try:
                timeout = budget.remaining()
                bounds_fut.result(timeout=timeout)
                if lad.tight_fut is not None:
                    lad.tight_fut.result(timeout=timeout)
                proved_optimal = inst.certify_optimal(
                    best_a,
                    allow_tight=(time_limit_s is None
                                 or lad.tight_fut is not None),
                )
            except Exception:
                proved_optimal = False
        if _sp is not None:
            _sp.set(feasible=feasible, moves=moves_final,
                    proved_optimal=proved_optimal)
    t_verify = time.perf_counter()
    if port_lanes:
        # the adaptive table's evidence: the config that produced the plan
        arrays.note_portfolio_result(
            port_cfgs[winner_lane] if winner_lane is not None else None)
    return SolveResult(
        a=best_a,
        solver="tpu",
        wall_clock_s=t_verify - t0,
        objective=int(weight),
        optimal=proved_optimal,
        stats={
            "platform": platform,
            "device": str(dev) if m is not None else None,
            "engine": engine,
            "scorer": scorer,
            "devices": n_dev,
            "chains_per_device": chains_per_device,
            **({"mesh": _mesh_stats(mesh)} if mesh is not None else {}),
            "rounds": rounds,
            "rounds_run": lad.rounds_run,
            "chunks": len(lad.curves),
            "timed_out": lad.timed_out,
            "early_stopped": early_stopped,
            "constructed": constructed,
            "construct_path": (getattr(inst, "_construct_path", None)
                               if constructed else None),
            "constructor_impl": _constructor.active(),
            "moves_lb": (
                inst.move_lower_bound()
                if getattr(inst, "_move_lb_memo", None) is None
                else inst._move_lb_memo
            ),
            "weight_ub": inst.best_known_weight_ub(),
            "flow_bound_declines": getattr(inst, "_flow_big_declines", 0),
            "proved_optimal": proved_optimal,
            **({"bucket_parts": int(bkt_parts), "bucket_rf": int(bkt_rf)}
               if bkt_parts is not None else {}),
            "time_limit_s": time_limit_s,
            "steps_per_round": steps_per_round,
            "steps_per_round_ignored": steps_per_round_ignored,
            # the ladder's dispatch: whether speculation ran, the host
            # time enqueueing, the host time blocked on the card, the
            # boundary work done behind a chunk in flight, the dispatches
            "pipeline": lad.pipelined,
            "dispatch_s": round(lad.dispatch_s, 4),
            "device_s": round(lad.device_s, 4),
            "boundary_overlap_s": round(lad.boundary_overlap_s, 4),
            "dispatches": lad.dispatches,
            # the fused ladder: its width, how it was chosen, its groups
            # and chunks, and whether a group's certificate retired it
            **({"megachunk": {
                "k": lad.mega_k,
                "mode": mega_mode,
                "groups": lad.mega_groups,
                "dispatches": lad.dispatches,
                "chunks": lad.chunks_exec,
                "early_exit": lad.mega_early_exit,
            }} if engine == "sweep" and chunks else {}),
            **({"pallas_fallback": lad.pallas_fallback}
               if lad.pallas_fallback else {}),
            # the portfolio's geometry, its winning lane and config, and
            # whether a lane's certificate retired the ladder (a boundary
            # adoption of the constructor's plan is no portfolio win)
            **({"portfolio": {
                "width": pw,
                "lane_bucket": port_lanes,
                "winner_lane": winner_lane,
                "winner_config": (
                    dataclasses.asdict(port_cfgs[winner_lane])
                    if winner_lane is not None else None),
                "early_exit": (lad.certified_a is not None
                               and not lad.constructed),
                **({"certified_at_s": lad.certified_at_s}
                   if lad.certified_at_s is not None else {}),
            }} if port_lanes else {}),
            **({"final_cert": final_cert} if final_cert else {}),
            "total_steps": (lad.rounds_run * steps_per_round
                            if engine == "chain"
                            else lad.rounds_run * inst.num_parts),
            "race_s": round(t_race - t0, 4),
            "seed_s": round(t_seed - t_race, 4),
            "lower_s": round(t_lower - t_seed, 4),
            "anneal_s": round(t_ladder - t_lower, 4),
            "select_s": round(t_select - t_ladder, 4),
            "polish_s": round(t_polish - t_select, 4),
            "verify_s": round(t_verify - t_polish, 4),
            "seed_moves": int(inst.move_count(a_seed)),
            "moves": moves_final,
            "feasible": feasible,
            "violations": sum(viol.values()),
            "resumed_from_checkpoint": resumed,
            # True when the delta API's adapted previous plan seeded (or
            # was certified as) this solve's plan
            "warm_started": warm_started,
            "score_curve": _downsample(curve, 32),
        },
    )


def solve_tpu_batch(
    insts: list,
    seeds: int | list[int] = 0,
    *,
    engine: str | None = None,
    batch: int | None = None,
    rounds: int | None = None,
    sweeps: int | None = None,
    t_hi: float | None = None,
    t_lo: float | None = None,
    n_devices: int | None = None,
    time_limit_s: float | None = None,
    certify: bool = False,
    trace: bool | str | None = None,
    pipeline: bool | None = None,
    portfolio: bool | int | None = None,
    megachunk=None,
    precompile: bool = False,
    device=None,
) -> list[SolveResult]:
    """Solve L independent instances in one lane ladder on ``device``
    (default the card): every instance padded up to one common bucket
    (the largest lane's rungs) and lowered into a stacked model, the
    lanes padded up the lane ladder (a padding lane reruns lane 0 with a
    key of its own and is never read), and each schedule chunk one lane
    stepper run (every kernel one launch for all lanes) or, for the chain
    engine, one anneal a lane. No constructor race, no boundary
    certificate, no polish: each lane's winner is verified against the
    numpy oracle (and B1 held to it), and ``certify=True`` adds the
    optimality certificate.

    ``seeds`` is one int (lane i takes ``seed + i``) or one a lane; lane
    i's key is ``PRNGKey(seeds[i])``. ``time_limit_s`` cuts the ladder
    into chunks with the deadline checked between them. Instances whose
    brokers or racks differ cannot stack: they are solved one by one
    with :func:`solve_tpu`, tagged ``stats["lane_fallback"]``.
    ``portfolio`` is honoured there only: the lanes of a batch are its
    instances. ``pipeline`` and ``megachunk`` schedule the lane ladder as
    in :func:`solve_tpu`; a fused group of a batch always runs disarmed
    (independent instances never share an early exit).

    The degradation-rung collector wraps the call: rungs the shared lane
    ladder takes apply to every lane, while a lane's own rungs on the
    unstackable fallback land on that lane's ``stats["degradations"]``
    only.

    ``trace`` records ONE solve report for the whole batch: every lane's
    stats carry its ``trace_id`` and ``solve_report``. Flight records:
    one a lane (kind ``"lane"``), sharing the batch's accounting; none
    for a ``precompile`` batch (the service's warm-up)."""
    nested = _flight.accounting_active()
    acc_tok = None if nested else _flight.start_accounting()
    t0 = time.perf_counter()
    try:
        with _ladder.collect() as rungs:
            results = _solve_tpu_batch(
                insts, seeds, engine, batch, rounds, sweeps, t_hi, t_lo,
                time_limit_s, certify, portfolio, device, pipeline,
                megachunk, trace, n_devices)
            for r in results:
                combined = (list(rungs or ())
                            + r.stats.get("degradations", []))
                if combined:
                    r.stats["degradations"] = combined
    except BaseException as e:
        acc = (_flight.end_accounting(acc_tok) if acc_tok is not None
               else None)
        if acc is not None and not precompile:
            # the whole batch failed: one failure record a lane
            for inst in insts:
                _flight.record_failure(inst, acc, time.perf_counter() - t0,
                                       e, kind="lane")
        raise
    acc = _flight.end_accounting(acc_tok) if acc_tok is not None else None
    if acc is not None and not precompile:
        for inst, r in zip(insts, results):
            _flight.record_solve(r, inst, acc, kind="lane")
    return results


def _solve_tpu_batch(insts, seeds, engine, batch, rounds, sweeps, t_hi,
                     t_lo, time_limit_s, certify, portfolio, device,
                     pipeline, megachunk, trace=None, n_devices=None):
    t0 = time.perf_counter()
    dev = resolve_device(device)
    pipeline = _PIPELINE_DEFAULT if pipeline is None else bool(pipeline)
    if _san.enabled():
        _san.install()
    if not insts:
        return []
    if isinstance(seeds, int):
        seeds = [seeds + i for i in range(len(insts))]
    if len(seeds) != len(insts):
        raise ValueError(f"got {len(seeds)} seeds for {len(insts)} instances")
    # one trace covers the whole call, the batch or its sequential
    # fallback alike
    tr = _otrace.begin(trace, name="solve_tpu_batch", lanes=len(insts))
    try:
        if len({(i.num_brokers, i.num_racks) for i in insts}) > 1:
            results = []
            for i, (inst, s) in enumerate(zip(insts, seeds)):
                # lane-scoped rungs: THIS lane's fallbacks must not flag
                # its siblings' stats
                with _otrace.span("lane", index=i), \
                        _ladder.collect_lane() as lane_rungs:
                    r = solve_tpu(inst, seed=s, engine=engine, batch=batch,
                                  rounds=rounds, sweeps=sweeps, t_hi=t_hi,
                                  t_lo=t_lo, time_limit_s=time_limit_s,
                                  pipeline=pipeline, portfolio=portfolio,
                                  megachunk=megachunk, device=device,
                                  n_devices=n_devices)
                if lane_rungs:
                    r.stats["degradations"] = list(lane_rungs)
                r.stats["lane_fallback"] = (
                    "brokers/racks differ across lanes")
                results.append(r)
        else:
            results = _solve_batch_body(
                insts, seeds, engine, batch, rounds, sweeps, t_hi, t_lo,
                time_limit_s, certify, t0, dev, pipeline, megachunk,
                n_devices, device)
    except BaseException as e:
        if isinstance(e, FloatingPointError):
            _san.note_nan_abort_once(e, "solve_tpu_batch")
        if tr is not None:
            tr.root.set(error=repr(e)[:200])
            _otrace.finish(tr)
        raise
    if tr is not None:
        rep = _otrace.finish(tr)
        for r in results:
            r.stats["trace_id"] = tr.trace_id
            r.stats["solve_report"] = rep
    else:
        tid = _otrace.current_trace_id()
        if tid:
            for r in results:
                r.stats.setdefault("trace_id", tid)
    return results


def _solve_batch_body(insts, seeds, engine, batch, rounds, sweeps, t_hi,
                      t_lo, time_limit_s, certify, t0, dev, pipeline=True,
                      megachunk=None, n_devices=None, mesh_device=None):
    for inst in insts:
        inst._bounds_cancelled = False
        inst._construct_path = None
        inst._flow_big_declines = 0
    L = len(insts)
    platform = "gpu" if dev.type == "cuda" else "cpu"
    # the budget follows the largest lane (one bucket, one cost)
    biggest = max(insts, key=lambda i: i.num_parts)
    d = _defaults(biggest, platform, engine)
    engine = d["engine"]
    batch = batch or d["batch"]
    rounds = rounds or sweeps or d["rounds"]
    steps_per_round = d["steps_per_round"]
    if t_hi is None:
        t_hi = 2.0 if engine == "sweep" else 2.5
    if t_lo is None:
        t_lo = 0.02 if engine == "sweep" else 0.05
    # no bounds, no race, no polish on the batch path: their skipped
    # marks keep the report's phase names those of the single path
    _otrace.mark("bounds", skipped=True)
    _otrace.mark("constructor", skipped=True)
    _otrace.mark("polish", skipped=True)
    with _otrace.span("seed", lanes=L):
        m_stack, lane_seeds, keys = stack_lanes(insts, seeds, dev)
    Lp, bkt_parts, bkt_rf = lane_seeds.shape
    note_lane_serve((insts[0].num_brokers, insts[0].num_racks, bkt_parts,
                     bkt_rf), L, Lp)
    seed_moves = [int(inst.move_count(arrays.unpad_candidate(
        lane_seeds[i], inst))) for i, inst in enumerate(insts)]
    scorer = "cuda" if dev.type == "cuda" else "torch"

    # a process group runs the whole ladder on every process alike
    multi = _dist.process_count() > 1
    if multi:
        time_limit_s = None
    chunks = _build_chunks(biggest, engine, rounds, t_hi, t_lo,
                           time_limit_s)
    # the lanes ride the solve mesh with the (chains x lanes) split the
    # chooser picks for the bucket; every split replays one trajectory
    bkt_key = (insts[0].num_brokers, insts[0].num_racks, int(bkt_parts),
               int(bkt_rf))
    mesh = make_solve_mesh(n_devices, lanes=Lp, bucket_key=bkt_key,
                           engine=engine, multi=multi,
                           device=mesh_device or dev)
    n_dev = mesh.size
    chains_per_device = max(1, batch // n_dev)
    warm_key = ("lanes", Lp, engine, chains_per_device, steps_per_round,
                int(bkt_parts), int(bkt_rf))
    if n_dev > 1:
        warm_key = (*warm_key, "%dx%d" % mesh_spec(mesh))
    mega_k, mega_mode, ev_key = _ladder_width(
        megachunk, engine, False, chunks, warm_key, scorer, mesh, Lp)
    # the single path's ladder with the certificate off (no bounds): the
    # lanes are independent instances, so no lane retires the others and
    # every fused group runs disarmed
    with _otrace.span("ladder", engine=engine, chunks=len(chunks)) as _lsp:
        marks0 = _flight.ledger_marks()
        lad = _run_ladder(
            insts[0], m_stack, chains_per_device, steps_per_round, engine,
            scorer, chunks, None, None,
            (init_lane_state(m_stack, lane_seeds, keys, chains_per_device,
                             mesh)
             if engine == "sweep" else None),
            None, None, 0.0, Budget(time_limit_s, t0=t0), warm_key,
            lanes=L, pipeline=pipeline, mega_k=mega_k,
            chain_lanes=None if engine == "sweep" else (lane_seeds, keys),
            mesh=mesh, multi=multi, group_chunks=mega_mode == "auto",
        )
        if _lsp is not None:
            _lsp.set(rounds_run=lad.rounds_run, timed_out=lad.timed_out,
                     scorer=lad.scorer, pipelined=lad.pipelined,
                     dispatches=lad.dispatches, megachunk_k=lad.mega_k)
    if lad.timed_out:
        _ladder.note_rung("deadline_truncated", rounds_run=lad.rounds_run)
    t_solve = _sync(dev)
    if engine == "sweep":
        # the "auto" chooser's evidence (batch groups run disarmed)
        _file_evidence(ev_key, lad, marks0)
    if engine == "sweep" and lad.dispatches:
        # production batches keep the sharding evidence honest about the
        # split they ran: the ledger's device window over the ladder, or
        # its own tally when no accounting is active
        marks1 = _flight.ledger_marks()
        n_ev = marks1["dispatches"] - marks0["dispatches"]
        dev_s = marks1["device_s"] - marks0["device_s"]
        if n_ev <= 0:
            n_ev, dev_s = lad.dispatches, lad.device_s
        note_sharding_evidence(bkt_key, mesh_spec(mesh), lanes=Lp,
                               solves=n_ev, device_s=dev_s)
    curve = np.concatenate(lad.curves, -1)  # [C, Lp, rounds]
    plans = _select_shards(insts, lad.fetched.get()[0])
    wall = time.perf_counter() - t0
    with _otrace.span("verify", lanes=L) as _vsp:
        viols = _verify_lanes(insts, m_stack, plans)
        if _vsp is not None:
            _vsp.set(lanes_feasible=sum(
                1 for v in viols if all(x == 0 for x in v.values())))
    mega = ({"k": lad.mega_k, "mode": mega_mode, "groups": lad.mega_groups,
             "dispatches": lad.dispatches, "chunks": lad.chunks_exec,
             "early_exit": lad.mega_early_exit}
            if engine == "sweep" and chunks else None)
    results = []
    for i, inst in enumerate(insts):
        best_a = arrays.unpad_candidate(plans[i], inst)
        viol = viols[i]
        weight = inst.preservation_weight(best_a)
        feasible = all(v == 0 for v in viol.values())
        proved = bool(certify and feasible and inst.certify_optimal(best_a))
        results.append(SolveResult(
            a=best_a,
            solver="tpu",
            wall_clock_s=wall,
            objective=int(weight),
            optimal=proved,
            stats={
                "platform": platform,
                "device": str(dev),
                "engine": engine,
                "lanes": L,
                "lane": i,
                "lane_bucket": Lp,
                "devices": n_dev,
                "chains_per_device": chains_per_device,
                "mesh": _mesh_stats(mesh),
                "rounds": rounds,
                "rounds_run": lad.rounds_run,
                "timed_out": lad.timed_out,
                "bucket_parts": int(bkt_parts),
                "bucket_rf": int(bkt_rf),
                "scorer": lad.scorer,
                "pipeline": lad.pipelined,
                # one ladder served every lane: these describe the batch
                "dispatches": lad.dispatches,
                **({"megachunk": dict(mega)} if mega else {}),
                **({"pallas_fallback": lad.pallas_fallback}
                   if lad.pallas_fallback else {}),
                "proved_optimal": proved,
                "time_limit_s": time_limit_s,
                "seed_moves": seed_moves[i],
                "moves": int(inst.move_count(best_a)),
                "feasible": feasible,
                "violations": sum(viol.values()),
                "anneal_s": round(t_solve - t0, 4),
                "batch_wall_s": round(wall, 4),
                "score_curve": _downsample(curve[:, i].max(0), 32),
            },
        ))
    return results


def _select_shards(insts, pa: np.ndarray) -> np.ndarray:
    """Each lane's plan from its shards' winners ``pa [C, Lp, P, R]``:
    the best under the solve's order (feasible, fewest violations, then
    weight, then fewest moves; the first shard among ties), by the numpy
    oracle; a padding lane keeps shard 0's. Returns ``[Lp, P, R]``."""
    if pa.shape[0] == 1:
        return pa[0]
    plans = pa[0].copy()
    for i, inst in enumerate(insts):
        best = None
        for c in range(pa.shape[0]):
            cand = arrays.unpad_candidate(pa[c, i], inst)
            pen = sum(inst.violations(cand).values())
            rank = (pen == 0, -pen, inst.preservation_weight(cand),
                    -inst.move_count(cand))
            if best is None or rank > best:
                best, plans[i] = rank, pa[c, i]
    return plans


def stack_lanes(insts, seeds, dev):
    """The lane ladder's inputs for same-broker, same-rack instances:
    every instance lowered at one common bucket (the largest lane's
    rungs) and stacked, the lanes padded up the lane ladder (a padding
    lane reruns lane 0's model and seed), each lane's greedy seed padded
    to the bucket, and each lane's key (``PRNGKey(seeds[i])``; padding
    lanes take keys derived from lane 0's, so no two lanes share a
    stream). Returns ``(m_stack, lane_seeds [Lp, P, R], keys [Lp, 2])``.
    """
    L = len(insts)
    bkt_parts = max(bucket.part_bucket(i.num_parts) for i in insts)
    bkt_rf = max(bucket.rf_bucket(i.max_rf) for i in insts)
    Lp = bucket.lane_bucket(L)
    models = []
    lane_seeds = np.empty((Lp, bkt_parts, bkt_rf), np.int32)
    for i, inst in enumerate(insts):
        bucket.STATS.record_bucket(
            (inst.num_brokers, inst.num_racks, bkt_parts, bkt_rf),
            padded=(bkt_parts, bkt_rf) != (inst.num_parts, inst.max_rf))
        m = arrays.from_instance(inst, dev, num_parts=bkt_parts,
                                 max_rf=bkt_rf)
        models.append(m)
        with _otrace.span("greedy", lane=i):
            a_seed = np.asarray(greedy_seed(inst), dtype=np.int32)
        assert (a_seed[inst.slot_valid] < inst.num_brokers).all(), (
            "seed left unfilled slots")
        lane_seeds[i] = arrays.pad_candidate(a_seed, m)
    for i in range(Lp - L):
        models.append(models[0])
        lane_seeds[L + i] = lane_seeds[0]
    keys = np.stack(
        [prng.PRNGKey(s) for s in seeds]
        + [prng.fold_in(prng.PRNGKey(seeds[0]), 1 + i)
           for i in range(Lp - L)])
    return arrays.stack_models(models), lane_seeds, keys


def _verify_lanes(insts, m_stack, plans) -> list[dict]:
    """The numpy oracle's violation counts of each real lane's plan,
    checked against the device scorer's (B1, one launch for every lane) —
    a disagreement means the device path is wrong, and raises."""
    a = torch.from_numpy(np.ascontiguousarray(plans)).to(m_stack.device)
    out = score_lanes(m_stack, a[:, None])[0][:, 0, :5].tolist()
    viols = []
    for i, inst in enumerate(insts):
        viol, oracle = _oracle(inst, arrays.unpad_candidate(plans[i], inst))
        viols.append(viol)
        if out[i] != oracle:
            raise RuntimeError(
                f"verification failed on lane {i}: the device scores "
                f"(weight, broker, leader, rack, diversity) {out[i]} "
                f"disagree with the numpy oracle {oracle}"
            )
    return viols


def _downsample(x: np.ndarray, n: int) -> list[int]:
    if x.size <= n:
        return [int(v) for v in x]
    idx = np.linspace(0, x.size - 1, n).round().astype(int)
    return [int(v) for v in x[idx]]
