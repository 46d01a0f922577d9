"""Hierarchical rack/AZ decomposition — the "decomposed" rung of the
bucket ladder (docs/DECOMPOSE.md).

A copy of ``kafka_assignment_optimizer_tpu.decompose``. Map-reduce over
the cluster's AZ structure: ``split`` extracts per-AZ sub-instances
whose feasibility nests under the flat instance (inherited global bands,
split.py); the **map** phase solves them as lanes of one lane ladder
(``engine.solve_tpu_batch``: every kernel one launch for every AZ); the
**reduce** phase stitches the local plans into one global candidate,
verifies it against the ORIGINAL flat instance's oracle, and proves a
global certificate or reports the bound gap. Map<->reduce iterates
(re-seeding unlucky lanes) up to ``KAO_DECOMPOSE_ITERS`` times.

Selection: ``engine.solve_tpu`` consults :func:`should_decompose` —
opt-in via the ``decompose`` keyword (CLI ``--decompose``) or
``KAO_DECOMPOSE=1``; automatic when the flat instance reaches
``KAO_DECOMPOSE_AUTO_PARTS`` partitions (default 150,000) or exceeds the
top rung of a custom ``KAO_BUCKETS`` ladder. ``KAO_DECOMPOSE=0``
disables it everywhere.

Degradation: a failed reduce — chaos point ``decompose_reduce``, a NaN
abort, or a stitched plan the oracle rejects after every iteration —
notes the ``decompose_to_flat`` rung and returns None, and the flat path
solves. Nothing else is caught: a kernel or device fault raises.

The reference's trace spans around each phase are left out (this
package has no solve tracer yet).
"""

from __future__ import annotations

import os
import time

from ..obs import log as _olog
from ..resilience import chaos as _chaos
from ..resilience import ladder as _ladder
from ..solvers.base import SolveResult
from .split import Split, split as split_instance
from .stats import COUNTER_NAMES, STATS
from .stitch import stitch

_AUTO_PARTS_DEFAULT = 150_000
_ITERS_DEFAULT = 2


def mode() -> str:
    """``KAO_DECOMPOSE`` -> 'off' | 'on' | 'auto' (unset = auto)."""
    v = os.environ.get("KAO_DECOMPOSE", "").strip().lower()
    if v in ("0", "off", "false", "no"):
        return "off"
    if v in ("1", "on", "true", "yes", "force"):
        return "on"
    return "auto"


def auto_parts() -> int:
    try:
        return int(os.environ.get("KAO_DECOMPOSE_AUTO_PARTS",
                                  _AUTO_PARTS_DEFAULT))
    except ValueError:
        return _AUTO_PARTS_DEFAULT


def max_iters() -> int:
    try:
        return max(1, int(os.environ.get("KAO_DECOMPOSE_ITERS",
                                         _ITERS_DEFAULT)))
    except ValueError:
        return _ITERS_DEFAULT


def _above_custom_ladder(num_parts: int) -> bool:
    """True when a bounded custom ``KAO_BUCKETS`` ladder is active and
    the instance exceeds its top rung — past the flat ladder's reach,
    where the decomposed rung takes over."""
    raw = os.environ.get("KAO_BUCKETS", "").strip().lower()
    if not raw or raw in ("on", "1", "true", "off", "0", "none",
                          "false"):
        return False  # default ladder is unbounded; bucketing off
    from ..solvers.tpu import bucket

    rungs = bucket.ladder(64)
    return bool(rungs) and int(num_parts) > max(rungs)


def should_decompose(inst, requested: bool | None = None) -> bool:
    """The selection rule: explicit keyword wins, then ``KAO_DECOMPOSE``,
    then the auto trigger (instance past the flat ladder's reach)."""
    if requested is not None:
        return bool(requested)
    m = mode()
    if m == "off":
        return False
    if m == "on":
        return True
    p = inst.num_parts
    return p >= auto_parts() or _above_custom_ladder(p)


def split_of(inst) -> Split | None:
    """``split(inst)``, computed once an instance: the split is a
    function of the instance, and its sub-instances carry what their
    solves memoize (the greedy seeds), so a second decomposed solve of
    the instance neither re-splits nor re-seeds."""
    memo = inst.__dict__.get("_decompose_split")
    if memo is None:
        memo = inst.__dict__["_decompose_split"] = (split_instance(inst),)
    return memo[0]


def maybe_decompose(
    inst, *, seed: int = 0, engine: str | None = None,
    time_limit_s: float | None = None, budget=None,
    portfolio: bool | None = None, n_devices: int | None = None,
    rounds: int | None = None, t_hi: float | None = None,
    t_lo: float | None = None, device=None,
) -> SolveResult | None:
    """Run the decomposed solve on ``device``. Returns the stitched
    SolveResult, or None when the instance is undecomposable or the
    reduce failed — the caller (``engine.solve_tpu``) then continues
    down the flat path (``decompose_to_flat`` has been noted on
    failure)."""
    t0 = time.perf_counter()
    sp = split_of(inst)
    if sp is None:
        STATS.note_unsplittable()
        _olog.info("decompose_unsplittable", parts=inst.num_parts,
                   racks=inst.num_racks)
        return None
    try:
        return _map_reduce(
            inst, sp, t0, seed=seed, engine=engine,
            time_limit_s=time_limit_s, budget=budget,
            portfolio=portfolio, n_devices=n_devices, rounds=rounds,
            t_hi=t_hi, t_lo=t_lo, device=device,
        )
    except (_chaos.ChaosFault, FloatingPointError) as e:
        STATS.note_fallback(subproblems=sp.n_groups)
        _ladder.note_rung(
            "decompose_to_flat", error=repr(e)[:120],
            subproblems=sp.n_groups,
        )
        _olog.warn("decompose_fallback", error=repr(e)[:200],
                   subproblems=sp.n_groups)
        return None


def _map_reduce(inst, sp: Split, t0: float, *, seed, engine,
                time_limit_s, budget, portfolio, n_devices, rounds,
                t_hi, t_lo, device=None) -> SolveResult | None:
    from ..solvers.tpu.engine import solve_tpu_batch

    G = sp.n_groups
    best = [None] * G  # per-lane best SolveResult across iterations
    todo = list(range(G))
    iters = 0
    a = None
    proved, gap = False, None
    # host-clock phase times (seconds): each map iteration, each
    # reduce (stitch + the flat oracle), the certificate
    times: dict = {"map": [], "reduce": [], "certify": 0.0}
    for it in range(1, max_iters() + 1):
        iters = it
        rem = budget.remaining() if budget is not None else None
        lane_limit = rem if rem is not None else time_limit_s
        tm = time.perf_counter()
        kw: dict = {
            "seeds": [seed + g + 1000 * (it - 1) for g in todo],
            "engine": engine,
            "device": device,
        }
        if lane_limit is not None:
            kw["time_limit_s"] = lane_limit
        if portfolio is not None:
            kw["portfolio"] = portfolio
        if n_devices is not None:
            kw["n_devices"] = n_devices
        if rounds is not None:
            kw["rounds"] = rounds
        if t_hi is not None:
            kw["t_hi"] = t_hi
        if t_lo is not None:
            kw["t_lo"] = t_lo
        lane_res = solve_tpu_batch([sp.subs[g] for g in todo], **kw)
        tr = time.perf_counter()
        times["map"].append(round(tr - tm, 4))
        for g, r in zip(todo, lane_res):
            if best[g] is None or _rank(r) > _rank(best[g]):
                best[g] = r
        _chaos.raise_if("decompose_reduce")
        a = stitch(inst, sp, [b.a for b in best])
        nviol = int(sum(inst.violations(a).values()))
        tc = time.perf_counter()
        times["reduce"].append(round(tc - tr, 4))
        if nviol == 0:
            rem = budget.remaining() if budget is not None else None
            if rem is not None:
                inst.set_bounds_deadline(max(0.1, min(rem, 10.0)))
            proved = bool(inst.certify_optimal(a, allow_tight=False))
            if proved:
                gap = 0
            else:
                ub = int(inst.weight_upper_bound(level=0))
                gap = max(0, ub - int(inst.preservation_weight(a)))
            times["certify"] = round(
                times["certify"] + time.perf_counter() - tc, 4)
        STATS.note_attempt(iteration=it, times=times, stitch_violations=nviol,
                           lane_violations=[int(b.stats["violations"])
                                            for b in best])
        if nviol == 0:
            if proved or gap == 0:
                break
            if it >= max_iters() or (budget is not None
                                     and budget.expired()):
                break  # report the gap — the contract's other half
            todo = list(range(G))  # re-seed every lane to chase the gap
        else:
            if it >= max_iters() or (budget is not None
                                     and budget.expired()):
                STATS.note_fallback(iterations=iters, subproblems=G)
                _ladder.note_rung(
                    "decompose_to_flat", reason="stitch_infeasible",
                    violations=nviol, subproblems=G,
                )
                _olog.warn("decompose_stitch_infeasible",
                           violations=nviol, iterations=iters)
                return None
            todo = [g for g in range(G)
                    if not best[g].stats.get("feasible")] or list(range(G))

    if a is None or int(sum(inst.violations(a).values())) != 0:
        STATS.note_fallback(iterations=iters, subproblems=G)
        _ladder.note_rung("decompose_to_flat",
                          reason="stitch_infeasible", subproblems=G)
        return None

    first = best[0].stats if best[0] is not None else {}
    sub_shape = {
        "brokers": int(sp.subs[0].num_brokers),
        "racks": int(sp.subs[0].num_racks),
        "parts": int(max(s.num_parts for s in sp.subs)),
        "bucket_parts": first.get("bucket_parts"),
        "bucket_rf": first.get("bucket_rf"),
        "lane_bucket": first.get("lane_bucket"),
    }
    STATS.note_solve(subproblems=G, iterations=iters, certified=proved,
                     bound_gap=gap, sub_shape=sub_shape)
    w = int(inst.preservation_weight(a))
    moves = int(inst.move_count(a))
    stats = {
        "engine": "decomposed",
        "map_engine": first.get("engine"),
        "feasible": True,
        "violations": 0,
        "moves": moves,
        "seed_moves": moves,
        "proved_optimal": proved,
        "timed_out": any(b is not None and b.stats.get("timed_out")
                         for b in best),
        "early_stopped": False,
        "constructed": False,
        "warm_started": False,
        "resumed_from_checkpoint": False,
        "rounds_run": int(sum(int(b.stats.get("rounds_run") or 0)
                              for b in best if b is not None)),
        "time_limit_s": time_limit_s,
        "bucket_parts": first.get("bucket_parts"),
        "bucket_rf": first.get("bucket_rf"),
        "decompose": {
            "subproblems": G,
            "groups": list(sp.group_names),
            "iterations": iters,
            "boundary_parts": int(sp.boundary.sum()),
            "moved_for_slack": int(sp.moved_for_slack),
            "certified": proved,
            "bound_gap": int(gap or 0),
            "uniform_shape": bool(sp.uniform_shape),
            "lane_fallback": bool(first.get("lane_fallback")),
            "sub_shape": sub_shape,
        },
    }
    return SolveResult(
        a=a, solver="tpu",
        wall_clock_s=time.perf_counter() - t0,
        objective=w, optimal=proved, stats=stats,
    )


def _rank(r) -> tuple:
    """Lane ordering for keep-best across iterations."""
    if r is None:
        return (-1, -1)
    return (1 if r.stats.get("feasible") else 0,
            int(r.objective if r.objective is not None else -1))


def config_snapshot() -> dict:
    """The decompose configuration, counters and last solve, and whether
    the last sub-bucket's lane shape has been served in this process
    (``parallel.mesh.lane_serve_report``; the CUDA kernels compile no
    executable per shape, so "warm" means served before)."""
    from ..parallel.mesh import lane_serve_report
    from ..solvers.tpu import bucket

    snap = STATS.snapshot()
    last = snap["last"]
    sub = (last.get("sub_shape") or {})
    warm = False
    if sub.get("brokers") is not None:
        want = "x".join(str(sub.get(k)) for k in (
            "brokers", "racks", "bucket_parts", "bucket_rf"))
        warm = want in lane_serve_report()
    return {
        "mode": mode(),
        "auto_parts": auto_parts(),
        "max_iters": max_iters(),
        "sub_bucket_ladder": bucket.ladder(8),
        "lane_ladder": bucket.lane_ladder(),
        "map_lane_warm": warm,
        "counters": snap["counters"],
        "last": last,
    }


__all__ = [
    "COUNTER_NAMES", "STATS", "Split", "config_snapshot",
    "maybe_decompose", "max_iters", "mode", "should_decompose",
    "split_instance", "split_of", "stitch",
]
