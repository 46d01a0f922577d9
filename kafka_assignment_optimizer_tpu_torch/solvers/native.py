"""``--solver=native`` — bundled C++ exact branch-and-bound backend.

Plays the role lp_solve plays for the reference — the native exact solver
behind the model (the upstream ``README.md:135-137``) — but in-process,
specialized to the replica-slot representation, and built from source in
this repo (``native/bb.cpp``). Exactness is cross-checked against the
HiGHS MILP oracle in tests/test_native.py.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np

from ..models.instance import ProblemInstance
from ..native import load
from .base import SolveResult, register

_STATUS = {0: "optimal", 1: "time_limit", 2: "time_limit_no_solution",
           3: "infeasible"}


@register("native")
def solve_native(
    inst: ProblemInstance, time_limit_s: float = 60.0, **_unused
) -> SolveResult:
    lib = load()
    t0 = time.perf_counter()
    P, B, K, R = inst.num_parts, inst.num_brokers, inst.num_racks, inst.max_rf

    def arr(x, dtype=np.int32):
        return np.ascontiguousarray(x, dtype=dtype)

    rf = arr(inst.rf)
    rack_of = arr(inst.rack_of_broker[:B])
    wl = arr(inst.w_leader)
    wf = arr(inst.w_follower)
    rack_lo = arr(inst.rack_lo)
    rack_hi = arr(inst.rack_hi)
    prh = arr(inst.part_rack_hi)
    # warm start: the greedy repair seed, when feasible, as first incumbent
    # (without one the B&B is a pure feasibility CSP until its first leaf)
    from .tpu.seed import greedy_seed

    seed_a = arr(greedy_seed(inst))
    has_seed = int(inst.is_feasible(seed_a))
    seed_w = int(inst.preservation_weight(seed_a)) if has_seed else 0
    out_a = np.full((P, R), B, dtype=np.int32)
    out_obj = np.zeros(1, dtype=np.int64)
    out_nodes = np.zeros(1, dtype=np.int64)

    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)

    def p32(a):
        return a.ctypes.data_as(i32p)

    status = lib.kao_solve(
        P, B, K, R,
        p32(rf), p32(rack_of), p32(wl), p32(wf),
        inst.broker_lo, inst.broker_hi, inst.leader_lo, inst.leader_hi,
        p32(rack_lo), p32(rack_hi), p32(prh),
        p32(seed_a), seed_w, has_seed,
        float(time_limit_s),
        p32(out_a),
        out_obj.ctypes.data_as(i64p),
        out_nodes.ctypes.data_as(i64p),
    )
    wall = time.perf_counter() - t0
    if status in (2, 3):
        raise RuntimeError(
            f"native solver found no solution ({_STATUS[status]}, "
            f"{int(out_nodes[0])} nodes, {wall:.2f}s)"
        )
    return SolveResult(
        a=out_a,
        solver="native",
        wall_clock_s=wall,
        objective=int(out_obj[0]),
        optimal=status == 0,
        stats={"status": _STATUS[status], "nodes": int(out_nodes[0])},
    )
