"""Exact 0-1 ILP oracle via scipy/HiGHS (native C++ solver, in-process).

Formulates the same binary model the reference feeds to lp_solve
(the upstream ``README.md:106-185``): one replica variable and one
leader variable per (partition, broker) — the dense cross-product of
``README.md:182-184`` — with the seven constraint families of
``README.md:148-180`` and the move-minimizing objective of
``README.md:116-133``. Serves as the exactness oracle the device engine is
tested against (cross-solver parity).

Variable layout (flat index over ``2*P*B`` binaries):
``x[p, b] -> p*B + b`` (follower role), ``y[p, b] -> P*B + p*B + b``
(leader role).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, milp

from ..models.instance import ProblemInstance
from .base import SolveResult, register


def build_milp(inst: ProblemInstance):
    """Return (c, constraints, integrality) for scipy.optimize.milp.

    Exposed separately so tests can count rows against the reference
    sample's structure (``README.md:144-185``).
    """
    P, B, K = inst.num_parts, inst.num_brokers, inst.num_racks
    n = 2 * P * B

    def xi(p, b):
        return p * B + b

    def yi(p, b):
        return P * B + p * B + b

    # objective: maximize preservation weight -> minimize negated weights
    c = np.zeros(n)
    c[: P * B] = -inst.w_follower[:, :B].ravel()
    c[P * B :] = -inst.w_leader[:, :B].ravel()

    rows: list[sp.csr_matrix] = []
    lbs: list[np.ndarray] = []
    ubs: list[np.ndarray] = []

    def add(mat: sp.spmatrix, lo, hi):
        rows.append(sp.csr_matrix(mat))
        lbs.append(np.atleast_1d(np.asarray(lo, dtype=float)))
        ubs.append(np.atleast_1d(np.asarray(hi, dtype=float)))

    eye_p = sp.eye(P, format="csr")
    ones_b = np.ones((1, B))
    # per-partition sums over brokers: kron(I_P, 1_B)
    sum_b = sp.kron(eye_p, ones_b, format="csr")  # [P, P*B]
    zero = sp.csr_matrix((P, P * B))

    # C4 replication factor: sum_b (x + y) == rf[p]       (README.md:148-151)
    add(sp.hstack([sum_b, sum_b]), inst.rf, inst.rf)
    # C5 one leader: sum_b y == 1                          (README.md:153-156)
    add(sp.hstack([zero, sum_b]), np.ones(P), np.ones(P))
    # C6 broker band: sum_p (x + y) in [lo, hi]            (README.md:158-161)
    sum_p = sp.kron(np.ones((1, P)), sp.eye(B), format="csr")  # [B, P*B]
    add(
        sp.hstack([sum_p, sum_p]),
        np.full(B, inst.broker_lo),
        np.full(B, inst.broker_hi),
    )
    # C7 leader band: sum_p y in [lo, hi]                  (README.md:163-166)
    add(
        sp.hstack([sp.csr_matrix((B, P * B)), sum_p]),
        np.full(B, inst.leader_lo),
        np.full(B, inst.leader_hi),
    )
    # C8 uniqueness: x + y <= 1 per (p, b)                 (README.md:168-171)
    eye_n = sp.eye(P * B, format="csr")
    add(sp.hstack([eye_n, eye_n]), np.zeros(P * B), np.ones(P * B))
    # C9 rack band: sum over rack members x+y in band      (README.md:173-176)
    rack_sel = sp.csr_matrix(
        (np.ones(B), (inst.rack_of_broker[:B], np.arange(B))), shape=(K, B)
    )  # [K, B]
    rack_p = sp.kron(np.ones((1, P)), rack_sel, format="csr")  # [K, P*B]
    add(sp.hstack([rack_p, rack_p]), inst.rack_lo, inst.rack_hi)
    # C10 partition-rack diversity: per (p, k) <= ceil(rf/K)  (README.md:178-180)
    pr = sp.kron(eye_p, rack_sel, format="csr")  # [P*K, P*B]
    hi_pk = np.repeat(inst.part_rack_hi.astype(float), K)
    add(sp.hstack([pr, pr]), np.zeros(P * K), hi_pk)

    A = sp.vstack(rows, format="csr")
    lo = np.concatenate(lbs)
    hi = np.concatenate(ubs)
    return c, LinearConstraint(A, lo, hi), np.ones(n, dtype=np.int64)


@register("milp")
def solve_milp(
    inst: ProblemInstance,
    time_limit_s: float | None = None,
    mip_rel_gap: float = 0.0,
    **_unused,
) -> SolveResult:
    import time

    t0 = time.perf_counter()
    P, B = inst.num_parts, inst.num_brokers
    c, constraint, integrality = build_milp(inst)
    options: dict = {"mip_rel_gap": mip_rel_gap}
    if time_limit_s is not None:
        options["time_limit"] = float(time_limit_s)
    res = milp(
        c,
        constraints=constraint,
        integrality=integrality,
        bounds=Bounds(0, 1),
        options=options,
    )
    if res.x is None:
        raise RuntimeError(f"MILP solve failed: {res.message}")
    x = np.round(res.x[: P * B]).astype(np.int64).reshape(P, B)
    y = np.round(res.x[P * B :]).astype(np.int64).reshape(P, B)

    R = inst.max_rf
    a = np.full((P, R), B, dtype=np.int32)
    for p in range(P):
        leaders = np.flatnonzero(y[p])
        followers = np.flatnonzero(x[p])
        if len(leaders) != 1:
            raise RuntimeError(f"partition {p}: {len(leaders)} leaders in solution")
        reps = [int(leaders[0])] + [int(b) for b in followers]
        if len(reps) != int(inst.rf[p]):
            raise RuntimeError(
                f"partition {p}: RF {len(reps)} != target {int(inst.rf[p])}"
            )
        a[p, : len(reps)] = reps
    wall = time.perf_counter() - t0
    return SolveResult(
        a=a,
        solver="milp",
        wall_clock_s=wall,
        objective=int(-res.fun) if res.fun is not None else None,
        optimal=bool(res.status == 0 and mip_rel_gap == 0.0),
        stats={"status": int(res.status), "message": str(res.message)},
    )
