"""Bound ladder + flow/LP machinery for :class:`ProblemInstance`.

Kept apart from ``models.instance``: the data
model keeps thin delegating methods with an unchanged public surface —
callers (and tests that monkeypatch ``ProblemInstance`` attributes)
see no difference — while the certificate machinery lives here:

- the weight upper-bound ladder (levels 0-2: kept-replica max-flow,
  leader-cap LP/flow tiers, the symmetry-aggregated LP/MILP) feeding
  ``certify_optimal`` (docs/OPTIMALITY.md has the soundness argument);
- the exact move lower bound (``move_lower_bound_exact``);
- the partition-symmetry aggregation (``_member_classes``) that keeps
  every tier tractable at 50k partitions.

Every function takes the instance as its first argument and stores its
memos on the instance (under ``inst._memo_lock()``), exactly as the
methods did; cross-calls go through ``inst.<method>`` so class-level
monkeypatching keeps intercepting them.
"""

from __future__ import annotations

import logging

import numpy as np

from . import instance as _inst_mod

_log = logging.getLogger(__name__)

def _safe_floor_ub(neg_fun: float) -> int:
    """Floor an LP maximum into a still-valid integer upper bound.

    The slack must dominate the solver's possible objective undershoot
    (termination tolerances are RELATIVE, so a fixed absolute epsilon
    fails at large objective scales); 1e-6 relative can at worst loosen
    a razor-edge bound by 1, never tighten it below the true optimum."""
    v = -neg_fun
    return int(np.floor(v + 1e-6 * max(1.0, abs(v))))


def _dual_repair_max_ub(c, a_ub, b_ub, a_eq, b_eq, lo, hi, res):
    """Certified upper bound on ``max -c'x`` from an (approximate) LP
    solve, via dual-feasibility repair — sound even when the primal
    iterate undershoots the true optimum (e.g. ``highs-ipm`` without
    crossover, whose termination tolerance is all that protects the
    primal value).

    Takes the solver's constraint marginals as a *starting point* for
    the dual (lam = -ineq marginals clamped >= 0, mu = -eq marginals),
    then restores exact dual stationarity by absorbing the residual
    ``r = c + A_ub' lam + A_eq' mu`` into the variable-bound duals
    (alpha = max(r, 0) on x >= lo, beta = max(-r, 0) on x <= hi). Any
    such (lam, mu, alpha, beta) is dual feasible, so by weak duality

        min c'x  >=  -lam'b_ub - mu'b_eq + alpha'lo - beta'hi

    and ``max -c'x <= -that``. Returns the float bound, or None when
    the solve carried no marginals (then the caller falls back to the
    primal value, which is exact for simplex/crossover methods)."""
    try:
        m_ub = getattr(res.ineqlin, "marginals", None)
        m_eq = getattr(res.eqlin, "marginals", None)
        if m_ub is None or m_eq is None:
            return None
        lam = np.maximum(-np.asarray(m_ub, dtype=np.float64), 0.0)
        mu = -np.asarray(m_eq, dtype=np.float64)
        r = np.asarray(c, dtype=np.float64)
        if lam.size:
            r = r + a_ub.T @ lam
        if mu.size:
            r = r + a_eq.T @ mu
        alpha = np.maximum(r, 0.0)
        beta = np.maximum(-r, 0.0)
        dual = (
            -(lam @ b_ub if lam.size else 0.0)
            - (mu @ b_eq if mu.size else 0.0)
            + alpha @ lo
            - beta @ hi
        )
        return float(-dual)
    except Exception:
        return None


def _leader_vals(inst):
    """Per-(partition, candidate-leader) optimum of the preservation
    weight, vectorized on a padded sparse member view. Returns
    ``(val [P, M], s_rm1 [P], ids [P, M])`` — ``val[p, m]`` is the
    best weight of partition p when member ``ids[p, m]`` leads (its
    leader weight plus the best rf-1 positive follower weights among
    the rest), ``s_rm1`` the best weight under a non-member (zero
    weight) leader, padding columns carry ids of -1 and val ==
    s_rm1. None when no weights exist at all."""
    P, B = inst.num_parts, inst.num_brokers
    if P == 0:
        return None
    wl_full = inst.w_leader[:, :B]
    wf_full = inst.w_follower[:, :B]
    # weights are sparse (only current members carry any): gather the
    # nonzero (partition, broker) pairs into a padded [P, M] view so
    # the per-leader formula runs on M ~ rf columns, not B
    rows, cols = np.nonzero((wl_full > 0) | (wf_full > 0))
    if rows.size == 0:
        return None
    cnt = np.bincount(rows, minlength=P)
    M = int(cnt.max())
    offs = np.zeros(P + 1, np.int64)
    np.cumsum(cnt, out=offs[1:])
    pos = np.arange(rows.size) - offs[rows]  # rank within its row
    wl = np.zeros((P, M), np.int64)
    wf = np.zeros((P, M), np.int64)
    ids = np.full((P, M), -1, np.int64)
    wl[rows, pos] = wl_full[rows, cols]
    wf[rows, pos] = np.maximum(wf_full[rows, cols], 0)
    ids[rows, pos] = cols
    rf = inst.rf.astype(np.int64)
    k = M
    top = -np.sort(-wf, axis=1)  # [P, M] desc
    csum = np.concatenate(
        [np.zeros((P, 1), np.int64), np.cumsum(top, axis=1)], axis=1
    )
    prow = np.arange(P)
    s_rm1 = csum[prow, np.minimum(rf - 1, k)]  # sum of top rf-1
    # with v_1 >= v_2 >= ... the clipped-positive follower weights and
    # s_k their prefix sums, leader m scores wl[m] + (s_{rf-1} - v(m)
    # + v_rf if v(m) >= v_{rf-1} else s_{rf-1}) — removing one
    # instance of m's follower value from the top set and backfilling
    # with the next-best; only values matter, so ties need no
    # identity tracking. v_edge = v_{rf-1} (the weakest kept
    # follower), v_next = v_rf (the backfill).
    v_edge = top[prow, np.clip(rf - 2, 0, k - 1)]
    v_next = np.where(
        rf - 1 < k, top[prow, np.clip(rf - 1, 0, k - 1)], 0
    )
    in_top = (wf >= v_edge[:, None]) & (rf[:, None] >= 2)
    foll_sum = np.where(
        in_top,
        s_rm1[:, None] - wf + v_next[:, None],
        s_rm1[:, None],
    )
    return wl + foll_sum, s_rm1, ids


def weight_upper_bound(inst, tight: bool = False, level: int = 0
                       ) -> int:
    """A constraint-aware upper bound on any feasible plan's
    preservation weight — ``max_weight`` tightened by the balance
    constraints that couple partitions through the objective.

    Leveled by cost, each level memoized, callers escalate only
    when the cheaper level fails to certify:

    - level 0 (``tight=False``, cheap): ``max_weight`` refined by
      the leader-cap transportation LP — leadership gains under the
      per-broker ``leader_hi`` cap (integral polytope, HiGHS via
      scipy, ~1 s at 10k partitions). Tight whenever lower bands
      and follower caps don't bind (demo, decommission, rf_change).
    - level 1: the same LP with per-broker zero-gain-lead slacks,
      the leader band's LOWER side, and the total-leads equality —
      needed when under-leading brokers are FORCED to take
      leaderships (leader-skew rebalances).
    - level 2 (``tight=True``): the joint kept-replica LP
      (``_kept_weight_lp``), which also bands follower keeps and
      forced new replicas per broker/rack — needed when brokers are
      over-full (scale-out). Seconds at 10k partitions, so only on
      explicit request (the engine runs it on a worker thread).
      Past ~60k members the unaggregated LP is intractable (the
      50k-partition jumbo times it out at 900 s) and the tier
      switches to the SYMMETRY-AGGREGATED formulation
      (``_kept_weight_agg``) — the exact same LP optimum at
      ~#classes/#partitions of the cost.
    - level 3: the aggregated kept-replica MILP's branch-and-bound
      dual bound (``_kept_weight_agg(integer=True)``) — integer
      aggregation is a valid relaxation of the true MILP, so this
      can only tighten level 2; time-limited, any size with few
      classes.

    ``certify_optimal`` escalates 0 -> 1 -> 2 -> 3.

    Thread-safe: the tier ladder runs under a per-instance lock
    (the engine prefetches bounds on worker threads while the main
    thread certifies — without the lock both would solve the same
    multi-second LPs). A caller that no longer needs tighter tiers
    (a finished solve with straggling workers) sets
    ``_bounds_cancelled``; not-yet-memoized tiers are then skipped
    WITHOUT memoizing, so the cancellation can never poison a later
    legitimate escalation."""
    level = 2 if tight else level
    with inst._memo_lock():
        memo = getattr(inst, "_wub_memo", None)
        if memo is None:
            memo = {}
            inst._wub_memo = memo
        if 0 not in memo:
            lead = inst._leader_cap_lp(with_lower=False)
            mw = inst.max_weight()
            memo[0] = mw if lead is None else min(mw, lead)
        # LP cost grows superlinearly in member count; past the
        # aggregation threshold the level-1 LP sticks with the
        # cheaper bound and level 2 switches to the aggregated
        # formulation (exact; see _kept_weight_agg). Level 2 also
        # prefers the aggregated LP whenever symmetry is effective
        # (generated and steady-state round-robin clusters): same
        # bound or tighter, at a fraction of the unaggregated cost.
        big = (
            level >= 1
            and inst._members()[0].size > _inst_mod.AGG_MEMBER_THRESHOLD
        )
        if level >= 1 and 1 not in memo:
            if getattr(inst, "_bounds_cancelled", False):
                return memo[0]
            # past the threshold the scipy LP is off the table, but
            # the flow fast path stays cheap at any size — so
            # big instances attempt level 1 flow-only instead of
            # skipping the tier outright
            lead = inst._leader_cap_lp(with_lower=True,
                                       flow_only=big)
            memo[1] = memo[0] if lead is None else min(memo[0], lead)
        if level >= 2 and 2 not in memo:
            if getattr(inst, "_bounds_cancelled", False):
                return memo[1]
            kept = (
                inst._kept_weight_agg()
                if big or inst.agg_effective() else None
            )
            if kept is None and not big:
                # aggregation unavailable or refused (solver
                # failure, deadline): the unaggregated LP is still
                # tractable here — don't silently degrade the
                # certificate to the level-1 bound
                kept = inst._kept_weight_lp()
            memo[2] = memo[1] if kept is None else min(memo[1], kept)
        if level >= 3 and 3 not in memo:
            if getattr(inst, "_bounds_cancelled", False):
                return memo[2]
            kept = inst._kept_weight_agg(integer=True)
            memo[3] = memo[2] if kept is None else min(memo[2], kept)
        return memo[level]


def move_lower_bound_exact(inst) -> int:
    """Max-flow sharpening of ``move_lower_bound``: moves >=
    total_replicas - maxflow, where the flow network models the kept
    caps JOINTLY (the counting bound takes their min):

        source -(rf_p)-> partition -(part_rack_hi_p)-> (p, rack)
               -(1 per member)-> broker -(broker_hi)-> rack
               -(rack_hi_k)-> sink

    Max integral flow == the most slots ANY feasible plan can keep.
    Never weaker than ``move_lower_bound``; memoized; milliseconds
    even at 50k partitions (scipy's C Dinic)."""
    cached = getattr(inst, "_move_lb_memo", None)
    if cached is None:
        kept = inst._kept_maxflow()
        cheap = inst.move_lower_bound()
        cached = cheap if kept is None else max(
            cheap, inst.total_replicas - kept
        )
        inst._move_lb_memo = cached
    return cached


def _kept_maxflow(inst) -> int | None:
    """Max number of kept slots over all feasible plans (see
    ``move_lower_bound_exact``)."""
    try:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import maximum_flow
    except Exception:
        return None
    mrows, mcols = inst._members()
    n = mrows.size
    if n == 0:
        return 0
    try:
        B, K, P = inst.num_brokers, inst.num_racks, inst.num_parts
        rack = inst.rack_of_broker[mcols].astype(np.int64)
        pair_key = mrows.astype(np.int64) * K + rack
        pairs, pair_idx = np.unique(pair_key, return_inverse=True)
        U = pairs.size
        # node ids: 0 source | 1..P parts | pairs | brokers | racks | sink
        o_part, o_pair = 1, 1 + P
        o_brok, o_rack = 1 + P + U, 1 + P + U + B
        t = o_rack + K
        live = np.flatnonzero(inst.rf > 0)
        src = np.concatenate([
            np.zeros(live.size, np.int64),       # s -> p
            o_part + pairs // K,                 # p -> (p,k)
            o_pair + pair_idx,                   # (p,k) -> b
            np.full(B, 0) + o_brok + np.arange(B),  # b -> rack
            o_rack + np.arange(K),               # rack -> t
        ])
        dst = np.concatenate([
            o_part + live,
            o_pair + np.arange(U),
            o_brok + mcols,
            o_rack + inst.rack_of_broker[:B].astype(np.int64),
            np.full(K, t),
        ])
        cap = np.concatenate([
            inst.rf[live].astype(np.int64),
            inst.part_rack_hi[(pairs // K)].astype(np.int64),
            np.ones(n, np.int64),
            np.full(B, int(inst.broker_hi), np.int64),
            inst.rack_hi.astype(np.int64),
        ])
        g = sp.csr_matrix(
            (cap.astype(np.int32), (src, dst)), shape=(t + 1, t + 1)
        )
        return int(maximum_flow(g, 0, t).flow_value)
    except Exception:
        return None


def _flow_prologue(inst, gain, rows, cols, ids):
    """Shared guards + arc extraction for the leader-bound flow
    fast paths. Returns ``(mcmf, g_int, b_of, nP, pidx)`` or None
    when the native kernel is unavailable, the bounds deadline is
    spent, or the gains are non-integral — callers fall back to
    the scipy LP in every case."""
    try:
        from ..native import mcmf
    except Exception:
        return None
    if inst._lp_options() is None:  # bounds deadline already spent
        return None
    g = gain[rows, cols]
    g_int = np.asarray(g, np.int64)
    if not np.array_equal(g_int, g):
        return None
    b_of = ids[rows, cols].astype(np.int64)
    up, pidx = np.unique(rows, return_inverse=True)
    return mcmf, g_int, b_of, up.size, pidx


def _leader_cap_flow(inst, gain, rows, cols, ids, base) -> int | None:
    """Exact cap-only leader bound on the native min-cost-flow
    kernel (the fast path of ``_leader_cap_lp``): the transportation
    polytope is integral, so integer flows reach the identical LP
    optimum. Returns None (caller falls back to the LP) when the
    shared prologue declines."""
    pro = inst._flow_prologue(gain, rows, cols, ids)
    if pro is None:
        return None
    mcmf, g_int, b_of, nP, pidx = pro
    ub, bidx = np.unique(b_of, return_inverse=True)
    nB, n = ub.size, rows.size
    o_b = 1 + nP
    t = o_b + nB
    src = np.concatenate([
        np.zeros(nP, np.int64),      # s -> p
        1 + pidx,                    # p -> broker (gain arcs)
        1 + np.arange(nP),           # p -> t (zero-cost disposal)
        o_b + np.arange(nB),         # broker -> t
    ])
    dst = np.concatenate([
        1 + np.arange(nP),
        o_b + bidx,
        np.full(nP, t, np.int64),
        np.full(nB, t, np.int64),
    ])
    cap = np.concatenate([
        np.ones(nP, np.int64),
        np.ones(n, np.int64),
        np.ones(nP, np.int64),
        np.full(nB, int(inst.leader_hi), np.int64),
    ])
    cost = np.concatenate([
        np.zeros(nP, np.int64),
        -g_int,
        np.zeros(nP, np.int64),
        np.zeros(nB, np.int64),
    ])
    try:
        _f, c, _af = mcmf(src, dst, cap, cost, 0, t, t + 1)
    except Exception:
        return None
    return base + int(-c)


def _leader_cap_flow_lower(inst, gain, rows, cols, ids, base,
                           p_active) -> int | None:
    """Exact LEVEL-1 leader bound on the native min-cost-flow
    kernel (the fast path of ``_leader_cap_lp(with_lower=True)``).
    The slack formulation is still a network: the per-broker
    zero-gain lead slack y_b is a POOL node any partition (or the
    source directly, for partitions with no gainful arc) can dump
    into and that feeds every broker at cost 0; the leader band's
    lower side becomes a rewarded broker->sink arc of capacity
    ``leader_lo`` at cost -BIG (BIG > total possible gain, so
    floors fill with absolute priority), the upper side the
    residual ``leader_hi - leader_lo`` at cost 0; the total-leads
    equality is the forced max flow of exactly ``p_active``. The
    polytope is integral, so the integer flow optimum IS the LP
    optimum — with none of the IPM-undershoot dual-repair the LP
    path needs. Returns None (caller falls back to the LP) when
    the shared prologue declines, the flow comes up short of
    ``p_active``, or any floor arc goes unsaturated
    (band-infeasible: the LP verdict decides)."""
    pro = inst._flow_prologue(gain, rows, cols, ids)
    if pro is None:
        return None
    mcmf, g_int, b_of, nP, pidx = pro
    B = inst.num_brokers
    lo_b = int(inst.leader_lo)
    hi_b = int(inst.leader_hi)
    big = int(g_int.sum()) + 1
    if big > np.iinfo(np.int32).max:
        # the floor-priority cost -BIG would overflow the kernel's
        # int32 arc costs; the wrapper would raise, the except
        # below would swallow it, and past the flow_only threshold
        # the level-1 tier would SILENTLY degrade to the weaker
        # level-0 bound. Decline loudly instead: count
        # it on the instance and log, so a tightness loss at scale
        # is visible in telemetry rather than inferred from bounds.
        inst._flow_big_declines = getattr(
            inst, "_flow_big_declines", 0
        ) + 1
        _log.debug(
            "leader-cap flow bound declined: BIG=%d exceeds int32 "
            "arc-cost range (falling back to the LP tier)", big,
        )
        return None
    n = rows.size
    o_pool = 1 + nP
    o_b = o_pool + 1
    t = o_b + B
    rest = int(p_active) - nP  # partitions with no gainful arc
    if rest < 0:
        return None  # inconsistent inputs; let the LP decide
    src = np.concatenate([
        np.zeros(nP, np.int64),          # s -> p
        1 + pidx,                        # p -> broker (gain arcs)
        1 + np.arange(nP),               # p -> pool (zero-gain)
        np.zeros(1, np.int64),           # s -> pool (gainless parts)
        np.full(B, o_pool, np.int64),    # pool -> broker
        o_b + np.arange(B),              # broker -> t (floor, -BIG)
        o_b + np.arange(B),              # broker -> t (residual)
    ])
    dst = np.concatenate([
        1 + np.arange(nP),
        o_b + b_of,
        np.full(nP, o_pool, np.int64),
        np.full(1, o_pool, np.int64),
        o_b + np.arange(B),
        np.full(B, t, np.int64),
        np.full(B, t, np.int64),
    ])
    cap = np.concatenate([
        np.ones(nP, np.int64),
        np.ones(n, np.int64),
        np.ones(nP, np.int64),
        np.full(1, rest, np.int64),
        np.full(B, int(p_active), np.int64),
        np.full(B, lo_b, np.int64),
        np.full(B, hi_b - lo_b, np.int64),
    ])
    cost = np.concatenate([
        np.zeros(nP, np.int64),
        -g_int,
        np.zeros(nP, np.int64),
        np.zeros(1, np.int64),
        np.zeros(B, np.int64),
        np.full(B, -big, np.int64),
        np.zeros(B, np.int64),
    ])
    try:
        f, c, af = mcmf(src, dst, cap, cost, 0, t, t + 1)
    except Exception:
        return None
    if f != int(p_active):
        return None  # band-infeasible or degenerate: LP decides
    floor_arcs = af[nP + n + nP + 1 + B:nP + n + nP + 1 + 2 * B]
    filled = int(floor_arcs.sum())
    if filled != B * lo_b:
        return None  # a floor went unmet: LP decides
    return base + int(-(c + big * filled))


def _leader_cap_lp(inst, with_lower: bool = False,
                   flow_only: bool = False) -> int | None:
    """max_weight with the per-broker leadership constraints modeled
    exactly. Each partition either hands leadership to a member m
    (gain = val[p,m] - s_rm1 over the non-member-leader optimum) or
    to some zero-gain leader; each broker accepts at most
    ``leader_hi`` — a transportation LP (integral).

    ``with_lower`` additionally introduces per-broker slack
    variables y_b counting the zero-gain leads, the band's LOWER
    side, and the total-leads equality. The lower band matters for
    leader-skew rebalances: under-leading brokers are FORCED to
    take leaderships away from gainful keeps, a loss the cap-only
    model cannot see — but the slack formulation solves ~3x slower,
    so it is a separate, lazier bound level.

    ``flow_only`` skips the scipy-LP fallback when the native flow
    fast path declines — for instances past the aggregation
    threshold, where the LP would grind for minutes but the flow
    stays sub-second at any size."""
    r = inst._leader_vals()
    if r is None:
        return 0
    val, s_rm1, ids = r
    active = inst.rf > 0
    p_active = int(active.sum())
    base = int(s_rm1[active].sum())
    gain = np.where(
        (ids >= 0) & active[:, None],
        np.maximum(val - s_rm1[:, None], 0), 0,
    )
    rows, cols = np.nonzero(gain > 0)
    if rows.size == 0:
        return base
    if inst.leader_hi <= 0:
        return base
    if not with_lower:
        # the cap-only model is a pure transportation problem:
        # source -> partition (cap 1) -> gainful member's broker
        # (cost -gain) -> sink (cap leader_hi), plus a zero-cost
        # partition -> sink disposal arc so the forced max flow
        # never routes a positive-cost path. Integer flows solve
        # the SAME integral polytope the LP does, on the native
        # min-cost-flow kernel — 5.3 s of HiGHS IPM -> ~0.3 s at
        # the 50k-partition adv50k size, and this
        # bound sits on the certificate critical path of every
        # annealed solve. The LP below stays as the fallback.
        b = inst._leader_cap_flow(gain, rows, cols, ids, base)
        if b is not None:
            return b
    else:
        # the slack formulation is a network too (pool node +
        # floor-priority arcs); same exactness argument, ~25x the
        # LP's speed at 50k partitions
        b = inst._leader_cap_flow_lower(
            gain, rows, cols, ids, base, p_active
        )
        if b is not None:
            return b
    if flow_only:
        return None  # caller ruled the scipy LP out at this size
    try:
        import scipy.sparse as sp
        from scipy.optimize import linprog

        B = inst.num_brokers
        g = gain[rows, cols].astype(np.float64)
        b_of = ids[rows, cols]
        n = rows.size
        var = np.arange(n)
        opts = inst._lp_options()
        if opts is None:  # bounds deadline already spent
            return None
        per_part = sp.csr_matrix(  # one leading member each
            (np.ones(n), (rows, var)), shape=(inst.num_parts, n)
        )
        cap = sp.csr_matrix((np.ones(n), (b_of, var)), shape=(B, n))
        if not with_lower:
            c = -g
            a_ub = sp.vstack([per_part, cap], format="csr")
            b_ub = np.concatenate(
                [np.ones(inst.num_parts),
                 np.full(B, float(inst.leader_hi))]
            )
            a_eq, b_eq = None, None
            lo, hi = np.zeros(n), np.ones(n)
            res = linprog(
                c, A_ub=a_ub, b_ub=b_ub, bounds=(0, 1),
                method="highs-ipm", options=opts,
            )
        else:
            # columns: x (gainful member leads) then y (per-broker
            # zero-gain lead slack)
            led_of_b = sp.hstack(
                [cap, sp.eye(B, format="csr")], format="csr"
            )
            a_ub = sp.vstack(
                [
                    sp.hstack(
                        [per_part,
                         sp.csr_matrix((inst.num_parts, B))],
                        format="csr",
                    ),
                    led_of_b,        # <= leader_hi
                    -led_of_b,       # >= leader_lo
                ],
                format="csr",
            )
            b_ub = np.concatenate(
                [
                    np.ones(inst.num_parts),
                    np.full(B, float(inst.leader_hi)),
                    np.full(B, -float(inst.leader_lo)),
                ]
            )
            c = -np.concatenate([g, np.zeros(B)])
            # every live partition has exactly one leader
            a_eq = sp.csr_matrix(np.ones((1, n + B)))
            b_eq = np.array([float(p_active)])
            lo = np.zeros(n + B)
            hi = np.concatenate(
                [np.ones(n), np.full(B, float(p_active))]
            )
            # variable bounds as one [n+B, 2] array: building the
            # equivalent Python list of tuples walks every variable in
            # the interpreter — dead host time at 150k members
            #; identical values, so the LP (and with it the
            # certified bound) is bit-equal
            res = linprog(
                c, A_ub=a_ub, b_ub=b_ub, A_eq=a_eq, b_eq=b_eq,
                bounds=np.stack([lo, hi], axis=1),
                method="highs-ipm", options=opts,
            )
        if not res.success:
            return None
        # certificate-critical: the repaired dual bound is valid
        # regardless of primal tolerance, so when marginals exist it
        # is the ONLY sound choice — a loose repair weakens the
        # verdict, never the soundness. The max with the primal
        # value guards fp noise in the repair arithmetic (a feasible
        # iterate's value never exceeds the true optimum, so the max
        # is still an upper bound). Primal fallback only when the
        # solve carried no marginals at all.
        ub = _dual_repair_max_ub(c, a_ub, b_ub, a_eq, b_eq, lo, hi, res)
        if ub is None:
            return base + _safe_floor_ub(res.fun)
        return base + _safe_floor_ub(-max(ub, -res.fun))
    except Exception:
        return None


def _kept_weight_lp(inst, return_solution: bool = False):
    """Level-2 bound: max preservation weight of kept slots under
    ALL band families jointly, BOTH sides (see
    ``weight_upper_bound``). Variables: x_{p,b} (member kept as
    follower, weight w_follower) / y_{p,b} (member kept as leader,
    weight w_leader) per current eligible member, plus zero-weight
    slacks u_b (partitions broker b leads through a non-kept
    leader) and z_b (new, non-kept replicas broker b hosts):

        x + y <= 1                    per member (one role)
        sum_b y <= 1                  per partition (C5)
        sum_b (x+y) <= rf_p           per partition (C4)
        sum_{b in k} (x+y) <= part_rack_hi_p   per (p, rack) (C10)
        leader_lo <= sum_p y->b + u_b <= leader_hi   per broker (C7)
        broker_lo <= sum (x+y)->b + z_b <= broker_hi per broker (C6)
        rack_lo_k <= sum_{b in k} [(x+y)->b + z_b] <= rack_hi_k (C9)
        sum y + sum u = #live partitions       (one leader each)
        sum (x+y) + sum z = total_replicas     (every slot filled)

    Every feasible plan maps into this region (kept roles -> x/y,
    its remaining leads/replicas -> u/z), so the optimum is a valid
    upper bound; the slacks let the LOWER bands and totals bind —
    an under-leading broker must absorb leaderships and a
    below-floor broker/rack must absorb new replicas, losses the
    cap-only levels cannot see."""
    try:
        import scipy.sparse as sp
        from scipy.optimize import linprog
    except Exception:
        return None
    mrows, mcols = inst._members()
    n = mrows.size
    if n == 0:
        return None if return_solution else 0
    # deadline check BEFORE model build: assembling the sparse
    # matrices costs seconds at 10k partitions (and holds the serve
    # solve lock) — an expired budget must not pay it
    opts = inst._lp_options()
    if opts is None:
        return None
    try:
        B, K, P = inst.num_brokers, inst.num_racks, inst.num_parts
        rack = inst.rack_of_broker[mcols]
        var = np.arange(n)
        one = np.ones(n)
        pair_key = mrows.astype(np.int64) * K + rack
        pairs, pair_idx = np.unique(pair_key, return_inverse=True)
        p_active = int((inst.rf > 0).sum())
        r_total = float(inst.total_replicas)
        # column layout: x (kept follower) 0..n-1 | y (kept leader)
        # n..2n-1 | u (non-kept lead per broker) 2n..2n+B-1 | z (new
        # replica per broker) 2n+B..2n+2B-1. The slack columns let
        # the LOWER bands and the totals bind: an under-leading
        # broker must take leads (losing 4->2 keeps elsewhere), new
        # replicas forced by broker/rack floors consume cap the
        # kept slots then cannot use.
        ncols = 2 * n + 2 * B
        u_off, z_off = 2 * n, 2 * n + B

        def block(r, c, shape0):
            return sp.csr_matrix(
                (np.ones(len(c)), (r, c)), shape=(shape0, ncols)
            )

        def both(r, shape0):  # rows over x+y
            return block(
                np.concatenate([r, r]),
                np.concatenate([var, var + n]),
                shape0,
            )

        def y_only(r, shape0):
            return block(r, var + n, shape0)

        b_idx = np.arange(B)
        lead_of_b = y_only(mcols, B) + block(
            b_idx, u_off + b_idx, B
        )
        repl_of_b = both(mcols, B) + block(b_idx, z_off + b_idx, B)
        rack_rows = both(rack, K) + block(
            inst.rack_of_broker[:B], z_off + b_idx, K
        )
        a_ub = sp.vstack(
            [
                both(var, n),          # x + y <= 1 per member
                y_only(mrows, P),      # one kept leader per part
                both(mrows, P),        # <= rf per part
                both(pair_idx, pairs.size),  # diversity per (p,k)
                lead_of_b,             # <= leader_hi per broker
                -lead_of_b,            # >= leader_lo per broker
                repl_of_b,             # <= broker_hi per broker
                -repl_of_b,            # >= broker_lo per broker
                rack_rows,             # <= rack_hi per rack
                -rack_rows,            # >= rack_lo per rack
            ],
            format="csr",
        )
        b_ub = np.concatenate(
            [
                np.ones(n),
                np.ones(P),
                inst.rf.astype(np.float64),
                inst.part_rack_hi[(pairs // K)].astype(np.float64),
                np.full(B, float(inst.leader_hi)),
                np.full(B, -float(inst.leader_lo)),
                np.full(B, float(inst.broker_hi)),
                np.full(B, -float(inst.broker_lo)),
                inst.rack_hi.astype(np.float64),
                -inst.rack_lo.astype(np.float64),
            ]
        )
        # totals: every live partition has one leader; every valid
        # slot is kept or new
        a_eq = sp.vstack(
            [
                block(
                    np.zeros(n + B, np.int64),
                    np.concatenate([var + n, u_off + b_idx]),
                    1,
                ),
                block(
                    np.zeros(2 * n + B, np.int64),
                    np.concatenate([var, var + n, z_off + b_idx]),
                    1,
                ),
            ],
            format="csr",
        )
        b_eq = np.array([float(p_active), r_total])
        wl = inst.w_leader[:, :B][mrows, mcols].astype(np.float64)
        wf = np.maximum(
            inst.w_follower[:, :B][mrows, mcols], 0
        ).astype(np.float64)
        # variable bounds as arrays (see _leader_cap_lp): the tuple
        # list walked 2n+2B variables in the interpreter per solve —
        # at the 50k-partition jumbo that is ~300k dead Python
        # iterations on the constructor's critical path
        lo = np.zeros(ncols)
        hi = np.concatenate([
            np.ones(2 * n),
            np.full(B, float(p_active)),
            np.full(B, r_total),
        ])
        bounds = np.stack([lo, hi], axis=1)
        if return_solution:
            # one composite solve: weight lexicographically above
            # the kept-slot count (kept < n+1, so the scaled weight
            # term dominates) — among weight-optimal vertices, pick
            # a move-minimal one for the constructor to decode. The
            # decoded plan's weight/moves are recomputed from the
            # ROUNDED integers, so composite-objective fp noise
            # cannot leak into any certificate.
            scale = float(n + 1)
            c = -np.concatenate(
                [scale * wf + 1, scale * wl + 1, np.zeros(2 * B)]
            )
        else:
            c = -np.concatenate([wf, wl, np.zeros(2 * B)])
        res = linprog(
            c,
            A_ub=a_ub, b_ub=b_ub, A_eq=a_eq, b_eq=b_eq,
            bounds=bounds, method="highs",
            options=opts,
        )
        if not res.success:
            return None
        if return_solution:
            sol = res.x
            return {
                "x": sol[:n],
                "y": sol[n:2 * n],
                "z": sol[z_off:z_off + B],
                "mrows": mrows,
                "mcols": mcols,
            }
        # certificate-critical: when marginals exist the repaired
        # dual bound is the only sound choice (see _leader_cap_lp);
        # max with the primal value guards repair fp noise
        ub = _dual_repair_max_ub(c, a_ub, b_ub, a_eq, b_eq, lo, hi, res)
        if ub is None:
            return _safe_floor_ub(res.fun)
        return _safe_floor_ub(-max(ub, -res.fun))
    except Exception:
        return None


def _member_classes(inst):
    """Partition-symmetry classes for the aggregated kept-weight
    bound: partitions are interchangeable in the level-2 LP when
    they share (rf, part_rack_hi, sorted member (broker, w_leader,
    w_follower) triples). Generated clusters — and real round-robin
    Kafka clusters — have FAR fewer classes than partitions (the
    50k-partition jumbo instance has 543), which is what makes the
    level-2 bound affordable at any size.

    Returns (cls_parts, cls_rf, cls_prh, cm_cls, cm_broker, cm_wl,
    cm_wf): per-class partition lists and rf/prh, plus flattened
    class-member arrays. Memoized."""
    cached = getattr(inst, "_member_classes_memo", None)
    if cached is not None:
        return cached

    mrows, mcols = inst._members()
    wl = inst.w_leader[mrows, mcols].astype(np.int64)
    wf = np.maximum(inst.w_follower[mrows, mcols], 0).astype(np.int64)
    P = inst.num_parts
    # vectorized grouping: encode each member as one int64, lay the
    # per-partition sorted member lists into a padded signature
    # matrix [P, 2 + maxM], and let np.unique(axis=0) find the
    # classes — the Python-dict version costs ~0.6 s at jumbo
    # scale, squarely on the constructor's critical path
    if (
        0 <= wl.min(initial=0)
        and wl.max(initial=0) < (1 << 12)
        and wf.max(initial=0) < (1 << 12)
        and inst.num_brokers < (1 << 24)
    ):
        enc = (mcols.astype(np.int64) << 24) | (wl << 12) | wf
        cnt = np.bincount(mrows, minlength=P)
        starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        order = np.lexsort((enc, mrows))
        r_s, e_s = mrows[order], enc[order]
        pos = np.arange(r_s.size) - starts[r_s]
        maxm = int(cnt.max(initial=0))
        sig = np.full((P, 2 + maxm), -1, np.int64)
        sig[:, 0] = inst.rf
        sig[:, 1] = inst.part_rack_hi
        sig[r_s, 2 + pos] = e_s
        uniq, inv = np.unique(sig, axis=0, return_inverse=True)
        by_cls = np.argsort(inv, kind="stable")
        splits = np.cumsum(np.bincount(inv))[:-1]
        cls_parts = [p.tolist() for p in np.split(by_cls, splits)]
        cls_rf = uniq[:, 0].copy()
        cls_prh = uniq[:, 1].copy()
        mem = uniq[:, 2:]
        ci, mj = np.nonzero(mem != -1)
        me = mem[ci, mj]
        out = (
            cls_parts,
            cls_rf,
            cls_prh,
            ci.astype(np.int64),
            (me >> 24).astype(np.int64),
            ((me >> 12) & 0xFFF).astype(np.int64),
            (me & 0xFFF).astype(np.int64),
        )
        inst._member_classes_memo = out
        return out

    # fallback for out-of-range weights/broker ids (never hit by
    # the README tier rule, which caps weights at 4)
    import collections

    per = collections.defaultdict(list)
    for r, c, a, b in zip(mrows.tolist(), mcols.tolist(),
                          wl.tolist(), wf.tolist()):
        per[r].append((c, a, b))
    groups: dict = collections.defaultdict(list)
    rf_l = inst.rf.tolist()
    prh_l = inst.part_rack_hi.tolist()
    for p in range(inst.num_parts):  # kao: disable=KAO109 -- out-of-range-weight fallback only; the vectorized np.unique grouping above serves every README-tier instance (weights <= 4)
        key = (rf_l[p], prh_l[p], tuple(sorted(per[p])))
        groups[key].append(p)
    cls_parts, cls_rf, cls_prh = [], [], []
    cm_cls, cm_broker, cm_wl, cm_wf = [], [], [], []
    for ci, (key, parts) in enumerate(groups.items()):
        rff, prh, members = key
        cls_parts.append(parts)
        cls_rf.append(rff)
        cls_prh.append(prh)
        for (b, a, f) in members:
            cm_cls.append(ci)
            cm_broker.append(b)
            cm_wl.append(a)
            cm_wf.append(f)
    out = (
        cls_parts,
        np.array(cls_rf, np.int64),
        np.array(cls_prh, np.int64),
        np.array(cm_cls, np.int64),
        np.array(cm_broker, np.int64),
        np.array(cm_wl, np.int64),
        np.array(cm_wf, np.int64),
    )
    inst._member_classes_memo = out
    return out


def _kept_weight_agg(inst, integer: bool = False,
                     return_solution: bool = False):
    """The level-2 kept-weight bound on the SYMMETRY-AGGREGATED
    model — exactly the same polytope as ``_kept_weight_lp`` but
    with one variable per (class, member) instead of per
    (partition, member).

    Exactness: the LP optimum is invariant under aggregation —
    averaging any optimum over a class's partitions (they have
    identical members, weights, rf and caps) is feasible with the
    same objective, and symmetric solutions biject with the
    aggregated ones (every aggregated row is the sum of the
    partition rows it replaces). So this IS the level-2 LP bound,
    at ~#classes/#partitions of the cost — 0.5 s where the
    unaggregated LP times out at 900 s (50k-partition jumbo).

    ``integer=True`` solves the aggregated MILP instead: integer
    symmetrization is only into (every real plan maps to an integer
    aggregate; not every integer aggregate is realizable), so its
    optimum — or its dual bound under a time limit — is a still-
    valid, potentially TIGHTER upper bound than the LP (the
    ``weight_upper_bound`` level-3 tier).

    ``return_solution`` (with ``integer=True``) returns the raw
    aggregated solution for the plan constructor
    (``solvers.lp_round``): a dict with per-class-member kept
    counts X/Y, per-broker new-replica quotas z and non-kept-leader
    quotas u, plus the class arrays to disaggregate with."""
    try:
        import scipy.sparse as sp
        from scipy.optimize import linprog
    except Exception:
        return None
    (cls_parts, cls_rf, cls_prh, cm_cls, cm_broker, cm_wl, cm_wf
     ) = inst._member_classes()
    n_cm = cm_broker.size
    if n_cm == 0:
        return None if return_solution else 0
    # the formulation only pays off when symmetry actually shrinks
    # the problem: on clusters with near-distinct per-partition
    # weights (#classes ~ #partitions) this would be a full-size
    # MILP burning its whole time limit to restate the level-2
    # verdict — refuse instead of grinding (certify_optimal and the
    # serve audit run these tiers synchronously)
    if not inst.agg_construct_viable():
        return None
    opts = inst._lp_options()
    if opts is None:  # bounds deadline already spent
        return None
    try:
        B, K = inst.num_brokers, inst.num_racks
        C = len(cls_parts)
        cls_n = np.array([len(p) for p in cls_parts], np.float64)
        cm_n = cls_n[cm_cls]
        rack = inst.rack_of_broker[cm_broker]
        p_active = float((inst.rf > 0).sum())
        r_total = float(inst.total_replicas)
        ncols = 2 * n_cm + 2 * B
        u_off, z_off = 2 * n_cm, 2 * n_cm + B
        var = np.arange(n_cm)

        def block(r, c, nrows):
            return sp.csr_matrix(
                (np.ones(len(c)), (r, c)), shape=(nrows, ncols)
            )

        def both(r, nrows):
            return block(
                np.concatenate([r, r]),
                np.concatenate([var, var + n_cm]),
                nrows,
            )

        b_idx = np.arange(B)
        pk = cm_cls * K + rack
        pairs, pair_idx = np.unique(pk, return_inverse=True)
        lead_b = block(cm_broker, var + n_cm, B) + block(
            b_idx, u_off + b_idx, B
        )
        repl_b = both(cm_broker, B) + block(b_idx, z_off + b_idx, B)
        rack_rows = both(rack, K) + block(
            inst.rack_of_broker[:B], z_off + b_idx, K
        )
        # u_b <= z_b: a lead through a non-kept leader sits on one
        # of that broker's NEW replicas (valid for every real plan;
        # tightens the aggregate against phantom leaderships)
        uz = sp.csr_matrix(
            (np.concatenate([np.ones(B), -np.ones(B)]),
             (np.concatenate([b_idx, b_idx]),
              np.concatenate([u_off + b_idx, z_off + b_idx]))),
            shape=(B, ncols),
        )
        a_ub = sp.vstack(
            [
                both(var, n_cm),              # X+Y <= n_c per member
                block(cm_cls, var + n_cm, C),  # sum Y <= n_c
                both(cm_cls, C),              # sum(X+Y) <= n_c rf
                both(pair_idx, pairs.size),   # diversity pairs
                block(cm_cls, var, C),        # sum X <= n_c (rf-1):
                # a fully-kept partition keeps its leader, so kept
                # FOLLOWERS never exceed rf-1
                lead_b, -lead_b,
                repl_b, -repl_b,
                rack_rows, -rack_rows,
                uz,
            ],
            format="csr",
        )
        b_ub = np.concatenate(
            [
                cm_n,
                cls_n,
                cls_n * cls_rf,
                (cls_n * cls_prh)[(pairs // K)],
                cls_n * np.maximum(cls_rf - 1, 0),
                np.full(B, float(inst.leader_hi)),
                np.full(B, -float(inst.leader_lo)),
                np.full(B, float(inst.broker_hi)),
                np.full(B, -float(inst.broker_lo)),
                inst.rack_hi.astype(np.float64),
                -inst.rack_lo.astype(np.float64),
                np.zeros(B),
            ]
        )
        a_eq = sp.vstack(
            [
                block(
                    np.zeros(n_cm + B, np.int64),
                    np.concatenate([var + n_cm, u_off + b_idx]),
                    1,
                ),
                block(
                    np.zeros(2 * n_cm + B, np.int64),
                    np.concatenate(
                        [var, var + n_cm, z_off + b_idx]
                    ),
                    1,
                ),
            ],
            format="csr",
        )
        b_eq = np.array([p_active, r_total])
        if return_solution:
            # lexicographic: weight dominant, kept count tie-break
            scale = float(inst.total_replicas + 1)
            c = -np.concatenate(
                [scale * cm_wf + 1, scale * cm_wl + 1,
                 np.zeros(2 * B)]
            )
        else:
            c = -np.concatenate(
                [cm_wf.astype(np.float64), cm_wl.astype(np.float64),
                 np.zeros(2 * B)]
            )
        lo = np.zeros(ncols)
        hi = np.concatenate(
            [cm_n, cm_n, np.full(B, p_active), np.full(B, r_total)]
        )
        if integer:
            from scipy.optimize import (
                Bounds, LinearConstraint, milp,
            )

            res = milp(
                c,
                constraints=[
                    LinearConstraint(a_ub, -np.inf, b_ub),
                    LinearConstraint(a_eq, b_eq, b_eq),
                ],
                bounds=Bounds(lo, hi),
                integrality=np.ones(ncols),
                options={"time_limit": opts["time_limit"],
                         "mip_rel_gap": 0.0},
            )
            if return_solution:
                # scipy.milp: success is True ONLY at proven
                # optimality (status 0) — a time-limit incumbent
                # reports success=False — so everything below,
                # including the recorded weight bound, rests on a
                # solved-to-optimality aggregate
                if not res.success or res.x is None:
                    return None
                sol = np.rint(res.x)
                if np.abs(res.x - sol).max(initial=0) > 1e-6:
                    return None
                # the pure-weight part of the lexicographic optimum
                # is a valid upper bound on ANY feasible plan's
                # weight: scale > every kept count, so a plan with
                # higher weight would map to an aggregate beating
                # the composite optimum. Recording it lets
                # certify_optimal skip the bound-ladder LPs for
                # constructor-built plans.
                xs = sol[:n_cm]
                ys = sol[n_cm:2 * n_cm]
                agg_w = int((cm_wf * xs).sum() + (cm_wl * ys).sum())
                # min-merged with any bound the unaggregated LP vertex
                # already recorded (solvers.lp_round._unagg_plan): both
                # are valid upper bounds, the tighter one certifies more
                prev = getattr(inst, "_agg_weight_ub", None)
                inst._agg_weight_ub = (
                    agg_w if prev is None else min(prev, agg_w)
                )
                return {
                    "X": sol[:n_cm].astype(np.int64),
                    "Y": sol[n_cm:2 * n_cm].astype(np.int64),
                    "u": sol[u_off:u_off + B].astype(np.int64),
                    "z": sol[z_off:z_off + B].astype(np.int64),
                    "cls_parts": cls_parts,
                    "cls_rf": cls_rf,
                    "cls_prh": cls_prh,
                    "cm_cls": cm_cls,
                    "cm_broker": cm_broker,
                    "cm_wl": cm_wl,
                    "cm_wf": cm_wf,
                }
            # branch-and-bound dual bound: valid even on timeout
            db = getattr(res, "mip_dual_bound", None)
            if db is None or not np.isfinite(db):
                return None
            return _safe_floor_ub(db)
        res = linprog(
            c, A_ub=a_ub, b_ub=b_ub, A_eq=a_eq, b_eq=b_eq,
            bounds=np.stack([lo, hi], axis=1), method="highs",
            options=opts,
        )
        if not res.success:
            return None
        ub = _dual_repair_max_ub(c, a_ub, b_ub, a_eq, b_eq, lo, hi,
                                 res)
        if ub is None:
            return _safe_floor_ub(res.fun)
        return _safe_floor_ub(-max(ub, -res.fun))
    except Exception:
        return None


def certify_optimal(inst, a: np.ndarray, allow_tight: bool = True
                    ) -> bool:
    """True iff ``a`` is PROVABLY a global optimum: feasible, its
    preservation weight meets the unconstrained upper bound
    (``max_weight``), and its move count meets ``move_lower_bound``.
    Search engines use this to stop early with ``optimal=True``; a
    False return proves nothing (the bounds may simply not be tight
    for this instance)."""
    if not inst.is_feasible(a):
        return False
    mc = inst.move_count(a)
    if mc > inst.move_lower_bound() and (
        mc > inst.move_lower_bound_exact()
    ):
        return False
    w = inst.preservation_weight(a)
    # fast path: an aggregated-MILP optimum recorded by the plan
    # constructor is already a valid upper bound on every feasible
    # plan's weight (see _kept_weight_agg) — meeting it needs no LP
    agg_ub = getattr(inst, "_agg_weight_ub", None)
    if agg_ub is not None and w >= agg_ub:
        return True
    if w >= inst.weight_upper_bound(level=0):
        return True
    # the higher levels solve multi-second LPs at 10k partitions;
    # deadline-sensitive callers (the engine under time_limit_s)
    # disable the synchronous escalation
    if not allow_tight:
        return False
    return (
        w >= inst.weight_upper_bound(level=1)
        or w >= inst.weight_upper_bound(level=2)
        or w >= inst.weight_upper_bound(level=3)
    )

