"""LP-rounding plan constructor — decode the kept-replica LP's vertex
into an actual reassignment plan.

The level-2 weight bound (``ProblemInstance._kept_weight_lp``) is a
transportation-structured LP whose optimum is (almost always) an
INTEGRAL vertex: x/y say exactly which current members stay and in which
role, z says how many new replicas each broker absorbs, u how many
leaderships land on non-kept leaders. When the caps genuinely bind —
scale-outs over-filling old brokers, leader-skew rebalances — local
search burns its whole ladder approaching that structure from below;
this module instead materializes it directly:

1. round x/y/z (bail to None on a fractional vertex),
2. place the kept members,
3. complete the vacant slots with new replicas via one max-flow
   (partitions -> (partition, rack) diversity nodes -> brokers with
   z-quota), so every band and diversity cap holds by construction,
4. reseat leaders exactly (``best_leader_assignment``).

If the result is feasible and meets the weight bound it IS a proven
global optimum and the engine can skip annealing entirely; otherwise it
still seeds the population at (or near) the LP structure. Returns None
whenever any step cannot complete — callers always have the greedy seed
to fall back on.

No counterpart in the reference (its lp_solve run IS the exact solve,
the upstream ``README.md:135-137``); this is the package's bridge
between the search engine and exact optimality.
"""

from __future__ import annotations

import numpy as np

from ..models import instance as _instance_mod
from ..models.instance import ProblemInstance


def construct(inst: ProblemInstance) -> np.ndarray | None:
    """Decode the kept-replica LP into a full plan, or None.

    Past ~60k members the unaggregated LP is intractable; the
    symmetry-aggregated MILP (``_kept_weight_agg``) is solved instead
    and its per-class kept counts are realized into per-partition
    choices (``_disaggregate``) — partitions within a class are
    exchangeable, so any realization of the counts is optimal. The
    aggregated path also serves any instance whose symmetry is
    effective (``agg_effective``): on the 10k-partition headline it
    builds the certified optimum with no compilation.

    The aggregated realization (greedy disaggregation + flow
    completion) could historically be LOSSY on instances with binding
    caps (observed -14 weight on the 8k-partition scale-out with
    the blind completion), so the caps-bind family used to solve the
    full unaggregated LP first — 2+ s of HiGHS at 8k partitions where
    the aggregated MILP takes ~0.2 s. The leader-aware MCMF completion
    has since made the aggregated realization lossless on the whole
    caps-bind benchmark family (scale_out, leader_only: weight == the
    recorded bound, verified each run by the lossless check below), so
    symmetry-effective instances now try the CHEAP aggregated path
    first even when caps bind (this is most of the
    scale-out/leader-only cold-path win); a lossy realization still
    falls through to the exact LP vertex exactly as before, so the
    failure mode costs one cheap MILP attempt, never quality. Only
    caps-bind instances WITHOUT effective symmetry keep the
    exact-vertex-first order."""
    members = inst._members()[0].size
    big = members > _instance_mod.AGG_MEMBER_THRESHOLD
    lp_first = not big and inst.caps_bind() and not inst.agg_effective()
    plan_lp = plan_agg = None
    if lp_first:
        plan_lp, vertex_w = _unagg_plan(inst, with_weight=True)
        if plan_lp is not None and (
            vertex_w is None
            or inst.preservation_weight(plan_lp) >= vertex_w
        ):
            inst._construct_path = "lp"
            return plan_lp  # realized the vertex losslessly: optimal
        # lossy realization (e.g. the blind max-flow completion when
        # the MCMF kernel is unavailable): let the aggregated path
        # compete below instead of short-circuiting past it
    if big or inst.agg_effective():
        try:
            agg = inst._kept_weight_agg(integer=True,
                                        return_solution=True)
        except Exception:
            agg = None
        d = _disaggregate(inst, agg) if isinstance(agg, dict) else None
        if d is not None:
            plan_agg = _realize(
                inst, d["x"], d["y"], agg["z"].astype(np.int64),
                d["mrows"], d["mcols"],
            )
            ub = getattr(inst, "_agg_weight_ub", None)
            if (
                plan_agg is not None
                and ub is not None
                and inst.preservation_weight(plan_agg) >= ub
            ):
                inst._construct_path = "agg"
                return plan_agg  # lossless realization: weight-optimal
        if big:
            if plan_agg is not None:
                inst._construct_path = "agg"
            return plan_agg  # nothing cheaper exists past the threshold
    if not lp_first:
        plan_lp, _ = _unagg_plan(inst, with_weight=True)
    if plan_agg is None:
        if plan_lp is not None:
            inst._construct_path = "lp"
        return plan_lp
    if plan_lp is None:
        inst._construct_path = "agg"
        return plan_agg
    best = max(
        (plan_lp, plan_agg),
        key=lambda p: (inst.preservation_weight(p),
                       -inst.move_count(p)),
    )
    inst._construct_path = "agg" if best is plan_agg else "lp"
    return best


def _unagg_plan(inst: ProblemInstance, with_weight: bool = False):
    """The exact-vertex path: solve the unaggregated kept-replica LP
    and realize its integral vertex (None on fractional vertices or
    any realization failure). With ``with_weight`` returns
    ``(plan, vertex_weight)`` — the kept weight the vertex itself
    attains, so callers can tell a lossless realization from a
    degraded one (completion fallbacks can demote kept leaders)."""
    empty = (None, None) if with_weight else None
    try:
        sol = inst._kept_weight_lp(return_solution=True)
    except Exception:
        return empty
    if not isinstance(sol, dict):
        return empty
    x, y = np.asarray(sol["x"]), np.asarray(sol["y"])
    z = np.asarray(sol["z"])

    # integral vertex required: kept roles and new-replica quotas must
    # be whole (transportation structure makes this the common case)
    if (
        np.abs(x - np.rint(x)).max(initial=0) > 1e-6
        or np.abs(y - np.rint(y)).max(initial=0) > 1e-6
        or np.abs(z - np.rint(z)).max(initial=0) > 1e-6
    ):
        return empty
    xi = np.rint(x).astype(bool)
    yi = np.rint(y).astype(bool)
    mrows, mcols = sol["mrows"], sol["mcols"]
    wl = inst.w_leader[mrows, mcols]
    wf = np.maximum(inst.w_follower[mrows, mcols], 0)
    vertex_w = int((wf * xi).sum() + (wl * yi).sum())
    # the weight part of the lexicographic LP optimum is a valid upper
    # bound on ANY feasible plan's weight (every plan maps into the
    # polytope and scale > any kept count — the same argument, and the
    # same recording convention, as the aggregated MILP's
    # ``_agg_weight_ub`` in models.bounds._kept_weight_agg). Recording
    # it lets certify_optimal skip the bound-ladder LPs entirely for a
    # losslessly realized vertex — previously the scale-out /
    # leader-only certify path re-solved the SAME kept-replica LP a
    # second time just to restate this number (the duplicated
    # multi-second LP on the construct critical path). Min-merged: both
    # recorders hold valid bounds, so the tighter one wins.
    prev = getattr(inst, "_agg_weight_ub", None)
    inst._agg_weight_ub = (
        vertex_w if prev is None else min(prev, vertex_w)
    )
    plan = _realize(
        inst, xi, yi, np.rint(z).astype(np.int64),
        mrows, mcols,
    )
    if not with_weight:
        return plan
    return plan, vertex_w


def _realize(inst, xi, yi, quota, mrows, mcols) -> np.ndarray | None:
    """Place the kept roles, complete the vacancies, reseat leaders —
    the shared tail of both construct paths. Returns a feasible plan
    or None."""
    P, R = inst.num_parts, inst.max_rf
    B, K = inst.num_brokers, inst.num_racks
    rf = inst.rf.astype(np.int64)
    valid = inst.slot_valid

    # place kept members sequentially per partition — slot ORDER is
    # irrelevant here because the final exact leader reseat permutes
    # each row anyway
    keep = xi | yi
    kr, kb = mrows[keep], mcols[keep]
    order = np.argsort(kr, kind="stable")
    kr, kb = kr[order], kb[order]
    first = np.r_[True, kr[1:] != kr[:-1]] if kr.size else np.array([], bool)
    start = np.maximum.accumulate(
        np.where(first, np.arange(kr.size), 0)
    ) if kr.size else kr
    rank = np.arange(kr.size) - start
    if kr.size and (rank >= rf[kr]).any():
        return None  # vertex kept more slots than the partition has
    a = np.full((P, R), B, dtype=np.int64)
    a[kr, rank] = kb

    kept_cnt = (a != B).sum(axis=1)
    vac = rf - kept_cnt  # >= 0: the rank check above caps keeps at rf
    need = int(vac.sum())
    if need != int(quota.sum()):
        return None
    if need > 0:
        # leader-aware completion first: partitions left without a kept
        # leader must receive one of their new replicas on a broker
        # with leadership headroom, or the final exact reseat is forced
        # to demote kept leaders elsewhere (observed: -67 weight on the
        # 50k-partition jumbo with the blind completion). Min-cost
        # max-flow places every vacancy AND maximizes lead-capable
        # coverage jointly; the plain max-flow remains the fallback
        # when the native kernel is unavailable.
        has_lead = np.zeros(P, dtype=bool)
        has_lead[mrows[yi]] = True
        leaderless = (~has_lead) & (inst.rf > 0)
        lead_cnt = np.bincount(mcols[yi], minlength=B + 1)[:B]
        lead_quota = np.maximum(inst.leader_hi - lead_cnt, 0)
        assign = None
        if leaderless.any():
            assign = _complete_mcmf(
                inst, a, vac, leaderless, lead_quota
            )
        if assign is None:
            flow = _complete_maxflow(inst, a, vac, quota)
            if flow is not None:
                ap, ab = flow
                assign = (ap, ab, np.zeros(ap.size, dtype=bool))
        if assign is None:
            return None
        # vectorized vacancy fill: the per-assignment Python
        # loop re-scanned each row for its first vacant slot — O(need)
        # interpreter iterations on the jumbo completion. Identical
        # result by construction: assignments grouped per partition in
        # list order (stable sort) land on that partition's vacant
        # slots in ascending slot order, exactly the order the
        # one-at-a-time ``vac_slots[0]`` loop produced.
        ap, ab, alead = assign
        ordr = np.argsort(ap, kind="stable")
        ap_s, ab_s = ap[ordr], ab[ordr]
        first = np.r_[True, ap_s[1:] != ap_s[:-1]] if ap_s.size else \
            np.array([], bool)
        start = (
            np.maximum.accumulate(
                np.where(first, np.arange(ap_s.size), 0)
            ) if ap_s.size else ap_s
        )
        rank = np.arange(ap_s.size) - start
        vr, vc = np.nonzero((a == B) & valid)  # row-major: slots ascend
        v_start = np.searchsorted(vr, ap_s)
        pos = v_start + rank
        if pos.size and (
            (pos >= vr.size) | (vr[np.minimum(pos, vr.size - 1)] != ap_s)
        ).any():
            return None  # more placements than vacancies on some row
        a[ap_s, vc[pos] if pos.size else pos] = ab_s
    else:
        assign = (
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, dtype=bool),
        )
    if ((a == B) & valid).any():
        return None

    # pre-seat slot 0 before the exact reseat: the kept leaders (y —
    # the LP/MILP's own leader choice, in-band by its leader rows) plus
    # the completion's lead-channel placements. Slot order was
    # arbitrary up to here, so without this the reseat sees random
    # leader counts, its fast cycle-canceller declines (out-of-band
    # input), and every constructed solve pays the full transportation
    # LP instead — measured 3.9 s of the jumbo's 16 s wall.
    ap, ab, alead = assign
    lead_b_of = np.full(P, -1, dtype=np.int64)
    # duplicate partitions keep the LAST entry, matching the loop the
    # scatter replaces (numpy fancy assignment is last-wins)
    lead_b_of[ap[alead]] = ab[alead]
    lead_b_of[mrows[yi]] = mcols[yi]  # kept leaders win over coverage
    prows = np.flatnonzero(lead_b_of >= 0)
    if prows.size:
        hit = a[prows] == lead_b_of[prows, None]
        s0 = hit.argmax(axis=1)
        ok = hit[np.arange(prows.size), s0]
        prows, s0 = prows[ok], s0[ok]
        lead_vals = a[prows, s0].copy()
        a[prows, s0] = a[prows, 0]
        a[prows, 0] = lead_vals

    a = a.astype(np.int32)
    a = inst.best_leader_assignment(a)
    if not inst.is_feasible(a):
        return None
    return a


def _disaggregate(inst, agg):
    """Realize the aggregated MILP's per-(class, member) kept counts as
    per-partition selections.

    Partitions within a class are exchangeable (identical members,
    weights, rf, caps), so ANY realization of the counts has the same
    objective. One pass per (class, member): numpy masks over the
    class's partition block. Leaders are laid out count-descending over
    the class's partitions; each follower member then takes its ``X_j``
    keeps on the first eligible partitions (rf headroom, rack-diversity
    headroom, not already this partition's leader). The aggregate rows
    guarantee per-partition feasibility on average; the realization can
    in principle strand demand on adversarial instances — the caller
    verifies the final plan and falls back, so a stranded realization
    costs nothing but the attempt (it returns the partial keeps, still
    a valid warm start)."""
    mrows, mcols = inst._members()
    n = mrows.size
    B, K = inst.num_brokers, inst.num_racks
    # member lookup: (p, b) -> flat member index, via binary search on
    # the row-major (p, b) keys np.nonzero already emits sorted
    keys = mrows.astype(np.int64) * (B + 1) + mcols.astype(np.int64)
    x = np.zeros(n, dtype=bool)
    y = np.zeros(n, dtype=bool)
    rack_of = inst.rack_of_broker
    cm_cls = np.asarray(agg["cm_cls"], np.int64)
    cm_broker = np.asarray(agg["cm_broker"], np.int64)
    X = np.asarray(agg["X"], np.int64)
    Y = np.asarray(agg["Y"], np.int64)
    n_cls = len(agg["cls_parts"])
    order = np.argsort(cm_cls, kind="stable")
    splits = np.cumsum(np.bincount(cm_cls, minlength=n_cls))[:-1]
    by_cls = np.split(order, splits)
    out_p: list[np.ndarray] = []
    out_b: list[np.ndarray] = []
    out_lead: list[np.ndarray] = []
    for ci, parts in enumerate(agg["cls_parts"]):
        cms = by_cls[ci]
        if cms.size == 0:
            continue
        parts_a = np.asarray(parts, dtype=np.int64)
        nP = parts_a.size
        rf_c = int(agg["cls_rf"][ci])
        prh = int(agg["cls_prh"][ci])
        placed = np.zeros(nP, dtype=np.int64)
        rack_load = np.zeros((nP, K), dtype=np.int64)
        lead_of_part = np.full(nP, -1, dtype=np.int64)
        ysort = cms[np.argsort(-Y[cms], kind="stable")]
        lead_members = np.repeat(ysort, Y[ysort])
        if lead_members.size:
            # sum(Y) <= n_c is an aggregate constraint row, so the
            # truncation below is defensive, not load-bearing
            lead_members = lead_members[:nP]
            nl = lead_members.size
            lead_of_part[:nl] = lead_members
            placed[:nl] = 1
            lead_rk = rack_of[cm_broker[lead_members]]
            rack_load[np.arange(nl), lead_rk] += 1
            out_p.append(parts_a[:nl])
            out_b.append(cm_broker[lead_members])
            out_lead.append(np.ones(nl, dtype=bool))
        for j in cms[np.argsort(-X[cms], kind="stable")].tolist():
            xj = int(X[j])
            if xj <= 0:
                continue
            rk = int(rack_of[cm_broker[j]])
            elig = (
                (placed < rf_c)
                & (rack_load[:, rk] < prh)
                & (lead_of_part != j)
            )
            idx = np.flatnonzero(elig)[:xj]
            if idx.size == 0:
                continue  # stranded demand: caller verifies, like legacy
            placed[idx] += 1
            rack_load[idx, rk] += 1
            out_p.append(parts_a[idx])
            out_b.append(np.full(idx.size, cm_broker[j], np.int64))
            out_lead.append(np.zeros(idx.size, dtype=bool))
    if out_p:
        pp = np.concatenate(out_p)
        bb = np.concatenate(out_b)
        ll = np.concatenate(out_lead)
        want = pp * (B + 1) + bb
        pos = np.searchsorted(keys, want)
        if n == 0 or (pos >= n).any() or (
            keys[np.minimum(pos, n - 1)] != want
        ).any():
            return None  # a counted member is not a member: refuse
        y[pos[ll]] = True
        x[pos[~ll]] = True
    return {"x": x, "y": y, "mrows": mrows, "mcols": mcols}


def _complete_mcmf(inst, a, vac, leaderless, lead_quota):
    """Leader-aware completion: one min-cost max-flow placing every
    vacancy directly against the BAND SLACK (per-broker and per-rack
    capacity left by the keeps) rather than a fixed per-broker quota —
    the LP's z quotas satisfy the bands but cannot see the (partition,
    broker) pairing, and a blind realization of them strands lead
    coverage (observed: -9 weight on the jumbo instance).

    Cost structure (min-cost at max flow):
    - arcs giving a LEADERLESS partition a new replica on a broker with
      leadership headroom (capped per broker by ``lead_quota`` through
      a gateway node) carry cost -1 -> coverage is maximized, so the
      final exact reseat is not forced to demote kept leaders; each
      such candidate also has a parallel cost-0 bypass so a plain
      placement never consumes lead quota (binding gates must reduce
      the reward, not the max flow);
    - the first ``broker_lo - kept`` / ``rack_lo - kept`` units into a
      below-floor broker/rack carry cost -1000 -> band deficits are
      filled with absolute priority (a completion that leaves a floor
      unmet is infeasible anyway).

    Returns [(p, broker, through_lead_channel)] or None; the caller
    verifies the final plan, so any shortfall here only costs the
    attempt. The lead flag marks placements the flow routed through a
    broker's lead quota — the caller's slot-0 pre-seat uses them so the
    exact reseat starts from in-band leader counts."""
    try:
        from ..native import mcmf
    except Exception:
        return None
    P, R = a.shape
    B, K = inst.num_brokers, inst.num_racks
    rack_of = inst.rack_of_broker[:B].astype(np.int64)
    filled = a != B
    kept_b = np.bincount(
        a[filled].astype(np.int64), minlength=B + 1
    )[:B]
    cap_b = np.maximum(inst.broker_hi - kept_b, 0)
    deficit_b = np.minimum(
        np.maximum(inst.broker_lo - kept_b, 0), cap_b
    )
    kept_k = np.bincount(
        inst.rack_of_broker[a[filled]], minlength=K + 1
    )[:K]
    cap_k = np.maximum(inst.rack_hi - kept_k, 0)
    deficit_k = np.minimum(np.maximum(inst.rack_lo - kept_k, 0), cap_k)
    qb = np.flatnonzero(cap_b > 0)
    pv = np.flatnonzero(vac > 0)
    if qb.size == 0 or pv.size == 0:
        return None
    # one bincount over the flattened (partition, rack) key: np.add.at
    # pays per-element scatter cost (~0.3 s at 50k partitions) on the
    # completion path
    kept_rack = np.bincount(
        np.arange(P, dtype=np.int64)[:, None].repeat(R, 1)[filled]
        * (K + 1)
        + inst.rack_of_broker[a[filled]],
        minlength=P * (K + 1),
    ).reshape(P, K + 1)
    rem = inst.part_rack_hi[:, None] - kept_rack[:, :K]
    qr = np.unique(rack_of[qb])
    grid_p = np.repeat(pv, qr.size)
    grid_k = np.tile(qr, pv.size)
    keep = rem[grid_p, grid_k] > 0
    pk_p, pk_k = grid_p[keep], grid_k[keep]
    U = pk_p.size
    if U == 0:
        return None
    pair_of = np.full(P * K, -1, dtype=np.int64)
    pair_of[pk_p * K + pk_k] = np.arange(U)
    in_part = np.zeros((P, B + 1), dtype=bool)
    rows_f, cols_f = np.nonzero(filled)
    in_part[rows_f, a[rows_f, cols_f]] = True

    # candidate (p, b) edges
    eb_p = np.repeat(pv, qb.size)
    eb_b = np.tile(qb, pv.size)
    pid = pair_of[eb_p * K + rack_of[eb_b]]
    ok_e = (pid >= 0) & ~in_part[eb_p, eb_b]
    eb_p, eb_b, pid = eb_p[ok_e], eb_b[ok_e], pid[ok_e]
    # lead-channel candidates get a per-(p, b) intermediate node with
    # TWO outgoing arcs: the gated lead arc (cost -1, shares the
    # broker's lead-quota capacity) AND a parallel cost-0 direct arc.
    # The intermediate's unit in-capacity keeps per-(p, b) uniqueness,
    # and the direct arc means a plain placement never consumes lead
    # quota — without it, binding gates push max flow below the
    # vacancy count and abort the whole leader-aware completion to the
    # blind fallback.
    lead_e = leaderless[eb_p] & (lead_quota[eb_b] > 0)
    n_lead = int(lead_e.sum())
    # node ids: 0 source | parts | pairs | lead gateways | brokers |
    # racks | per-(p, b) lead intermediates | sink
    o_part, o_pair = 1, 1 + P
    o_gate = o_pair + U
    o_brok = o_gate + B
    o_rack = o_brok + B
    o_mid = o_rack + K
    t = o_mid + n_lead
    DEFICIT_REWARD = 1000
    b_idx = np.arange(B)
    k_idx = np.arange(K)
    m_idx = np.arange(n_lead)
    src = [
        np.zeros(pv.size, np.int64),        # s -> p
        o_part + pk_p,                      # p -> (p, k)
        o_pair + pid[~lead_e],              # (p, k) -> b   (plain)
        o_pair + pid[lead_e],               # (p, k) -> mid (lead cand)
        o_mid + m_idx,                      # mid -> gate (lead channel)
        o_mid + m_idx,                      # mid -> b     (plain bypass)
        o_gate + b_idx,                     # gate -> b
        o_brok + qb,                        # b -> rack: deficit channel
        o_brok + qb,                        # b -> rack: remaining slack
        o_rack + k_idx,                     # rack -> t: deficit channel
        o_rack + k_idx,                     # rack -> t: remaining slack
    ]
    dst = [
        o_part + pv,
        o_pair + np.arange(U),
        o_brok + eb_b[~lead_e],
        o_mid + m_idx,
        o_gate + eb_b[lead_e],
        o_brok + eb_b[lead_e],
        o_brok + b_idx,
        o_rack + rack_of[qb],
        o_rack + rack_of[qb],
        np.full(K, t, np.int64),
        np.full(K, t, np.int64),
    ]
    cap = [
        vac[pv],
        np.minimum(rem[pk_p, pk_k], vac[pk_p]),
        np.ones(int((~lead_e).sum()), np.int64),
        np.ones(n_lead, np.int64),
        np.ones(n_lead, np.int64),
        np.ones(n_lead, np.int64),
        np.minimum(lead_quota, cap_b),
        deficit_b[qb],
        (cap_b - deficit_b)[qb],
        deficit_k,
        cap_k - deficit_k,
    ]
    cost = [
        np.zeros(pv.size, np.int64),
        np.zeros(U, np.int64),
        np.zeros(int((~lead_e).sum()), np.int64),
        np.zeros(n_lead, np.int64),
        -np.ones(n_lead, np.int64),
        np.zeros(n_lead, np.int64),
        np.zeros(B, np.int64),
        np.full(qb.size, -DEFICIT_REWARD, np.int64),
        np.zeros(qb.size, np.int64),
        np.full(K, -DEFICIT_REWARD, np.int64),
        np.zeros(K, np.int64),
    ]
    src = np.concatenate(src)
    dst = np.concatenate(dst)
    cap = np.concatenate(cap)
    cost = np.concatenate(cost)
    try:
        flow, _cost, arc_flow = mcmf(src, dst, cap, cost, 0, t, t + 1)
    except Exception:
        return None
    if flow != int(vac.sum()):
        return None
    n0 = pv.size + U
    n_plain = int((~lead_e).sum())
    p_pl, b_pl = eb_p[~lead_e], eb_b[~lead_e]
    p_ld, b_ld = eb_p[lead_e], eb_b[lead_e]
    pf = np.asarray(arc_flow[n0:n0 + n_plain], np.int64)
    # a lead candidate is placed iff its (p, k) -> mid arc carries flow;
    # it consumed lead quota iff the mid -> gate channel carried it
    # (the bypass is a plain placement). Assignments returned as flat
    # (partition, broker, via-lead-channel) arrays — np.repeat over the
    # arc flows instead of the per-unit Python list build.
    lf = np.asarray(arc_flow[n0 + n_plain:n0 + n_plain + n_lead],
                    np.int64)
    gf = np.asarray(
        arc_flow[n0 + n_plain + n_lead:n0 + n_plain + 2 * n_lead],
        np.int64,
    )
    ap = np.concatenate([
        np.repeat(p_pl, pf), np.repeat(p_ld, lf),
    ]).astype(np.int64)
    ab = np.concatenate([
        np.repeat(b_pl, pf), np.repeat(b_ld, lf),
    ]).astype(np.int64)
    alead = np.concatenate([
        np.zeros(int(pf.sum()), dtype=bool),
        np.repeat(gf > 0, lf),
    ])
    return ap, ab, alead


def _complete_maxflow(inst, a, vac, quota):
    """Assign each vacancy a (partition, broker) pair: max-flow over
    partitions -> (p, rack) diversity nodes -> quota brokers. Returns
    [(p, broker)] or None if the vacancies cannot all be placed."""
    try:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import maximum_flow
    except Exception:
        return None
    P, R = a.shape
    B, K = inst.num_brokers, inst.num_racks
    rack_of = inst.rack_of_broker[:B].astype(np.int64)
    qb = np.flatnonzero(quota > 0)
    if qb.size == 0:
        return None
    # per-(p, rack) remaining diversity allowance
    filled = a != B
    # one bincount over the flattened (partition, rack) key: np.add.at
    # pays per-element scatter cost (~0.3 s at 50k partitions) on the
    # completion path
    kept_rack = np.bincount(
        np.arange(P, dtype=np.int64)[:, None].repeat(R, 1)[filled]
        * (K + 1)
        + inst.rack_of_broker[a[filled]],
        minlength=P * (K + 1),
    ).reshape(P, K + 1)
    rem = inst.part_rack_hi[:, None] - kept_rack[:, :K]  # [P, K]

    # sparse (p, k) pair nodes: only racks holding quota brokers, only
    # partitions with vacancies and remaining allowance. Fully
    # vectorized — at 50k partitions x 100 quota brokers the Python
    # per-edge version costs seconds of host CPU.
    qr = np.unique(rack_of[qb])
    pv = np.flatnonzero(vac > 0)
    if pv.size == 0 or qr.size == 0:
        return None
    grid_p = np.repeat(pv, qr.size)
    grid_k = np.tile(qr, pv.size)
    keep = rem[grid_p, grid_k] > 0
    pk_p, pk_k = grid_p[keep], grid_k[keep]
    U = pk_p.size
    if U == 0:
        return None
    # pair lookup: index into the dense (p, k) grid
    pair_of = np.full(P * K, -1, dtype=np.int64)
    pair_of[pk_p * K + pk_k] = np.arange(U)

    # membership mask to forbid brokers already in the partition
    in_part = np.zeros((P, B + 1), dtype=bool)
    rows_f, cols_f = np.nonzero(filled)
    in_part[rows_f, a[rows_f, cols_f]] = True

    o_part, o_pair = 1, 1 + P
    o_brok = 1 + P + U
    t = o_brok + B
    src, dst, cap = [], [], []
    # s -> partition
    src.append(np.zeros(pv.size, np.int64))
    dst.append(o_part + pv)
    cap.append(vac[pv])
    # partition -> pair
    src.append(o_part + pk_p)
    dst.append(o_pair + np.arange(U))
    cap.append(np.minimum(rem[pk_p, pk_k], vac[pk_p]))
    # pair -> broker (cap 1 per (p, b); skip members already in p):
    # cross every quota broker with every pair node of its rack
    eb_p = np.repeat(pv, qb.size)        # candidate partition
    eb_b = np.tile(qb, pv.size)          # candidate broker
    pid = pair_of[eb_p * K + rack_of[eb_b]]
    ok_e = (pid >= 0) & ~in_part[eb_p, eb_b]
    if not ok_e.any():
        return None
    src.append(o_pair + pid[ok_e])
    dst.append(o_brok + eb_b[ok_e])
    cap.append(np.ones(int(ok_e.sum()), np.int64))
    # broker -> t
    src.append(o_brok + qb)
    dst.append(np.full(qb.size, t, np.int64))
    cap.append(quota[qb])

    src = np.concatenate(src)
    dst = np.concatenate(dst)
    cap = np.concatenate(cap).astype(np.int32)
    g = sp.csr_matrix((cap, (src, dst)), shape=(t + 1, t + 1))
    res = maximum_flow(g, 0, t)
    if res.flow_value != int(vac.sum()):
        return None
    flow = res.flow.tocoo()
    # vectorized extraction of the pair -> broker arcs (the per-edge
    # Python loop walked every arc of the flow matrix)
    fi = np.asarray(flow.row, np.int64)
    fj = np.asarray(flow.col, np.int64)
    fd = np.asarray(flow.data, np.int64)
    keep = (
        (fd > 0) & (fi >= o_pair) & (fi < o_brok)
        & (fj >= o_brok) & (fj < t)
    )
    fi, fj, fd = fi[keep], fj[keep], fd[keep]
    ap = np.repeat(pk_p[fi - o_pair], fd).astype(np.int64)
    ab = np.repeat(fj - o_brok, fd).astype(np.int64)
    return ap, ab
