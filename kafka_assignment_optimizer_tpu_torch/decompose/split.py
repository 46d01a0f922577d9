"""Map-phase split: an AZ/rack-structured instance -> per-AZ
sub-instances whose feasibility NESTS under the flat instance.

The nesting argument (docs/DECOMPOSE.md): every sub-instance inherits
the flat instance's band values verbatim — ``broker_lo/hi`` and
``leader_lo/hi`` as the same global scalars, ``rack_lo/hi`` and
``part_rack_hi`` as slices of the same global arrays. Because the
broker and rack axes are *partitioned* across groups (each broker and
each rack belongs to exactly one group) and every partition is
assigned wholly to one group, a plan that satisfies every sub-instance
satisfies every constraint family of the flat instance exactly — the
stitched plan is globally feasible *by construction*, and the reduce
phase's oracle check is a redundant proof, not a repair pass.

What the splitter must therefore guarantee up front is only
*admissibility*: each group's partition load must land inside the
windows the inherited bands imply (replicas in
``[max(broker_lo*B_g, sum rack_lo_g), min(broker_hi*B_g, sum
rack_hi_g)]``, leaders in ``[leader_lo*B_g, leader_hi*B_g]``) and each
partition must be *placeable* in its group (``rf <= B_g`` and
``sum_k min(part_rack_hi, rack_size_k) >= rf``). The band-slack
reconciliation below moves boundary partitions between groups until
every window holds, or reports the instance undecomposable (None ->
the flat path).

A copy of ``kafka_assignment_optimizer_tpu.decompose.split``: all
per-partition work is vectorized numpy; Python loops range only over
groups and racks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.instance import ProblemInstance

# bounded reconciliation: each pass fixes the worst window violation by
# moving partitions between one (donor, receiver) pair; 4 passes per
# group pair is far past what any band geometry needs to converge
_RECONCILE_PASSES_PER_GROUP = 8


@dataclass
class Split:
    """One decomposition: group structure + extracted sub-instances."""

    n_groups: int
    group_names: list[str]
    group_of_rack: np.ndarray  # [K] int32
    group_of_part: np.ndarray  # [P] int32
    boundary: np.ndarray  # [P] bool — current members span >1 group
    subs: list[ProblemInstance]
    part_idx: list[np.ndarray]  # global partition indices per group
    broker_idx: list[np.ndarray]  # global broker indices per group
    moved_for_slack: int  # partitions re-homed by band reconciliation

    @property
    def uniform_shape(self) -> bool:
        """All groups share (brokers, racks) — the stacking invariant
        that lets the map phase run ONE lane-padded executable."""
        shapes = {(s.num_brokers, s.num_racks) for s in self.subs}
        return len(shapes) == 1


def infer_groups(inst: ProblemInstance):
    """Group racks by AZ prefix (rack names like ``az0-rack1`` group on
    the text before the last ``-``). Returns ``(names, group_of_rack)``
    or None when the topology carries no usable group structure
    (unprefixed racks, or fewer than 2 groups)."""
    prefixes = []
    for n in inst.rack_names:  # racks, not partitions (KAO112-clean)
        if "-" not in str(n):
            return None
        prefixes.append(str(n).rsplit("-", 1)[0])
    uniq = sorted(set(prefixes))
    if len(uniq) < 2:
        return None
    gmap = {p: i for i, p in enumerate(uniq)}
    return uniq, np.array([gmap[p] for p in prefixes], np.int32)


def split(inst: ProblemInstance) -> Split | None:
    """Build the decomposition, or None when the instance is not
    decomposable (no group structure, a partition no group can place,
    or band windows that no reconciliation satisfies)."""
    got = infer_groups(inst)
    if got is None:
        return None
    names, g_rack = got
    G = len(names)
    B, P, K = inst.num_brokers, inst.num_parts, inst.num_racks
    g_broker = g_rack[inst.rack_of_broker[:B]]
    sizes_b = np.bincount(g_broker, minlength=G).astype(np.int64)
    if int(sizes_b.min()) == 0:
        return None

    # per-(partition, group) current-member counts, one bincount over
    # the flattened (p, group) key — null slots (a0 == B) land in the
    # discarded G column
    g_ext = np.append(g_broker, G).astype(np.int64)
    key = (np.arange(P, dtype=np.int64)[:, None] * (G + 1)
           + g_ext[inst.a0]).ravel()
    cnt = np.bincount(key, minlength=P * (G + 1)).reshape(
        P, G + 1)[:, :G].astype(np.int64)
    boundary = (cnt > 0).sum(axis=1) > 1

    # placeability: group g can host partition p iff rf_p <= B_g and
    # the group's racks admit rf_p replicas under part_rack_hi
    rack_size = np.bincount(inst.rack_of_broker[:B],
                            minlength=K).astype(np.int64)
    cap_pk = np.minimum(inst.part_rack_hi.astype(np.int64)[:, None],
                        rack_size[None, :])  # [P, K]
    fit = np.empty((P, G), bool)
    for g in range(G):
        fit[:, g] = (cap_pk[:, g_rack == g].sum(axis=1)
                     >= inst.rf) & (inst.rf <= sizes_b[g])
    if not fit.any(axis=1).all():
        return None  # some partition fits no group: undecomposable

    # home each partition with its current-member majority, restricted
    # to fitting groups; memberless partitions take their first fit
    score = np.where(fit, cnt, -1)
    g_part = np.argmax(score, axis=1).astype(np.int32)

    # band-slack reconciliation: inherited global bands imply per-group
    # replica/leader windows; move least-attached partitions between
    # groups until every window holds
    rf64 = inst.rf.astype(np.int64)
    rack_lo_g = np.array(
        [int(inst.rack_lo[g_rack == g].sum()) for g in range(G)],
        np.int64)
    rack_hi_g = np.array(
        [int(inst.rack_hi[g_rack == g].sum()) for g in range(G)],
        np.int64)
    r_lo = np.maximum(inst.broker_lo * sizes_b, rack_lo_g)
    r_hi = np.minimum(inst.broker_hi * sizes_b, rack_hi_g)
    p_lo = inst.leader_lo * sizes_b
    p_hi = inst.leader_hi * sizes_b
    moved = 0
    for _ in range(_RECONCILE_PASSES_PER_GROUP * G):
        r_g = np.bincount(g_part, weights=rf64,
                          minlength=G).astype(np.int64)
        p_g = np.bincount(g_part, minlength=G).astype(np.int64)
        if ((r_g > r_hi).any() or (r_g < r_lo).any()
                or (p_g > p_hi).any() or (p_g < p_lo).any()):
            pass
        else:
            break
        # worst violation picks the (donor, receiver, amount) move, in
        # the violated unit (replica slots or leader counts)
        over_r, under_r = r_g - r_hi, r_lo - r_g
        over_p, under_p = p_g - p_hi, p_lo - p_g
        if max(over_r.max(), under_r.max()) > 0:
            units, tot, lo, hi = rf64, r_g, r_lo, r_hi
            over, under = over_r, under_r
        else:
            units, tot, lo, hi = np.ones(P, np.int64), p_g, p_lo, p_hi
            over, under = over_p, under_p
        if over.max() >= under.max():
            donor = int(np.argmax(over))
            receiver = int(np.argmax(hi - tot))
        else:
            receiver = int(np.argmax(under))
            donor = int(np.argmax(tot - lo))
        amount = int(min(max(over[donor], under[receiver]),
                         hi[receiver] - tot[receiver],
                         tot[donor] - lo[donor]))
        if donor == receiver or amount <= 0:
            return None  # no slack anywhere to absorb the violation
        cand = np.nonzero((g_part == donor) & fit[:, receiver])[0]
        if cand.size == 0:
            return None
        # move the partitions least attached to the donor first (and
        # most attached to the receiver): minimal preservation loss
        order = cand[np.argsort(cnt[cand, donor] - cnt[cand, receiver],
                                kind="stable")]
        take = int(np.searchsorted(np.cumsum(units[order]), amount) + 1)
        take = min(take, order.size)
        g_part[order[:take]] = receiver
        moved += take
    else:
        return None  # reconciliation did not converge

    # per-rack admissibility audit: within a group the inherited
    # proportional rack bands must be reachable under the per-partition
    # diversity caps. For rack k of group g:
    #   achievable ceiling  sum_p min(prh_p, size_k)   >= rack_lo_k
    #   forced floor  sum_p max(0, rf_p - cap(other racks)) <= rack_hi_k
    # (a group whose largest rack's proportional share exceeds
    # P_g * prh, or whose rack count pins every partition onto a small
    # rack, is undecomposable under inherited bands -> flat path)
    for g in range(G):
        in_g = g_part == g
        racks_g = np.nonzero(g_rack == g)[0]
        rowsum = cap_pk[np.ix_(in_g.nonzero()[0], racks_g)]  # [Pg, Kg]
        total = rowsum.sum(axis=1)
        rf_g = rf64[in_g]
        ceil_k = rowsum.sum(axis=0)
        floor_k = np.maximum(
            rf_g[:, None] - (total[:, None] - rowsum), 0).sum(axis=0)
        if ((ceil_k < inst.rack_lo[racks_g]).any()
                or (floor_k > inst.rack_hi[racks_g]).any()):
            return None

    # extraction: pure index translation, one vectorized gather per
    # group — local broker/rack ids via lookup arrays (null B -> B_g,
    # null rack K -> K_g)
    subs, part_idx, broker_idx = [], [], []
    for g in range(G):
        Pg = np.nonzero(g_part == g)[0]
        Sg = np.nonzero(g_broker == g)[0]
        Rg = np.nonzero(g_rack == g)[0]
        if Pg.size == 0:
            return None  # empty lane: nothing to stack
        Bg, Kg = int(Sg.size), int(Rg.size)
        loc = np.full(B + 1, Bg, np.int32)
        loc[Sg] = np.arange(Bg, dtype=np.int32)
        rloc = np.full(K + 1, Kg, np.int32)
        rloc[Rg] = np.arange(Kg, dtype=np.int32)
        cols = np.append(Sg, B)  # group brokers + shared null column
        subs.append(ProblemInstance(
            broker_ids=inst.broker_ids[Sg].copy(),
            rack_of_broker=rloc[inst.rack_of_broker[cols]],
            rack_names=[inst.rack_names[int(k)] for k in Rg],
            topics=inst.topics,
            topic_of_part=inst.topic_of_part[Pg].copy(),
            part_id=inst.part_id[Pg].copy(),
            rf=inst.rf[Pg].copy(),
            a0=loc[inst.a0[Pg]],
            current=None,
            w_leader=np.ascontiguousarray(inst.w_leader[np.ix_(Pg, cols)]),
            w_follower=np.ascontiguousarray(
                inst.w_follower[np.ix_(Pg, cols)]),
            broker_lo=inst.broker_lo, broker_hi=inst.broker_hi,
            leader_lo=inst.leader_lo, leader_hi=inst.leader_hi,
            rack_lo=inst.rack_lo[Rg].copy(),
            rack_hi=inst.rack_hi[Rg].copy(),
            part_rack_hi=inst.part_rack_hi[Pg].copy(),
        ))
        part_idx.append(Pg)
        broker_idx.append(Sg)
    return Split(
        n_groups=G, group_names=list(names), group_of_rack=g_rack,
        group_of_part=g_part, boundary=boundary, subs=subs,
        part_idx=part_idx, broker_idx=broker_idx,
        moved_for_slack=moved,
    )
