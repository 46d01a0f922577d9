"""Solver-neutral optimization model (the reference's L1-L3 layers).

A copy of ``kafka_assignment_optimizer_tpu.models.instance`` limited to
what the device solve path calls: building the instance, the numpy
oracle (``violations``, ``preservation_weight``, ``move_count``), the
cheap counting move bound, the unconstrained weight optimum
(``max_weight``) and ``decode``. The LP/flow bounds and the exact leader
reseat of the reference (its ``models.bounds`` / ``models.reseat``
delegates) are not part of this package yet.

Candidates are *replica-slot* arrays ``A[P, R] : int`` of broker
**indices** with slot 0 = leader, which hard-encodes the replication
factor, one-leader and per-broker-uniqueness equalities; the inequality
families (replica/leader/rack balance bands and per-partition rack
diversity) are the penalty terms of the search.

Objective weights: current preferred leader broker scores 4 as leader and
2 as follower; a current follower scores 2 as leader and 1 as follower;
any other broker 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from .cluster import Assignment, PartitionAssignment, Topology

# Objective weight tiers (README.md:146 observed values).
W_LEADER_KEEP = 4  # current leader stays leader
W_LEADER_DEMOTE = 2  # current leader stays as follower
W_FOLLOWER_PROMOTE = 2  # current follower becomes leader
W_FOLLOWER_KEEP = 1  # current follower stays follower


@dataclass
class ProblemInstance:
    """Dense, index-based optimization model.

    Broker axis is *eligible brokers only* (the target ``--broker-list``);
    ``broker_ids[i]`` maps index -> Kafka broker id. Index ``B`` (one past
    the end) is the shared "null bucket" used for padded replica slots, so
    histograms can be built with scatter-adds without branching.
    """

    # topology / broker axis
    broker_ids: np.ndarray  # [B] int32, sorted eligible Kafka broker ids
    rack_of_broker: np.ndarray  # [B+1] int32 rack index; null bucket -> K
    rack_names: list[str]
    # partition axis (all topics flattened)
    topics: list[str]
    topic_of_part: np.ndarray  # [P] int32 topic index
    part_id: np.ndarray  # [P] int32 kafka partition id within topic
    rf: np.ndarray  # [P] int32 target replication factor
    # current assignment, in broker-*index* space, -? see below
    # A0[p, s] = broker index of current replica in slot s (slot 0 leader),
    #            B (null) if slot unused or broker not eligible.
    a0: np.ndarray  # [P, R] int32
    # current assignment in raw broker-id space (for diffs / weights incl.
    # ineligible brokers)
    current: Assignment = field(repr=False, default=None)
    # objective weights, [P, B+1] int32 (null bucket column always 0)
    w_leader: np.ndarray = field(repr=False, default=None)
    w_follower: np.ndarray = field(repr=False, default=None)
    # inequality-constraint bounds
    broker_lo: int = 0
    broker_hi: int = 0
    leader_lo: int = 0
    leader_hi: int = 0
    rack_lo: np.ndarray = None  # [K] int32
    rack_hi: np.ndarray = None  # [K] int32
    part_rack_hi: np.ndarray = None  # [P] int32: ceil(rf/K)

    # -- sizes ----------------------------------------------------------
    @property
    def num_brokers(self) -> int:
        return int(self.broker_ids.shape[0])

    @property
    def num_parts(self) -> int:
        return int(self.topic_of_part.shape[0])

    @property
    def num_racks(self) -> int:
        return len(self.rack_names)

    @property
    def max_rf(self) -> int:
        return int(self.a0.shape[1])

    @property
    def total_replicas(self) -> int:
        return int(self.rf.sum())

    @property
    def slot_valid(self) -> np.ndarray:
        """[P, R] bool — slot s is a real replica slot for partition p."""
        return np.arange(self.max_rf)[None, :] < self.rf[:, None]

    # -- decode ---------------------------------------------------------
    def decode(self, a: np.ndarray) -> Assignment:
        """Map a candidate ``A[P, R]`` of broker indices back to
        reassignment JSON (leader = slot 0 = ``replicas[0]``,
        ``README.md:65-78``). One vectorized id translation; the Python
        loop only assembles the output objects (at 10k partitions the
        per-element indexing version cost ~0.1 s of the warm solve)."""
        valid = self.slot_valid
        ids = self.broker_ids[np.where(valid, a, 0)].tolist()
        rfs = self.rf.tolist()
        topic_names = [self.topics[t] for t in self.topic_of_part.tolist()]
        pids = self.part_id.tolist()
        parts = [
            PartitionAssignment(
                topic=topic_names[p],
                partition=pids[p],
                replicas=ids[p][: rfs[p]],
            )
            for p in range(self.num_parts)
        ]
        return Assignment(partitions=parts)

    # -- feasibility / scoring (numpy reference; oracle for all backends) --
    def violations(self, a: np.ndarray) -> dict[str, int]:
        """Exact integer violation counts of the inequality families for a
        candidate in index space. All zeros == feasible. Also validates the
        hard-encoded families (rf/leader/uniqueness) defensively."""
        B, K, P, R = self.num_brokers, self.num_racks, self.num_parts, self.max_rf
        valid = self.slot_valid
        a = np.asarray(a)
        flat = np.where(valid, a, B)
        # per-broker totals (replica+leader vars together, README.md:158-161)
        cnt = np.bincount(flat.ravel(), minlength=B + 1)[:B]
        lead = np.bincount(np.where(self.rf > 0, a[:, 0], B), minlength=B + 1)[:B]
        rk = self.rack_of_broker[flat]  # [P, R], null -> K
        rcnt = np.bincount(rk.ravel(), minlength=K + 1)[:K]
        # per (partition, rack) counts via one bincount over the
        # flattened (partition, rack) key — np.add.at's per-element
        # scatter cost ~0.3 s per call at 50k partitions, and this
        # oracle runs several times per solve
        pr = np.bincount(
            (np.arange(P, dtype=np.int64)[:, None] * (K + 1)
             + rk).ravel(),
            minlength=P * (K + 1),
        ).reshape(P, K + 1)
        pr = pr[:, :K]

        def band(x, lo, hi):
            return int(np.maximum(x - hi, 0).sum() + np.maximum(lo - x, 0).sum())

        srt = np.sort(flat, axis=1)
        dup = int(
            ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] < B)).sum()
        )
        return {
            "broker_balance": band(cnt, self.broker_lo, self.broker_hi),
            "leader_balance": band(lead, self.leader_lo, self.leader_hi),
            "rack_balance": band(rcnt, self.rack_lo, self.rack_hi),
            "part_rack_diversity": int(
                np.maximum(pr - self.part_rack_hi[:, None], 0).sum()
            ),
            # hard-encoded families, checked defensively:
            "slot_out_of_range": int(((flat < 0) | (flat > B)).sum()),
            "null_in_valid_slot": int((flat[valid] >= B).sum()),
            "duplicate_in_partition": dup,
        }

    def is_feasible(self, a: np.ndarray) -> bool:
        return all(v == 0 for v in self.violations(a).values())

    def preservation_weight(self, a: np.ndarray) -> int:
        """Objective value (maximized): sum of kept-assignment weights."""
        P = self.num_parts
        a = np.asarray(a)
        valid = self.slot_valid
        rows = np.arange(P)
        w = int(self.w_leader[rows, a[:, 0]][self.rf > 0].sum())
        if self.max_rf > 1:
            foll = self.w_follower[rows[:, None], a[:, 1:]]
            w += int(foll[valid[:, 1:]].sum())
        return w

    def max_weight(self) -> int:
        """Exact unconstrained per-partition optimum of the preservation
        weight (ignoring the balance constraints): for each partition, the
        best choice of leader among weighted brokers (or an unweighted
        one) plus the best rf-1 positive follower weights among the rest.
        A true upper bound on any feasible plan's objective.

        Vectorized over partitions: with v_1 >= v_2 >= ... the clipped-positive
        follower weights of partition p and s_k their prefix sums, leader
        b scores  w_lead[b] + (s_{rf-1} - v(b) + v_rf  if v(b) >= v_{rf-1}
        else s_{rf-1})  — removing one instance of b's follower value from
        the top set and backfilling with the next-best; only values
        matter, so ties need no identity tracking."""
        r = self._leader_vals()
        if r is None:
            return 0
        val, s_rm1, _ = r
        best = np.maximum(val.max(axis=1), s_rm1)
        return int(best[self.rf > 0].sum())

    def _leader_vals(self):
        """Per-(partition, candidate-leader) optimum of the preservation
        weight, vectorized on a padded sparse member view. Returns
        ``(val [P, M], s_rm1 [P], ids [P, M])`` — ``val[p, m]`` is the
        best weight of partition p when member ``ids[p, m]`` leads (its
        leader weight plus the best rf-1 positive follower weights among
        the rest), ``s_rm1`` the best weight under a non-member (zero
        weight) leader, padding columns carry ids of -1 and val ==
        s_rm1. None when no weights exist at all."""
        P, B = self.num_parts, self.num_brokers
        if P == 0:
            return None
        wl_full = self.w_leader[:, :B]
        wf_full = self.w_follower[:, :B]
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
        rf = self.rf.astype(np.int64)
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

    def move_count(self, a: np.ndarray) -> int:
        """Replica moves vs the current assignment: count of valid slots
        whose broker is not in the partition's current (eligible) replica
        set. Membership test uses the weight matrices: every currently
        assigned eligible broker carries nonzero leader weight."""
        a = np.asarray(a)
        member = self.w_leader[np.arange(self.num_parts)[:, None], a] > 0
        return int((~member & self.slot_valid).sum())

    def move_lower_bound(self) -> int:
        """Provable lower bound on ``move_count`` over ALL feasible plans,
        from a counting relaxation of "how many slots can possibly be
        kept": a kept slot holds a current eligible member of its
        partition, each partition keeps at most min(rf, |members|) of them
        (at most ``part_rack_hi`` per rack), each broker hosts at most
        ``broker_hi`` total and appears in at most m_b = |{p : b member}|
        partitions, each rack holds at most ``rack_hi`` total. Every
        non-kept valid slot is one move, so

            moves >= total_replicas - min(A, B, C)

        with A/B/C the per-partition / per-broker / per-rack kept caps.
        Arrival counting gives two more bounds: a broker below
        ``broker_lo`` needs (lo - m_b) incoming moves, a rack below its
        ``rack_lo`` likewise. The max of all bounds is returned. It
        reproduces the hand-derived bounds of every benchmark scenario
        (``utils/gen.py``): decommission (slots on the removed broker),
        rf_change (new slots have no members), scale_out (empty brokers
        must absorb floor(R/B) each), leader_only (0)."""
        B, K = self.num_brokers, self.num_racks
        member = self.w_leader > 0  # [P, B+?]; columns past B are unused
        member = member[:, :B]
        m_b = member.sum(axis=0).astype(np.int64)  # [B]
        rack = self.rack_of_broker[:B]  # [B] rack index of each broker

        # A: per-partition kept cap, rack-diversity aware. Per-rack
        # column-group sums via reduceat over rack-sorted columns: the
        # np.add.at scatter this replaces cost ~0.3 s at 50k
        # partitions, on the bounds_flow critical path.
        # Racks are nonempty by construction (rack_names derive from
        # the brokers), so no reduceat empty-segment edge case.
        order = np.argsort(rack, kind="stable")
        starts = np.searchsorted(rack[order], np.arange(K))
        mem_rack = np.add.reduceat(
            member[:, order].astype(np.int64), starts, axis=1
        )
        per_part = np.minimum(mem_rack, self.part_rack_hi[:, None]).sum(1)
        a_cap = int(np.minimum(self.rf, per_part).sum())

        # B: per-broker kept cap;  C: per-rack kept cap
        capped_b = np.minimum(m_b, self.broker_hi)
        b_cap = int(capped_b.sum())
        per_rack = np.bincount(rack, weights=capped_b, minlength=K)[:K]
        c_cap = int(np.minimum(per_rack, self.rack_hi).sum())

        lb_kept = self.total_replicas - min(a_cap, b_cap, c_cap)
        # arrival bounds (each move lands exactly one replica somewhere)
        lb_broker_in = int(np.maximum(self.broker_lo - m_b, 0).sum())
        mk = np.bincount(rack, weights=m_b, minlength=K)[:K]
        lb_rack_in = int(np.maximum(self.rack_lo - mk, 0).sum())
        return max(lb_kept, lb_broker_in, lb_rack_in, 0)



def build_instance(
    current: Assignment,
    broker_list: Sequence[int],
    topology: Topology | None = None,
    target_rf: int | dict[str, int] | None = None,
) -> ProblemInstance:
    """Build the solver-neutral model from raw inputs (reference L0->L1-L3,
    ``README.md:46-63, 106-133``)."""
    broker_ids = np.array(sorted(set(int(b) for b in broker_list)), dtype=np.int32)
    B = len(broker_ids)
    if B == 0:
        raise ValueError("empty broker list")

    if topology is None:
        topology = Topology.single_rack(broker_ids.tolist())
    rack_names = sorted({topology.rack(int(b)) for b in broker_ids})
    rack_idx = {r: i for i, r in enumerate(rack_names)}
    K = len(rack_names)
    rack_of_broker = np.full(B + 1, K, dtype=np.int32)
    for i, b in enumerate(broker_ids):
        rack_of_broker[i] = rack_idx[topology.rack(int(b))]

    parts = sorted(current.partitions, key=lambda p: (p.topic, p.partition))
    topics = []
    topic_idx: dict[str, int] = {}
    for p in parts:
        if p.topic not in topic_idx:
            topic_idx[p.topic] = len(topics)
            topics.append(p.topic)
    P = len(parts)

    if isinstance(target_rf, dict):
        # a typo'd topic would otherwise be silently ignored and the
        # operator would apply a plan believing RF was raised
        unknown = sorted(set(target_rf) - set(topic_idx))
        if unknown:
            raise ValueError(
                f"target_rf names unknown topic(s) {unknown}; "
                f"assignment has {sorted(topic_idx)}"
            )

    def rf_for(p: PartitionAssignment) -> int:
        if target_rf is None:
            return len(p.replicas)
        if isinstance(target_rf, dict):
            return int(target_rf.get(p.topic, len(p.replicas)))
        return int(target_rf)

    rf = np.array([rf_for(p) for p in parts], dtype=np.int32)
    if (rf <= 0).any():
        raise ValueError("replication factor must be >= 1")
    if (rf > B).any():
        raise ValueError("replication factor exceeds broker count")
    R = int(rf.max())

    topic_of_part = np.array([topic_idx[p.topic] for p in parts], dtype=np.int32)
    part_id = np.array([p.partition for p in parts], dtype=np.int32)

    # current assignment -> index space; ineligible brokers -> null
    # bucket B. Vectorized over one flattened (partition, slot, broker)
    # view: the per-partition Python fills cost ~0.35 s at
    # the 50k-partition jumbo, on every solve's cold path. Broker-id ->
    # index translation is a searchsorted over the (sorted) broker_ids.
    rep_counts = np.fromiter(
        (len(p.replicas) for p in parts), np.int64, count=P
    )
    n_flat = int(rep_counts.sum())
    flat_b = np.fromiter(
        (int(b) for p in parts for b in p.replicas), np.int64,
        count=n_flat,
    )
    rows = np.repeat(np.arange(P, dtype=np.int64), rep_counts)
    starts = np.concatenate([[0], np.cumsum(rep_counts)[:-1]]) \
        if P else np.zeros(0, np.int64)
    slots = np.arange(n_flat, dtype=np.int64) - starts[rows] \
        if n_flat else np.zeros(0, np.int64)
    pos = np.searchsorted(broker_ids, flat_b)
    eligible = (pos < B) & (
        broker_ids[np.minimum(pos, B - 1)] == flat_b
    )
    idx = np.where(eligible, pos, B).astype(np.int32)
    a0 = np.full((P, R), B, dtype=np.int32)
    in_range = slots < R
    a0[rows[in_range], slots[in_range]] = idx[in_range]

    # objective weights (README.md:116-133, 146): see module docstring.
    # Follower tiers first (duplicate scatters write the same constant,
    # so last-wins assignment equals the legacy max), then the leader
    # tier overwrites — reproducing the legacy slot-order semantics
    # where a broker appearing as both leader and follower keeps the
    # leader weights.
    w_leader = np.zeros((P, B + 1), dtype=np.int32)
    w_follower = np.zeros((P, B + 1), dtype=np.int32)
    foll = eligible & (slots > 0)
    w_leader[rows[foll], idx[foll]] = W_FOLLOWER_PROMOTE
    w_follower[rows[foll], idx[foll]] = W_FOLLOWER_KEEP
    lead = eligible & (slots == 0)
    w_leader[rows[lead], idx[lead]] = W_LEADER_KEEP
    w_follower[rows[lead], idx[lead]] = W_LEADER_DEMOTE

    # bound arithmetic (README.md:158-180)
    r_tot = int(rf.sum())
    broker_lo, broker_hi = r_tot // B, -(-r_tot // B)
    leader_lo, leader_hi = P // B, -(-P // B)
    rack_sizes = np.array(
        [int((rack_of_broker[:B] == k).sum()) for k in range(K)], dtype=np.int64
    )
    rack_lo = (r_tot * rack_sizes) // B
    rack_hi = -((-r_tot * rack_sizes) // B)
    part_rack_hi = -(-rf // K)

    # --- satisfiability repair (balance bands are preferences: they must
    # never make the instance infeasible). Equal-size racks satisfy every
    # condition below as-is and reproduce the reference sample's exact
    # bounds unchanged (README.md:173-176); lopsided topologies (found by
    # the property fuzz: a 1-broker rack + diversity caps can make the
    # proportional ceilings under-supply r_tot, which the exact MILP
    # reports as infeasible) get the minimal relaxation that admits a
    # plan. Steps:
    #   1. per-partition: the diversity cap c_p must allow rf_p replicas
    #      across racks given each rack's broker count (uniqueness).
    #   2. per-rack: tighten the band to the true implied extremes
    #      [m_k, M_k] (no semantic change), then
    #   3. jointly: relax ceilings/floors until sum(hi) covers r_tot and
    #      sum(lo) <= r_tot.
    #   4. broker bands: every rack's brokers must supply its floor, and
    #      the global per-broker supply must cover r_tot under the rack
    #      ceilings.
    cap_pk = np.minimum(part_rack_hi[:, None], rack_sizes[None, :])
    short = rf - cap_pk.sum(1)
    while (short > 0).any():  # step 1 (terminates: B >= rf checked)
        part_rack_hi = part_rack_hi + (short > 0)
        cap_pk = np.minimum(part_rack_hi[:, None], rack_sizes[None, :])
        short = rf - cap_pk.sum(1)
    M = cap_pk.sum(0)  # [K] true max replicas rack k can hold
    m = np.maximum(  # [K] forced minimum (others at their caps)
        rf[:, None] - (cap_pk.sum(1)[:, None] - cap_pk), 0
    ).sum(0)
    rack_hi = np.maximum(np.minimum(rack_hi, M), m)  # step 2 (m <= M, so
    rack_lo = np.maximum(np.minimum(rack_lo, rack_hi), m)  # lo <= hi holds)
    # steps 3a/3b converge in <= K+1 passes: every non-final pass clips
    # at least one rack at its extreme
    for _ in range(K + 1):  # step 3a: raise ceilings toward M
        deficit = r_tot - int(rack_hi.sum())
        head = M - rack_hi
        if deficit <= 0 or not (head > 0).any():
            break
        add = -(-deficit // max(int((head > 0).sum()), 1))
        rack_hi = np.minimum(rack_hi + np.where(head > 0, add, 0), M)
    for _ in range(K + 1):  # step 3b: lower floors toward m
        excess = int(rack_lo.sum()) - r_tot
        slack = rack_lo - m
        if excess <= 0 or not (slack > 0).any():
            break
        sub = -(-excess // max(int((slack > 0).sum()), 1))
        rack_lo = np.maximum(rack_lo - np.where(slack > 0, sub, 0), m)
    # step 4: per-broker band vs rack floors/ceilings
    broker_hi = max(broker_hi, int(np.max(-(-rack_lo // rack_sizes))))
    supply = lambda h: int(np.minimum(rack_sizes * h, rack_hi).sum())  # noqa: E731
    while supply(broker_hi) < r_tot and broker_hi < r_tot:
        broker_hi += 1
    broker_lo = min(broker_lo, int(np.min(rack_hi // rack_sizes)))

    inst = ProblemInstance(
        broker_ids=broker_ids,
        rack_of_broker=rack_of_broker,
        rack_names=rack_names,
        topics=topics,
        topic_of_part=topic_of_part,
        part_id=part_id,
        rf=rf,
        a0=a0,
        current=current,
        w_leader=w_leader,
        w_follower=w_follower,
        broker_lo=int(broker_lo),
        broker_hi=int(broker_hi),
        leader_lo=int(leader_lo),
        leader_hi=int(leader_hi),
        rack_lo=rack_lo.astype(np.int32),
        rack_hi=rack_hi.astype(np.int32),
        part_rack_hi=part_rack_hi.astype(np.int32),
    )
    return inst
