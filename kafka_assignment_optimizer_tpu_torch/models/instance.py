"""Solver-neutral optimization model (the reference's L1-L3 layers).

A copy of ``kafka_assignment_optimizer_tpu.models.instance``: builds, from
(current assignment, target broker list, topology, target RF), the single
:class:`ProblemInstance` that every solver backend consumes — the MILP
oracle, the LP emitter, the native C++ branch-and-bound, the plan
constructor and the device annealing engine — with the numpy oracle
(``violations``, ``preservation_weight``, ``move_count``), ``encode`` /
``decode``, and thin delegates to the bound ladder (``models.bounds``)
and the exact leader reseat (``models.reseat``).

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

import threading
import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

# guards creation of per-instance memo locks (instances are dataclasses;
# the lock attribute is created lazily on first bound computation)
_MEMO_GUARD = threading.Lock()

# member count past which the UNaggregated kept-replica LP is considered
# intractable (the 50k-partition jumbo's ~150k members time out at 900 s)
# and the symmetry-aggregated formulation takes over — in the bound
# ladder and in the plan constructor (solvers.lp_round)
AGG_MEMBER_THRESHOLD = 60_000

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

    def encode(self, plan: Assignment) -> np.ndarray:
        """Inverse of :meth:`decode`: map a plan in reassignment-JSON
        form onto this instance's index space ``A[P, R]`` (slot 0 =
        ``replicas[0]`` = leader). The plan must cover exactly this
        instance's (topic, partition) set, with each replica list no
        longer than the partition's target RF (the index space cannot
        represent extra replicas, and silently truncating them would
        let an over-replicated plan audit as feasible) — structural
        mismatches raise. Everything representable is ENCODED rather
        than judged: ineligible brokers map to the null bucket ``B``
        (surfacing as ``null_in_valid_slot`` violations), duplicated
        brokers land in their slots (``duplicate_in_partition``), and
        short replica lists leave null slots — so external plans, e.g.
        ``kafka-reassign-partitions`` output, get scored and certified
        by the same oracle as every solver's."""
        B = self.num_brokers
        by_key: dict[tuple[str, int], list[int]] = {}
        for p in plan.partitions:
            key = (p.topic, p.partition)
            if key in by_key:
                # last-wins dict building would silently dedupe a
                # malformed plan listing the same partition twice (with
                # possibly conflicting replica lists) — a structural
                # mismatch, so it raises like the others
                raise ValueError(
                    f"plan lists partition {key[0]}/{key[1]} more than once"
                )
            by_key[key] = p.replicas
        idx_of_broker = {int(b): i for i, b in enumerate(self.broker_ids)}
        a = np.full((self.num_parts, self.max_rf), B, dtype=np.int32)
        topic_names = [self.topics[t] for t in self.topic_of_part.tolist()]
        pids = self.part_id.tolist()
        rfs = self.rf.tolist()
        seen = set()
        for p in range(self.num_parts):
            key = (topic_names[p], pids[p])
            if key not in by_key:
                raise ValueError(
                    f"plan is missing partition {key[0]}/{key[1]}"
                )
            seen.add(key)
            reps = by_key[key]
            if len(reps) > rfs[p]:
                raise ValueError(
                    f"plan has {len(reps)} replicas for "
                    f"{key[0]}/{key[1]} but the target RF is {rfs[p]} "
                    "(pass target_rf / --rf to audit at a different RF)"
                )
            for s, broker in enumerate(reps):
                a[p, s] = idx_of_broker.get(int(broker), B)
        extra = set(by_key) - seen
        if extra:
            raise ValueError(
                f"plan contains unknown partitions: {sorted(extra)[:3]}"
            )
        return a

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

        Vectorized over partitions (it sits on the warm solve path via
        ``certify_optimal``): with v_1 >= v_2 >= ... the clipped-positive
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

    def _leader_vals(self, *a, **k):
        """Delegates to ``models.bounds._leader_vals`` (the bound/
        reseat machinery lives outside the data model)."""
        from . import bounds
        return bounds._leader_vals(self, *a, **k)

    def weight_upper_bound(self, *a, **k):
        """Delegates to ``models.bounds.weight_upper_bound`` (the bound/
        reseat machinery lives outside the data model)."""
        from . import bounds
        return bounds.weight_upper_bound(self, *a, **k)

    def _memo_lock(self) -> threading.Lock:
        lock = getattr(self, "_bounds_memo_lock", None)
        if lock is None:
            with _MEMO_GUARD:
                lock = getattr(self, "_bounds_memo_lock", None)
                if lock is None:
                    lock = threading.Lock()
                    self._bounds_memo_lock = lock
        return lock

    def cancel_pending_bounds(self) -> None:
        """Tell straggling bound workers to stop escalating: tiers not
        yet memoized are skipped (un-memoized) on the next check. The
        in-flight HiGHS solve still runs to its time limit — scipy
        cannot be interrupted — but no NEW tier starts. Engines call
        this when their solve returns so a daemon bounds thread cannot
        grind multi-second LPs into the next request's wall-clock."""
        self._bounds_cancelled = True

    def set_bounds_deadline(self, budget_s: float | None) -> None:
        """Give the bound LPs a wall-clock budget: each subsequent LP
        gets ``min(30 s, time remaining)`` as its HiGHS time limit, and
        LPs starting after the deadline are skipped outright (the bound
        ladder then falls back to the cheapest computed level — looser,
        never unsound). Used by deadline-sensitive callers: the serve
        audit endpoint (``--max-solve-s``) and the engine's bounds
        worker."""
        self._bounds_deadline = (
            None if budget_s is None else time.perf_counter() + budget_s
        )

    def _lp_options(self, default_limit: float = 30.0) -> dict | None:
        """HiGHS options for one bound LP under the instance deadline;
        None when the deadline has already passed (caller skips)."""
        d = getattr(self, "_bounds_deadline", None)
        if d is None:
            return {"time_limit": default_limit}
        remaining = d - time.perf_counter()
        if remaining <= 0.05:
            return None
        return {"time_limit": min(default_limit, remaining)}

    def best_known_weight_ub(self) -> int | None:
        """The tightest weight upper bound evaluated so far (for
        reports), or None if none has been."""
        memo = getattr(self, "_wub_memo", None)
        if not memo:
            return None
        # .copy() is atomic under the GIL; a bounds worker thread may be
        # inserting a tier concurrently
        return min(memo.copy().values())

    def move_lower_bound_exact(self, *a, **k):
        """Delegates to ``models.bounds.move_lower_bound_exact`` (the bound/
        reseat machinery lives outside the data model)."""
        from . import bounds
        return bounds.move_lower_bound_exact(self, *a, **k)

    def _members(self):
        """(mrows, mcols): the (partition, broker) pairs whose slot could
        be *kept* — current eligible members of live partitions.
        Memoized: the bound ladder, the plan constructor and the
        disaggregator each re-derive it, and the nonzero scan costs
        ~0.12 s at the 50k-partition jumbo — repeated four times that
        was a measurable slice of the construct path. The
        weight matrices are immutable after build, so the memo can
        never go stale; a concurrent double fill is benign (identical
        value)."""
        cached = getattr(self, "_members_memo", None)
        if cached is None:
            B = self.num_brokers
            cached = np.nonzero(
                ((self.w_leader[:, :B] > 0) | (self.w_follower[:, :B] > 0))
                & (self.rf[:, None] > 0)
            )
            self._members_memo = cached
        return cached

    def _kept_maxflow(self, *a, **k):
        """Delegates to ``models.bounds._kept_maxflow`` (the bound/
        reseat machinery lives outside the data model)."""
        from . import bounds
        return bounds._kept_maxflow(self, *a, **k)

    def _flow_prologue(self, *a, **k):
        """Delegates to ``models.bounds._flow_prologue`` (the bound/
        reseat machinery lives outside the data model)."""
        from . import bounds
        return bounds._flow_prologue(self, *a, **k)

    def _leader_cap_flow(self, *a, **k):
        """Delegates to ``models.bounds._leader_cap_flow`` (the bound/
        reseat machinery lives outside the data model)."""
        from . import bounds
        return bounds._leader_cap_flow(self, *a, **k)

    def _leader_cap_flow_lower(self, *a, **k):
        """Delegates to ``models.bounds._leader_cap_flow_lower`` (the bound/
        reseat machinery lives outside the data model)."""
        from . import bounds
        return bounds._leader_cap_flow_lower(self, *a, **k)

    def _leader_cap_lp(self, *a, **k):
        """Delegates to ``models.bounds._leader_cap_lp`` (the bound/
        reseat machinery lives outside the data model)."""
        from . import bounds
        return bounds._leader_cap_lp(self, *a, **k)

    def _kept_weight_lp(self, *a, **k):
        """Delegates to ``models.bounds._kept_weight_lp`` (the bound/
        reseat machinery lives outside the data model)."""
        from . import bounds
        return bounds._kept_weight_lp(self, *a, **k)

    def _member_classes(self, *a, **k):
        """Delegates to ``models.bounds._member_classes`` (the bound/
        reseat machinery lives outside the data model)."""
        from . import bounds
        return bounds._member_classes(self, *a, **k)

    def agg_effective(self) -> bool:
        """True when partition symmetry collapses the member space
        enough that the AGGREGATED kept-replica formulation (LP and
        MILP) is cheap — the gate for preferring it over the
        unaggregated LP in the bound ladder and for racing the
        aggregated plan constructor on any instance, not just the
        over-threshold ones. Steady-state round-robin clusters (the
        benchmark family, and real Kafka clusters after a balanced
        tool pass) collapse by 50-500x; adversarial distinct-weight
        clusters do not, and this returns False. The gate is a pure
        collapse RATIO (>= 8x) — no absolute floor — so small or
        asymmetric instances keep the annealer path (and its CI
        coverage) instead of degenerating into a host MILP solve."""
        members = self._members()[0].size
        if members == 0:
            return False
        n_cm = self._member_classes()[3].size
        return n_cm * 8 <= members

    def agg_construct_viable(self) -> bool:
        """True when the AGGREGATED kept-weight formulation would
        accept this instance rather than refuse: small enough to grind
        regardless (<= 20k members), or class collapse of at least 4x.
        ``_kept_weight_agg``'s refusal and the engine's constructor-race
        gate share this predicate so the two can never drift — past the
        unaggregated-LP size a refusal here means the constructor has
        NO viable path and racing it only delays the annealer."""
        members = self._members()[0].size
        if members <= 20_000:
            return True
        # n_cm <= members // 4 for integers — the refusal's complement
        return self._member_classes()[3].size * 4 <= members

    def _kept_weight_agg(self, *a, **k):
        """Delegates to ``models.bounds._kept_weight_agg`` (the bound/
        reseat machinery lives outside the data model)."""
        from . import bounds
        return bounds._kept_weight_agg(self, *a, **k)

    def best_leader_assignment(self, *a, **k):
        """Delegates to ``models.reseat.best_leader_assignment`` (the bound/
        reseat machinery lives outside the data model)."""
        from . import reseat
        return reseat.best_leader_assignment(self, *a, **k)

    def _best_leader_lp(self, *a, **k):
        """Delegates to ``models.reseat._best_leader_lp`` (the bound/
        reseat machinery lives outside the data model)."""
        from . import reseat
        return reseat._best_leader_lp(self, *a, **k)

    def _reseat_cycle_cancel(self, *a, **k):
        """Delegates to ``models.reseat._reseat_cycle_cancel`` (the bound/
        reseat machinery lives outside the data model)."""
        from . import reseat
        return reseat._reseat_cycle_cancel(self, *a, **k)

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

    def caps_bind(self) -> bool:
        """True when balance bands bind against the CURRENT assignment —
        over-full or under-floor brokers for either replicas or
        leaderships. These are exactly the instances where (a) local
        search must trade keeps against bands and plateaus epsilon below
        the optimum, and (b) the LP-rounding constructor
        (``solvers.lp_round``) tends to produce a certified optimum
        outright: scale-outs, leader-skew rebalances, RF changes. A
        plain decommission triggers neither side."""
        B = self.num_brokers
        m_b = (self.w_leader[:, :B] > 0).sum(axis=0)
        lead = self.a0[:, 0]
        ok = (
            (self.rf > 0)
            & (lead >= 0)
            & (lead < B)
            & (self.w_leader[np.arange(self.num_parts),
                             np.clip(lead, 0, B - 1)] > 0)
        )
        lcnt = np.bincount(lead[ok], minlength=B)[:B]
        return bool(
            (m_b > self.broker_hi).any()
            or (m_b < self.broker_lo).any()
            or (lcnt > self.leader_hi).any()
            or (lcnt < self.leader_lo).any()
        )

    def certify_optimal(self, *a, **k):
        """Delegates to ``models.bounds.certify_optimal`` (the bound/
        reseat machinery lives outside the data model)."""
        from . import bounds
        return bounds.certify_optimal(self, *a, **k)

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
