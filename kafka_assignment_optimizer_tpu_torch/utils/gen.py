"""Synthetic scenario generators: the port's copy of the scenario
catalogue (``SCENARIOS``) at its published sizes.

- ``demo``          the upstream README example (golden: exactly 1 move);
- ``scale_out``     56 -> 64 brokers / 4 racks / 8k partitions RF 3;
- ``decommission``  256 brokers / 8 racks / 10k partitions RF 3, drop one
  broker (the headline scenario; the bound is tight);
- ``rf_change``     RF 2 -> 3 across 1k partitions on 32 brokers / 4 racks;
- ``leader_only``   128 brokers / 8 racks / 5k partitions, leader skew
  only: 0 replica moves;
- ``adversarial``   256 brokers / 8 racks / 10k partitions, half the
  topics at RF 2 and half at RF 4, member sets drawn by seeded shuffle,
  one broker decommissioned — the at-scale row that reaches the sweep
  engine;
- ``jumbo``, ``adv50k``  ``decommission`` and ``adversarial`` grown to
  512 brokers / 16 racks / 50k partitions;
- ``ultra_jumbo``   an AZ/rack-structured decommission (200k partitions
  at its default size), the decomposed solve's family;
- ``messy_case``    a small irregular cluster (the portfolio's test).

Copied from ``kafka_assignment_optimizer_tpu.utils.gen``; the same seed
and sizes give the same scenario in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..models.cluster import (
    Assignment,
    PartitionAssignment,
    Topology,
    demo_assignment,
    demo_broker_list,
    demo_topology,
)

@dataclass
class Scenario:
    """One benchmark configuration: the optimizer's full input tuple plus
    bookkeeping the harness uses to judge plan quality."""

    name: str
    current: Assignment
    broker_list: list[int]
    topology: Topology
    target_rf: int | None = None
    # a provable lower bound on replica moves for any feasible plan; when
    # ``lb_tight`` the bound is known achievable, so the harness's quality
    # gate requires moves == min_moves_lb (e.g. leader_only: exactly 0)
    min_moves_lb: int = 0
    lb_tight: bool = False
    notes: str = ""

    @property
    def kwargs(self) -> dict:
        return dict(
            current=self.current,
            broker_list=self.broker_list,
            topology=self.topology,
            target_rf=self.target_rf,
        )


def _rack_interleaved(broker_ids: list[int], topology: Topology) -> list[int]:
    """Order brokers round-robin across racks."""
    by_rack: dict[str, list[int]] = {}
    for b in broker_ids:
        by_rack.setdefault(topology.rack(b), []).append(b)
    lanes = [sorted(v) for _, v in sorted(by_rack.items())]
    out: list[int] = []
    i = 0
    while len(out) < len(broker_ids):
        for lane in lanes:
            if i < len(lane):
                out.append(lane[i])
        i += 1
    return out


def balanced_assignment(
    broker_ids: list[int],
    topology: Topology,
    topics: dict[str, int],
    rf: int,
) -> Assignment:
    """Rack-diverse, balanced placement (see module docstring).

    Replica slots are filled *sequentially* through the rack-interleaved
    order — replica g lands on ``order[g % B]`` — so per-broker totals are
    exactly floor/ceil(R_tot/B) and per-rack totals exactly proportional,
    whatever P and B are. The leader of each partition is then chosen
    greedily as its least-leading replica, keeping leader counts inside
    the floor/ceil band too: the generated current assignments are fully
    feasible steady states."""
    order = _rack_interleaved(broker_ids, topology)
    B = len(order)
    lcnt = {b: 0 for b in broker_ids}
    parts = []
    g = 0
    for topic, n_parts in topics.items():
        for p in range(n_parts):
            reps = [order[(g + s) % B] for s in range(rf)]
            g += rf
            lead = min(reps, key=lambda b: (lcnt[b], b))
            lcnt[lead] += 1
            reps = [lead] + [b for b in reps if b != lead]
            parts.append(
                PartitionAssignment(topic=topic, partition=p, replicas=reps)
            )
    return Assignment(partitions=parts)


def _mod_topology(broker_ids: list[int], n_racks: int) -> Topology:
    return Topology.from_dict(
        {str(b): f"rack{b % n_racks}" for b in broker_ids}
    )


def demo() -> Scenario:
    """The upstream README's worked example
    (``README.md:27-91``): 20 brokers, even/odd AZs, 10 partitions RF=2,
    decommission broker 19. Known optimum: exactly 1 replica move."""
    return Scenario(
        name="demo",
        current=demo_assignment(),
        broker_list=demo_broker_list(),  # 0..18 (19 removed)
        topology=demo_topology(),
        min_moves_lb=1,
        lb_tight=True,
        notes="golden: optimal plan moves exactly 1 replica (README.md:85-91)",
    )


def scale_out(
    n_old: int = 56, n_new: int = 64, n_racks: int = 4,
    n_topics: int = 200, parts_per_topic: int = 40, rf: int = 3,
) -> Scenario:
    """Scale-out rebalance: cluster grew from 56 to 64
    brokers; rebalance so the 8 empty brokers take their share."""
    new_list = list(range(n_new))
    topo = _mod_topology(new_list, n_racks)
    current = balanced_assignment(
        list(range(n_old)), topo, {f"t{i}": parts_per_topic for i in range(n_topics)}, rf
    )
    # every replica the new brokers must absorb is one unavoidable move:
    # any feasible plan gives each broker >= floor(R/B) replicas
    r_tot = n_topics * parts_per_topic * rf
    lb = (n_new - n_old) * (r_tot // n_new)
    return Scenario(
        name="scale_out",
        current=current,
        broker_list=new_list,
        topology=topo,
        min_moves_lb=lb,
        notes=f"add {n_new - n_old} brokers; each must reach floor(R/B) replicas",
    )


def decommission(
    n_brokers: int = 256, n_racks: int = 8,
    n_topics: int = 100, parts_per_topic: int = 100, rf: int = 3,
    remove: int | None = None,
) -> Scenario:
    """The headline scenario: 256 brokers,
    8 racks, 10k partitions RF=3, single-broker decommission. Minimum moves
    = the replicas hosted on the removed broker (each must land somewhere
    else; nothing else is forced to move since remaining-broker bands stay
    satisfiable)."""
    all_brokers = list(range(n_brokers))
    remove = n_brokers - 1 if remove is None else remove
    topo = _mod_topology(all_brokers, n_racks)
    current = balanced_assignment(
        all_brokers, topo, {f"t{i}": parts_per_topic for i in range(n_topics)}, rf
    )
    lb = sum(
        1 for p in current.partitions for b in p.replicas if b == remove
    )
    return Scenario(
        name="decommission",
        current=current,
        broker_list=[b for b in all_brokers if b != remove],
        topology=topo,
        min_moves_lb=lb,
        lb_tight=True,
        notes=f"drop broker {remove}; it hosts {lb} replicas -> min {lb} moves",
    )


def rf_change(
    n_brokers: int = 32, n_racks: int = 4,
    n_topics: int = 10, parts_per_topic: int = 100, rf_old: int = 2, rf_new: int = 3,
) -> Scenario:
    """Replication-factor increase 2->3 under strict
    rack diversity (the reference's RF-change use case, README.md:8-10).
    Every partition gains rf_new - rf_old replicas; each is a move."""
    brokers = list(range(n_brokers))
    topo = _mod_topology(brokers, n_racks)
    current = balanced_assignment(
        brokers, topo, {f"t{i}": parts_per_topic for i in range(n_topics)}, rf_old
    )
    n_parts = n_topics * parts_per_topic
    return Scenario(
        name="rf_change",
        current=current,
        broker_list=brokers,
        topology=topo,
        target_rf=rf_new,
        min_moves_lb=n_parts * (rf_new - rf_old),
        lb_tight=True,
        notes="each partition must gain one replica on a new broker",
    )


def leader_only(
    n_brokers: int = 128, n_racks: int = 8,
    n_topics: int = 50, parts_per_topic: int = 100, rf: int = 3,
) -> Scenario:
    """Leader-only rebalance: replicas are perfectly
    placed but leadership is skewed onto a subset of brokers. The optimal
    plan fixes leader balance with in-place leader swaps: ZERO replica
    moves. Exercises the engine's lswap move type in isolation."""
    brokers = list(range(n_brokers))
    topo = _mod_topology(brokers, n_racks)
    base = balanced_assignment(
        brokers, topo, {f"t{i}": parts_per_topic for i in range(n_topics)}, rf
    )
    # skew leadership: make the replica with the smallest (id mod 16)
    # residue the leader — leaders pile onto low-residue brokers while the
    # replica *sets* stay balanced and rack-diverse
    parts = []
    for p in base.partitions:
        reps = sorted(p.replicas, key=lambda b: (b % 16, b))
        parts.append(
            PartitionAssignment(topic=p.topic, partition=p.partition, replicas=reps)
        )
    return Scenario(
        name="leader_only",
        current=Assignment(partitions=parts),
        broker_list=brokers,
        topology=topo,
        min_moves_lb=0,
        lb_tight=True,
        notes="optimal plan has 0 replica moves, only leader swaps",
    )


def _scatter_assignment(
    broker_ids: list[int],
    topology: Topology,
    topic_rf: list[tuple[str, int, int]],
    rng,
) -> Assignment:
    """Exactly balanced but SHUFFLED placement: per-broker totals are
    floor/ceil(R/B) and every partition is rack-diverse, yet member
    sets are drawn by seeded shuffle so essentially every partition is
    its own symmetry class (the opposite of ``balanced_assignment``'s
    round-robin windows, which collapse 50-500x under
    ``_member_classes``). ``topic_rf`` is [(topic, n_parts, rf)]."""
    B = len(broker_ids)
    rack = {b: topology.rack(b) for b in broker_ids}
    rfs = [rf for _, n, rf in topic_rf for _ in range(n)]
    R = sum(rfs)
    lo, n_hi = R // B, R % B
    counts = {b: lo for b in broker_ids}
    # ceil brokers spread rack-interleaved so rack totals stay balanced
    for b in _rack_interleaved(broker_ids, topology)[:n_hi]:
        counts[b] += 1
    supply = [b for b in broker_ids for _ in range(counts[b])]
    rng.shuffle(supply)
    starts = [0]
    for r in rfs:
        starts.append(starts[-1] + r)
    # forward repair: ensure each partition's slots are distinct
    # brokers in distinct racks, swapping offenders with any later slot
    # that fits (later partitions are untouched regions, so a forward
    # swap can only be re-examined, never silently corrupted)
    n_slots = len(supply)
    for p in range(len(rfs)):
        s, e = starts[p], starts[p + 1]
        for j in range(s, e):
            used_b = set(supply[s:j])
            used_r = {rack[x] for x in supply[s:j]}
            if supply[j] not in used_b and rack[supply[j]] not in used_r:
                continue
            for k in range(e, n_slots):
                if (supply[k] not in used_b
                        and rack[supply[k]] not in used_r):
                    supply[j], supply[k] = supply[k], supply[j]
                    break
            else:
                # tail starvation: trade with an earlier partition where
                # both stay valid (rare; seeded, so exercised in tests)
                if not _backward_slot_trade(
                    supply, starts, rfs, rack, p, j
                ):
                    raise RuntimeError(
                        "scatter repair failed; change the seed"
                    )
    # leaders: greedy least-loaded, then rebalanced into the band that
    # is valid BOTH before and after any single-broker removal
    n_p = len(rfs)
    reps = [supply[starts[p]:starts[p + 1]] for p in range(n_p)]
    lcnt = {b: 0 for b in broker_ids}
    leads = []
    for rr in reps:
        ld = min(rr, key=lambda b: (lcnt[b], b))
        lcnt[ld] += 1
        leads.append(ld)
    if B > 1:
        # the surviving-cluster floor is the stricter target, but it is
        # only reachable when B brokers can all carry it
        lo_t = n_p // (B - 1)
        if lo_t * B > n_p:
            lo_t = n_p // B
        # ceil(n_p/B) is the stricter (pre-removal) ceiling of the two
        hi_t = max(-(-n_p // B), lo_t)
    else:
        lo_t = hi_t = n_p
    def promote(p, nb):
        lcnt[leads[p]] -= 1
        lcnt[nb] += 1
        leads[p] = nb

    for _ in range(4 * n_p):
        if all(lo_t <= lcnt[b] <= hi_t for b in broker_ids):
            break
        changed = False
        for p, rr in enumerate(reps):
            ld = leads[p]
            if lcnt[ld] > hi_t:
                cand = [b for b in rr if lcnt[b] < hi_t]
            elif lcnt[ld] > lo_t:
                cand = [b for b in rr if lcnt[b] < lo_t]
            else:
                continue
            if cand:
                promote(p, min(cand, key=lambda b: (lcnt[b], b)))
                changed = True
        if all(lo_t <= lcnt[b] <= hi_t for b in broker_ids):
            break
        if changed:
            continue
        # single promotions are stuck: augment through an at-bound
        # intermediary W (U gains via A, W compensates via B — the
        # 2-hop chains some seeds need when every deficit broker only
        # appears in partitions whose leaders sit exactly on a bound)
        contains: dict[int, list[int]] = {b: [] for b in broker_ids}
        for p, rr in enumerate(reps):
            for b in rr:
                contains[b].append(p)
        for U in [b for b in broker_ids if lcnt[b] < lo_t]:
            done = False
            for A in contains[U]:
                W = leads[A]
                for Bp in contains[W]:
                    V = leads[Bp]
                    if V != W and lcnt[V] > lo_t:
                        promote(Bp, W)  # W compensates first
                        promote(A, U)
                        done = changed = True
                        break
                if done:
                    break
        for V in [b for b in broker_ids if lcnt[b] > hi_t]:
            done = False
            for Bp in [p for p in range(n_p) if leads[p] == V]:
                for W in reps[Bp]:
                    if W == V:
                        continue
                    for A in [p for p in contains[W] if leads[p] == W]:
                        X = [b for b in reps[A]
                             if b != W and lcnt[b] < hi_t]
                        if X:
                            promote(A, min(X))  # W sheds first
                            promote(Bp, W)
                            done = changed = True
                            break
                    if done:
                        break
                if done:
                    break
        if not changed:
            raise RuntimeError(
                "leader rebalance stalled; change the seed"
            )
    if not all(lo_t <= lcnt[b] <= hi_t for b in broker_ids):
        raise RuntimeError("leader rebalance did not converge")
    parts = []
    i = 0
    for topic, n, _rf in topic_rf:
        for p in range(n):
            rr = reps[i]
            ld = leads[i]
            parts.append(PartitionAssignment(
                topic=topic, partition=p,
                replicas=[ld] + [b for b in rr if b != ld],
            ))
            i += 1
    return Assignment(partitions=parts)


def _backward_slot_trade(supply, starts, rfs, rack, p, j) -> bool:
    """Swap ``supply[j]`` with a slot of an earlier partition such that
    both partitions end up valid. Returns True on success."""
    s, e = starts[p], starts[p + 1]
    used_b = set(supply[s:j])
    used_r = {rack[x] for x in supply[s:j]}
    for q in range(p):
        qs, qe = starts[q], starts[q + 1]
        for k in range(qs, qe):
            cand = supply[k]
            if cand in used_b or rack[cand] in used_r:
                continue
            q_others = [supply[x] for x in range(qs, qe) if x != k]
            give = supply[j]
            if give in q_others:
                continue
            if rack[give] in {rack[x] for x in q_others}:
                continue
            supply[j], supply[k] = supply[k], supply[j]
            return True
    return False


def adversarial(
    n_brokers: int = 256, n_racks: int = 8,
    n_topics_low: int = 50, n_topics_high: int = 50,
    parts_per_topic: int = 100, rf_low: int = 2, rf_high: int = 4,
    seed: int = 7,
) -> Scenario:
    """Constructor-proof decommission at headline scale: 256 brokers / 8
    racks / 10k partitions with per-partition RF asymmetry (half the
    topics RF=2, half RF=4) and seeded-shuffled member sets, so every
    partition is its own symmetry class and caps stay slack. The sweep
    annealer has to close to the bound on the device: this row is the
    at-scale exercise of the search engine, not of a host constructor."""
    import numpy as _np

    all_brokers = list(range(n_brokers))
    remove = n_brokers - 1
    topo = _mod_topology(all_brokers, n_racks)
    topic_rf = (
        [(f"lo{i}", parts_per_topic, rf_low)
         for i in range(n_topics_low)]
        + [(f"hi{i}", parts_per_topic, rf_high)
           for i in range(n_topics_high)]
    )
    current = _scatter_assignment(
        all_brokers, topo, topic_rf, _np.random.default_rng(seed)
    )
    lb = sum(
        1 for p in current.partitions for b in p.replicas if b == remove
    )
    return Scenario(
        name="adversarial",
        current=current,
        broker_list=[b for b in all_brokers if b != remove],
        topology=topo,
        min_moves_lb=lb,
        lb_tight=True,
        notes=(
            f"shuffled mixed-RF decommission of broker {remove} "
            f"({lb} replicas): every partition its own symmetry class, "
            "caps slack -> annealer must close to the bound on-chip"
        ),
    )


def jumbo(
    n_brokers: int = 512, n_racks: int = 16,
    n_topics: int = 250, parts_per_topic: int = 200, rf: int = 3,
) -> Scenario:
    """Beyond the north star: 512 brokers / 16 racks / 50k partitions
    RF=3 decommission — 5x the headline's partition count (150k replica
    slots). It exists to demonstrate the sweep
    engine's scaling headroom past the size that motivated the rebuild
    (per-sweep work is O(chains * partitions); sequential depth stays
    flat)."""
    sc = decommission(n_brokers=n_brokers, n_racks=n_racks,
                      n_topics=n_topics, parts_per_topic=parts_per_topic,
                      rf=rf)
    return replace(
        sc, name="jumbo",
        notes=f"{n_brokers}b/{n_topics * parts_per_topic}-part "
              f"decommission; {sc.notes}",
    )


def adv50k(
    n_brokers: int = 512, n_racks: int = 16,
    n_topics_low: int = 126, n_topics_high: int = 124,
    parts_per_topic: int = 200, seed: int = 7,
) -> Scenario:
    """Constructor-proof at JUMBO scale: the adversarial shuffled
    mixed-RF decommission grown to 512 brokers / 16 racks / 50k
    partitions (149,600 replica slots — jumbo's size with adversarial's
    asymmetry). The 126/124 topic split keeps the broker bands
    removal-invariant ([292, 292] both sides; leaders [97, 98] both),
    so caps stay slack. ~147k symmetry classes over ~149k members, so
    the aggregated MILP refuses, and the sweep annealer must close to
    the bound ladder on the device at 5x the headline scale — the proof that
    the search engine's flat sequential depth survives where the host
    constructors cannot follow."""
    sc = adversarial(
        n_brokers=n_brokers, n_racks=n_racks,
        n_topics_low=n_topics_low, n_topics_high=n_topics_high,
        parts_per_topic=parts_per_topic, seed=seed,
    )
    return replace(
        sc, name="adv50k",
        notes=(f"{n_brokers}b/"
               f"{(n_topics_low + n_topics_high) * parts_per_topic}-part "
               f"shuffled mixed-RF decommission; {sc.notes}"),
    )


def ultra_jumbo(
    n_az: int = 4, racks_per_az: int = 4, base_brokers: int = 8,
    partitions: int = 200_000, rf: int = 3, cross_frac: float = 0.02,
    seed: int = 0,
) -> Scenario:
    """The decomposed solve's instance family: an AZ/rack-structured
    decommission sized past any flat bucket (default 200k partitions,
    600k replica slots). Racks are heterogeneous (``base + r`` brokers
    for rack ``r``) but the rack-size *multiset is identical across
    AZs*, and the decommission removes one rack-0 broker per AZ — so
    every AZ keeps the same (brokers, racks) shape and the decomposed
    map phase can stack all AZ sub-instances as the lanes of ONE lane
    ladder (docs/DECOMPOSE.md). Most partitions live entirely
    inside one AZ (per-AZ balanced topic blocks); a ``cross_frac``
    sliver of partitions is placed with each replica in a *different*
    AZ — the boundary family the reduce phase must reconcile."""
    if rf > n_az:
        raise ValueError(f"ultra_jumbo needs rf <= n_az ({rf} > {n_az})")
    if racks_per_az <= rf:
        # ceil(rf/K) pins part_rack_hi at 1 for big K: a group with
        # only rf racks would force every partition onto ALL of them,
        # colliding with the proportional rack bands
        raise ValueError(
            f"ultra_jumbo needs racks_per_az > rf "
            f"({racks_per_az} <= {rf})")
    # heterogeneous but FLAT rack sizes (base+0..base+racks-1): per-AZ
    # rack-band admissibility needs the largest rack <= B_az/rf once
    # part_rack_hi == 1 (docs/DECOMPOSE.md "split criteria")
    rack_sizes = [base_brokers + r for r in range(racks_per_az)]
    rack_of: dict[str, str] = {}
    az_brokers: list[list[int]] = []
    removed: list[int] = []
    bid = 0
    for g in range(n_az):
        mine: list[int] = []
        for r, sz in enumerate(rack_sizes):
            for _ in range(sz):
                rack_of[str(bid)] = f"az{g}-rack{r}"
                mine.append(bid)
                bid += 1
        az_brokers.append(mine)
        removed.append(mine[base_brokers - 1])  # last rack-0 broker
    topo = Topology.from_dict(rack_of)
    all_brokers = [b for mine in az_brokers for b in mine]

    cross = int(partitions * cross_frac)
    per_az = (partitions - cross) // n_az
    cross = partitions - per_az * n_az  # exact total
    parts: list[PartitionAssignment] = []
    for g in range(n_az):
        blk = balanced_assignment(
            az_brokers[g], topo, {f"az{g}": per_az}, rf
        )
        parts.extend(blk.partitions)
    # boundary family: replica j of cross partition p lives in AZ
    # (seed + p + j) % n_az, walking each AZ's rack-interleaved order —
    # every replica a distinct AZ (hence a distinct rack)
    orders = [_rack_interleaved(mine, topo) for mine in az_brokers]
    for p in range(cross):
        reps = [
            orders[(seed + p + j) % n_az][(p * rf + j) % len(orders[0])]
            for j in range(rf)
        ]
        parts.append(
            PartitionAssignment(topic="xaz", partition=p, replicas=reps)
        )
    current = Assignment(partitions=parts)
    gone = set(removed)
    lb = sum(1 for pa in current.partitions for b in pa.replicas
             if b in gone)
    return Scenario(
        name="ultra_jumbo",
        current=current,
        broker_list=[b for b in all_brokers if b not in gone],
        topology=topo,
        min_moves_lb=lb,
        notes=(
            f"{len(all_brokers)}b/{n_az}az/{partitions}-part AZ-structured "
            f"decommission of one broker per AZ ({lb} replicas), "
            f"{cross} cross-AZ boundary partitions"
        ),
    )


def ultra_jumbo_case(seed: int = 0, partitions: int = 200_000) -> Scenario:
    """The AZ-structured ultra-jumbo decommission at the requested size
    (200,000 partitions: 4 AZs x 4 racks of 8-11 brokers, 152 brokers,
    one rack-0 broker per AZ decommissioned, RF 3, 4,000 cross-AZ
    partitions), seeded for reproducible boundary placement. Tests and
    chip_smoke.py both use this wrapper, so the decomposed path is
    always measured on the same family."""
    return ultra_jumbo(partitions=partitions, seed=seed)


def messy_cluster(rng):
    """One deliberately irregular cluster: several topics with different
    partition counts and RFs, a lopsided rack map (rack 0 holds about
    half the brokers; exact bands with single-broker racks are common),
    and a broker list that may both drop and add brokers. Returns
    ``(current, broker_list, topology, target_rf)``."""
    n_brokers = int(rng.integers(6, 16))
    n_topics = int(rng.integers(1, 4))
    parts = []
    for t in range(n_topics):
        rf = int(rng.integers(1, min(4, n_brokers) + 1))
        for p in range(int(rng.integers(2, 9))):
            reps = rng.choice(n_brokers, size=rf, replace=False)
            parts.append(PartitionAssignment(
                f"topic-{t}", p, [int(b) for b in reps]
            ))
    n_racks = int(rng.integers(1, 4))
    add = int(rng.integers(0, 3))
    all_ids = list(range(n_brokers + add))
    rack_of = {
        b: f"rack{0 if b % 4 < 2 else (b % n_racks)}" for b in all_ids
    }
    drop = int(rng.integers(0, 2))
    brokers = all_ids[drop:]
    target_rf = None
    if rng.random() < 0.3:
        target_rf = int(rng.integers(1, 4))
    return (Assignment(partitions=parts), brokers,
            Topology(rack_of=rack_of), target_rf)


def messy_case(seed: int = 0):
    """:func:`messy_cluster` seeded with ``default_rng(2000 + seed)``;
    ``messy_case(1)`` is the exact-band case on which the portfolio's
    plan differs from the solo solve's."""
    import numpy as _np

    return messy_cluster(_np.random.default_rng(2000 + int(seed)))


SCENARIOS = {
    "demo": demo,
    "scale_out": scale_out,
    "decommission": decommission,
    "rf_change": rf_change,
    "leader_only": leader_only,
    "adversarial": adversarial,
    "adv50k": adv50k,
    "jumbo": jumbo,
    "ultra_jumbo": ultra_jumbo,
}

# shrunk per-scenario kwargs for quick CPU runs: the single source of
# truth shared by the tests and ops.bench_kernel, so a scenario solve and
# the kernel bench measure the same instance
SMOKE_KWARGS = {
    "demo": dict(),
    "scale_out": dict(n_old=12, n_new=16, n_topics=8, parts_per_topic=10),
    "decommission": dict(n_brokers=32, n_topics=8, parts_per_topic=25),
    "rf_change": dict(n_brokers=16, n_topics=4, parts_per_topic=25),
    "leader_only": dict(n_brokers=32, n_topics=8, parts_per_topic=25),
    "adversarial": dict(n_brokers=32, n_topics_low=11, n_topics_high=9,
                        parts_per_topic=10),
    "adv50k": dict(n_brokers=48, n_topics_low=6, n_topics_high=6,
                   parts_per_topic=10),
    "jumbo": dict(n_brokers=48, n_topics=10, parts_per_topic=40),
    "ultra_jumbo": dict(n_az=3, racks_per_az=4, partitions=600),
}
