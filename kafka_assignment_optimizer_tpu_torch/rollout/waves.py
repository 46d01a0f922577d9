"""Bandwidth-budgeted move waves (docs/ROLLOUT.md).

A certified plan is a *destination*; the cluster has to copy real data
to get there. This module decomposes the move diff between the current
assignment and the plan into ordered **waves** — partial reassignments
applied one at a time — such that within any single wave no broker and
no rack exceeds a per-wave transfer cap. Wave packing is itself an
assignment problem over the move graph (moves are nodes, shared
brokers/racks are capacity edges), the same structure the lane engine
scores as energies, so two packers share one accounting model:

- ``greedy`` — the host reference packer: first-fit-decreasing over the
  move list, deterministic, always available;
- ``scored`` — opt-in (``packer="scored"`` / ``KAO_ROLLOUT_PACKER``):
  races ``lanes`` diverse move orderings through the same first-fit
  core (the portfolio-lane idiom applied host-side) and keeps the
  packing minimizing ``makespan x peak per-wave cross-rack traffic``.
  Lane 0 is always the greedy order, so the scored packer can never do
  worse than the reference it replaces.

Transfer model (the bandwidth-cap contract, docs/ROLLOUT.md): one
**transfer unit** is one replica copy of one partition. A replica added
to broker ``b`` charges 1 inbound unit to ``b`` (and to ``b``'s rack)
and 1 outbound unit to the move's **source** — the partition's current
leader, which streams the copy. A partition with an empty current
replica list (declared but never placed: ``partition_growth``) has no
source; its initial copies charge inbound only. Replica removals and
leader-only changes are metadata, zero units. Broker load is
``inbound + outbound`` (NICs are full-duplex but the replication
fetcher pool is not); rack load counts inbound units only.

Caps are **fields of the plan** (:class:`WaveCaps`), never module
constants: every wave records the caps it was packed under, and a cap
below the largest single move's own demand is raised to it (recorded
as ``raised``) — a single partition's copy can never be split across
waves.

Within a wave, moves that change the partition's leader are ordered
LAST: the data copies land first, leadership flips at the tail, so a
wave aborted midway has moved bytes but not traffic leadership.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..models.cluster import Assignment, Topology

__all__ = [
    "Move", "Wave", "WaveCaps", "WavePlan", "moves_of", "pack_waves",
    "DEFAULT_BROKER_CAP", "DEFAULT_RACK_CAP", "DEFAULT_LANES",
]

DEFAULT_BROKER_CAP = 4
DEFAULT_RACK_CAP = 16
DEFAULT_LANES = 8


@dataclass(frozen=True)
class Move:
    """One partition's transition from its current replica list to the
    plan's. ``adds`` are the replica copies the cluster must stream
    (the transfer units); ``source`` is the current leader that streams
    them (None for an initial placement)."""

    topic: str
    partition: int
    old: tuple[int, ...]
    new: tuple[int, ...]
    adds: tuple[int, ...]
    source: int | None
    leader_changed: bool

    @property
    def cost(self) -> int:
        return len(self.adds)

    def to_dict(self) -> dict:
        return {
            "topic": self.topic, "partition": self.partition,
            "old": list(self.old), "new": list(self.new),
            "adds": list(self.adds), "source": self.source,
            "leader_changed": self.leader_changed,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Move":
        return cls(
            topic=str(d["topic"]), partition=int(d["partition"]),
            old=tuple(int(b) for b in d["old"]),
            new=tuple(int(b) for b in d["new"]),
            adds=tuple(int(b) for b in d["adds"]),
            source=(None if d.get("source") is None
                    else int(d["source"])),
            leader_changed=bool(d["leader_changed"]),
        )


@dataclass(frozen=True)
class WaveCaps:
    """Per-wave transfer caps, in transfer units (replica copies).
    Carried as plan fields so every wave records the contract it was
    packed under; ``raised`` notes the caps were lifted to admit the
    largest single move."""

    broker: int = DEFAULT_BROKER_CAP
    rack: int = DEFAULT_RACK_CAP
    raised: bool = False

    def to_dict(self) -> dict:
        return {"broker": self.broker, "rack": self.rack,
                "raised": self.raised}

    @classmethod
    def from_dict(cls, d: dict) -> "WaveCaps":
        return cls(broker=int(d["broker"]), rack=int(d["rack"]),
                   raised=bool(d.get("raised", False)))


@dataclass
class Wave:
    """One wave: the moves it applies (data moves first, leader-
    changing moves last) and its transfer accounting."""

    index: int
    moves: list[Move] = field(default_factory=list)
    broker_load: dict[int, int] = field(default_factory=dict)
    rack_load: dict[str, int] = field(default_factory=dict)
    cross_rack: int = 0

    @property
    def peak_broker(self) -> int:
        return max(self.broker_load.values(), default=0)

    @property
    def peak_rack(self) -> int:
        return max(self.rack_load.values(), default=0)

    @property
    def data_units(self) -> int:
        return sum(m.cost for m in self.moves)

    def ordered_moves(self) -> list[Move]:
        """Leader moves LAST within the wave (stable otherwise)."""
        return sorted(self.moves,
                      key=lambda m: (bool(m.leader_changed),))

    def targets(self) -> list[tuple[str, int, list[int]]]:
        """(topic, partition, target replicas) in emission order."""
        return [(m.topic, m.partition, list(m.new))
                for m in self.ordered_moves()]

    def to_dict(self) -> dict:
        return {
            "index": self.index,
            "moves": [m.to_dict() for m in self.ordered_moves()],
            "broker_load": {str(b): n
                            for b, n in sorted(self.broker_load.items())},
            "rack_load": dict(sorted(self.rack_load.items())),
            "cross_rack": self.cross_rack,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Wave":
        return cls(
            index=int(d["index"]),
            moves=[Move.from_dict(m) for m in d["moves"]],
            broker_load={int(b): int(n)
                         for b, n in d.get("broker_load", {}).items()},
            rack_load={str(r): int(n)
                       for r, n in d.get("rack_load", {}).items()},
            cross_rack=int(d.get("cross_rack", 0)),
        )


@dataclass
class WavePlan:
    """The packed schedule: waves in application order, the caps they
    honor, and the packer's provenance."""

    waves: list[Wave]
    caps: WaveCaps
    packer: str = "greedy"
    lanes_raced: int = 1
    winner_lane: int = 0

    @property
    def makespan(self) -> int:
        return len(self.waves)

    @property
    def peak_broker(self) -> int:
        return max((w.peak_broker for w in self.waves), default=0)

    @property
    def peak_rack(self) -> int:
        return max((w.peak_rack for w in self.waves), default=0)

    @property
    def peak_cross_rack(self) -> int:
        return max((w.cross_rack for w in self.waves), default=0)

    @property
    def score(self) -> int:
        """makespan x peak per-wave cross-rack traffic (the scored
        packer's objective; total cross-rack units are invariant to the
        packing — the PEAK is what saturates inter-rack links)."""
        return self.makespan * max(self.peak_cross_rack, 1)

    def to_dict(self) -> dict:
        return {
            "waves": [w.to_dict() for w in self.waves],
            "caps": self.caps.to_dict(),
            "packer": self.packer,
            "lanes_raced": self.lanes_raced,
            "winner_lane": self.winner_lane,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WavePlan":
        return cls(
            waves=[Wave.from_dict(w) for w in d["waves"]],
            caps=WaveCaps.from_dict(d["caps"]),
            packer=str(d.get("packer", "greedy")),
            lanes_raced=int(d.get("lanes_raced", 1)),
            winner_lane=int(d.get("winner_lane", 0)),
        )


def moves_of(current: Assignment, target: Assignment) -> list[Move]:
    """The move list between two assignments, sorted by key. Partitions
    only the plan knows are initial placements (empty ``old``);
    partitions only the current assignment knows are left alone (the
    plan does not speak for them)."""
    cur_by = current.by_key()
    out: list[Move] = []
    for p in sorted(target.partitions, key=lambda x: (x.topic, x.partition)):
        olds = cur_by.get(p.key)
        old = tuple(olds.replicas) if olds else ()
        new = tuple(p.replicas)
        if old == new:
            continue
        adds = tuple(b for b in new if b not in set(old))
        out.append(Move(
            topic=p.topic, partition=p.partition, old=old, new=new,
            adds=adds, source=(old[0] if old else None),
            leader_changed=bool(old and new and old[0] != new[0]),
        ))
    return out


def _move_demand(m: Move, rack_of) -> tuple[dict, dict, int]:
    """One move's own (broker_load, rack_load, cross_rack) demand."""
    bl: dict[int, int] = {}
    rl: dict[str, int] = {}
    cross = 0
    for b in m.adds:
        bl[b] = bl.get(b, 0) + 1
        r = rack_of(b)
        rl[r] = rl.get(r, 0) + 1
        if m.source is not None:
            bl[m.source] = bl.get(m.source, 0) + 1
            if rack_of(m.source) != r:
                cross += 1
    return bl, rl, cross


def _fits(wave: Wave, bl: dict, rl: dict, caps: WaveCaps) -> bool:
    return all(
        wave.broker_load.get(b, 0) + n <= caps.broker
        for b, n in bl.items()
    ) and all(
        wave.rack_load.get(r, 0) + n <= caps.rack for r, n in rl.items()
    )


def _first_fit(moves: list[Move], caps: WaveCaps, rack_of) -> list[Wave]:
    """First-fit over ``moves`` in the given order: each data move
    lands in the earliest wave whose caps still admit its demand.
    Zero-cost (leader-only / remove-only) moves ride the LAST wave —
    they are metadata and must not open waves of their own."""
    waves: list[Wave] = []
    meta: list[Move] = []
    for m in moves:
        bl, rl, cross = _move_demand(m, rack_of)
        if not bl:
            meta.append(m)
            continue
        placed = False
        for w in waves:
            if _fits(w, bl, rl, caps):
                placed = True
                break
        if not placed:
            w = Wave(index=len(waves))
            waves.append(w)
        w.moves.append(m)
        for b, n in bl.items():
            w.broker_load[b] = w.broker_load.get(b, 0) + n
        for r, n in rl.items():
            w.rack_load[r] = w.rack_load.get(r, 0) + n
        w.cross_rack += cross
    if meta:
        if not waves:
            waves.append(Wave(index=0))
        waves[-1].moves.extend(meta)
    return waves


def _orderings(moves: list[Move], lanes: int, seed: int,
               rack_of) -> list[tuple[str, list[Move]]]:
    """The scored packer's lane orderings. Lane 0 is the greedy
    reference order (cost-descending first fit), so the race can never
    lose to the packer it replaces; the rest spread sources, front-load
    cross-rack copies, and explore seeded shuffles."""
    idx = list(range(len(moves)))
    ffd = sorted(idx, key=lambda i: (-moves[i].cost, moves[i].topic,
                                     moves[i].partition))
    lanes_out: list[tuple[str, list[Move]]] = [
        ("greedy", [moves[i] for i in ffd]),
    ]
    if lanes > 1:
        cross_first = sorted(idx, key=lambda i: (
            -_move_demand(moves[i], rack_of)[2], -moves[i].cost,
            moves[i].topic, moves[i].partition,
        ))
        lanes_out.append(("cross_first", [moves[i] for i in cross_first]))
    if lanes > 2:
        # round-robin over source brokers: consecutive moves never
        # share a source, so first fit spreads outbound load
        by_src: dict = {}
        for i in ffd:
            by_src.setdefault(moves[i].source, []).append(i)
        rr: list[int] = []
        queues = [by_src[k] for k in sorted(
            by_src, key=lambda s: (s is None, s))]
        while queues:
            nxt = []
            for q in queues:
                rr.append(q.pop(0))
                if q:
                    nxt.append(q)
            queues = nxt
        lanes_out.append(("source_rr", [moves[i] for i in rr]))
    rng = np.random.default_rng(seed)
    for j in range(len(lanes_out), lanes):
        perm = rng.permutation(len(moves))
        lanes_out.append((f"shuffle{j}", [moves[i] for i in perm]))
    return lanes_out[:max(lanes, 1)]


def _effective_caps(moves: list[Move], caps: WaveCaps,
                    rack_of) -> WaveCaps:
    """Caps below the largest single move's own demand are raised to it
    — a single partition's copy cannot be split across waves, so the
    floor is the packing's feasibility condition."""
    need_b = need_r = 0
    for m in moves:
        bl, rl, _ = _move_demand(m, rack_of)
        need_b = max(need_b, max(bl.values(), default=0))
        need_r = max(need_r, max(rl.values(), default=0))
    b = max(int(caps.broker), 1)
    r = max(int(caps.rack), 1)
    if need_b > b or need_r > r:
        return WaveCaps(broker=max(b, need_b), rack=max(r, need_r),
                        raised=True)
    return WaveCaps(broker=b, rack=r, raised=False)


def pack_waves(current: Assignment, target: Assignment,
               topology: Topology | None = None, *,
               caps: WaveCaps | None = None,
               packer: str | None = None,
               lanes: int = DEFAULT_LANES,
               seed: int = 0,
               budget=None) -> WavePlan:
    """Decompose ``current -> target`` into a capped wave schedule.

    ``packer``: ``"greedy"`` (default) or ``"scored"`` (opt-in, also
    via ``KAO_ROLLOUT_PACKER``). ``budget`` is an optional
    :class:`~..resilience.budget.Budget`: the scored race stops early
    when it expires, keeping the best candidate packed so far (lane 0
    — the greedy reference — always completes)."""
    caps = caps or WaveCaps()
    packer = packer or os.environ.get("KAO_ROLLOUT_PACKER") or "greedy"
    if packer not in ("greedy", "scored"):
        raise ValueError(
            f"unknown wave packer {packer!r}; want 'greedy' or 'scored'"
        )
    rack_of = (topology.rack if topology is not None
               else (lambda b: "r0"))
    moves = moves_of(current, target)
    eff = _effective_caps(moves, caps, rack_of)
    if not moves:
        return WavePlan(waves=[], caps=eff, packer=packer)
    if packer == "greedy":
        order = sorted(moves, key=lambda m: (-m.cost, m.topic,
                                             m.partition))
        return WavePlan(waves=_first_fit(order, eff, rack_of), caps=eff,
                        packer="greedy")
    best: WavePlan | None = None
    orderings = _orderings(moves, max(int(lanes), 1), seed, rack_of)
    for lane, (label, order) in enumerate(orderings):
        cand = WavePlan(waves=_first_fit(order, eff, rack_of), caps=eff,
                        packer="scored", lanes_raced=len(orderings),
                        winner_lane=lane)
        if best is None or cand.score < best.score:
            best = cand
        if lane > 0 and budget is not None:
            left = budget.remaining()
            if left is not None and left <= 0.0:
                break  # keep the best candidate packed so far
    return best


def verify_caps(plan: WavePlan) -> bool:
    """Every wave within the plan's caps (the invariant tests assert
    straight off the move graph)."""
    return all(
        w.peak_broker <= plan.caps.broker
        and w.peak_rack <= plan.caps.rack
        for w in plan.waves
    )
