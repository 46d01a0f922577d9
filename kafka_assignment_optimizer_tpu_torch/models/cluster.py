"""Cluster / topology / assignment model (ingest + emit + move diff).

A copy of ``kafka_assignment_optimizer_tpu.models.cluster`` (the
reference's L0/L6 layers):

- Kafka reassignment-JSON parse/emit — the dialect shown in the reference
  demo (the upstream ``README.md:50-78``): ``{"version": 1, "partitions":
  [{"topic": ..., "partition": ..., "replicas": [brokerIds]}]}`` with the
  leader first in every replica list (``README.md:52-78``).
- Broker list + broker->rack topology ingest (``README.md:27-29, 46-48``).
- Move diff / plan-minimality report (``README.md:83-91``): the whole point
  of the optimizer is that the emitted plan moves as few replicas as
  possible.

Everything here is plain Python + numpy; device arrays only appear once a
:class:`~kafka_assignment_optimizer_tpu_torch.models.instance.ProblemInstance` is
built from these objects.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence


@dataclass(frozen=True, order=True)
class PartitionKey:
    """Identity of one partition: (topic name, partition id)."""

    topic: str
    partition: int


@dataclass
class PartitionAssignment:
    """One partition's replica list; ``replicas[0]`` is the preferred leader
    (reference demo convention, ``README.md:52-78``)."""

    topic: str
    partition: int
    replicas: list[int]

    @property
    def key(self) -> PartitionKey:
        return PartitionKey(self.topic, self.partition)

    @property
    def leader(self) -> int:
        if not self.replicas:
            raise ValueError(f"{self.topic}-{self.partition} has no replicas")
        return self.replicas[0]


@dataclass
class Assignment:
    """A full current/proposed assignment in Kafka's reassignment-JSON
    dialect (``README.md:50-63``)."""

    partitions: list[PartitionAssignment] = field(default_factory=list)
    version: int = 1

    # -- ingest ---------------------------------------------------------
    @classmethod
    def from_json(cls, text: str | bytes) -> "Assignment":
        data = json.loads(text)
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: Mapping) -> "Assignment":
        if "partitions" not in data:
            raise ValueError("reassignment JSON must contain 'partitions'")
        parts = [
            PartitionAssignment(
                topic=str(p["topic"]),
                partition=int(p["partition"]),
                replicas=[int(b) for b in p["replicas"]],
            )
            for p in data["partitions"]
        ]
        return cls(partitions=parts, version=int(data.get("version", 1)))

    # -- emit -----------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "partitions": [
                {
                    "topic": p.topic,
                    "partition": p.partition,
                    "replicas": list(p.replicas),
                }
                for p in sorted(self.partitions, key=lambda x: (x.topic, x.partition))
            ],
        }

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    # -- views ----------------------------------------------------------
    def by_key(self) -> dict[PartitionKey, PartitionAssignment]:
        return {p.key: p for p in self.partitions}

    def topics(self) -> list[str]:
        seen: dict[str, None] = {}
        for p in self.partitions:
            seen.setdefault(p.topic, None)
        return list(seen)

    def broker_ids(self) -> list[int]:
        ids: set[int] = set()
        for p in self.partitions:
            ids.update(p.replicas)
        return sorted(ids)


@dataclass
class Topology:
    """Broker -> rack (or AZ / top-of-rack switch) mapping.

    The reference demo's topology is "odd brokers in AZ b, even in AZ a"
    (``README.md:27-29``); the LP sample names racks like ``tor02``
    (``README.md:173``). A missing topology means one implicit rack.
    """

    rack_of: dict[int, str] = field(default_factory=dict)

    @classmethod
    def from_json(cls, text: str | bytes) -> "Topology":
        data = json.loads(text)
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: Mapping) -> "Topology":
        # accepted forms: {"0": "a", "1": "b"} or
        # {"racks": {"a": [0, 2], "b": [1, 3]}}
        if "racks" in data:
            rack_of: dict[int, str] = {}
            for rack, brokers in data["racks"].items():
                for b in brokers:
                    rack_of[int(b)] = str(rack)
            return cls(rack_of=rack_of)
        return cls(rack_of={int(k): str(v) for k, v in data.items()})

    @classmethod
    def even_odd(cls, broker_ids: Iterable[int], even: str = "a", odd: str = "b") -> "Topology":
        """The reference demo topology (``README.md:27-29``)."""
        return cls(rack_of={b: (even if b % 2 == 0 else odd) for b in broker_ids})

    @classmethod
    def single_rack(cls, broker_ids: Iterable[int], rack: str = "r0") -> "Topology":
        return cls(rack_of={b: rack for b in broker_ids})

    def to_dict(self) -> dict:
        return {str(b): r for b, r in sorted(self.rack_of.items())}

    def racks(self) -> list[str]:
        seen: dict[str, None] = {}
        for b in sorted(self.rack_of):
            seen.setdefault(self.rack_of[b], None)
        return list(seen)

    def rack(self, broker: int, default: str = "r0") -> str:
        return self.rack_of.get(broker, default)


def parse_broker_list(text: str) -> list[int]:
    """Parse ``--broker-list 0,1,2,...,18`` style input (``README.md:48``).

    Supports comma-separated ids and inclusive ranges (``0-18``).
    """
    out: list[int] = []
    for tok in text.replace(" ", "").split(","):
        if not tok:
            continue
        if "-" in tok and not tok.startswith("-"):
            lo, hi = tok.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(tok))
    seen: dict[int, None] = {}
    for b in out:
        seen.setdefault(b, None)
    return list(seen)


# ---------------------------------------------------------------------------
# Move diff (C15): plan minimality report
# ---------------------------------------------------------------------------


@dataclass
class MoveReport:
    """Diff between two assignments, counting real data movement.

    A *replica move* is a (partition, broker) pair present in the new plan
    but absent from the old one — each such pair implies copying the whole
    partition over the network, the cost the optimizer minimizes
    (``README.md:8-18``). Leader changes that keep the replica set intact
    are metadata-only and counted separately.
    """

    replica_moves: int
    leader_changes: int
    changed: list[PartitionKey]
    added: dict[PartitionKey, list[int]]
    removed: dict[PartitionKey, list[int]]

    def to_dict(self) -> dict:
        return {
            "replica_moves": self.replica_moves,
            "leader_changes": self.leader_changes,
            "changed_partitions": [
                {"topic": k.topic, "partition": k.partition} for k in self.changed
            ],
        }


def move_diff(old: Assignment, new: Assignment) -> MoveReport:
    old_by = old.by_key()
    new_by = new.by_key()
    replica_moves = 0
    leader_changes = 0
    changed: list[PartitionKey] = []
    added: dict[PartitionKey, list[int]] = {}
    removed: dict[PartitionKey, list[int]] = {}
    for key in sorted(set(old_by) | set(new_by)):
        olds = old_by.get(key)
        news = new_by.get(key)
        if olds is not None and news is not None \
                and olds.replicas == news.replicas:
            # identical replica list: no adds, no removes, no leader
            # change — skip the set algebra. On a 50k-partition
            # decommission ~49.7k partitions take this path, which is
            # most of move_diff's 0.7 s of host time.
            continue
        old_set = set(olds.replicas) if olds else set()
        new_set = set(news.replicas) if news else set()
        add = sorted(new_set - old_set)
        rem = sorted(old_set - new_set)
        # a partition with an empty replica list (declared but not yet
        # placed — the delta API's partition_growth) has no leader to
        # change: its initial placement is charged as replica moves
        lead_changed = bool(
            olds and news and olds.replicas and news.replicas
            and olds.replicas[0] != news.replicas[0]
        )
        if add or rem or lead_changed:
            changed.append(key)
        if add:
            added[key] = add
        if rem:
            removed[key] = rem
        replica_moves += len(add)
        leader_changes += int(lead_changed)
    return MoveReport(
        replica_moves=replica_moves,
        leader_changes=leader_changes,
        changed=changed,
        added=added,
        removed=removed,
    )


def demo_assignment() -> Assignment:
    """The reference demo's current assignment (``README.md:52-63``):
    20 brokers / 2 AZs, topic ``x.y.z.t`` with 10 partitions, RF=2."""
    replicas = [
        [7, 18], [8, 19], [9, 10], [0, 11], [1, 12],
        [2, 13], [3, 14], [4, 15], [5, 16], [6, 17],
    ]
    return Assignment(
        partitions=[
            PartitionAssignment("x.y.z.t", i, r) for i, r in enumerate(replicas)
        ]
    )


def demo_broker_list() -> list[int]:
    """Target broker list of the demo: drop broker 19 (``README.md:46-48``)."""
    return list(range(19))


def demo_topology() -> Topology:
    """Odd brokers on AZ ``b``, even on ``a`` (``README.md:27-29``)."""
    return Topology.even_odd(range(20))
