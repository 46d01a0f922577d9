"""Typed cluster-change events and their state transitions.

The delta API's vocabulary is the change sequence the source README
motivates (rolling decommissions, failure response, RF changes) made
explicit: each event is a small JSON object carrying a client ``epoch``
and a ``type``, and applying it to a :class:`ClusterState` is a PURE
function — no I/O, no solver — so fencing, replay, and the event-day
bench all reuse one transition implementation.

Grammar (``docs/WATCH.md``):

=================  ========================================================
``bootstrap``      full state: ``assignment`` (reassignment JSON),
                   ``brokers`` (list or range string), optional
                   ``topology``/``rf`` — registers or re-registers the
                   cluster
``broker_add``     ``brokers`` + optional ``racks`` (id->rack) or ``rack``
``broker_remove``  ``brokers`` — gone from the cluster (and its topology)
``broker_drain``   ``brokers`` — stays racked, must hold no replicas
``rack_fail``      ``rack`` — every broker of that rack drains at once
``partition_growth``  ``topic`` + ``add`` (+ ``rf`` for a new topic):
                   new partitions appear with EMPTY current replica
                   lists — placing them costs moves, which is honest:
                   the data copy is real
``rf_change``      ``rf``: an int for all topics or a topic->int object
=================  ========================================================

Malformed events raise :class:`EventError` (the serve layer's 400);
semantically impossible states (every broker drained, RF above the
surviving broker count) surface when the instance is built, as 422s.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, replace

from ..models.cluster import (
    Assignment,
    PartitionAssignment,
    Topology,
    parse_broker_list,
)

__all__ = [
    "EVENT_TYPES", "ClusterState", "EventError", "validate_event",
    "apply_event",
]

EVENT_TYPES = (
    "bootstrap", "broker_add", "broker_remove", "broker_drain",
    "rack_fail", "partition_growth", "rf_change",
)

# cluster ids become file names in the plan store: one conservative
# charset, validated at the door
_ID_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}")


class EventError(ValueError):
    """A malformed event (unknown type, missing/mistyped field)."""


def valid_cluster_id(cluster_id: str) -> bool:
    return isinstance(cluster_id, str) and bool(
        _ID_RE.fullmatch(cluster_id)
    )


@dataclass
class ClusterState:
    """Everything the optimizer needs to know about one named cluster,
    as of ``epoch``: the current assignment, the eligible (non-drained)
    broker list, the rack topology over ALL known brokers (drained
    brokers stay racked — they may come back), and the target RF."""

    cluster_id: str
    epoch: int
    assignment: Assignment
    brokers: list[int]
    topology: Topology | None = None
    rf: int | dict | None = None
    # brokers known to the cluster but currently drained/failed (kept
    # so a later broker_add can bring one back without re-racking it)
    drained: list[int] = field(default_factory=list)
    # bumped on every (re-)bootstrap: a solve committed against an
    # older generation must NOT merge its plan into a re-declared
    # assignment (the operator's bootstrap is the new ground truth)
    generation: int = 0

    def to_dict(self) -> dict:
        return {
            "cluster_id": self.cluster_id,
            "epoch": self.epoch,
            "assignment": self.assignment.to_dict(),
            "brokers": list(self.brokers),
            "topology": (
                self.topology.to_dict() if self.topology else None
            ),
            "rf": self.rf,
            "drained": list(self.drained),
            "generation": self.generation,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ClusterState":
        topo = d.get("topology")
        return cls(
            cluster_id=d["cluster_id"],
            epoch=int(d["epoch"]),
            assignment=Assignment.from_dict(d["assignment"]),
            brokers=[int(b) for b in d["brokers"]],
            topology=Topology.from_dict(topo) if topo else None,
            rf=d.get("rf"),
            drained=[int(b) for b in d.get("drained", [])],
            generation=int(d.get("generation", 0)),
        )


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise EventError(msg)


def _is_int_key(k) -> bool:
    """JSON object keys are strings; a broker-id key must parse as an
    int so ``apply_event``'s ``int(k)`` can never raise out of the
    validated path (a raw ValueError there would surface as a
    misleading 422 and abort a CLI replay mid-stream)."""
    try:
        int(k)
        return True
    except (TypeError, ValueError):
        return False


def _event_brokers(ev: dict) -> list[int]:
    spec = ev.get("brokers")
    if isinstance(spec, str):
        try:
            return parse_broker_list(spec)
        except ValueError as e:
            raise EventError(f"bad 'brokers' range string: {e}") from e
    _require(
        isinstance(spec, list) and spec and all(
            isinstance(b, int) and not isinstance(b, bool) for b in spec
        ),
        "'brokers' must be a non-empty list of ints or a range string",
    )
    return list(spec)


def _validate_rf_field(rf) -> None:
    if rf is None:
        return
    if isinstance(rf, bool) or not isinstance(rf, (int, dict)):
        raise EventError("'rf' must be an int or a topic->int object")
    if isinstance(rf, int):
        _require(rf >= 1, "'rf' must be >= 1")
        return
    for k, v in rf.items():
        _require(
            isinstance(k, str) and isinstance(v, int)
            and not isinstance(v, bool) and v >= 1,
            "'rf' object must map topic names to ints >= 1",
        )


def validate_event(ev) -> dict:
    """Schema-check one event; returns it unchanged. Raises
    :class:`EventError` on any malformation — epochs are validated here
    structurally (a non-negative int); MONOTONICITY is the manager's
    job (it owns the per-cluster latest epoch)."""
    _require(isinstance(ev, dict), "event must be a JSON object")
    etype = ev.get("type")
    _require(
        etype in EVENT_TYPES,
        f"unknown event type {etype!r}; valid: {list(EVENT_TYPES)}",
    )
    epoch = ev.get("epoch")
    _require(
        isinstance(epoch, int) and not isinstance(epoch, bool)
        and epoch >= 0,
        "'epoch' must be a non-negative int",
    )
    if etype == "bootstrap":
        _require("assignment" in ev, "bootstrap needs 'assignment'")
        _require("brokers" in ev, "bootstrap needs 'brokers'")
        _event_brokers(ev)
        _validate_rf_field(ev.get("rf"))
        topo = ev.get("topology")
        _require(
            topo is None or isinstance(topo, dict) or topo == "even-odd",
            "'topology' must be a broker->rack object, 'even-odd', "
            "or null",
        )
    elif etype in ("broker_add", "broker_remove", "broker_drain"):
        _event_brokers(ev)
        if etype == "broker_add":
            racks = ev.get("racks")
            _require(
                racks is None or (
                    isinstance(racks, dict) and all(
                        isinstance(v, str) for v in racks.values()
                    ) and all(
                        _is_int_key(k) for k in racks
                    )
                ),
                "'racks' must map integer broker ids to rack names",
            )
            rack = ev.get("rack")
            _require(
                rack is None or isinstance(rack, str),
                "'rack' must be a string",
            )
    elif etype == "rack_fail":
        _require(
            isinstance(ev.get("rack"), str) and ev["rack"],
            "rack_fail needs a non-empty 'rack' string",
        )
    elif etype == "partition_growth":
        _require(
            isinstance(ev.get("topic"), str) and ev["topic"],
            "partition_growth needs a non-empty 'topic' string",
        )
        add = ev.get("add")
        _require(
            isinstance(add, int) and not isinstance(add, bool)
            and 1 <= add <= 1_000_000,
            "'add' must be an int in [1, 1000000]",
        )
        rf = ev.get("rf")
        _require(
            rf is None or (
                isinstance(rf, int) and not isinstance(rf, bool)
                and rf >= 1
            ),
            "partition_growth 'rf' must be an int >= 1",
        )
    elif etype == "rf_change":
        _require("rf" in ev, "rf_change needs 'rf'")
        _validate_rf_field(ev["rf"])
        _require(ev["rf"] is not None, "rf_change 'rf' may not be null")
    return ev


def _bootstrap_state(cluster_id: str, ev: dict,
                     generation: int = 0) -> ClusterState:
    try:
        assignment = Assignment.from_dict(ev["assignment"])
    except (KeyError, TypeError, ValueError) as e:
        raise EventError(f"bad bootstrap 'assignment': {e}") from e
    brokers = _event_brokers(ev)
    topo = ev.get("topology")
    try:
        if topo == "even-odd":
            all_ids = sorted(set(brokers) | set(assignment.broker_ids()))
            topology = Topology.even_odd(all_ids)
        elif isinstance(topo, dict):
            topology = Topology.from_dict(topo)
        else:
            topology = None
    except Exception as e:
        raise EventError(f"bad bootstrap 'topology': {e}") from e
    return ClusterState(
        cluster_id=cluster_id,
        epoch=int(ev["epoch"]),
        assignment=assignment,
        brokers=sorted(set(brokers)),
        topology=topology,
        rf=ev.get("rf"),
        generation=generation,
    )


def _drop_brokers(state: ClusterState, ids: list[int], *,
                  forget: bool) -> ClusterState:
    known = set(state.brokers) | set(state.drained)
    unknown = sorted(set(ids) - known)
    _require(not unknown, f"unknown broker(s) {unknown}")
    brokers = [b for b in state.brokers if b not in set(ids)]
    _require(
        bool(brokers),
        "event would leave the cluster with zero eligible brokers",
    )
    drained = sorted(set(state.drained) | set(ids)) if not forget else [
        b for b in state.drained if b not in set(ids)
    ]
    topology = state.topology
    if forget and topology is not None:
        rack_of = {
            b: r for b, r in topology.rack_of.items() if b not in set(ids)
        }
        topology = Topology(rack_of=rack_of)
    return replace(state, brokers=brokers, drained=drained,
                   topology=topology)


def apply_event(state: ClusterState | None, cluster_id: str,
                ev: dict) -> ClusterState:
    """The pure state transition: ``(state, event) -> new state`` with
    the event's epoch stamped on. ``state`` is None only for the first
    event of an unknown cluster, which must be a bootstrap."""
    ev = validate_event(ev)
    etype = ev["type"]
    if state is None:
        _require(
            etype == "bootstrap",
            f"cluster {cluster_id!r} is unknown; the first event must "
            "be a 'bootstrap'",
        )
        return _bootstrap_state(cluster_id, ev)
    if etype == "bootstrap":
        # re-registration (operator rebuilt the cluster record): the
        # fencing contract still applies — the manager admitted this
        # epoch as newer before calling here. The generation bump keeps
        # an in-flight solve from merging its stale plan over the
        # re-declared assignment at commit.
        return _bootstrap_state(cluster_id, ev,
                                generation=state.generation + 1)

    epoch = int(ev["epoch"])
    if etype == "broker_add":
        ids = _event_brokers(ev)
        already = sorted(set(ids) & set(state.brokers))
        _require(not already, f"broker(s) {already} already eligible")
        topology = state.topology
        racks = ev.get("racks") or {}
        if ev.get("rack"):
            racks = {**{str(b): ev["rack"] for b in ids}, **racks}
        if racks:
            rack_of = dict(topology.rack_of if topology else {})
            for b, r in racks.items():
                rack_of[int(b)] = str(r)
            topology = Topology(rack_of=rack_of)
        elif topology is not None:
            missing = [
                b for b in ids
                if b not in topology.rack_of and b not in state.drained
            ]
            _require(
                not missing,
                f"racked topology requires a rack for new broker(s) "
                f"{missing} (pass 'racks' or 'rack')",
            )
        state = replace(
            state,
            brokers=sorted(set(state.brokers) | set(ids)),
            drained=[b for b in state.drained if b not in set(ids)],
            topology=topology,
        )
    elif etype == "broker_remove":
        state = _drop_brokers(state, _event_brokers(ev), forget=True)
    elif etype == "broker_drain":
        state = _drop_brokers(state, _event_brokers(ev), forget=False)
    elif etype == "rack_fail":
        _require(
            state.topology is not None,
            "rack_fail on a cluster with no topology",
        )
        rack = ev["rack"]
        _require(
            rack in state.topology.racks(),
            f"unknown rack {rack!r}; cluster has "
            f"{state.topology.racks()}",
        )
        ids = [
            b for b in state.brokers
            if state.topology.rack(b) == rack
        ]
        _require(
            bool(ids),
            f"rack {rack!r} has no eligible brokers left to fail",
        )
        state = _drop_brokers(state, ids, forget=False)
    elif etype == "partition_growth":
        topic, add = ev["topic"], int(ev["add"])
        existing = [
            p for p in state.assignment.partitions if p.topic == topic
        ]
        rf = ev.get("rf")
        if rf is None:
            _require(
                bool(existing),
                f"new topic {topic!r} needs an explicit 'rf'",
            )
            rf = max(len(p.replicas) for p in existing)
            if isinstance(state.rf, int):
                rf = state.rf
            elif isinstance(state.rf, dict) and topic in state.rf:
                rf = state.rf[topic]
        next_id = 1 + max(
            (p.partition for p in existing), default=-1
        )
        # new partitions hold no data yet: an EMPTY current replica
        # list means zero preservation weight, so the solver places
        # them wherever balance wants — and the move count honestly
        # charges the initial copies
        grown = Assignment(
            partitions=state.assignment.partitions + [
                PartitionAssignment(topic=topic, partition=next_id + i,
                                    replicas=[])
                for i in range(add)
            ],
            version=state.assignment.version,
        )
        # the model derives a partition's RF from its current replica
        # list unless told otherwise; empty lists MUST be told
        new_rf = state.rf
        if new_rf is None:
            new_rf = {topic: int(rf)}
        elif isinstance(new_rf, dict):
            new_rf = {**new_rf, topic: int(rf)}
        elif int(rf) != int(new_rf):
            # an int rf covers every topic; an explicit different rf
            # for the grown topic forces the per-topic form
            new_rf = {
                t: int(new_rf) for t in {
                    p.topic for p in state.assignment.partitions
                }
            }
            new_rf[topic] = int(rf)
        state = replace(state, assignment=grown, rf=new_rf)
    elif etype == "rf_change":
        rf = ev["rf"]
        if isinstance(rf, dict):
            known = {p.topic for p in state.assignment.partitions}
            unknown = sorted(set(rf) - known)
            _require(
                not unknown,
                f"rf_change names unknown topic(s) {unknown}",
            )
            merged = (
                dict(state.rf) if isinstance(state.rf, dict) else {}
            )
            merged.update({k: int(v) for k, v in rf.items()})
            rf = merged
        state = replace(state, rf=rf)
    return replace(state, epoch=epoch)
