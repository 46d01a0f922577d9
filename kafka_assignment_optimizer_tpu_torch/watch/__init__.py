"""Cluster-watch mode, copies of the reference package's ``watch``
modules: the optimizer as an online service that remembers each named
cluster between decisions.

- :mod:`.events` — the typed event grammar (broker add/remove/drain,
  rack failure, partition growth, RF change) and the pure state
  transition each event applies.
- :mod:`.store` — the durable per-cluster plan store: atomic
  write-rename JSON records, fingerprint-verified on load.
- :mod:`.adapt` — warm-start adaptation: evict dead brokers/racks from
  the previous plan, keep surviving replicas in place, fill the holes
  rack-aware; the result seeds ``engine.solve_tpu(warm_start=...)``.
- :mod:`.manager` — epoch fencing (structured 409 on stale or replayed
  epochs), event-storm coalescing (a burst on one cluster becomes one
  re-solve of the latest state; superseded solves are cancelled through
  their ``resilience.budget.Budget``), and backlog backpressure.

The HTTP surface (``POST /clusters/<id>/events``) lives in ``serve``;
everything here is transport-free.
"""

from .events import ClusterState, EventError, apply_event, validate_event
from .manager import FencedEpoch, StormShed, WatchRegistry
from .store import PlanStore

__all__ = [
    "ClusterState", "EventError", "apply_event", "validate_event",
    "FencedEpoch", "StormShed", "WatchRegistry", "PlanStore",
]
