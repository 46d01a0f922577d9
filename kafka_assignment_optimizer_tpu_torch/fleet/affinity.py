"""Bucket-affinity routing math (docs/FLEET.md).

Two pieces, both free of torch (the router must boot in milliseconds and
never initialize a device backend — pinned by test):

- :func:`bucket_key_of` recomputes the shape bucket key
  ``(brokers, racks, part-bucket, rf-bucket)`` from a raw ``/submit``
  payload, HOST-SIDE, with exactly the semantics ``serve.handle_submit``
  uses when it builds the instance (pinned against ``build_instance``
  by test). The key is the unit of warmth: every solve in a bucket
  reuses one set of compiled executables, so routing by bucket IS
  routing to warmth.

- :func:`rendezvous_rank` / :func:`rank_workers` order the live worker
  set for a key: highest-random-weight (rendezvous) hashing gives every
  key a stable owner that only moves when ITS owner leaves — a worker
  join/leave reshuffles only the buckets the affected worker owned,
  never the whole keyspace — and the warmth bias sorts workers whose
  ``/healthz`` affinity ledger already reports the bucket warm ahead of
  cold ones (a router restart then keeps routing warm even before its
  own routing history rebuilds).
"""

from __future__ import annotations

import hashlib

from ..models.cluster import Assignment, Topology, parse_broker_list
from ..solvers.tpu import bucket as _bucket

__all__ = ["bucket_key_of", "payload_shape", "shape_key",
           "rendezvous_rank", "rank_workers"]


def payload_shape(payload: dict) -> tuple[int, int, int, int] | None:
    """``(B, K, P, R)`` — brokers, racks, partitions, max-RF — of a
    /submit-style payload, mirroring ``build_instance``; None when the
    payload is malformed (the worker will 400/422 it — the router just
    routes it anywhere)."""
    try:
        current = Assignment.from_dict(payload["assignment"])
        spec = payload["brokers"]
        brokers = (parse_broker_list(spec) if isinstance(spec, str)
                   else [int(b) for b in spec])
        broker_ids = sorted(set(int(b) for b in brokers))
        if not broker_ids:
            return None
        topo_spec = payload.get("topology")
        if topo_spec is None:
            topo = None
        elif topo_spec == "even-odd":
            all_ids = sorted(set(broker_ids) | set(current.broker_ids()))
            topo = Topology.even_odd(all_ids)
        elif isinstance(topo_spec, dict):
            topo = Topology.from_dict(topo_spec)
        else:
            return None
        if topo is None:
            num_racks = 1
        else:
            num_racks = len({topo.rack(int(b)) for b in broker_ids})
        parts = current.partitions
        if not parts:
            return None
        rf = payload.get("rf")
        if rf is None:
            max_rf = max(len(p.replicas) for p in parts)
        elif isinstance(rf, bool):
            return None
        elif isinstance(rf, int):
            max_rf = int(rf)
        elif isinstance(rf, dict):
            max_rf = max(
                int(rf.get(p.topic, len(p.replicas))) for p in parts
            )
        else:
            return None
        if not 1 <= max_rf <= len(broker_ids):
            return None
        return len(broker_ids), num_racks, len(parts), max_rf
    except Exception:
        return None


def shape_key(brokers: int, partitions: int, rf: int,
              racks: int) -> tuple[int, int, int, int]:
    """The bucket key of one warmup shape ``(B, P, R, K)`` — what the
    router partitions across workers for fleet warmup."""
    return (int(brokers), int(racks),
            _bucket.part_bucket(partitions), _bucket.rf_bucket(rf))


def bucket_key_of(payload: dict) -> tuple[int, int, int, int] | None:
    """The executable bucket key of a /submit payload, or None. Same
    4-tuple the worker records in its affinity ledger
    (``/healthz`` cache ``warm_buckets``) and keys its circuit breaker
    and exec cache on."""
    shape = payload_shape(payload)
    if shape is None:
        return None
    b, k, p, r = shape
    return b, k, _bucket.part_bucket(p), _bucket.rf_bucket(r)


def _score(key_str: str, worker: str) -> int:
    h = hashlib.sha256(
        (key_str + "|" + worker).encode("utf-8", "replace")
    ).digest()
    return int.from_bytes(h[:8], "big")


def rendezvous_rank(key, workers: list[str]) -> list[str]:
    """Workers ordered by highest-random-weight hash for ``key``:
    deterministic, and minimally disruptive under membership change —
    removing a worker promotes the runner-up for ONLY that worker's
    keys; adding one steals only the keys it now wins."""
    key_str = ("~" if key is None
               else ":".join(str(x) for x in key))
    return sorted(workers,
                  key=lambda w: (-_score(key_str, w), w))


def rank_workers(key, workers: list[str],
                 warm: dict | None = None) -> list[str]:
    """The routing order for ``key``: rendezvous order, with workers
    whose affinity ledger reports the bucket warm sorted first (stable
    within the warm and cold groups, so two warm workers still split
    keys deterministically by rendezvous weight).

    ``warm`` maps worker -> set of bucket-key tuples (from the health
    tracker's /healthz polls); None or an unknown key means no bias —
    pure rendezvous."""
    ranked = rendezvous_rank(key, workers)
    if not warm or key is None:
        return ranked
    kt = tuple(key)
    return sorted(
        ranked,
        key=lambda w: 0 if kt in warm.get(w, ()) else 1,
    )
