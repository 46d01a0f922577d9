"""Bucket-affinity serving fleet (docs/FLEET.md).

The serving fleet: N ordinary
``serve.py`` worker processes behind one ``kao-router`` front process
that

- routes each ``/submit`` to the worker whose lane-padded executables
  and exec cache are already warm for the request's shape bucket
  (``affinity`` — the shape bucket key computed host-side, rendezvous-
  hashed over the live worker set, biased by the workers' ``/healthz``
  warm-bucket ledgers),
- fails over on sheds and dead workers with budget-capped hedging
  (``router``), keeping every watched cluster sticky to one worker so
  epoch fencing still sees a single writer,
- partitions warmup across the fleet so each bucket compiles exactly
  once fleet-wide, with the shared persistent compile cache
  (``KAO_COMPILE_CACHE``, ``utils.platform``) turning that one cold
  compile into every other worker's disk hit.

The router itself imports neither torch nor jax (pinned by test): it is
pure
stdlib HTTP + the dependency-free bucket/cluster model modules, so it
boots in milliseconds and can front heterogeneous worker pools.
"""

from __future__ import annotations

from .affinity import bucket_key_of, rank_workers, rendezvous_rank

__all__ = ["bucket_key_of", "rank_workers", "rendezvous_rank"]
