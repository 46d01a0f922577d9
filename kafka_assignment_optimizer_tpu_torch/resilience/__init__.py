"""Resilience primitives of the solve path, copies of the reference's
``resilience`` modules:

- :mod:`.budget` — the per-solve deadline budget and the shared
  jittered backoff;
- :mod:`.breaker` — the serving path's per-bucket circuit breaker;
- :mod:`.chaos` — the ``KAO_CHAOS`` / ``--chaos`` fault-injection
  harness (host-side injection points, no-ops unless armed);
- :mod:`.ladder` — the degradation ladder: named rungs, recorded in the
  solve's ``stats["degradations"]``, a process counter and a log line.
"""
