"""Per-solve deadline budget — the one remaining-time object.

A copy of the ``Budget`` of ``kafka_assignment_optimizer_tpu.resilience.
budget``: created once per solve, every join, retry and chunk-boundary
gate asks it for ``remaining()`` instead of re-deriving ``t0 +
time_limit_s`` (so a retry runs on what is left, never on the original
limit again), and a caller-owned budget can be cancelled from another
thread. Retries (the watch manager's solve loop, the circuit breaker's
cooldowns) share one jittered exponential backoff, :func:`backoff_s`.
"""

from __future__ import annotations

import random
import time

__all__ = ["Budget", "backoff_s", "jitter_factor"]

_RNG = random.Random()


def jitter_factor(jitter: float) -> float:
    """Uniform scale factor in ``[1-jitter, 1+jitter]`` (floored at
    0), the one jitter shape every retry and cooldown shares."""
    lo = max(0.0, 1.0 - jitter)
    return lo + (1.0 + jitter - lo) * _RNG.random()


def backoff_s(attempt: int, base_s: float = 0.05, cap_s: float = 2.0,
              jitter: float = 0.5) -> float:
    """Jittered exponential backoff: ``base * 2**attempt`` capped at
    ``cap_s``, scaled by :func:`jitter_factor`. ``attempt`` counts
    from 0 (the first retry)."""
    raw = min(float(base_s) * (2.0 ** max(int(attempt), 0)), float(cap_s))
    return raw * jitter_factor(jitter)


class Budget:
    """Remaining-time accounting for one solve.

    ``Budget(None)`` is the unlimited budget: ``remaining()`` is None,
    ``expired()`` is False, ``cap()`` passes timeouts through.
    :meth:`cancel` collapses the remaining budget to zero from another
    thread, so every gate that asks ``remaining()`` stops at its next
    check."""

    __slots__ = ("t0", "limit_s", "cancelled")

    def __init__(self, limit_s: float | None, t0: float | None = None):
        self.limit_s = None if limit_s is None else float(limit_s)
        self.t0 = time.perf_counter() if t0 is None else float(t0)
        self.cancelled = False

    def cancel(self) -> None:
        """Collapse the budget: ``remaining()`` is 0.0 and ``expired()``
        is True from now on, even on an unlimited budget (a one-way
        flag, so safe from another thread)."""
        self.cancelled = True

    @property
    def deadline(self) -> float | None:
        """Absolute ``time.perf_counter()`` deadline (None = none)."""
        if self.limit_s is None:
            return None
        return self.t0 + self.limit_s

    def remaining(self) -> float | None:
        """Seconds left (clamped at 0.0); None = unlimited. A cancelled
        budget always reports 0.0."""
        if self.cancelled:
            return 0.0
        if self.limit_s is None:
            return None
        return max(0.0, self.t0 + self.limit_s - time.perf_counter())

    def expired(self) -> bool:
        r = self.remaining()
        return r is not None and r <= 0.0

    def cap(self, timeout_s: float | None) -> float | None:
        """``timeout_s`` bounded by the remaining budget (None in,
        remaining out; an unlimited budget passes ``timeout_s``
        through)."""
        r = self.remaining()
        if r is None:
            return timeout_s
        if timeout_s is None:
            return r
        return min(float(timeout_s), r)

    def __repr__(self) -> str:
        r = self.remaining()
        return (
            "Budget(unlimited)" if r is None
            else f"Budget(limit={self.limit_s:.3f}s, left={r:.3f}s)"
        )
