"""Per-key circuit breaker for the serving path.

A bucket whose executable reliably fails to compile or dispatch (bad
shape interaction, device wedged, chaos) must not make every matching
request pay a full compile-attempt-and-crash cycle: after ``threshold``
consecutive failures on one key the circuit OPENS and matching requests
shed instantly with 503 + ``Retry-After`` until the cooldown passes.
Then exactly one probe request is admitted (half-open); success closes
the circuit, failure re-opens it with an exponentially escalated,
jittered cooldown (resilience.budget.jitter_factor is the shared
jitter shape).

Keys are opaque tuples — serve uses the solve bucket identity for device-engine
requests and ``("solver", name)`` otherwise.
"""

from __future__ import annotations

import threading
import time

from .budget import jitter_factor

__all__ = ["CircuitBreaker"]


class _KeyState:
    __slots__ = ("failures", "open_until", "trips", "probing")

    def __init__(self):
        self.failures = 0
        self.open_until = 0.0
        self.trips = 0
        self.probing = False


class CircuitBreaker:
    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 max_cooldown_s: float = 600.0):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.max_cooldown_s = float(max_cooldown_s)
        self._lock = threading.Lock()
        self._keys: dict[tuple, _KeyState] = {}
        self._trips_total = 0

    def configure(self, threshold: int | None = None,
                  cooldown_s: float | None = None) -> None:
        with self._lock:
            if threshold is not None:
                self.threshold = max(1, int(threshold))
            if cooldown_s is not None:
                self.cooldown_s = float(cooldown_s)

    def allow(self, key: tuple) -> tuple[bool, float]:
        """``(admitted, retry_after_s)``: admitted requests proceed;
        shed ones carry the remaining cooldown as the Retry-After
        hint. An expired-cooldown key admits ONE probe; concurrent
        requests behind the probe stay shed until it resolves."""
        now = time.monotonic()
        with self._lock:
            st = self._keys.get(key)
            if st is None or st.open_until <= 0.0:
                return True, 0.0
            if now < st.open_until:
                return False, max(st.open_until - now, 0.1)
            if st.probing:
                # a probe is in flight: hold the line briefly
                return False, 1.0
            st.probing = True  # half-open: this caller is the probe
            return True, 0.0

    def record_success(self, key: tuple) -> None:
        with self._lock:
            self._keys.pop(key, None)

    def release_probe(self, key: tuple) -> None:
        """A probe concluded WITHOUT a solver verdict (the request shed
        on saturation or failed validation before the solver ran):
        clear the half-open latch so a later request may probe again —
        without this, a shed probe would wedge the circuit open
        forever."""
        with self._lock:
            st = self._keys.get(key)
            if st is not None:
                st.probing = False

    def record_failure(self, key: tuple) -> None:
        now = time.monotonic()
        with self._lock:
            st = self._keys.setdefault(key, _KeyState())
            was_probe = st.probing
            st.probing = False
            st.failures += 1
            if st.failures < self.threshold and not was_probe:
                return
            # trip: escalate the cooldown exponentially with jitter
            st.trips += 1
            self._trips_total += 1
            st.failures = 0
            base = min(
                self.cooldown_s * (2.0 ** (st.trips - 1)),
                self.max_cooldown_s,
            )
            st.open_until = now + base * jitter_factor(0.25)
            key_r, trips = repr(key)[:120], st.trips
        from ..obs import log as _olog

        _olog.error("breaker_open", key=key_r, trips=trips)

    def open_keys(self) -> int:
        now = time.monotonic()
        with self._lock:
            return sum(
                1 for st in self._keys.values() if st.open_until > now
            )

    def snapshot(self) -> dict:
        with self._lock:
            tracked = len(self._keys)
            trips = self._trips_total
        return {
            "open": self.open_keys(),
            "tracked": tracked,
            "trips_total": trips,
        }

    def reset(self) -> None:
        with self._lock:
            self._keys.clear()
            self._trips_total = 0
