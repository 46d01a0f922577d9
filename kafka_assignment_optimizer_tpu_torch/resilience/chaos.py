"""Fault-injection harness (``KAO_CHAOS=<spec>`` / ``--chaos <spec>``).

A copy of ``kafka_assignment_optimizer_tpu.resilience.chaos``: named
injection points, strict no-ops unless armed (one module-level ``None``
check), deterministic under a seed so a chaos run can be replayed. The
catalogue is the reference's whole; which points this package fires is
said where it fires them (``solvers.tpu.engine._chaos_chunk_hooks``,
``decompose``).

Spec grammar (comma-separated)::

    KAO_CHAOS="seed=7,delay=0.2,nan_chunk:0.5,chunk_overrun:1:3"

- ``point[:prob[:times]]`` — arm ``point``; each eligible call site
  fires with probability ``prob`` (default 1.0) at most ``times`` times
  (default 1; ``-1`` = unlimited). Unknown point names are a hard error
  — a typo must not silently disarm a chaos soak.
- ``seed=N`` — seed the harness RNG (replayable probabilistic faults).
- ``delay=S`` — seconds slept by delay-type points (``chunk_overrun``,
  ``slow_client``); default 0.25.

Chaos hooks are host-side only: they fire between device launches,
never inside one.
"""

from __future__ import annotations

import os
import random
import threading
import time

__all__ = [
    "POINTS", "ChaosFault", "arm", "disarm", "armed", "spec_string",
    "fires", "raise_if", "sleep_if", "delay_s", "is_fault",
    "is_pallas_fault", "snapshot", "reset_counters",
]

# the injection-point catalogue: point -> (layer, what it simulates)
POINTS: dict[str, tuple[str, str]] = {
    "compile_fail": (
        "parallel.mesh", "AOT lower/compile failure (falls back to jit)"),
    "device_transfer": (
        "parallel.mesh", "device->host transfer error (retried once)"),
    "exec_evict": (
        "parallel.mesh", "executable-cache eviction storm"),
    "pallas_fault": (
        "solvers.tpu.engine", "device kernel fault (drained and retried "
        "on the plain path; not fired in this package yet)"),
    "megachunk_fault": (
        "solvers.tpu.engine", "fault inside a fused megachunk scan "
        "dispatch (drains to the per-chunk path)"),
    "nan_chunk": (
        "solvers.tpu.engine", "NaN surfacing from an annealing chunk"),
    "chunk_overrun": (
        "solvers.tpu.engine", "chunk running far past its warm estimate"),
    "checkpoint_write": (
        "solvers.tpu.engine", "checkpoint persistence write failure"),
    "decompose_reduce": (
        "decompose", "reduce-phase boundary/stitch failure "
        "(degrades decompose_to_flat)"),
    "worker_crash": (
        "serve", "solve worker thread dies mid-request"),
    "queue_overload": (
        "serve", "solve queue reports no capacity"),
    "slow_client": (
        "serve", "slow client holding a handler thread"),
}

_DEFAULT_DELAY_S = 0.25


class ChaosFault(RuntimeError):
    """An injected fault. Carries the point name so fault-specific
    handling can key on it without string matching. A subclass of
    ``RuntimeError`` (as every CUDA launch error is): tell the two apart
    with :func:`is_fault`, never by ``isinstance(e, RuntimeError)``."""

    def __init__(self, point: str, message: str | None = None):
        super().__init__(
            message or f"chaos: injected fault at point {point!r}"
        )
        self.point = point


_LOCK = threading.Lock()
# None = disarmed (the fast path — ``fires`` returns before the lock);
# armed: point -> {"prob": float, "left": int (-1 = unlimited)}
_SPEC: dict[str, dict] | None = None
_SPEC_STRING: str | None = None
_DELAY = _DEFAULT_DELAY_S
_RNG = random.Random()
_FIRED: dict[str, int] = {}


def parse_spec(spec: str) -> tuple[dict[str, dict], int | None, float]:
    """``"seed=7,delay=0.1,pallas_fault:0.5:2"`` ->
    ``(points, seed, delay_s)``; raises ValueError on anything
    malformed (a chaos spec typo must fail loudly, not no-op)."""
    points: dict[str, dict] = {}
    seed: int | None = None
    delay = _DEFAULT_DELAY_S
    for raw in spec.split(","):
        part = raw.strip()
        if not part:
            continue
        if part.startswith("seed="):
            seed = int(part[5:])
            continue
        if part.startswith("delay="):
            delay = float(part[6:])
            if delay < 0:
                raise ValueError(f"chaos delay must be >= 0: {part!r}")
            continue
        fields = part.split(":")
        name = fields[0]
        if name not in POINTS:
            raise ValueError(
                f"unknown chaos point {name!r}; known: "
                f"{sorted(POINTS)}"
            )
        if len(fields) > 3:
            raise ValueError(f"bad chaos point spec {part!r}; "
                             "want point[:prob[:times]]")
        prob = float(fields[1]) if len(fields) > 1 else 1.0
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"chaos probability out of [0,1]: {part!r}")
        times = int(fields[2]) if len(fields) > 2 else 1
        if times == 0 or times < -1:
            raise ValueError(
                f"chaos times must be >= 1 or -1 (unlimited): {part!r}"
            )
        points[name] = {"prob": prob, "left": times}
    if not points:
        raise ValueError(f"chaos spec arms no points: {spec!r}")
    return points, seed, delay


def arm(spec: str) -> None:
    """Parse and arm ``spec`` (replaces any previous arming)."""
    global _SPEC, _SPEC_STRING, _DELAY
    points, seed, delay = parse_spec(spec)
    with _LOCK:
        _SPEC = points
        _SPEC_STRING = spec
        _DELAY = delay
        if seed is not None:
            _RNG.seed(seed)


def disarm() -> None:
    global _SPEC, _SPEC_STRING
    with _LOCK:
        _SPEC = None
        _SPEC_STRING = None


def armed() -> bool:
    return _SPEC is not None


def spec_string() -> str | None:
    """The armed spec verbatim (healthz / replay logging)."""
    return _SPEC_STRING


def delay_s() -> float:
    return _DELAY


def fires(point: str) -> bool:
    """True when the armed spec says ``point`` faults NOW (consumes one
    of the point's remaining fires). Disarmed: one ``is None`` check."""
    spec = _SPEC
    if spec is None:
        return False
    with _LOCK:
        cfg = spec.get(point)
        if cfg is None or cfg["left"] == 0:
            return False
        if cfg["prob"] < 1.0 and _RNG.random() >= cfg["prob"]:
            return False
        if cfg["left"] > 0:
            cfg["left"] -= 1
        _FIRED[point] = _FIRED.get(point, 0) + 1
    from ..obs import log as _olog

    _olog.warn("chaos_fired", point=point)
    return True


def raise_if(point: str, exc_type: type[BaseException] | None = None) -> None:
    """Raise the point's fault when armed-and-firing. ``exc_type``
    shapes the fault like the real failure it simulates (e.g.
    ``FloatingPointError`` for ``nan_chunk``, ``OSError`` for
    ``checkpoint_write``); default is :class:`ChaosFault`."""
    if not fires(point):
        return
    if exc_type is None:
        raise ChaosFault(point)
    raise exc_type(f"chaos: injected fault at point {point!r}")


def sleep_if(point: str) -> None:
    """Delay-type injection: sleep the armed delay when firing."""
    if fires(point):
        time.sleep(_DELAY)


def is_fault(e: BaseException) -> bool:
    return isinstance(e, ChaosFault)


def is_pallas_fault(e: BaseException) -> bool:
    """True for the injected kernel fault (``pallas_fault``), the point
    a kernel->plain retry rung keys on."""
    return isinstance(e, ChaosFault) and e.point == "pallas_fault"


def snapshot() -> dict:
    """{"armed": 0|1, "spec": str|None, "fired": {point: n}}."""
    with _LOCK:
        return {
            "armed": int(_SPEC is not None),
            "spec": _SPEC_STRING,
            "fired": dict(_FIRED),
        }


def reset_counters() -> None:
    """Zero the fired counters (tests)."""
    with _LOCK:
        _FIRED.clear()


# arm-from-environment at import: a typo'd KAO_CHAOS must fail the
# process loudly, never silently run without chaos
_env = os.environ.get("KAO_CHAOS", "").strip()
if _env:
    arm(_env)
del _env
