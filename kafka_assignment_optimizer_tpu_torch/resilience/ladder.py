"""The graceful-degradation ladder: one ordered, observable policy.

A copy of ``kafka_assignment_optimizer_tpu.resilience.ladder``. Every
fallback the solve path takes is a named rung, ordered from cheapest to
most drastic, and every step down is recorded at once in:

- the solve's ``stats["degradations"]`` list (an ambient collector that
  the engine's entry points activate);
- the process counter behind :func:`snapshot`;
- a zero-length ``degrade`` span mark on the active solve trace
  (``/debug/solves/<id>``);
- one structured ``degradation`` log line (``obs.log``).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading

from ..obs import trace as _otrace

__all__ = [
    "RUNGS", "note_rung", "collect", "collect_lane", "snapshot", "reset",
]

# the ladder, cheapest rung first. Results stay bit-identical through
# "pipelined_to_sync"; from "pallas_to_xla" down the executable changes
# but the trajectory holds; "sweep_to_chain" changes the search;
# "anneal_to_construct" abandons the device search for the host greedy
# path (flagged degraded unless it certifies); the rest are serving and
# persistence containment steps. The catalogue is the reference's, rungs
# this package cannot take yet included, so the counters line up
RUNGS: tuple[str, ...] = (
    "megachunk_to_chunked",  # fused scan drained; per-chunk ladder re-entry
    "pipelined_to_sync",    # drain speculation, retry chunk synchronously
    "aot_to_jit",           # AOT executable path failed; plain jit dispatch
    "transfer_retry",       # device->host transfer retried after a fault
    "pallas_to_xla",        # kernel fault; chunk re-run on the plain path
    "deadline_truncated",   # budget bit: ladder stopped early, best-so-far
    "checkpoint_skipped",   # checkpoint write failed; solve continued
    "warm_start_rejected",  # delta-API warm seed unusable; solved cold
    "decompose_to_flat",    # failed map-reduce stitch; flat solve instead
    "sweep_to_chain",       # defaulted sweep infeasible; chain engine retry
    "anneal_to_construct",  # device path unusable; host greedy/constructor
    "worker_restart",       # serve worker crashed; respawned (+1 retry)
)

_LOCK = threading.Lock()
_COUNTS: dict[str, int] = {r: 0 for r in RUNGS}

# ambient per-solve rung collector: the OUTERMOST engine entry point
# owns the list (nested solves — the chain retry, per-lane fallbacks —
# feed the same one), and copies it into stats["degradations"]. A rung
# noted on another thread reaches it only where that thread runs in a
# copied context, as in the reference
_ACTIVE: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "kao_degradation_rungs", default=None
)


def note_rung(rung: str, **attrs) -> None:
    """Record one step down the ladder: counter + trace mark +
    structured log + the ambient per-solve collector."""
    with _LOCK:
        _COUNTS[rung] = _COUNTS.get(rung, 0) + 1
    lst = _ACTIVE.get()
    if lst is not None:
        lst.append(rung)
    _otrace.mark("degrade", rung=rung, **attrs)
    from ..obs import log as _olog

    _olog.warn("degradation", rung=rung, **attrs)


@contextlib.contextmanager
def collect():
    """Activate the per-solve rung collector on this context; yields
    the list, or None when an OUTER collector is already active (nested
    solves append to the outermost one, so a retry's rungs land on the
    request-level stats exactly once)."""
    if _ACTIVE.get() is not None:
        yield None
        return
    lst: list = []
    token = _ACTIVE.set(lst)
    try:
        yield lst
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def collect_lane():
    """Per-lane scope inside a batch solve: rungs taken here land on
    the yielded list ONLY, shadowing the batch-level collector — a
    single lane's sequential fallback must not flag the other lanes'
    stats as degraded (the counter, the trace mark and the log line
    still fire)."""
    lst: list = []
    token = _ACTIVE.set(lst)
    try:
        yield lst
    finally:
        _ACTIVE.reset(token)


def snapshot() -> dict[str, int]:
    """rung -> times taken, every catalogued rung present (zeros
    included)."""
    with _LOCK:
        out = {r: 0 for r in RUNGS}
        out.update(_COUNTS)
        return out


def reset() -> None:
    """Zero the counters (tests)."""
    with _LOCK:
        for k in list(_COUNTS):
            _COUNTS[k] = 0
