"""Runtime sanitizer mode (``KAO_SANITIZE=1`` / ``--sanitize``).

The counterpart of the reference package's ``analysis.sanitize``, with
the same public names and counters (``kao_sanitizer_*`` on
``/metrics``). The reference arms three guards over JAX; this package
has no XLA executables and donates no buffers, so each guard watches
what plays that part here:

- **NaN guard.** The reference turns on ``jax_debug_nans``, so a device
  NaN raises ``FloatingPointError`` at its dispatch. Here, while armed,
  the ladder hands each chunk's float tensors (its outputs and the
  model's float tables it ran on) to :func:`check_device`: one fused
  ``isfinite`` reduction and ONE host sync a chunk, none while
  disarmed; a non-finite value raises ``FloatingPointError``, which the
  engine counts once through :func:`note_nan_abort_once`
  (``kao_sanitizer_nan_aborts_total``) before it propagates.
  :func:`check_host` gives the host-built temperature ladder the same
  guard. While armed the engine's host fallback declines
  ``FloatingPointError`` (``engine._degradable``): the operator asked
  for loud failure.
- **Donation guard.** The reference refuses to dispatch arguments a
  donating dispatch already consumed. Here the hazard is a lane or
  chain state that a stepper has already consumed and that is passed to
  a stepper again (a stale state read after its successor exists: the
  aliasing hazard). The ladder marks each state it hands to a stepper
  as consumed once the stepper returns (:func:`consume_state`) and
  checks every state before a dispatch (:func:`check_state`), raising
  :class:`DonationReuseError` (``kao_sanitizer_donation_reuse_total``).
- **Recompile sentinel.** The reference counts XLA compiles per
  executable-cache key. Here :func:`note_compile` is fed by the two
  things a process builds: a kernel library compiled with ``nvcc``
  (``ops.kernels``, key: the source and its content hash) and a CUDA
  graph captured by the chain engine (``solvers.tpu.anneal``, key: the
  runner, the model and the state's shape). A key built more than
  ``KAO_SANITIZE_COMPILE_BUDGET`` times (default 2) fails the solve
  (``kao_sanitizer_recompiles_total``): each is built once per key
  while its cache works.

Everything is a no-op until :func:`enable` runs (or ``KAO_SANITIZE`` is
truthy at import). Counters are process-wide and thread-safe.
``compile_log_lines_total`` counts the reference's compile log lines;
this package emits none, so it stays 0 (kept so the counter families
match).
"""

from __future__ import annotations

import os
import threading
import weakref

__all__ = [
    "SanitizerError", "RecompileBudgetError", "DonationReuseError",
    "enabled", "enable", "disable", "install", "compile_budget",
    "note_compile", "forget_key", "note_nan_abort", "note_nan_abort_once",
    "note_donation_reuse", "check_state", "consume_state",
    "check_host", "check_device", "snapshot", "reset",
]


class SanitizerError(RuntimeError):
    """Base class: a sanitizer tripwire fired."""


class RecompileBudgetError(SanitizerError):
    pass


class DonationReuseError(SanitizerError):
    pass


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "on", "true", "yes")


_LOCK = threading.Lock()
_ENABLED = _env_truthy("KAO_SANITIZE")
_COMPILES_BY_KEY: dict = {}
# the lead tensor of every state a stepper has consumed, by id, weakly
# held: a state nobody keeps leaves the table on its own
_CONSUMED: dict = {}
_C = {
    "recompiles_total": 0,       # sentinel trips (budget exceeded)
    "nan_aborts_total": 0,       # NaN guard aborts (device or host)
    "donation_reuse_total": 0,   # consumed-state guard trips
    "compiles_observed_total": 0,   # kernel builds + graph captures seen
    "compile_log_lines_total": 0,   # the reference's compile log lines
}


def enabled() -> bool:
    return _ENABLED


def compile_budget() -> int:
    """Expected builds per key: 1, plus 1 of slack as in the reference
    (whose legitimate maximum is a kernel attempt and one fallback)."""
    try:
        return int(os.environ.get("KAO_SANITIZE_COMPILE_BUDGET", "2"))
    except ValueError:
        return 2


def enable() -> None:
    global _ENABLED
    _ENABLED = True
    install()


def disable() -> None:
    """Turn the guards off (tests)."""
    global _ENABLED
    _ENABLED = False


def install() -> None:
    """The reference flips JAX's debug flags here; this package's guards
    live at their call sites, so installing sets nothing. Kept so the
    entry points call it as the reference's do."""


def note_compile(key) -> None:
    """Record one kernel build or graph capture for ``key``; raises
    :class:`RecompileBudgetError` past the per-key budget."""
    if not _ENABLED:
        return
    with _LOCK:
        _C["compiles_observed_total"] += 1
        n = _COMPILES_BY_KEY.get(key, 0) + 1
        _COMPILES_BY_KEY[key] = n
        budget = compile_budget()
        if n <= budget:
            return
        _C["recompiles_total"] += 1
        # the trip ends this episode: the next build of the key counts
        # from zero again
        _COMPILES_BY_KEY.pop(key, None)
    from ..obs import log as _olog

    _olog.error("sanitizer_recompile_budget", key=repr(key)[:200],
                compiles=n, budget=budget)
    raise RecompileBudgetError(
        f"sanitizer: key built {n}x (budget {budget}); a kernel library "
        "or a captured graph must be built once per key and reused. "
        f"key={key!r}"
    )


def forget_key(key) -> None:
    """The cache dropped ``key``: its next build is legitimate."""
    with _LOCK:
        _COMPILES_BY_KEY.pop(key, None)


def note_nan_abort_once(exc: BaseException, context: str = "") -> None:
    """Count a NaN abort exactly once per exception object: nested solve
    paths (the batch's sequential fallback, the chain-engine retry)
    route the same ``FloatingPointError`` through several handlers."""
    if getattr(exc, "_kao_nan_counted", False):
        return
    try:
        exc._kao_nan_counted = True
    except Exception:
        pass
    note_nan_abort(context)


def note_nan_abort(context: str = "") -> None:
    if not _ENABLED:
        # counted only while armed: the counter stays zero and inert off
        return
    with _LOCK:
        _C["nan_aborts_total"] += 1
    from ..obs import log as _olog

    _olog.error("sanitizer_nan_abort", context=context or None)


def note_donation_reuse(key) -> None:
    with _LOCK:
        _C["donation_reuse_total"] += 1
    from ..obs import log as _olog

    _olog.error("sanitizer_donation_reuse", key=repr(key)[:200])
    raise DonationReuseError(
        "sanitizer: a stepper was handed a state it has already consumed "
        "(use the state it RETURNED; states are never shared between "
        f"steps). key={key!r}"
    )


def _lead(state):
    """The first tensor of a state (a tensor, a tuple or a dataclass of
    tensors), or None."""
    import torch

    if isinstance(state, torch.Tensor):
        return state
    if isinstance(state, (tuple, list)):
        for x in state:
            if isinstance(x, torch.Tensor):
                return x
        return None
    for x in getattr(state, "__dict__", {}).values():
        if isinstance(x, torch.Tensor):
            return x
    return None


def check_state(state, key="state") -> None:
    """Before a dispatch: raise :class:`DonationReuseError` when a
    stepper has already consumed ``state``."""
    if not _ENABLED or state is None:
        return
    t = _lead(state)
    ref = _CONSUMED.get(id(t)) if t is not None else None
    if ref is not None and ref() is t:
        note_donation_reuse(key)


def consume_state(state) -> None:
    """After a stepper returned: mark its input ``state`` consumed."""
    if not _ENABLED or state is None:
        return
    t = _lead(state)
    if t is not None:
        k = id(t)
        _CONSUMED[k] = weakref.ref(t, lambda _r, k=k: _CONSUMED.pop(k, None))


def check_host(arr, context: str = "host array") -> None:
    """NaN guard for host-built float arrays (the temperature ladder)."""
    if not _ENABLED:
        return
    import numpy as np

    a = np.asarray(arr)
    if a.dtype.kind == "f" and not np.isfinite(a).all():
        note_nan_abort(context)
        raise SanitizerError(
            f"sanitizer: non-finite values in {context}"
        )


def check_device(tensors, context: str = "chunk") -> None:
    """NaN guard for a chunk's device float tensors: one ``isfinite``
    reduction over all of them and one host sync, only while armed.
    Raises ``FloatingPointError`` (counted by the engine's
    :func:`note_nan_abort_once`)."""
    if not _ENABLED:
        return
    import torch

    bad = [(~torch.isfinite(t)).any().reshape(1) for t in tensors
           if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if bad and bool(torch.cat(bad).any()):
        raise FloatingPointError(
            f"sanitizer: non-finite values in {context}"
        )


def snapshot() -> dict:
    with _LOCK:
        out = dict(_C)
    out["enabled"] = int(_ENABLED)
    return out


def reset() -> None:
    """Zero the counters and per-key build history (tests)."""
    with _LOCK:
        _COMPILES_BY_KEY.clear()
        for k in _C:
            _C[k] = 0
    _CONSUMED.clear()
