"""Runtime lock sanitizer (``KAO_LSAN=1``) — the dynamic complement
to the static lock-discipline rules (:mod:`.concurrency`).

Counterpart of ``kafka_assignment_optimizer_tpu.analysis.lsan``. The
package prefix below resolves to THIS package, so :func:`install` wraps
the port's locks only (``anneal._CAPTURE_LOCK`` among them) and leaves
the reference package's alone.

``install()`` monkeypatches ``threading.Lock``/``RLock`` with a
factory that returns an instrumented proxy ONLY when the caller's
module lives inside this package (``sys._getframe`` inspection at
construction time, so stdlib locks — ``queue.Queue``'s mutex, logging,
torch internals — stay raw and free). Each proxy records:

- **acquisition order**: a process-wide held-before graph. Taking B
  while holding A adds the edge A→B; if B→A was ever observed, two
  threads running both paths can deadlock — the sanitizer trips
  (:class:`LockOrderInversion`) at the acquisition that closed the
  cycle, naming both creation sites.
- **hold time**: a release after more than ``KAO_LSAN_HOLD_S``
  (default {DEFAULT_HOLD_BUDGET_S}s) records a ``hold_budget``
  :class:`Violation` (recorded, never raised — raising on release
  would corrupt the caller's unwind).

Armed runs call :func:`install` before importing the port (its
module-level locks bind at import) and read :func:`violations` at the
end: tests/test_torch_lockcheck.py's child process and chip_smoke.py's
phase (p), around the chain engine's capture lock on the card.
:func:`holds` reports each lock's acquisitions and longest hold. Tests
that deliberately trip the sanitizer use :func:`scope` to keep their
violations out of the session ledger.

Env knobs: ``KAO_LSAN`` (arm), ``KAO_LSAN_HOLD_S`` (hold budget,
seconds), ``KAO_LSAN_RAISE`` (default on; ``0`` records inversions
instead of raising).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass, field

DEFAULT_HOLD_BUDGET_S = 5.0

_PKG = __name__.split(".analysis")[0]

__doc__ = __doc__.replace("{DEFAULT_HOLD_BUDGET_S}",
                          str(DEFAULT_HOLD_BUDGET_S))


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in (
        "1", "true", "yes", "on"
    )


class LsanError(AssertionError):
    """Base for sanitizer trips (an AssertionError so a trip inside a
    test fails that test loudly)."""


class LockOrderInversion(LsanError):
    pass


@dataclass(frozen=True)
class Violation:
    kind: str          # "inversion" | "hold_budget"
    detail: str
    site_a: str        # creation site of the held/long-held lock
    site_b: str        # creation site of the acquired lock ("" = n/a)
    thread: str


@dataclass
class _State:
    """One recording scope: the order graph + violation ledger."""

    # (held_site, acquired_site) -> first-observed description
    edges: dict[tuple[str, str], str] = field(default_factory=dict)
    violations: list[Violation] = field(default_factory=list)
    # creation site -> [acquisitions, longest hold (s), where it ended]
    holds: dict[str, list] = field(default_factory=dict)


_REG_LOCK = threading.Lock()  # guards _STATES and install bookkeeping
_STATES: list[_State] = [_State()]
_INSTALLED = False
# survive a re-import while installed: the factories carry their real
# constructor in _kao_real, so we never capture our own wrapper
_REAL_LOCK = getattr(threading.Lock, "_kao_real", threading.Lock)
_REAL_RLOCK = getattr(threading.RLock, "_kao_real", threading.RLock)
_HELD = threading.local()   # per-thread stack of (proxy, t_acquire)
_HOLD_BUDGET = [DEFAULT_HOLD_BUDGET_S]  # cached; env read at install


def _held_stack() -> list:
    st = getattr(_HELD, "stack", None)
    if st is None:
        st = _HELD.stack = []
    return st


def hold_budget_s() -> float:
    return _HOLD_BUDGET[0]


def _refresh_hold_budget() -> None:
    try:
        _HOLD_BUDGET[0] = float(
            os.environ.get("KAO_LSAN_HOLD_S", "")
            or DEFAULT_HOLD_BUDGET_S
        )
    except ValueError:
        _HOLD_BUDGET[0] = DEFAULT_HOLD_BUDGET_S


def _raise_on_inversion() -> bool:
    v = os.environ.get("KAO_LSAN_RAISE", "").strip().lower()
    return v not in ("0", "false", "no", "off")


class _LsanLock:
    """Instrumented proxy over a real Lock/RLock. Delegates the
    primitive protocol (including the ``Condition`` integration
    surface: ``_release_save``/``_acquire_restore``/``_is_owned``) and
    funnels every transition through the order/hold bookkeeping."""

    def __init__(self, inner, site: str, reentrant: bool):
        self._inner = inner
        self._site = site
        self._reentrant = reentrant
        self._owner: int | None = None
        self._depth = 0

    # -- bookkeeping -------------------------------------------------

    def _note_acquired(self) -> None:
        me = threading.get_ident()
        if self._reentrant and self._owner == me:
            self._depth += 1
            return  # re-entry: no new edge, no new hold window
        self._owner, self._depth = me, 1
        stack = _held_stack()
        edges = [
            held._site for held, _t0 in stack
            if held is not self and held._site != self._site
        ]
        # bookkeeping BEFORE any inversion raise, so the stack always
        # matches reality even when the acquisition trips
        stack.append((self, time.monotonic()))
        for held_site in edges:
            _note_edge(held_site, self._site)

    def _note_released(self) -> None:
        if self._reentrant and self._depth > 1:
            self._depth -= 1
            return
        self._owner, self._depth = None, 0
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is self:
                _t, t0 = stack.pop(i)
                held_s = time.monotonic() - t0
                _note_hold(self._site, held_s)
                if held_s > hold_budget_s():
                    _record(Violation(
                        "hold_budget",
                        f"lock held {held_s:.3f}s "
                        f"(budget {hold_budget_s():.3f}s)",
                        self._site, "",
                        threading.current_thread().name))
                break

    # -- lock protocol -----------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            try:
                self._note_acquired()
            except LsanError:
                # a trip FAILS the acquisition: undo bookkeeping and
                # release, so the raise from __enter__ (where __exit__
                # will never run) cannot leak a held lock
                stack = _held_stack()
                if stack and stack[-1][0] is self:
                    stack.pop()
                self._owner, self._depth = None, 0
                self._inner.release()
                raise
        return got

    def release(self) -> None:
        self._note_released()
        self._inner.release()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # -- Condition integration ---------------------------------------

    def _release_save(self):
        self._note_released()
        inner = getattr(self._inner, "_release_save", None)
        if inner is not None:
            return inner()
        self._inner.release()
        return None

    def _acquire_restore(self, state) -> None:
        inner = getattr(self._inner, "_acquire_restore", None)
        if inner is not None:
            inner(state)
        else:
            self._inner.acquire()
        self._note_acquired()

    def _is_owned(self) -> bool:
        inner = getattr(self._inner, "_is_owned", None)
        if inner is not None:
            return bool(inner())
        return self._owner == threading.get_ident()

    def __repr__(self) -> str:
        return f"<LsanLock {self._site} over {self._inner!r}>"


def _note_edge(held_site: str, acq_site: str) -> None:
    desc = (f"{held_site} held while acquiring {acq_site} "
            f"on {threading.current_thread().name}")
    with _REG_LOCK:
        states = list(_STATES)
    tripped = None
    for st in states:
        st.edges.setdefault((held_site, acq_site), desc)
        if (acq_site, held_site) in st.edges:
            v = Violation(
                "inversion",
                f"lock-order inversion: {desc}; reverse order "
                f"previously seen: {st.edges[(acq_site, held_site)]}",
                held_site, acq_site,
                threading.current_thread().name)
            st.violations.append(v)
            tripped = v
    if tripped is not None:
        _log("lsan_inversion", detail=tripped.detail)
        if _raise_on_inversion():
            raise LockOrderInversion(tripped.detail)


def _note_hold(site: str, held_s: float) -> None:
    """One completed hold of the lock made at ``site``: its count, and
    its longest hold with the caller that released it."""
    where = ""
    with _REG_LOCK:
        states = list(_STATES)
    for st in states:
        row = st.holds.get(site)
        if row is None:
            row = st.holds[site] = [0, 0.0, ""]
        row[0] += 1
        if held_s > row[1]:
            if not where:
                where = _release_site()
            row[1], row[2] = held_s, where


def _release_site() -> str:
    """``module:line`` of the innermost frame outside this module: where
    the hold ended (the ``with`` block's owner)."""
    f = sys._getframe(1)
    while f is not None and f.f_globals.get("__name__") == __name__:
        f = f.f_back
    if f is None:
        return ""
    return f"{f.f_globals.get('__name__', '?')}:{f.f_lineno}"


def _record(v: Violation) -> None:
    with _REG_LOCK:
        states = list(_STATES)
    for st in states:
        st.violations.append(v)
    _log(f"lsan_{v.kind}", detail=v.detail, site=v.site_a)


def _log(event: str, **kw) -> None:
    try:
        from ..obs import log as _olog

        _olog.warn(event, **kw)
    except Exception:
        pass


def _caller_site(depth: int = 2) -> tuple[str, str] | None:
    """(module, file:line) of the lock construction site; None when
    the caller is outside the project package."""
    try:
        f = sys._getframe(depth)
    except ValueError:  # pragma: no cover - shallow stack
        return None
    mod = f.f_globals.get("__name__", "")
    if not (mod == _PKG or mod.startswith(_PKG + ".")):
        return None
    return mod, f"{mod}:{f.f_lineno}"


def _lock_factory():
    site = _caller_site()
    if site is None:
        return _REAL_LOCK()
    return _LsanLock(_REAL_LOCK(), site[1], reentrant=False)


def _rlock_factory():
    site = _caller_site()
    if site is None:
        return _REAL_RLOCK()
    return _LsanLock(_REAL_RLOCK(), site[1], reentrant=True)


_lock_factory._kao_real = _REAL_LOCK
_rlock_factory._kao_real = _REAL_RLOCK


def wrap(lock=None, *, site: str = "explicit", reentrant: bool = False):
    """Wrap one lock explicitly (tests, or hot spots outside the
    package) regardless of install state."""
    return _LsanLock(lock if lock is not None else _REAL_LOCK(),
                     site, reentrant)


def install() -> bool:
    """Arm the sanitizer: project-module ``threading.Lock``/``RLock``
    constructions return instrumented proxies from here on. Idempotent;
    returns True when armed. Locks created BEFORE install stay raw, so
    call this before importing the serving modules (conftest does)."""
    global _INSTALLED
    _refresh_hold_budget()
    with _REG_LOCK:
        if _INSTALLED:
            return True
        threading.Lock = _lock_factory
        threading.RLock = _rlock_factory
        _INSTALLED = True
    _log("lsan_installed", hold_budget_s=hold_budget_s())
    return True


def uninstall() -> None:
    global _INSTALLED
    with _REG_LOCK:
        if not _INSTALLED:
            return
        threading.Lock = _REAL_LOCK
        threading.RLock = _REAL_RLOCK
        _INSTALLED = False


def installed() -> bool:
    return _INSTALLED


def violations() -> list[Violation]:
    """The session ledger (the root recording scope)."""
    with _REG_LOCK:
        return list(_STATES[0].violations)


def edges() -> list[tuple[str, str]]:
    """The session ledger's lock-order graph: ``(held_site,
    acquired_site)`` pairs observed so far."""
    with _REG_LOCK:
        return sorted(_STATES[0].edges)


def holds() -> dict[str, dict]:
    """The session ledger's hold statistics by lock creation site:
    ``{"acquisitions", "max_hold_s", "max_hold_at"}`` (the site of the
    code that released the longest hold)."""
    with _REG_LOCK:
        rows = dict(_STATES[0].holds)
    return {site: {"acquisitions": n, "max_hold_s": mx, "max_hold_at": at}
            for site, (n, mx, at) in sorted(rows.items())}


def reset() -> None:
    """Clear the session ledger AND its order graph (tests)."""
    with _REG_LOCK:
        _STATES[0].edges.clear()
        _STATES[0].violations.clear()
        _STATES[0].holds.clear()


class scope:
    """``with lsan.scope() as sc:`` — record into a private ledger;
    violations observed inside land in ``sc.violations`` and are kept
    OUT of the session ledger (deliberate-trip tests)."""

    def __init__(self):
        self._st = _State()
        self.violations = self._st.violations

    def __enter__(self) -> "scope":
        with _REG_LOCK:
            _STATES.append(self._st)
            self._suspended = _STATES.pop(0)
            _STATES.insert(0, _State())  # shield the session ledger
        return self

    def __exit__(self, *exc) -> None:
        with _REG_LOCK:
            _STATES.remove(self._st)
            _STATES.pop(0)
            _STATES.insert(0, self._suspended)
