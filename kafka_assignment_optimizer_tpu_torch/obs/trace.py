"""Solve-trace telemetry: nested timed spans with attributes.

The engine runs a multi-stage pipeline (bounds → constructor race →
seed → chunked anneal ladder → polish → oracle verify) across a batched
serving path; this module is the instrument that says *which phase ate
the budget* and *what the annealer actually did*. Design constraints:

- **Dependency-free**: stdlib only (``contextvars``/``threading``/
  ``time``) — importable from the lowest layers (``parallel.mesh``)
  without cycles.
- **Negligible overhead when disabled** (the default): every
  instrumentation site (``span``/``mark``/``set_attrs``) starts with one
  contextvar read; with no active trace, ``span`` returns a shared
  ``nullcontext`` — no allocation, no timestamps, and keyword attrs at
  the call sites are kept cheap (expensive attrs are computed only under
  ``if sp is not None``).
- **Thread-safe**: child-span attachment takes the trace lock;
  ``wrap()`` carries a span onto worker threads (contextvars do not
  cross threads by themselves). Attribute writes stay on the owning
  thread.

Propagation is ambient: ``begin()`` activates a trace on the current
context, and every ``span()`` underneath — engine phases, mesh
dispatch/compile, device transfers — attaches to it automatically, so
the serving path can trace a whole request without threading a handle
through every signature. Across PROCESS boundaries propagation is
explicit (docs/OBSERVABILITY.md "Distributed traces"): ``inject()``
renders the active context as a W3C ``traceparent`` header, and
``extract()`` + ``begin(remote_parent=...)`` adopt it on the far side,
so a router-edge trace and the worker-side solve trace share one ID
and re-join under ``GET /debug/traces/<id>``. ``finish()`` closes the
trace, builds the solve report (span tree + per-phase seconds +
optional annealing trajectory), registers it in the ``RECENT`` ring
buffer (the ``/debug/solves`` surface) subject to the tail-retention
policy (``KAO_TRACE_TAIL``, :class:`TailPolicy`), and feeds the
per-phase latency histograms rendered as
``kao_phase_seconds{phase=...}`` on ``/metrics``.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import re
import threading
import time
import uuid
from collections import OrderedDict, deque, namedtuple

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "kao_current_span", default=None
)
# the shared disabled-path context manager: span() must not allocate
# when tracing is off (it sits on per-chunk and per-dispatch hot paths)
_NULL = contextlib.nullcontext()

# constructor sub-phases (docs/CONSTRUCTOR.md): nested spans
# whose TOTAL seconds are rolled up into the solve report's ``phases``
# dict alongside the root-level pipeline phases, so flight records and
# bench's construct_host_s column attribute host time to the exact loop
# the vectorized constructor rewrote. Summed (not first-occurrence like
# the root phases) because e.g. "greedy" legitimately runs both in a
# race worker and in _pick_seed within one solve.
SUB_PHASES = ("bounds_flow", "greedy", "reseat", "adopt")


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[16:]


# --------------------------------------------------------------------------
# W3C traceparent codec (docs/OBSERVABILITY.md "Distributed traces")
#
# One trace must survive the process hop: the kao-router begins a trace
# at its edge, ``inject()``s it into the upstream request headers, and
# the worker ``extract()``s it so the solve's span tree carries the
# router's trace ID (the /debug/traces join key). The wire format is
# the W3C Trace Context ``traceparent`` header —
# ``00-{trace-id:32hex}-{parent-span-id:16hex}-{flags:2hex}`` — so any
# W3C-speaking proxy or client interoperates. Internal compact 16-hex
# trace IDs are left-padded with zeros on the wire and stripped back on
# extract; a foreign full-width 32-hex ID is adopted verbatim.
# Malformed or unusable headers are tolerated: extract() returns None
# (the request gets a fresh root; the remote link is dropped) and the
# rejection is counted, never raised.
# --------------------------------------------------------------------------

TRACEPARENT = "traceparent"
_TP_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)
_HEX_RE = re.compile(r"^[0-9a-f]+$")
_TID_PAD = "0" * 16

# a remote causal context: the upstream trace ID to adopt and the
# caller-side span that parents this process's root span
RemoteContext = namedtuple("RemoteContext", ("trace_id", "span_id"))

_PROP_LOCK = threading.Lock()
# codec traffic counters (kao_trace_context_total{event=}):
# extracted = remote contexts adopted, malformed = rejected headers
# (new root, remote link dropped), injected = contexts propagated
PROPAGATION = {"extracted": 0, "malformed": 0, "injected": 0}


def _prop_count(event: str) -> None:
    with _PROP_LOCK:
        PROPAGATION[event] += 1


def inject(trace_id: str | None = None,
           span_id: str | None = None) -> str | None:
    """The ``traceparent`` header value for the given context — or for
    the ACTIVE one when called without arguments (the current span gets
    a lazily-assigned span ID so the receiver can parent onto it).
    Returns None when there is nothing propagable: no active trace, or
    an ID the wire format cannot carry."""
    if trace_id is None:
        sp = _CURRENT.get()
        if sp is None:
            return None
        trace_id = sp.trace.trace_id
        span_id = sp.sid()
    tid = str(trace_id).lower()
    sid = str(span_id).lower() if span_id else new_span_id()
    if len(tid) > 32 or not _HEX_RE.match(tid) \
            or len(sid) > 16 or not _HEX_RE.match(sid):
        return None
    _prop_count("injected")
    return f"00-{tid.rjust(32, '0')}-{sid.rjust(16, '0')}-01"


def extract(value) -> RemoteContext | None:
    """Parse a ``traceparent`` header into a :class:`RemoteContext`, or
    None when absent/unusable (malformed syntax, all-zero IDs, the
    reserved ``ff`` version) — the caller then starts a fresh root and
    the remote link is dropped, never an error. A 32-hex ID carrying
    our compact left-pad round-trips back to the 16-hex internal form;
    a genuinely foreign full-width ID is adopted as-is."""
    if not value or not isinstance(value, str):
        return None
    m = _TP_RE.match(value.strip().lower())
    if m is None:
        _prop_count("malformed")
        return None
    version, tid, sid, _flags = m.groups()
    if version == "ff" or tid == "0" * 32 or sid == "0" * 16:
        _prop_count("malformed")
        return None
    if tid.startswith(_TID_PAD):
        tid = tid[len(_TID_PAD):]
    _prop_count("extracted")
    return RemoteContext(tid, sid)


def _jsonable(v):
    """Coerce an attr value to something json.dumps handles (numpy
    scalars carry .item(); anything else falls back to str)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(v)


class Span:
    """One timed pipeline step: name, start/end, attrs, children."""

    __slots__ = ("name", "trace", "start", "end", "attrs", "children",
                 "span_id")

    def __init__(self, name: str, trace: "Trace", attrs: dict | None = None):
        self.name = name
        self.trace = trace
        self.start = time.perf_counter()
        self.end: float | None = None
        self.attrs = dict(attrs) if attrs else {}
        self.children: list[Span] = []
        # lazily assigned (sid()): only spans that actually propagate
        # across a process boundary pay for an ID — chunk/dispatch
        # spans on the hot path never do
        self.span_id: str | None = None

    def sid(self) -> str:
        """This span's ID, assigned on first use (under the trace lock:
        a router attempt span can be read by the report serializer
        while the attempt thread assigns it)."""
        with self.trace._lock:
            if self.span_id is None:
                self.span_id = new_span_id()
            return self.span_id

    def set(self, **attrs) -> None:
        # under the trace lock: a wrap()-ed worker span can still be
        # mutating while another thread serializes the report (a solve
        # legitimately returns past a straggling bounds worker)
        with self.trace._lock:
            self.attrs.update(attrs)

    @property
    def wall_s(self) -> float | None:
        return None if self.end is None else self.end - self.start

    def to_dict(self, t0: float) -> dict:
        # snapshot under the trace lock, serialize outside it: in-flight
        # worker spans may mutate attrs/children concurrently
        with self.trace._lock:
            attrs = dict(self.attrs)
            children = list(self.children)
            end = self.end
            span_id = self.span_id
        d: dict = {
            "name": self.name,
            "start_s": round(self.start - t0, 6),
            # None = still running when the report was built (e.g. a
            # straggling bounds worker past the solve's return)
            "wall_s": (
                None if end is None else round(end - self.start, 6)
            ),
        }
        if span_id is not None:
            # only propagation-relevant spans carry one (see sid())
            d["span_id"] = span_id
        if attrs:
            d["attrs"] = {k: _jsonable(v) for k, v in attrs.items()}
        if children:
            d["spans"] = [c.to_dict(t0) for c in children]
        return d


class Trace:
    """One solve's span tree. Created via :func:`begin`; the root span
    is activated on the current context so nested :func:`span` calls
    attach automatically."""

    def __init__(self, trace_id: str | None = None, name: str = "solve",
                 **attrs):
        self.trace_id = trace_id or new_trace_id()
        self.name = name
        self.started_unix = time.time()
        self._lock = threading.Lock()
        self.root = Span(name, self, attrs)
        self.trajectory: dict | None = None
        self._token = None

    def attach(self, parent: Span, child: Span) -> None:
        with self._lock:
            parent.children.append(child)

    def report(self) -> dict:
        """The solve report: span tree + per-phase seconds (first
        occurrence of each direct child of the root, plus the SUMMED
        constructor sub-phases from anywhere in the tree — see
        ``SUB_PHASES``) + trajectory."""
        t0 = self.root.start
        phases: dict[str, float] = {}
        with self._lock:
            children = list(self.root.children)
        for c in children:
            # SUB_PHASES names are excluded here even as direct root
            # children (the host-fallback path opens "greedy" at root
            # level): they get SUMMED totals below, and first-occurrence
            # recording would otherwise shadow every later occurrence
            if c.end is not None and c.name not in phases \
                    and c.name not in SUB_PHASES:
                phases[c.name] = round(c.end - c.start, 6)
        sub: dict[str, float] = {}
        stack = list(children)
        while stack:
            sp = stack.pop()
            with self._lock:
                stack.extend(sp.children)
            if sp.name in SUB_PHASES and sp.end is not None:
                sub[sp.name] = sub.get(sp.name, 0.0) + (sp.end - sp.start)
        for k, v in sub.items():
            phases[k] = round(v, 6)
        rep = {
            "trace_id": self.trace_id,
            "name": self.name,
            "started_unix": round(self.started_unix, 3),
            "wall_s": (
                None if self.root.end is None
                else round(self.root.end - self.root.start, 6)
            ),
            "phases": phases,
            "spans": self.root.to_dict(t0),
        }
        if self.trajectory:
            rep["annealing"] = self.trajectory
        return rep


class _SpanCtx:
    """Context manager for one child span of ``parent``."""

    __slots__ = ("_parent", "_name", "_attrs", "_span", "_token")

    def __init__(self, parent: Span, name: str, attrs: dict):
        self._parent = parent
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> Span:
        tr = self._parent.trace
        sp = Span(self._name, tr, self._attrs)
        tr.attach(self._parent, sp)
        self._span = sp
        self._token = _CURRENT.set(sp)
        return sp

    def __exit__(self, exc_type, exc, tb):
        sp = self._span
        sp.end = time.perf_counter()
        if exc is not None:
            sp.attrs.setdefault("error", repr(exc)[:200])
        _CURRENT.reset(self._token)
        return False


def span(name: str, **attrs):
    """``with span("chunk", index=i) as sp:`` — a nested timed span, or
    a shared no-op context (yielding None) when no trace is active.
    Keyword attrs are evaluated at the call site even when disabled, so
    keep them cheap there; compute expensive attrs under
    ``if sp is not None: sp.set(...)``."""
    parent = _CURRENT.get()
    if parent is None:
        return _NULL
    return _SpanCtx(parent, name, attrs)


def mark(name: str, **attrs) -> None:
    """Zero-duration span: records a pipeline phase that did not run
    (``skipped=True``) or a point event, keeping the span tree's phase
    vocabulary complete on every path."""
    parent = _CURRENT.get()
    if parent is None:
        return
    sp = Span(name, parent.trace, attrs)
    sp.end = sp.start
    parent.trace.attach(parent, sp)


def set_attrs(**attrs) -> None:
    """Merge attrs into the current span (no-op when untraced)."""
    sp = _CURRENT.get()
    if sp is not None:
        sp.set(**attrs)


def current_span() -> Span | None:
    return _CURRENT.get()


def active() -> bool:
    return _CURRENT.get() is not None


def current_trace_id() -> str | None:
    sp = _CURRENT.get()
    return None if sp is None else sp.trace.trace_id


def wrap(name: str, fn, **attrs):
    """Bind ``fn`` to a child span of the CURRENT span so it can run on
    another thread (contextvars do not cross threads). Returns ``fn``
    unchanged when no trace is active — zero overhead on the default
    path. The span stays open until the wrapped call returns; a report
    built before then shows it with ``wall_s: null`` (in flight)."""
    parent = _CURRENT.get()
    if parent is None:
        return fn
    tr = parent.trace

    def run():
        sp = Span(name, tr, attrs)
        tr.attach(parent, sp)
        tok = _CURRENT.set(sp)
        try:
            return fn()
        except BaseException as e:
            # via the lock (Span.set): the solve may be serializing the
            # report on its own thread at this very moment
            if "error" not in sp.attrs:
                sp.set(error=repr(e)[:200])
            raise
        finally:
            sp.end = time.perf_counter()
            _CURRENT.reset(tok)

    return run


def set_trajectory(**summary) -> None:
    """Merge annealing-trajectory summary fields into the active trace
    (rendered as the solve report's ``annealing`` block)."""
    sp = _CURRENT.get()
    if sp is not None:
        tr = sp.trace
        tr.trajectory = {**(tr.trajectory or {}), **summary}


def open_span(parent: Span | None, name: str, **attrs) -> Span | None:
    """An explicitly-parented span for structured cross-thread work
    (the router's attempt/hedge races): created and attached NOW, never
    touching the ambient contextvar, so any thread may open children of
    any parent it holds. Close with :func:`close_span`. None-in/None-out
    so call sites stay unconditional."""
    if parent is None:
        return None
    sp = Span(name, parent.trace, attrs)
    parent.trace.attach(parent, sp)
    return sp


def close_span(sp: Span | None, **attrs) -> None:
    """Stamp the end (and final attrs) of an :func:`open_span` span."""
    if sp is None:
        return
    if attrs:
        sp.set(**attrs)
    sp.end = time.perf_counter()


def begin(trace=None, *, name: str = "solve",
          remote_parent: str | None = None, **attrs) -> Trace | None:
    """Start a trace when ``trace`` is truthy (``True`` → generated ID,
    a string → that ID) and activate it on the current context. Returns
    None — tracing disabled — otherwise. Nesting is legal: the token
    restores the outer context at :func:`finish`.

    ``remote_parent`` records a propagated upstream context (the
    ``traceparent`` parent span ID from :func:`extract`): the root span
    becomes a remote-parented server span — ``parent_span_id`` /
    ``span_kind: "server"`` in its attrs — which is how the fleet
    trace merge re-attaches this process's tree under the exact router
    attempt that caused it."""
    if not trace:
        return None
    tid = trace if isinstance(trace, str) else None
    tr = Trace(trace_id=tid, name=name, **attrs)
    if remote_parent:
        tr.root.attrs.setdefault("parent_span_id", str(remote_parent))
        tr.root.attrs.setdefault("span_kind", "server")
    tr._token = _CURRENT.set(tr.root)
    return tr


def finish(tr: Trace | None) -> dict | None:
    """Close ``tr``: deactivate it, build the solve report, register it
    in the ring buffer (subject to the tail-retention policy — see
    :class:`TailPolicy`), and feed the per-phase latency histograms.
    Idempotent-ish on None for uniform call sites."""
    if tr is None:
        return None
    tr.root.end = time.perf_counter()
    if tr._token is not None:
        try:
            _CURRENT.reset(tr._token)
        except ValueError:
            # finished on a different thread/context than begin(): just
            # detach rather than corrupt the finishing thread's context
            pass
        tr._token = None
    rep = tr.report()
    decision = TAIL.decide(rep)
    if TAIL.enabled:
        rep["retention"] = decision
    if decision != "dropped":
        RECENT.put(rep)
    # histograms see EVERY trace either way: retention bounds the ring,
    # never the metrics
    _observe_tree(tr.root)
    return rep


# --------------------------------------------------------------------------
# tail-based trace retention (KAO_TRACE_TAIL — docs/OBSERVABILITY.md
# "Distributed traces")
# --------------------------------------------------------------------------

TAIL_DECISIONS = ("full", "head", "dropped")
# span names whose presence anywhere in the tree marks a trace
# tail-worthy: degradation rungs (resilience.ladder), chaos marks, and
# the engine's sweep→chain retry
_TAIL_KEEP_SPANS = frozenset({"degrade", "chaos", "retry"})
# root/span attrs that mark a trace tail-worthy regardless of latency
_TAIL_KEEP_ATTRS = ("error", "hedged", "chaos")


class TailPolicy:
    """Decide, at finish(), whether a trace's full span tree is worth
    ring residency. Disabled (the default) every trace is kept.
    Enabled (``KAO_TRACE_TAIL=1`` or a spec, below),
    full trees are kept only for traces that ended *interesting*:

    - **slow** — wall clock at or above the rolling p-``quantile``
      (default 0.99) of the last ``window`` traces of the same name
      (the SLO-window p99 shape: per-class, recent);
    - **degraded** — any ``degrade``/``retry`` mark in the tree
      (resilience rung > 0), or an ``error`` attr anywhere;
    - **chaos-touched** — a ``chaos`` mark or attr;
    - **hedged** — the router stamped ``hedged`` on the root (the
      duplicate-race traces a tail investigation always wants).

    Everything else is *head-sampled*: kept iff a deterministic hash of
    the trace ID lands in the 1-in-``head_every`` sample (the unbiased
    baseline a dashboard compares the tail against), dropped from the
    ring otherwise — so ring memory stays bounded at fleet request
    rates while every trace an operator will actually chase is
    retrievable in full. Dropped traces still feed every histogram.

    Spec grammar: ``KAO_TRACE_TAIL=1`` (defaults) or comma-separated
    ``head=N,window=N,quantile=F,min=N``. A typo fails loudly at
    configure time (the chaos-spec discipline)."""

    def __init__(self, enabled: bool = False, head_every: int = 16,
                 window: int = 512, quantile: float = 0.99,
                 min_samples: int = 64):
        self.enabled = bool(enabled)
        self.head_every = max(int(head_every), 1)
        self.window = max(int(window), 8)
        self.quantile = min(max(float(quantile), 0.0), 1.0)
        self.min_samples = max(int(min_samples), 1)
        self._lock = threading.Lock()
        self._durations: dict[str, deque] = {}
        self.counters = {d: 0 for d in TAIL_DECISIONS}

    @classmethod
    def from_spec(cls, spec: str | None) -> "TailPolicy":
        spec = (spec or "").strip().lower()
        if not spec or spec in ("0", "off", "false"):
            return cls(enabled=False)
        kw: dict = {}
        if spec not in ("1", "on", "true"):
            keys = {"head": "head_every", "window": "window",
                    "quantile": "quantile", "min": "min_samples"}
            for part in spec.split(","):
                k, sep, v = part.strip().partition("=")
                if not sep or k not in keys:
                    raise ValueError(
                        f"bad KAO_TRACE_TAIL part {part!r}; want '1' "
                        "or comma-separated head=N,window=N,"
                        "quantile=F,min=N"
                    )
                try:
                    kw[keys[k]] = (float(v) if k == "quantile"
                                   else int(v))
                except ValueError as e:
                    raise ValueError(
                        f"bad KAO_TRACE_TAIL value {part!r}: {e}"
                    ) from e
        return cls(enabled=True, **kw)

    def configure(self, spec: str | None) -> None:
        """Re-arm from a spec string (serve boot / tests); resets the
        rolling windows but keeps the lifetime counters."""
        fresh = TailPolicy.from_spec(spec)
        with self._lock:
            self.enabled = fresh.enabled
            self.head_every = fresh.head_every
            self.window = fresh.window
            self.quantile = fresh.quantile
            self.min_samples = fresh.min_samples
            self._durations.clear()

    @staticmethod
    def _signals(report: dict) -> bool:
        """True when the span tree carries a tail signal (degraded /
        chaos-touched / hedged / errored) — an iterative walk over the
        already-serialized report, once per finish."""
        stack = [report.get("spans") or {}]
        while stack:
            sp = stack.pop()
            if sp.get("name") in _TAIL_KEEP_SPANS:
                return True
            attrs = sp.get("attrs") or {}
            for key in _TAIL_KEEP_ATTRS:
                if attrs.get(key):
                    return True
            stack.extend(sp.get("spans") or ())
        return False

    def _slow(self, name: str, wall) -> bool:
        """Feed the rolling per-name duration window; True when this
        trace sits at/above the configured quantile of the RECENT
        distribution (insufficient evidence during warmup reads as not
        slow — head sampling covers the cold start)."""
        if wall is None:
            return False
        with self._lock:
            dq = self._durations.get(name)
            if dq is None:
                dq = self._durations[name] = deque(maxlen=self.window)
            slow = False
            if len(dq) >= self.min_samples:
                ranked = sorted(dq)
                k = min(int(len(ranked) * self.quantile),
                        len(ranked) - 1)
                slow = wall >= ranked[k]
            dq.append(float(wall))
        return slow

    def decide(self, report: dict) -> str:
        """``"full"`` | ``"head"`` | ``"dropped"`` for one finished
        report. Deterministic: the head sample hashes the trace ID, so
        a replayed seeded load makes identical decisions."""
        if not self.enabled:
            return "full"
        name = report.get("name") or "solve"
        slow = self._slow(name, report.get("wall_s"))
        if slow or self._signals(report):
            decision = "full"
        else:
            tid = str(report.get("trace_id") or "")
            try:
                h = int(tid[-8:], 16)
            except ValueError:
                h = sum(tid.encode())
            decision = ("head" if h % self.head_every == 0
                        else "dropped")
        with self._lock:
            self.counters[decision] += 1
        return decision

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "head_every": self.head_every,
                "window": self.window,
                "quantile": self.quantile,
                "min_samples": self.min_samples,
                "decisions": dict(self.counters),
            }


TAIL = TailPolicy.from_spec(os.environ.get("KAO_TRACE_TAIL"))


def trace_families() -> list:
    """The ``kao_trace_*`` exposition families shared by every surface
    that renders them (serve's /metrics and the kao-router — the
    obs.expo contract, validated by tests/test_metrics_format.py)."""
    snap = TAIL.snapshot()
    with _PROP_LOCK:
        prop = dict(PROPAGATION)
    return [
        ("kao_trace_tail_enabled", "gauge",
         "tail-based trace retention armed (KAO_TRACE_TAIL; "
         "docs/OBSERVABILITY.md)",
         [(None, int(snap["enabled"]))]),
        ("kao_trace_retained_total", "counter",
         "finished traces by retention decision (full = slow/degraded/"
         "chaos/hedged tail keep; head = deterministic baseline "
         "sample; dropped = fast-clean, histograms only)",
         [({"decision": d}, snap["decisions"][d])
          for d in TAIL_DECISIONS]),
        ("kao_trace_context_total", "counter",
         "W3C traceparent codec traffic (extracted = remote contexts "
         "adopted, malformed = rejected headers tolerated as new "
         "roots, injected = contexts propagated downstream)",
         [({"event": e}, prop[e])
          for e in ("extracted", "malformed", "injected")]),
    ]


# --------------------------------------------------------------------------
# per-phase latency histograms (rendered on /metrics as
# kao_phase_seconds{phase=...} — Prometheus histogram convention)
# --------------------------------------------------------------------------

PHASE_BUCKETS = (0.005, 0.025, 0.1, 0.5, 2.5, 10.0, 60.0)
# an exemplar older than this is replaced by ANY fresh observation in
# its bucket at write time, and dropped from snapshots at read time —
# a stale worst-case must not keep advertising a trace the report ring
# has already evicted
EXEMPLAR_TTL_S = 600.0


class ExemplarHistogram:
    """A keyed Prometheus-style histogram with a worst-recent exemplar
    per (key, containment bucket) — shared by the per-phase latency
    histograms here and the per-class solve histograms in
    ``obs.flight``, so the bucket math, the exemplar policy, and the
    snapshot shapes can never drift apart.

    Exemplar policy: a bigger observation always takes its bucket's
    exemplar; a smaller one only replaces an exemplar older than
    ``ttl_s``. Reads (:meth:`exemplars`) drop entries past the TTL
    entirely — a quiet bucket must not advertise a dead trace ID
    forever."""

    def __init__(self, buckets: tuple, ttl_s: float = EXEMPLAR_TTL_S):
        self.buckets = tuple(buckets)
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        # key -> [per-bucket cumulative counts..., count, sum]
        self._rows: dict[str, list] = {}
        # (key, bucket_index) -> (value, trace_id, unix_ts); index
        # len(buckets) is the +Inf bucket (containment, per the
        # OpenMetrics exemplar convention — non-cumulative)
        self._exemplars: dict[tuple, tuple] = {}

    def observe(self, key: str, seconds: float,
                trace_id: str | None = None) -> None:
        s = float(seconds)
        idx = len(self.buckets)
        for i, le in enumerate(self.buckets):
            if s <= le:
                idx = i
                break
        now = time.time()
        with self._lock:
            row = self._rows.get(key)
            if row is None:
                row = self._rows[key] = (
                    [0] * len(self.buckets) + [0, 0.0]
                )
            for i in range(idx, len(self.buckets)):
                row[i] += 1
            row[-2] += 1
            row[-1] += s
            if trace_id:
                cur = self._exemplars.get((key, idx))
                if (cur is None or s >= cur[0]
                        or now - cur[2] > self.ttl_s):
                    self._exemplars[(key, idx)] = (s, trace_id, now)

    def snapshot(self) -> dict[str, dict]:
        """{key: {"buckets": [(le_str, cumulative_count), ...],
        "count": n, "sum": seconds}} — buckets cumulative per the
        Prometheus histogram convention (+Inf bucket is ``count``)."""
        with self._lock:
            rows = {k: list(v) for k, v in self._rows.items()}
        out = {}
        for key, row in rows.items():
            out[key] = {
                "buckets": [
                    (repr(le), row[i])
                    for i, le in enumerate(self.buckets)
                ],
                "count": row[-2],
                "sum": round(row[-1], 6),
            }
        return out

    def exemplars(self, label: str) -> list[dict]:
        """Live (younger than the TTL) worst-recent exemplars, one per
        non-empty (key, bucket): ``{label, "le", "trace_id", "value",
        "age_s"}``."""
        now = time.time()
        with self._lock:
            items = list(self._exemplars.items())
        out = []
        for (key, idx), (val, tid, ts) in sorted(items):
            age = now - ts
            if age > self.ttl_s:
                continue  # the linked report is long evicted
            le = (
                repr(self.buckets[idx]) if idx < len(self.buckets)
                else "+Inf"
            )
            out.append({
                label: key, "le": le, "trace_id": tid,
                "value": round(val, 6), "age_s": round(age, 1),
            })
        return out

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()
            self._exemplars.clear()


PHASE_HIST = ExemplarHistogram(PHASE_BUCKETS)


def observe_phase(phase: str, seconds: float,
                  trace_id: str | None = None) -> None:
    PHASE_HIST.observe(phase, seconds, trace_id=trace_id)


def phase_snapshot() -> dict[str, dict]:
    return PHASE_HIST.snapshot()


def phase_exemplars() -> list[dict]:
    """Worst-recent exemplars per (phase, bucket) — the metric-to-
    trace link rendered next to ``kao_phase_seconds`` on /metrics."""
    return PHASE_HIST.exemplars("phase")


def reset_phase_stats() -> None:
    PHASE_HIST.reset()


def _observe_tree(root: Span) -> None:
    """Feed every finished, non-skipped span into the phase histograms
    (span names are a small fixed vocabulary: the pipeline phases plus
    chunk/dispatch/compile/device_transfer). Each observation carries
    the trace ID so the histogram's worst-recent exemplar links back
    to this solve's report."""
    lock = root.trace._lock
    tid = root.trace.trace_id
    stack = [root]
    while stack:
        sp = stack.pop()
        with lock:  # in-flight workers may still attach children
            stack.extend(sp.children)
            skipped = sp.attrs.get("skipped")
        if sp is root or sp.end is None or skipped:
            continue
        observe_phase(sp.name, sp.end - sp.start, trace_id=tid)


# --------------------------------------------------------------------------
# solve-report ring buffer (GET /debug/solves/<trace_id>)
# --------------------------------------------------------------------------


def _truncate_report(report: dict, max_bytes: int) -> tuple[dict, int]:
    """Cap one report's serialized size by pruning the DEEPEST span
    level first (a pathological ladder's ten-thousand chunk children go
    before the phase skeleton an operator actually reads). Each pruned
    parent records ``spans_dropped``; a touched report is marked
    ``"truncated": true``. Returns ``(report, serialized_size)`` —
    the original object is never mutated (finish() hands the same dict
    to the caller's ``stats["solve_report"]``)."""
    size = len(json.dumps(report, default=str))
    if size <= max_bytes:
        return report, size
    report = json.loads(json.dumps(report, default=str))  # private copy
    report["truncated"] = True

    def depth_of(span: dict) -> int:
        kids = span.get("spans") or ()
        return 1 + max((depth_of(c) for c in kids), default=0)

    def prune_at(span: dict, level: int) -> None:
        kids = span.get("spans") or ()
        if level <= 1:
            if kids:
                span["spans_dropped"] = (
                    span.get("spans_dropped", 0) + len(kids)
                )
                del span["spans"]
            return
        for c in kids:
            prune_at(c, level - 1)

    root = report.get("spans")
    while size > max_bytes:
        if isinstance(root, dict):
            d = depth_of(root)
            if d > 1:
                prune_at(root, d - 1)
                size = len(json.dumps(report, default=str))
                continue
        # span tree exhausted: shed the trajectory, then give up (the
        # scalar skeleton is as small as this report gets)
        if report.pop("annealing", None) is None:
            break
        size = len(json.dumps(report, default=str))
    return report, size


class ReportRing:
    """Bounded most-recent-solve-reports map, keyed by trace ID.

    Two bounds, both resident-memory caps rather than entry counts
    alone: ``capacity`` entries, and ``max_total_bytes`` of serialized
    payload (oldest evicted first). Each report is additionally capped
    at ``max_report_bytes`` via :func:`_truncate_report` — a single
    pathological ladder (tens of thousands of chunk spans) cannot grow
    the ring unbounded."""

    def __init__(self, capacity: int = 128,
                 max_report_bytes: int = 256 << 10,
                 max_total_bytes: int = 8 << 20):
        self.capacity = max(1, int(capacity))
        self.max_report_bytes = max(4096, int(max_report_bytes))
        self.max_total_bytes = max(self.max_report_bytes,
                                   int(max_total_bytes))
        self._lock = threading.Lock()
        self._d: OrderedDict[str, tuple[dict, int]] = OrderedDict()
        self._bytes = 0
        self.truncated_total = 0

    def put(self, report: dict) -> None:
        tid = report.get("trace_id")
        if not tid:
            return
        report, size = _truncate_report(report, self.max_report_bytes)
        with self._lock:
            if report.get("truncated"):
                self.truncated_total += 1
            old = self._d.pop(tid, None)
            if old is not None:
                self._bytes -= old[1]
            self._d[tid] = (report, size)
            self._bytes += size
            while self._d and (
                len(self._d) > self.capacity
                or self._bytes > self.max_total_bytes
            ):
                if len(self._d) == 1:
                    break  # always retain the newest report
                _, (_, osz) = self._d.popitem(last=False)
                self._bytes -= osz

    def get(self, trace_id: str) -> dict | None:
        with self._lock:
            row = self._d.get(trace_id)
        return None if row is None else row[0]

    def ids(self) -> list[str]:
        """Most recent first."""
        with self._lock:
            return list(reversed(self._d))

    def stats(self) -> dict:
        with self._lock:
            return {
                "reports": len(self._d),
                "bytes": self._bytes,
                "capacity": self.capacity,
                "max_report_bytes": self.max_report_bytes,
                "max_total_bytes": self.max_total_bytes,
                "truncated_total": self.truncated_total,
            }


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


RECENT = ReportRing(
    _env_int("KAO_TRACE_RING", 128),
    max_report_bytes=_env_int("KAO_TRACE_REPORT_BYTES", 256 << 10),
    max_total_bytes=_env_int("KAO_TRACE_RING_BYTES", 8 << 20),
)
