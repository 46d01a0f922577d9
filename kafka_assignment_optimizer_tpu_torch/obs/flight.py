"""Solve-cost flight recorder: a copy of the reference package's
``obs.flight``, fed by this package's engine.

Every completed product solve — a ``/submit`` solve, a cluster-watch
delta, or one lane of a coalesced batch — lands ONE compact JSON record
here: bucket identity, per-phase seconds, the compile/device/host
split, cache movement, degradation rungs, warm/cold provenance, and
plan quality (objective, certification, move count, warm-certify hit).
The record stream is what the SLO engine (``obs.slo``), the drift
monitor (``obs.drift``), the ``kao_solve_seconds`` histograms and the
roofline profiler's attribution (``obs.prof``) all read from —
``/metrics`` says *that* p99 moved, the flight log says *which solves*
moved it and *what they paid for*.

Three sinks, fed by one :func:`record` call:

- an **in-memory ring** (``RECENT``, bounded) behind ``GET /debug/slo``,
  ``GET /debug/profile`` and the device sampler;
- the **SLO engine** (``obs.slo.ENGINE.observe``) driving burn-rate
  windows and ``kao_slo_*`` metrics, and the drift monitor;
- the ``kao_solve_seconds{class=...}`` histograms with worst-recent
  exemplars;
- an optional **append-only JSONL file** under ``--flight-dir`` /
  ``KAO_FLIGHT_DIR``. Appends are line-atomic best-effort; the reader
  (:func:`iter_records`) tolerates a torn final line, so a ``kill -9``
  mid-write costs at most one record. Rotation: the live file is
  ``os.replace``d to an archived name (atomic on POSIX), a fresh live
  file is opened, and archives beyond the cap are pruned oldest-first.

Every record is stamped with this process's worker identity
(host/pid/port/boot-id) plus a per-worker monotonic ``seq`` and fanned
out to live-stream subscribers (``GET /debug/stream``; bounded
per-client queues, slow clients shed their own tail).

Recording must NEVER fail a solve: every sink is wrapped, failures are
counted (``kao_flight_write_errors_total``) and logged.

Per-solve accounting (``start_accounting``/``note_compile``/
``note_dispatch``/``note_device``/``attribute``): a contextvar
accumulator the engine feeds so each record carries its own numbers.
The reference measures an XLA compile/dispatch/device split; this
package compiles no XLA, so on its records:

- ``compile_s`` (and ``cache.compiles``): the ``nvcc`` kernel-library
  builds (``ops.kernels``) and the chain engine's CUDA-graph captures
  (``solvers.tpu.anneal``) that ran inside the solve's window, or 0
  once the process is warm (a build or capture is paid once per
  process and shape);
- ``dispatch_s``: the engine's ``stats["dispatch_s"]``, host time
  enqueueing the ladder's chunks or fused groups;
- ``device_s``: the engine's ``stats["device_s"]``, host time blocked
  waiting for a retired chunk's copies to land (``note_device``);
- ``cache.hits``/``misses``: chunk dispatches that found their kernel
  library built (hit) or paid its build (miss).

The watch manager tags delta solves via :func:`context` (kind +
cluster/epoch), which the engine-level :func:`record_solve` merges in.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import queue as _queue
import socket
import threading
import time
import uuid
from collections import deque

from . import log as _olog
from .trace import ExemplarHistogram

# latency buckets for kao_solve_seconds{class=...}: warm solves sit
# around 1 s, cold ~2-70 s (compile-bound), delta warm-certify in the
# tens of ms — the ladder must resolve all three regimes
SOLVE_BUCKETS = (0.025, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0,
                 600.0)

_RECENT_CAP = 512
DEFAULT_MAX_BYTES = 8 << 20   # rotate the live JSONL past this
DEFAULT_MAX_FILES = 4         # archived rotations kept

# live-stream fan-out (GET /debug/stream, docs/OBSERVABILITY.md "Fleet
# plane"): bounded per-client queues; a slow client sheds its OWN tail
# (kao_stream_dropped_total), never backpressures the solve path
MAX_STREAM_CLIENTS = int(os.environ.get("KAO_STREAM_CLIENTS", "8"))
STREAM_QUEUE_LEN = int(os.environ.get("KAO_STREAM_QUEUE", "256"))


# --------------------------------------------------------------------------
# worker identity + per-worker monotonic sequence (fleet plane)
# --------------------------------------------------------------------------

# every flight record is stamped with the worker that produced it —
# host/pid/port/boot-id — plus a per-worker monotonic ``seq``. The
# fleet merge (obs.fleet) orders WITHIN a worker by seq (immune to that
# worker's clock) and dedups on (worker, seq); readers treat records
# without these fields as legacy (single pseudo-worker, file order).
_WORKER = {
    "host": socket.gethostname(),
    "pid": os.getpid(),
    "port": None,
    "boot": uuid.uuid4().hex[:8],
}


def worker_identity() -> dict:
    """This process's worker identity stamp (copied into records)."""
    return dict(_WORKER)


def set_worker_port(port: int | None) -> None:
    """Serve calls this once the listener is bound, so records name the
    port peers would use to reach this worker."""
    _WORKER["port"] = int(port) if port is not None else None


def worker_key(rec: dict) -> str:
    """Stable merge key for the worker that produced ``rec``:
    ``host:pid:boot`` (port changes on restart reuse; boot-id breaks
    pid-recycling collisions). Legacy records collapse to one
    pseudo-worker."""
    w = rec.get("worker")
    if not isinstance(w, dict):
        return "legacy"
    return f"{w.get('host')}:{w.get('pid')}:{w.get('boot')}"


# --------------------------------------------------------------------------
# per-solve accounting (fed by parallel.mesh's dispatch/compile sites)
# --------------------------------------------------------------------------


# attribution-ledger categories (docs/OBSERVABILITY.md "Reading a
# roofline"). LEAF windows are measured directly at their source —
# mesh's compile/dispatch-enqueue/transfer sites, the engine's device
# waits — and are disjoint by construction (all on the solve thread,
# none nested in another leaf). NESTED windows (boundary, constructor)
# wrap blocks that may CONTAIN leaf windows; :func:`attribute` nets the
# leaf seconds accrued inside back out, so a transfer inside a chunk
# boundary is counted once as transfer, never twice.
LEDGER_LEAVES = ("compile", "dispatch", "device", "transfer")
LEDGER_NESTED = ("boundary", "constructor")
# sums-to-wall epsilon: 8 components rounded at 4 decimals plus
# cross-thread clock skew; relative term covers long solves
LEDGER_EPS_S = 0.005
LEDGER_EPS_FRAC = 0.01


class _SolveAcc:
    __slots__ = ("compile_s", "compiles", "cache_hits", "cache_misses",
                 "cache_fallbacks", "seconds", "leaf_s")

    def __init__(self):
        self.compile_s = 0.0
        self.compiles = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_fallbacks = 0
        # per-category measured seconds for the attribution ledger;
        # leaf_s tracks the LEAF total so nested windows can net out
        # the leaf time accrued inside them
        self.seconds = dict.fromkeys(LEDGER_LEAVES + LEDGER_NESTED, 0.0)
        self.leaf_s = 0.0


_ACC: contextvars.ContextVar = contextvars.ContextVar(
    "kao_flight_acc", default=None
)
# delta/batch context: the watch manager (and any future wrapper) tags
# the solves it drives with a kind + extra identity fields
_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "kao_flight_ctx", default=None
)


def start_accounting():
    """Begin a per-solve compile/cache accumulator on this context;
    returns the token for :func:`end_accounting`."""
    from . import prof as _oprof

    # a stale speculative dispatch from a previous solve on this
    # context must not mispair with this solve's device waits
    _oprof.reset_pending()
    return _ACC.set(_SolveAcc())


def accounting_active() -> bool:
    """True when a solve accumulator is live on this context — the
    engine's nesting guard: a retry/lane solve running INSIDE another
    recorded solve must not land its own record (its compiles flow
    into the outer accumulator instead)."""
    return _ACC.get() is not None


def end_accounting(token) -> _SolveAcc | None:
    acc = _ACC.get()
    try:
        _ACC.reset(token)
    except ValueError:  # crossed threads: keep the numbers anyway
        pass
    return acc


def note_compile(seconds: float) -> None:
    """One kernel-library build or CUDA-graph capture attributed to the
    current solve (``ops.kernels`` and the chain engine call this next
    to their process-global counters). Also the ledger's compile LEAF
    window."""
    acc = _ACC.get()
    if acc is not None:
        acc.compile_s += float(seconds)
        acc.compiles += 1
        acc.seconds["compile"] += float(seconds)
        acc.leaf_s += float(seconds)


def note_dispatch(cache: str) -> None:
    """One chunk dispatch: ``cache`` is hit (its kernels were built),
    miss (the dispatch paid a build) or fallback (the plain versions
    ran)."""
    acc = _ACC.get()
    if acc is None:
        return
    if cache == "hit":
        acc.cache_hits += 1
    elif cache == "miss":
        acc.cache_misses += 1
    else:
        acc.cache_fallbacks += 1


def note_window(category: str, seconds: float) -> None:
    """One LEAF attribution window measured at its source: ``dispatch``
    (the engine's enqueue time around a chunk's launches), ``device``
    (the engine's retire-side wait on a chunk's copies), ``transfer``.
    Leaves are disjoint on the solve thread by construction;
    :func:`attribute` blocks net them out."""
    acc = _ACC.get()
    if acc is not None:
        acc.seconds[category] += float(seconds)
        acc.leaf_s += float(seconds)


def note_device(seconds: float) -> None:
    """One retire-side device wait: the ledger's device leaf AND the
    profiler's occupancy pairing (enqueue->retire window against the
    dispatch key's analytic cost model) in one call — the engine's
    walkers feed both planes through this single funnel."""
    note_window("device", seconds)
    from . import prof as _oprof

    _oprof.note_device(seconds)


@contextlib.contextmanager
def attribute(category: str):
    """Measure a NESTED attribution window (``boundary``,
    ``constructor``): the block's wall minus whatever leaf windows
    accrued inside it — a ``fetch_global`` inside a chunk boundary
    lands once under transfer, and the boundary figure is the host
    work that remains. Never double-counts by construction."""
    acc = _ACC.get()
    if acc is None:
        yield
        return
    t0 = time.perf_counter()
    leaf0 = acc.leaf_s
    try:
        yield
    finally:
        net = (time.perf_counter() - t0) - (acc.leaf_s - leaf0)
        if net > 0:
            acc.seconds[category] += net


def ledger_marks() -> dict:
    """Cumulative funnel totals of the CURRENT solve accumulator —
    the engine differences these around a ladder so the megachunk
    evidence table is fed from the same measured windows the ledger
    lands (one accounting funnel; the two can never disagree)."""
    acc = _ACC.get()
    if acc is None:
        return {"dispatches": 0, "dispatch_s": 0.0, "device_s": 0.0}
    return {
        "dispatches": (acc.cache_hits + acc.cache_misses
                       + acc.cache_fallbacks),
        "dispatch_s": acc.seconds["dispatch"],
        "device_s": acc.seconds["device"],
    }


# queue-wait tagging (serve's worker hop): the seconds a request sat in
# the solve queue before a worker picked it up. A dedicated contextvar
# (not `context()`): the watch manager's delta tagging REPLACES the
# ambient context, and the queue share must survive that
_QWAIT: contextvars.ContextVar = contextvars.ContextVar(
    "kao_flight_qwait", default=0.0
)


def set_queue_wait(seconds: float):
    """Tag solves on this context with measured queue-wait seconds
    (serve's ``_SolveQueue._execute`` hop); returns the reset token."""
    return _QWAIT.set(max(float(seconds), 0.0))


def reset_queue_wait(token) -> None:
    try:
        _QWAIT.reset(token)
    except ValueError:
        pass


def _ledger(acc: _SolveAcc | None, wall_s: float,
            trace_id=None) -> dict:
    """The wall-clock attribution ledger: every measured category plus
    the unattributed remainder, summing to ``wall_s`` + queue wait
    within epsilon. ``ok=False`` (plus a profiler counter) marks a
    ledger whose measured components exceeded the wall beyond epsilon
    — surfaced, never silently clamped."""
    secs = acc.seconds if acc is not None else {}
    queue_wait = _QWAIT.get()
    comp = {
        "constructor_s": secs.get("constructor", 0.0),
        "compile_s": secs.get("compile", 0.0),
        "dispatch_gap_s": secs.get("dispatch", 0.0),
        "device_s": secs.get("device", 0.0),
        "transfer_s": secs.get("transfer", 0.0),
        "boundary_s": secs.get("boundary", 0.0),
    }
    measured = sum(comp.values())
    other = wall_s - measured
    eps = max(LEDGER_EPS_S, LEDGER_EPS_FRAC * wall_s)
    ok = other >= -eps
    if not ok:
        from . import prof as _oprof

        _oprof.note_ledger_overrun()
    led = {
        "wall_s": round(queue_wait + wall_s, 4),
        "queue_wait_s": round(queue_wait, 4),
        **{k: round(v, 4) for k, v in comp.items()},
        "other_s": round(max(other, 0.0), 4),
        "ok": ok,
    }
    return led


@contextlib.contextmanager
def context(kind: str, **extra):
    """Tag solves under this block with ``kind`` (e.g. ``delta``) and
    identity fields (cluster, epoch) merged into their records."""
    tok = _CTX.set({"kind": kind, **extra})
    try:
        yield
    finally:
        try:
            _CTX.reset(tok)
        except ValueError:
            pass


# --------------------------------------------------------------------------
# kao_solve_seconds{class=...} histograms with worst-recent exemplars
# (the shared machinery lives in obs.trace.ExemplarHistogram so the
# bucket math and exemplar policy cannot drift from kao_phase_seconds)
# --------------------------------------------------------------------------

SOLVE_HIST = ExemplarHistogram(SOLVE_BUCKETS)


def observe_solve(cls: str, seconds: float,
                  trace_id: str | None = None) -> None:
    SOLVE_HIST.observe(cls, seconds, trace_id=trace_id)


def solve_snapshot() -> dict[str, dict]:
    """{class: {"buckets": [(le_str, cumulative), ...], "count": n,
    "sum": s}} — same shape as ``obs.trace.phase_snapshot``."""
    return SOLVE_HIST.snapshot()


def solve_exemplars() -> list[dict]:
    """Live worst-recent exemplars, one per non-empty (class, bucket):
    ``{"class", "le", "trace_id", "value", "age_s"}``."""
    return SOLVE_HIST.exemplars("class")


def reset_solve_stats() -> None:
    SOLVE_HIST.reset()


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------


class FlightRecorder:
    """Append-only JSONL sink with atomic rotation. Disabled (memory
    ring + SLO feed only) until :meth:`configure` names a directory."""

    def __init__(self):
        self._lock = threading.Lock()
        self._dir: str | None = None
        self._fh = None
        self._bytes = 0
        self.max_bytes = DEFAULT_MAX_BYTES
        self.max_files = DEFAULT_MAX_FILES
        self.records_total = 0
        self.write_errors_total = 0
        self.rotations_total = 0
        self._seq = 1
        self._warned = False

    @property
    def path(self) -> str | None:
        return (
            os.path.join(self._dir, "flight.jsonl") if self._dir else None
        )

    def configure(self, directory: str | None,
                  max_bytes: int | None = None,
                  max_files: int | None = None) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
            self._dir = directory or None
            if max_bytes is not None:
                self.max_bytes = max(int(max_bytes), 4096)
            if max_files is not None:
                self.max_files = max(int(max_files), 1)
            if self._dir:
                os.makedirs(self._dir, exist_ok=True)
                # resume the archive sequence past any prior process's
                # rotations so names stay unique and time-ordered
                self._seq = 1 + max(
                    (self._archive_seq(f)
                     for f in os.listdir(self._dir)),
                    default=0,
                )
                # probe-open the live file NOW: an existing-but-
                # unwritable directory must be a boot-time error
                # (serve maps it to ap.error, the CLI to exit 2), not
                # a per-solve warn loop silently dropping the ledger
                self._open_locked()

    @staticmethod
    def _archive_seq(name: str) -> int:
        if name.startswith("flight-") and name.endswith(".jsonl"):
            try:
                return int(name[len("flight-"):-len(".jsonl")])
            except ValueError:
                return 0
        return 0

    def enabled(self) -> bool:
        return self._dir is not None

    def _open_locked(self) -> None:
        self._fh = open(self.path, "a", encoding="utf-8")
        self._bytes = self._fh.tell()

    def _rotate_locked(self) -> None:
        """watch/store.py discipline: fsync the live file, atomically
        ``os.replace`` it to an archived name, reopen fresh, prune
        archives past the cap oldest-first."""
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
        except OSError:
            pass
        self._fh = None
        # zero-padded sequence names sort lexicographically in write
        # order (and before the live "flight.jsonl": '-' < '.'), so
        # iter_records over the directory replays chronologically
        dst = os.path.join(self._dir, f"flight-{self._seq:08d}.jsonl")
        self._seq += 1
        os.replace(self.path, dst)
        self.rotations_total += 1
        archives = sorted(
            f for f in os.listdir(self._dir)
            if f.startswith("flight-") and f.endswith(".jsonl")
        )
        for old in archives[: max(len(archives) - self.max_files, 0)]:
            try:
                os.remove(os.path.join(self._dir, old))
            except OSError:
                pass
        self._open_locked()

    def write(self, rec: dict) -> None:
        """Append one record; never raises (errors are counted and
        logged once). ``records_total`` counts SUCCESSFUL appends only
        — with no directory configured (or a failed write) it stays
        put, so the counter always agrees with the JSONL contents."""
        with self._lock:
            if self._dir is None:
                return
            try:
                if self._fh is None:
                    self._open_locked()
                line = json.dumps(rec, separators=(",", ":"),
                                  default=str)
                self._fh.write(line + "\n")
                self._fh.flush()
                self._bytes += len(line) + 1
                self.records_total += 1
                if self._bytes >= self.max_bytes:
                    self._rotate_locked()
            except OSError as e:
                self.write_errors_total += 1
                self._fh = None  # reopen on the next write
                if not self._warned:
                    self._warned = True
                    _olog.warn("flight_write_failed",
                               path=self.path, error=repr(e)[:200])

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": int(self._dir is not None),
                "dir": self._dir,
                "records_total": self.records_total,
                "write_errors_total": self.write_errors_total,
                "rotations_total": self.rotations_total,
                "max_bytes": self.max_bytes,
                "max_files": self.max_files,
            }


RECORDER = FlightRecorder()
# the in-memory tail of the record stream (GET /debug/slo, tests)
_RECENT_LOCK = threading.Lock()
RECENT: deque = deque(maxlen=_RECENT_CAP)
# records that entered the STREAM (ring + SLO + histograms) — distinct
# from the recorder's records_total, which counts only disk appends
_STREAM_TOTAL = [0]
# per-worker monotonic sequence, stamped into every record under the
# same lock that orders the ring — seq order IS ring order
_SEQ = [0]
# device-occupancy duty accounting (obs.sampler): cumulative device /
# dispatch seconds landed by completed solves; the sampler differences
# these between ticks to derive the dispatch-accumulator duty cycle
_DUTY_LOCK = threading.Lock()
_DUTY = {"device_s": 0.0, "dispatch_s": 0.0, "wall_s": 0.0, "solves": 0}


def duty_totals() -> dict:
    with _DUTY_LOCK:
        return dict(_DUTY)


def _note_duty(rec: dict) -> None:
    split = rec.get("split") or {}
    with _DUTY_LOCK:
        _DUTY["device_s"] += float(split.get("device_s") or 0.0)
        _DUTY["dispatch_s"] += float(split.get("dispatch_s") or 0.0)
        _DUTY["wall_s"] += float(rec.get("wall_s") or 0.0)
        _DUTY["solves"] += 1


class StreamClient:
    """One ``GET /debug/stream`` subscriber: a bounded queue the record
    fan-out offers into. A full queue (slow client) drops the NEWEST
    record for THIS client only and counts it — the solve path never
    blocks on a reader."""

    __slots__ = ("_q", "dropped_total")

    def __init__(self, maxlen: int = STREAM_QUEUE_LEN):
        self._q: _queue.Queue = _queue.Queue(maxsize=max(int(maxlen), 1))
        self.dropped_total = 0

    def get(self, timeout: float | None = None) -> dict | None:
        """Next record, or None on timeout (heartbeat opportunity)."""
        try:
            return self._q.get(timeout=timeout)
        except _queue.Empty:
            return None

    def _offer(self, rec: dict) -> None:
        try:
            self._q.put_nowait(rec)
        except _queue.Full:
            self.dropped_total += 1
            with _STREAM_LOCK:
                _STREAM_DROPPED[0] += 1


_STREAM_LOCK = threading.Lock()
_STREAM_CLIENTS: list[StreamClient] = []
_STREAM_DROPPED = [0]


def subscribe(maxlen: int = STREAM_QUEUE_LEN) -> StreamClient:
    """Register a live-stream subscriber; raises RuntimeError at the
    client cap (the caller sheds with 503 + Retry-After)."""
    client = StreamClient(maxlen)
    with _STREAM_LOCK:
        if len(_STREAM_CLIENTS) >= MAX_STREAM_CLIENTS:
            raise RuntimeError(
                f"stream client cap reached ({MAX_STREAM_CLIENTS}); "
                "retry later or raise KAO_STREAM_CLIENTS"
            )
        _STREAM_CLIENTS.append(client)
    return client


def unsubscribe(client: StreamClient) -> None:
    with _STREAM_LOCK:
        try:
            _STREAM_CLIENTS.remove(client)
        except ValueError:
            pass


def stream_stats() -> dict:
    with _STREAM_LOCK:
        return {
            "clients": len(_STREAM_CLIENTS),
            "dropped_total": _STREAM_DROPPED[0],
        }


def configure(directory: str | None, **kw) -> None:
    RECORDER.configure(directory, **kw)


def enabled() -> bool:
    return RECORDER.enabled()


def snapshot() -> dict:
    with _RECENT_LOCK:
        stream = _STREAM_TOTAL[0]
    return {**RECORDER.snapshot(), "stream_records_total": stream}


def recent(n: int | None = None, kind: str | None = None) -> list[dict]:
    with _RECENT_LOCK:
        recs = list(RECENT)
    if kind is not None:
        recs = [r for r in recs if r.get("kind") == kind]
    return recs[-n:] if n else recs


def reset_recent() -> None:
    with _RECENT_LOCK:
        RECENT.clear()


def record(rec: dict) -> None:
    """Land one flight record on every sink. Never raises.

    Stamps the worker identity + per-worker monotonic ``seq`` here —
    the ONE funnel every record builder goes through — so the fleet
    merge key exists on solve, failure, delta, lane, and exact-oracle
    records alike. Also fans the record out to live-stream subscribers
    (``GET /debug/stream``) and the drift monitor (``obs.drift``)."""
    try:
        with _RECENT_LOCK:
            _SEQ[0] += 1
            rec.setdefault("worker", worker_identity())
            rec.setdefault("seq", _SEQ[0])
            RECENT.append(rec)
            _STREAM_TOTAL[0] += 1
        RECORDER.write(rec)
        with _STREAM_LOCK:
            clients = list(_STREAM_CLIENTS)
        for c in clients:
            c._offer(rec)
        _note_duty(rec)
        observe_solve(rec.get("kind") or "solve",
                      float(rec.get("wall_s") or 0.0),
                      rec.get("trace_id"))
        from . import drift as _drift
        from . import slo as _slo

        _slo.ENGINE.observe_record(rec)
        _drift.MONITOR.observe_record(rec)
    except Exception as e:  # telemetry must never fail a solve
        _olog.warn("flight_record_failed", error=repr(e)[:200])


def _split(stats: dict, acc: _SolveAcc | None, wall_s: float) -> dict:
    """The compile/device/host wall split: device + dispatch seconds
    come from the ladder accounting, compile from this solve's own
    accumulator, host is the remainder — the components sum to
    ~wall_s. Dispatch is compile-INCLUSIVE on first contact
    (docs/PIPELINE.md), so the remainder subtracts
    ``max(dispatch, compile)`` rather than both: subtracting both
    would double-count the compile that happened inside the enqueue
    window."""
    device_s = float(stats.get("device_s") or 0.0)
    dispatch_s = float(stats.get("dispatch_s") or 0.0)
    compile_s = round(acc.compile_s, 4) if acc else 0.0
    host_s = max(wall_s - device_s - max(dispatch_s, compile_s), 0.0)
    out = {
        "compile_s": compile_s,
        "device_s": round(device_s, 4),
        "dispatch_s": round(dispatch_s, 4),
        "host_s": round(host_s, 4),
    }
    # ladder dispatch count + duty cycle: duty is the
    # fraction of the solve's device-facing wall the device was
    # actually computing — megachunk fusion raises it by collapsing
    # per-chunk enqueue round-trips (docs/OBSERVABILITY.md)
    if stats.get("dispatches") is not None:
        out["dispatches"] = int(stats["dispatches"])
        busy = device_s + dispatch_s
        out["duty_cycle"] = round(device_s / busy, 4) if busy > 0 else None
    return out


def record_solve(result, inst=None, acc: _SolveAcc | None = None,
                 *, kind: str | None = None,
                 wall_s: float | None = None,
                 extra: dict | None = None) -> dict | None:
    """Build and land the compact record for one finished engine solve
    (``result``: a SolveResult). The ambient :func:`context` supplies
    the kind + identity for delta solves; ``kind`` overrides (batch
    lanes). Returns the record (tests), or None on failure — recording
    never raises into the solve path."""
    try:
        st = result.stats
        ctx = _CTX.get() or {}
        k = kind or ctx.get("kind") or "solve"
        wall = float(wall_s if wall_s is not None
                     else result.wall_clock_s)
        bucket = None
        if inst is not None:
            bucket = [
                int(inst.num_brokers), int(inst.num_racks),
                int(st["bucket_parts"]) if st.get("bucket_parts")
                is not None else None,
                int(st["bucket_rf"]) if st.get("bucket_rf")
                is not None else None,
            ]
        rep = st.get("solve_report") or {}
        phases = {
            p: round(float(v), 4)
            for p, v in (rep.get("phases") or {}).items()
        } or {
            # untraced solve: the engine's own coarse phase clocks
            "seed": round(float(st.get("seed_s") or 0.0), 4),
            "ladder": round(float(st.get("anneal_s") or 0.0), 4),
            "polish": round(float(st.get("polish_s") or 0.0), 4),
        }
        construct_path = st.get("construct_path")
        rec = {
            "ts": round(time.time(), 3),
            "kind": k,
            "trace_id": st.get("trace_id"),
            "engine": st.get("engine"),
            "bucket": bucket,
            "wall_s": round(wall, 4),
            "phases": phases,
            # wall-clock attribution (docs/OBSERVABILITY.md "Reading a
            # roofline"): queue-wait / constructor / compile /
            # dispatch-gap / device / transfer / boundary / other,
            # summing to wall + queue within epsilon
            "ledger": _ledger(acc, wall),
            "split": _split(st, acc, wall),
            "cache": {
                "hits": acc.cache_hits if acc else 0,
                "misses": acc.cache_misses if acc else 0,
                "fallbacks": acc.cache_fallbacks if acc else 0,
                "compiles": acc.compiles if acc else 0,
            },
            "degradations": list(st.get("degradations") or ()),
            "warm": {
                # warm path = no compile paid by THIS solve
                "warm_path": not (acc.compiles if acc else 0),
                "warm_started": bool(st.get("warm_started")),
                "warm_certify": construct_path == "warm",
                "resumed": bool(st.get("resumed_from_checkpoint")),
                "construct_path": construct_path,
            },
            "quality": {
                "feasible": bool(st.get("feasible")),
                "certified": bool(st.get("proved_optimal")),
                "moves": st.get("moves"),
                "objective": getattr(result, "objective", None),
                "timed_out": bool(st.get("timed_out")),
                "degraded": bool(st.get("degraded")),
            },
        }
        if st.get("portfolio"):
            # winner-lane provenance (docs/PORTFOLIO.md): which lane
            # config produced the plan, whether a first-to-certify
            # boundary retired the ladder, and when
            rec["portfolio"] = dict(st["portfolio"])
        if st.get("megachunk"):
            # fused-ladder provenance (docs/PIPELINE.md):
            # resolved width + chooser mode, group/chunk counts, and
            # whether an on-device certificate retired the scan
            rec["megachunk"] = dict(st["megachunk"])
        if st.get("decompose"):
            # map-reduce provenance (docs/DECOMPOSE.md): sub-problem
            # count, map<->reduce iterations, and the certificate-or-
            # bound-gap outcome of the stitched plan
            d = st["decompose"]
            rec["decompose"] = {
                "subproblems": d.get("subproblems"),
                "iterations": d.get("iterations"),
                "boundary_parts": d.get("boundary_parts"),
                "certified": bool(d.get("certified")),
                "bound_gap": d.get("bound_gap"),
            }
        for key, v in {**ctx, **(extra or {})}.items():
            if key != "kind" and key not in rec:
                rec[key] = v
        if rep:
            # dispatch-gap series from the solve report's span
            # timestamps (obs.prof): p99-gap exemplars carry this
            # trace_id into the trace chain
            from . import prof as _oprof

            _oprof.observe_gaps(rep, rec.get("trace_id"))
        record(rec)
        return rec
    except Exception as e:
        _olog.warn("flight_record_failed", error=repr(e)[:200])
        return None


def record_failure(inst, acc: _SolveAcc | None, wall_s: float,
                   error: BaseException, *,
                   kind: str | None = None) -> dict | None:
    """The record for a solve that RAISED: no plan, no quality — but
    the failure must burn the SLO quality budget and land in the
    ledger, or a total outage of the solve path reads as zero burn
    ("the page condition never fires because nothing completed").
    Never raises."""
    try:
        ctx = _CTX.get() or {}
        rec = {
            "ts": round(time.time(), 3),
            "kind": kind or ctx.get("kind") or "solve",
            "trace_id": None,
            "engine": None,
            "bucket": (
                [int(inst.num_brokers), int(inst.num_racks), None,
                 None] if inst is not None else None
            ),
            "wall_s": round(float(wall_s), 4),
            "phases": {},
            # failures still carry their measured windows — whatever
            # the solve paid before raising is attributed, the rest
            # lands in other
            "ledger": _ledger(acc, float(wall_s)),
            "split": _split({}, acc, float(wall_s)),
            "cache": {
                "hits": acc.cache_hits if acc else 0,
                "misses": acc.cache_misses if acc else 0,
                "fallbacks": acc.cache_fallbacks if acc else 0,
                "compiles": acc.compiles if acc else 0,
            },
            "degradations": [],
            "warm": {"warm_path": False, "warm_started": False,
                     "warm_certify": False, "resumed": False,
                     "construct_path": None},
            "quality": {"feasible": False, "certified": False,
                        "moves": None, "objective": None,
                        "timed_out": False, "degraded": False},
            "error": repr(error)[:200],
        }
        from . import trace as _otrace

        rec["trace_id"] = _otrace.current_trace_id()
        for key, v in ctx.items():
            if key != "kind" and key not in rec:
                rec[key] = v
        record(rec)
        return rec
    except Exception as e:
        _olog.warn("flight_record_failed", error=repr(e)[:200])
        return None


def record_optimize(result) -> dict | None:
    """Reduced record for a non-TPU (exact-oracle) solve —
    ``api.optimize`` calls this when the resolved solver has no
    engine-level recorder, so exact-solver traffic (the small-instance
    path ``auto`` routes to MILP/native) still lands in the SLO ledger.
    Phase/split/cache columns are annealing-engine concepts and stay
    empty; quality is computed against the same oracle every solver
    answers to. Never raises."""
    try:
        solve = result.solve
        inst = result.instance
        viol = inst.violations(solve.a)
        from . import trace as _otrace

        ctx = _CTX.get() or {}
        rec = {
            "ts": round(time.time(), 3),
            "kind": ctx.get("kind") or "solve",
            "trace_id": (solve.stats.get("trace_id")
                         or _otrace.current_trace_id()),
            "engine": solve.solver,
            "bucket": [int(inst.num_brokers), int(inst.num_racks),
                       None, None],
            "wall_s": round(float(result.wall_clock_s), 4),
            "phases": {},
            # exact-oracle solves pay no device windows: the ledger is
            # degenerate (queue + other = wall) but PRESENT, so every
            # record kind answers the same attribution query
            "ledger": _ledger(None, float(result.wall_clock_s)),
            "split": {"compile_s": 0.0, "device_s": 0.0,
                      "dispatch_s": 0.0,
                      "host_s": round(float(result.wall_clock_s), 4)},
            "cache": {"hits": 0, "misses": 0, "fallbacks": 0,
                      "compiles": 0},
            "degradations": list(solve.stats.get("degradations") or ()),
            "warm": {
                "warm_path": True,  # exact solvers never compile
                "warm_started": False,
                "warm_certify": False,
                "resumed": False,
                "construct_path": solve.solver,
            },
            "quality": {
                "feasible": all(v == 0 for v in viol.values()),
                "certified": bool(solve.optimal),
                "moves": result.moves.replica_moves,
                "objective": solve.objective,
                "timed_out": False,
                "degraded": bool(solve.stats.get("degraded")),
            },
        }
        for key, v in ctx.items():
            if key != "kind" and key not in rec:
                rec[key] = v
        record(rec)
        return rec
    except Exception as e:
        _olog.warn("flight_record_failed", error=repr(e)[:200])
        return None


def iter_records(path: str):
    """Yield records from one flight JSONL file (or every file,
    archives first, when ``path`` is a directory). A torn/corrupt line
    — the kill -9 tail — is skipped, never fatal."""
    paths = [path]
    if os.path.isdir(path):
        names = sorted(
            f for f in os.listdir(path)
            if f.startswith("flight") and f.endswith(".jsonl")
        )
        # archives (flight-*) sort before the live file (flight.jsonl)
        # lexicographically already: '-' < '.'
        paths = [os.path.join(path, f) for f in names]
    for p in paths:
        try:
            with open(p, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        yield json.loads(line)
                    except ValueError:
                        continue  # torn tail / bit rot: skip
        except OSError:
            continue


def _parse_lines(chunk: bytes, buf: bytes):
    """Split ``buf + chunk`` into complete JSON lines; returns
    (records, remaining_partial). A torn trailing line stays buffered
    until its newline lands — never parsed early. Bytes in, so byte
    offsets stay exact for the :func:`snapshot_records` resume
    handoff."""
    buf += chunk
    out = []
    while b"\n" in buf:
        line, buf = buf.split(b"\n", 1)
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            continue  # bit rot mid-stream: skip the line
    return out, buf


def _live_and_dir(path: str) -> tuple[str, str]:
    if os.path.isdir(path):
        return os.path.join(path, "flight.jsonl"), path
    return path, os.path.dirname(path) or "."


def _list_archives(dirpath: str) -> list:
    """[(seq, fullpath, inode)] for the dir's archives, seq-sorted
    (the writer's zero-padded names make seq == write order)."""
    rows = []
    try:
        names = os.listdir(dirpath)
    except OSError:
        return rows
    for name in names:
        seq = FlightRecorder._archive_seq(name)
        if seq <= 0:
            continue
        full = os.path.join(dirpath, name)
        try:
            rows.append((seq, full, os.stat(full).st_ino))
        except OSError:
            continue  # pruned between listdir and stat
    rows.sort()
    return rows


def snapshot_records(path: str) -> tuple[list, tuple]:
    """Every record currently on disk (archives in write order, then
    the live file), plus a RESUME token for :func:`follow_records` —
    the gap-free ``kao-trace flight --tail --follow`` handoff: a
    record landing between this snapshot and the follow's first read
    is delivered by the follow, never skipped and never duplicated.

    The token is ``(live_inode, live_byte_offset, seen_archive_seq)``;
    ``seen_archive_seq`` is captured BEFORE the live read, so a
    rotation racing the snapshot leaves the rotated-in archive above
    the watermark for the follower to catch up."""
    live, dirpath = _live_and_dir(path)
    archives = _list_archives(dirpath)
    seen_seq = max((s for s, _f, _i in archives), default=0)
    records: list = []
    for _seq, full, _ino in archives:
        try:
            with open(full, "rb") as fh:
                recs, _rest = _parse_lines(fh.read(), b"")
                records.extend(recs)
        except OSError:
            continue
    ino, offset = None, 0
    try:
        with open(live, "rb") as fh:
            ino = os.fstat(fh.fileno()).st_ino
            data = fh.read()
        # resume at the byte after the last COMPLETE line: a torn tail
        # stays for the follower, which buffers it until the newline
        offset = data.rfind(b"\n") + 1
        recs, _rest = _parse_lines(data[:offset], b"")
        records.extend(recs)
    except OSError:
        pass
    return records, (ino, offset, seen_seq)


def follow_records(path: str, *, poll_s: float = 0.2,
                   stop=None, from_start: bool = False,
                   resume: tuple | None = None):
    """``tail -f`` the live flight JSONL, surviving rotation
    (``kao-trace flight --follow``).

    Rotation contract (matches :meth:`FlightRecorder._rotate_locked`):
    the writer ``os.replace``s the live file to a ``flight-NNNNNNNN``
    archive and opens a fresh, EMPTY live file. The follower holds the
    OLD fd, so on detecting the swap it (1) drains every record still
    unread from that fd, (2) reads any archives that rotated in SINCE
    it last looked — a fast writer can rotate several times between
    polls — skipping the archive whose inode it just drained and
    anything at or below the highest archive sequence already
    consumed, then (3) reopens the new live file FROM ITS START, which
    contains only post-rotation records. A record is therefore never
    yielded twice; none is skipped short of archive pruning outrunning
    the follower. Partial trailing lines are buffered until their
    newline lands.

    ``stop`` is an optional zero-arg callable polled between reads;
    ``from_start=False`` (the default) begins at the live file's
    current end, like ``tail -f``; ``resume`` is the token from
    :func:`snapshot_records` — the follow continues at the exact byte
    the snapshot stopped at (rotation-safe), so snapshot + follow
    covers the stream gap-free."""
    path, dirpath = _live_and_dir(path)

    def _read_archive(full: str, start: int = 0):
        try:
            with open(full, "rb") as af:
                if start:
                    af.seek(start)
                recs, _rest = _parse_lines(af.read(), b"")
                return recs
        except OSError:
            return []  # pruned mid-read: its records are gone

    fh = None
    ino = None
    buf = b""
    first_open = True
    resume_pending = resume is not None
    if resume is not None:
        resume_ino, resume_offset, seen_seq = resume
    else:
        resume_ino, resume_offset = None, 0
        # archives present at start are history, never re-read
        seen_seq = max(
            (s for s, _f, _i in _list_archives(dirpath)), default=0
        )
    while True:
        if fh is None:
            try:
                fh = open(path, "rb")
                ino = os.fstat(fh.fileno()).st_ino
            except OSError:
                fh = None
            if fh is not None:
                if resume_pending:
                    resume_pending = False
                    if ino == resume_ino:
                        # no rotation since the snapshot (archives only
                        # appear via rotation, which changes the live
                        # inode): continue at the exact byte it
                        # stopped at
                        fh.seek(resume_offset)
                    else:
                        # rotations since the snapshot: the snapshot's
                        # live file is an archive now — read it from
                        # the snapshot offset, newer archives in full;
                        # the just-opened live file reads from start
                        for seq, full, a_ino in _list_archives(dirpath):
                            if a_ino == ino:
                                # the fd we JUST opened rotated out
                                # before this listing: it reads these
                                # bytes itself (from offset 0), so
                                # reading the archive too would yield
                                # every record twice
                                seen_seq = max(seen_seq, seq)
                                continue
                            if seq <= seen_seq:
                                continue
                            yield from _read_archive(
                                full,
                                resume_offset if a_ino == resume_ino
                                else 0,
                            )
                            seen_seq = max(seen_seq, seq)
                elif first_open and not from_start:
                    fh.seek(0, os.SEEK_END)
            first_open = False
        got = b""
        if fh is not None:
            try:
                got = fh.read()
            except OSError:
                got = b""
            if got:
                recs, buf = _parse_lines(got, buf)
                yield from recs
        if fh is not None and not got:
            # at EOF of the fd we hold: has the live path moved on?
            try:
                cur = os.stat(path).st_ino
            except OSError:
                cur = None  # between os.replace and the fresh open
            if cur != ino:
                # final drain: the writer may have appended between our
                # last read and the swap; the archived inode is frozen
                # now, so read-to-EOF is complete
                while True:
                    try:
                        tail_chunk = fh.read()
                    except OSError:
                        break
                    if not tail_chunk:
                        break
                    recs, buf = _parse_lines(tail_chunk, buf)
                    yield from recs
                try:
                    fh.close()
                except OSError:
                    pass
                fh = None
                buf = b""
                # catch up on archives that rotated in since the last
                # look: skip the one we just drained by inode, and
                # everything already consumed by sequence
                for seq, full, a_ino in _list_archives(dirpath):
                    if a_ino == ino:
                        seen_seq = max(seen_seq, seq)
                        continue  # the fd above already delivered it
                    if seq <= seen_seq:
                        continue
                    yield from _read_archive(full)
                    seen_seq = max(seen_seq, seq)
                continue  # reopen the new live file from its start
        if stop is not None and stop():
            return
        if not got:
            time.sleep(poll_s)
