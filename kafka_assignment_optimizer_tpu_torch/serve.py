"""HTTP service — optimizer-as-a-service, on the card.

The reference package's ``serve``, route for route and body for body,
driving this package's solver: every ``tpu`` solve (and every solve that
``auto`` sends there) runs on the card through the hand-written CUDA
kernels unless the service was started with ``--device cpu``; it never
moves to the CPU on its own. Stdlib-only (ThreadingHTTPServer).

Endpoints:

``POST /submit``
    Request JSON::

        {
          "assignment": {"version": 1, "partitions": [...]},   # required
          "brokers": "0-18" | [0, 1, ...],                     # required
          "topology": {"0": "rackA", ...} | "even-odd" | null,
          "rf": 3 | {"topic": 3} | null,
          "solver": "auto" | "milp" | "native" | "tpu" | "lp_solve",
          "options": {"seed": 0, "batch": 8, ...}              # solver kwargs
        }

    Response 200: ``{"assignment": {...}, "report": {...}, "trace_id"}``.
    ``options`` accepts search knobs only (``ALLOWED_OPTIONS``); every
    solve is capped at ``--max-solve-s``. Errors: 400 malformed input or
    disallowed option, 422 model rejected the inputs, 500 solver failure,
    501 an option value this package does not support yet, 503 load shed
    (with ``Retry-After`` and ``reason``/``retry_after_s`` in the body).

``POST /evaluate``
    Audit an EXISTING plan (``api.evaluate``; host work only, on its own
    lock).

``GET /`` and ``GET /schema``
    The landing page and the request schema (the reference's, byte for
    byte).

``POST /warmup``
    Pre-pay the first-solve costs of a list of cluster shapes (kernel
    builds, the lane and portfolio paths) with ``precompile=True``
    solves; also at startup via ``--warmup B:P[:R[:K]],...``.

``POST /clusters/<id>/events``, ``GET /clusters``, ``GET /clusters/<id>``
    The cluster-watch delta API (``watch``): epoch-fenced typed events,
    warm-started delta solves through ``api.optimize_delta``.

``GET /clusters/<id>/rollout`` and
``POST /clusters/<id>/rollout/{start,advance,pause,rollback}``
    Streaming plan rollout (``rollout``, docs/ROLLOUT.md): execute the
    cluster's certified plan as bandwidth-budgeted move waves (no broker
    or rack exceeds a per-wave transfer cap), with canary verification
    gating advancement, epoch-fenced commands (stale -> structured 409
    without touching the store), bit-exact rollback via inverse waves,
    and mid-rollout cluster events re-planning the remaining waves
    against the partially-moved ground truth. Each wave is emitted as
    upstream-compatible reassignment JSON.

``GET /healthz`` and ``GET /metrics``
    Health and the ``kao_*`` Prometheus families.

``GET /debug/solves``, ``GET /debug/solves/<trace_id>``,
``GET /debug/stream``, ``GET /debug/fleet``
    Solve reports (``obs.trace``; ``?format=chrome`` gives the Chrome
    trace-event JSON of ``obs.chrome``), the live flight-record stream
    (``obs.flight``), and this worker's records merged with those of its
    ``--fleet-peers`` (``obs.fleet``).

``GET /debug/slo`` and ``GET /debug/profile``
    The SLO engine's burn rates and the drift monitor (``obs.slo``,
    ``obs.drift``; ``--slo``), and the roofline observatory
    (``obs.prof``): per-key occupancy against the analytic cost of the
    three CUDA launches, ledger attribution, dispatch gaps.
    ``--sample-devices HZ`` arms the device sampler (``obs.sampler``,
    ``/healthz`` ``devices``); ``--profile-dir``/``--profile-solves``
    capture ``torch.profiler`` traces of the first solves per bucket.

``GET /debug/kernels``
    This package's own: each CUDA kernel wrapper's launch count in this
    process and the kernel build directory's hits and misses.

Several workers sharing a ``--watch-dir`` (and a kernel build directory)
run behind ``kao-router`` (``fleet.router``).

Concurrency: solves run on a bounded request queue drained by a small
worker pool (``--workers``, default 2: two solves share the card);
same-bucket ``tpu`` solves that arrive while the pool is busy coalesce
into one ``optimize_batch`` (``--batch-window-ms``, ``--max-batch``),
its lanes padded up ``bucket.lane_bucket`` as in the reference.

Run: ``python -m kafka_assignment_optimizer_tpu_torch.serve --port 8787``
(``--device cpu`` to serve from the CPU).
"""

from __future__ import annotations

import argparse
import json
import queue as _queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import landing
from .analysis import sanitize as _sanitize_mod
from .api import optimize
from .models.cluster import Assignment, Topology, parse_broker_list
from .obs import chrome as _ochrome
from .obs import drift as _odrift
from .obs import expo as _expo
from .obs import flight as _oflight
from .obs import log as _olog
from .obs import prof as _oprof
from .obs import sampler as _osampler
from .obs import slo as _oslo
from .obs import trace as _otrace
from .resilience import breaker as _breaker
from .resilience import budget as _rbudget
from .resilience import chaos as _chaos
from .resilience import ladder as _ladder
from .rollout import exec as _rexec
from .rollout import state as _rstate
from .rollout import waves as _rwaves
from .utils import platform as _platform
from .watch import events as _wevents
from .watch import manager as _wmanager
from .watch import store as _wstore

# audits (/evaluate) hold their OWN lock: they are pure host-side work
# (numpy + bound LPs + the native flow kernel, no device), so they never
# queue behind a device solve. One audit at a time still bounds host
# CPU: the bound LPs cost seconds at 10k partitions.
_AUDIT_LOCK = threading.Lock()

MAX_BODY_BYTES = 64 << 20  # 64 MiB — a 10k-partition cluster is ~1 MiB

# Options the HTTP surface forwards to solvers: search-effort knobs only.
# Path-valued solver kwargs (``checkpoint``, ``profile_dir``) are
# deliberately NOT forwardable — a remote client must never be able to
# make the service create directories or read/write files at
# client-chosen paths. Operators who want checkpointing use the CLI.
ALLOWED_OPTIONS = frozenset({
    "seed", "batch", "rounds", "sweeps", "steps_per_round", "engine",
    "time_limit_s", "t_hi", "t_lo", "n_devices", "pipeline",
    "portfolio", "decompose", "megachunk",
})

# saturation policy: how long a request waits for a queue slot before
# the service sheds it with 503 (a single 10k-partition solve must not
# make every later POST hang indefinitely), and the time limit injected
# into each solve unless the client sets a smaller one
DEFAULT_LOCK_WAIT_S = 30.0
DEFAULT_MAX_SOLVE_S = 300.0
DEFAULT_WORKERS = 2
DEFAULT_QUEUE_DEPTH = 4
# maintenance drain window (--queue-wait-s): how long the periodic
# maintenance pass waits for in-flight solves before skipping
DEFAULT_QUEUE_WAIT_S = 15.0

# the solve device of every tpu solve this service runs (--device; the
# card unless the operator asks for the CPU)
SERVE = {"device": "cuda"}

# serve-side resilience knobs (docs/RESILIENCE.md), set by main():
# - default_deadline_s: per-request end-to-end deadline applied when
#   the request carries no "deadline_s" field (None = no deadline
#   beyond --max-solve-s);
# - checkpoint_dir: operator-chosen directory for per-cluster solve
#   checkpoints, keyed by instance FINGERPRINT (never a client path —
#   the path-valued-option rejection above still stands). Enables
#   crash-safe auto-resume: a retried or repeated solve of the same
#   cluster warm-starts from the last completed plan.
RESILIENCE = {
    "default_deadline_s": None,
    "checkpoint_dir": None,
    # --checkpoint-dir hygiene: the periodic maintenance pass GCs
    # fingerprint-keyed .npz checkpoints past these caps (age first, then
    # oldest beyond the count cap); the live file count is exported as the
    # kao_checkpoint_files gauge
    "checkpoint_max_files": 512,
    "checkpoint_max_age_s": 7 * 24 * 3600.0,
}

# cluster-watch delta API (docs/WATCH.md): POST /clusters/<id>/events.
# "dir" is the OPERATOR-chosen durable plan-store directory
# (--watch-dir); without it the watch endpoints still work but state is
# process-local only (healthz says durable: false). The registry is
# built lazily so tests can point "dir" somewhere and reset.
WATCH = {
    "dir": None,
    "window_s": _wmanager.DEFAULT_WINDOW_S,
    "max_backlog": _wmanager.DEFAULT_MAX_BACKLOG,
    "registry": None,
    "lock_wait_s": DEFAULT_LOCK_WAIT_S,
    "max_solve_s": DEFAULT_MAX_SOLVE_S,
}

# streaming plan rollout (docs/ROLLOUT.md): GET /clusters/<id>/rollout
# + POST /clusters/<id>/rollout/{start,advance,pause,rollback}. The
# manager rides the watch registry (same plan store, same solve path
# for mid-rollout re-plans) and is rebuilt whenever the registry is —
# tests that reset WATCH["registry"] get a fresh manager for free.
ROLLOUT = {
    "manager": None,
    "broker_cap": _rwaves.DEFAULT_BROKER_CAP,
    "rack_cap": _rwaves.DEFAULT_RACK_CAP,
    "packer": "greedy",
    "lanes": _rwaves.DEFAULT_LANES,
}
# the kao_rollout_* counter families, pre-declared at zero so
# dashboards see them before the first rollout
_ROLLOUT_COUNTER_NAMES = (
    "started_total", "commands_total", "fenced_total",
    "waves_emitted_total", "waves_applied_total", "canary_fail_total",
    "rollbacks_total", "replans_total", "completed_total", "active",
)

# circuit breaker on repeated solver failures per bucket key
# (resilience.breaker): a bucket that keeps failing compile/dispatch
# sheds instantly with Retry-After instead of burning a full
# compile-and-crash cycle per request
_BREAKER = _breaker.CircuitBreaker()
# request coalescing (--batch-window-ms / --max-batch): same-bucket TPU
# solves that arrive while the pool is busy are grouped for up to the
# window, then submitted as ONE batched lane solve (engine.solve_tpu_batch)
# and demultiplexed. A request that finds free capacity bypasses the
# window entirely — sparse traffic pays zero added latency.
DEFAULT_BATCH_WINDOW_MS = 25.0
DEFAULT_MAX_BATCH = 8
# options the batched lane path understands; a request carrying any
# other knob (e.g. steps_per_round) takes the single-solve path
_BATCHABLE_OPTIONS = frozenset({
    "seed", "batch", "rounds", "sweeps", "engine", "time_limit_s",
    "t_hi", "t_lo", "n_devices", "pipeline", "portfolio", "megachunk",
})
# maintenance cadence: the checkpoint-dir hygiene pass runs after this
# many completed solves (see _SolveQueue._maintenance)
_CLEAR_CACHES_EVERY = 64

# solve-trace telemetry (docs/OBSERVABILITY.md): every request gets a
# trace ID; the solve runs under an ambient obs.trace span tree whose
# report lands in the ring buffer behind GET /debug/solves/<trace_id>
# and is echoed as "trace_id" in the response envelope. --no-trace
# disables it (requests then carry no trace_id). --profile-dir
# additionally wraps the first --profile-solves tpu solves per bucket
# in a torch.profiler trace capture (kernel-level evidence next to the
# span-level reports). --flight-dir persists one compact flight record
# per solve/delta/batch-lane (obs.flight); the SLO engine (obs.slo)
# runs over the record stream either way
OBS = {
    "trace": True,
    "profile_dir": None,
    "profile_solves": 1,
    "flight_dir": None,
}
# fleet telemetry plane (docs/OBSERVABILITY.md "Fleet plane"):
# GET /debug/fleet merges THIS worker's record ring with the recent
# streams of the operator-named peers (--fleet-peers; client-supplied
# peer URLs are deliberately not accepted — the server must never be
# pointable at attacker-chosen endpoints)
FLEET = {
    "peers": [],
    "timeout_s": 5.0,
    "tail": 512,
}

# process start, for the kao_uptime_seconds gauge
_START_UNIX = time.time()
# kao_build_info labels, resolved once
_BUILD_INFO: dict = {}


def _build_info(resolve: bool = False) -> dict:
    """kao_build_info labels (the package version, torch's version, the
    service's device and the card count). ``/metrics`` reads the cache
    only; ``handle_healthz`` resolves it (``resolve=True``)."""
    if not _BUILD_INFO and resolve:
        try:
            import torch

            from . import __version__

            _BUILD_INFO.update({
                "version": __version__,
                "torch": torch.__version__,
                "backend": SERVE["device"],
                "devices": str(torch.cuda.device_count()
                               if torch.cuda.is_available() else 0),
            })
        except Exception:  # uncached, retried next probe
            pass
    if not _BUILD_INFO:
        return {"version": "unknown", "torch": "unknown",
                "backend": "unknown", "devices": "0"}
    return dict(_BUILD_INFO)


_PROFILE_LOCK = threading.Lock()
_PROFILED_BUCKETS: dict[tuple, int] = {}  # bucket key -> solves profiled


def _profile_dir_for(bucket_key: tuple, trace_id: str | None) -> str | None:
    """Claim one profiled solve for ``bucket_key`` if the per-bucket
    budget (--profile-solves) has room; returns the capture directory
    (unique per solve) or None."""
    base = OBS["profile_dir"]
    if not base:
        return None
    with _PROFILE_LOCK:
        n = _PROFILED_BUCKETS.get(bucket_key, 0)
        if n >= max(int(OBS["profile_solves"]), 0):
            return None
        _PROFILED_BUCKETS[bucket_key] = n + 1
    import os

    safe = "-".join(
        str(x) for x in bucket_key if isinstance(x, (int, str))
    ) or "default"
    return os.path.join(base, safe, trace_id or _otrace.new_trace_id())


def _tpu_kw(solver_eff: str) -> dict:
    """The solver keywords every ``tpu`` solve of this service gets: its
    device (the host backends take none). The fused width of a request
    that sets no megachunk option is the engine's process default
    (``--megachunk``, ``KAO_MEGACHUNK``)."""
    if solver_eff != "tpu":
        return {}
    return {"device": SERVE["device"]}


class _QueueItem:
    __slots__ = ("fn", "done", "result", "exc", "abandoned", "enq")

    def __init__(self, fn):
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self.exc: BaseException | None = None
        self.abandoned = False
        # enqueue timestamp: the worker differences it at pickup so the
        # flight ledger's queue-wait share is measured, not inferred
        self.enq = time.perf_counter()


class _SolveQueue:
    """Bounded request queue + worker pool — the serving path that
    replaced the serialize-everything solve lock. Overlapping submits
    enqueue and run on ``workers`` daemon threads (warm, shape-bucketed
    executables are process-wide, so two warm solves genuinely overlap:
    host-side constructor races, bound LPs, and device dispatches
    interleave instead of convoying behind one lock). Saturation policy:
    a request that cannot get a queue slot within its wait budget is
    shed with 503, exactly like the old lock timeout — but a queued
    request keeps its place instead of stampeding on a lock."""

    def __init__(self, workers: int = DEFAULT_WORKERS,
                 depth: int = DEFAULT_QUEUE_DEPTH):
        self.workers = max(1, int(workers))
        self.queue_wait_s = DEFAULT_QUEUE_WAIT_S
        self._q: _queue.Queue = _queue.Queue(maxsize=max(1, int(depth)))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._started = False
        self._active = 0
        self._done_count = 0
        self._draining = False  # maintenance holds new solves at the gate

    def configure(self, workers: int | None = None,
                  depth: int | None = None,
                  queue_wait_s: float | None = None) -> None:
        """Resize before the workers start (server startup); a no-op
        once traffic has begun (``queue_wait_s`` may change anytime —
        it only gates the next maintenance drain)."""
        with self._lock:
            if queue_wait_s is not None:
                self.queue_wait_s = max(float(queue_wait_s), 0.0)
            if self._started:
                return
            if workers is not None:
                self.workers = max(1, int(workers))
            if depth is not None:
                self._q = _queue.Queue(maxsize=max(1, int(depth)))

    def _ensure_started(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
            for i in range(self.workers):
                threading.Thread(
                    target=self._run, daemon=True, name=f"kao-solve-{i}"
                ).start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item.abandoned:  # waiter gave up while queued
                continue
            if _chaos.fires("worker_crash"):
                # chaos (docs/RESILIENCE.md): this worker dies holding
                # a request. The containment path is _respawn — a
                # replacement worker starts and the crashed request
                # gets its one retry there, so pool capacity is never
                # silently lost and the waiter never hangs.
                self._respawn(item)
                return  # the crash: this worker thread exits
            self._execute(item)

    def _execute(self, item: _QueueItem) -> None:
        with self._cv:
            # maintenance in progress: no new trace/compile may
            # start until the cache clear has landed
            while self._draining:
                self._cv.wait()
            self._active += 1
        # queue-wait tagging (obs/flight ledger): everything between the
        # submit's enqueue and this pickup — including a maintenance
        # drain hold — is time the REQUEST waited, attributed to the
        # solve this worker is about to run
        qw_tok = _oflight.set_queue_wait(time.perf_counter() - item.enq)
        try:
            try:
                item.result = item.fn()
            except BaseException as e:  # delivered to the waiter
                item.exc = e
            item.done.set()
        finally:
            _oflight.reset_queue_wait(qw_tok)
            with self._cv:
                self._active -= 1
                self._done_count += 1
                n = self._done_count
                self._cv.notify_all()
        if n % _CLEAR_CACHES_EVERY == 0:
            self._maintenance()

    def _respawn(self, item: _QueueItem) -> None:
        """A worker crashed mid-request (today only the ``worker_crash``
        chaos point can get here — ``_execute`` contains genuine solve
        exceptions and delivers them to the waiter). Start a replacement
        worker and give the in-flight request its ONE retry on it; with
        ``--checkpoint-dir`` the retried solve auto-resumes from the
        last completed checkpoint of the same cluster."""
        _ladder.note_rung("worker_restart")
        _olog.error("worker_crashed", respawned=True,
                    retrying=not item.abandoned)

        def run():
            if not item.abandoned:
                self._execute(item)
            self._run()

        threading.Thread(target=run, daemon=True,
                         name="kao-solve-respawn").start()

    def _maintenance(self) -> None:
        """The periodic maintenance pass. The reference clears its
        in-process XLA executable caches here, behind a drain gate
        (``_draining`` holds new solves while in-flight ones finish,
        bounded by ``queue_wait_s``). This package holds no per-shape
        executables (the kernel libraries are built once per process,
        and the chain engine's graphs live with their solve), so the
        drain clears nothing; the checkpoint-dir hygiene still runs."""
        with self._cv:
            if self._draining:
                return
            self._draining = True
            # drain window (--queue-wait-s): a busy pool bounds how long
            # the pass may hold the gate before skipping
            deadline = time.monotonic() + self.queue_wait_s
            while self._active > 0:
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(timeout=left):
                    break
            drained = self._active == 0
        del drained  # nothing to clear in this package
        with self._cv:
            self._draining = False
            self._cv.notify_all()
        # checkpoint-dir hygiene: age + count caps, never fatal. File GC
        # needs no exclusion (utils.checkpoint.load treats a vanished
        # file as no checkpoint, and writes are atomic-rename).
        _gc_checkpoints()

    def stats(self) -> dict:
        with self._lock:
            return {
                "queue_depth": self._q.qsize(),
                "active_solves": self._active,
                "workers": self.workers,
                "solves_completed": self._done_count,
            }

    def submit(self, fn, wait_s: float, budget_s: float | None):
        """Run ``fn`` on the worker pool; raises ApiError(503) when the
        queue stays full past ``wait_s`` or the solve outlives the
        service window."""
        self._ensure_started()
        item = _QueueItem(fn)
        try:
            if _chaos.fires("queue_overload"):
                # chaos: the queue reports no capacity — the request
                # must take the exact shed path a saturated pool takes
                raise _queue.Full
            self._q.put(item, timeout=max(float(wait_s), 0.0))
        except _queue.Full:
            raise _shed(
                "queue_full",
                f"solver busy (no capacity within {wait_s:.0f}s); "
                "retry later",
                retry_after_s=self._retry_after_hint(),
                queue_wait_s=self.queue_wait_s,
            ) from None
        # budget_s None means the operator runs uncapped solves
        # (--max-solve-s 0 with no client limit): wait to completion,
        # exactly like the pre-queue synchronous path did
        window = (
            None if budget_s is None
            else max(float(wait_s), 0.0) + float(budget_s) + 60.0
        )
        if not item.done.wait(window):
            item.abandoned = True  # dropped if still queued; best effort
            raise _shed(
                "service_window",
                f"solve did not finish within the {window:.0f}s service "
                "window; retry later",
                retry_after_s=self._retry_after_hint(),
            )
        if item.exc is not None:
            raise item.exc
        return item.result

    def _retry_after_hint(self) -> float:
        """Retry-After for queue sheds: roughly one queue's worth of
        the last observed solve time, clamped to [1, 60] s — an honest
        hint beats a constant, and the clamp keeps a pathological
        sample from telling clients to go away for an hour."""
        with _METRICS_LOCK:
            last = _METRICS["last_solve_seconds"]
        backlog = max(self._q.qsize(), 1)
        return min(max(last * backlog, 1.0), 60.0)


def _checkpoint_files() -> list:
    """The ``.npz`` checkpoints currently under --checkpoint-dir (empty
    when the feature is off or the dir vanished)."""
    d = RESILIENCE["checkpoint_dir"]
    if not d:
        return []
    import glob
    import os

    return glob.glob(os.path.join(d, "*.npz"))


def _gc_checkpoints() -> int:
    """--checkpoint-dir hygiene: fingerprint-keyed checkpoints accumulate one
    file per distinct cluster forever. Drop files older than
    ``checkpoint_max_age_s``, then the oldest beyond ``checkpoint_max_files``.
    Returns how many were removed; never raises (a GC failure must not take
    down maintenance)."""
    import os
    import time as _time

    removed = 0
    try:
        files = _checkpoint_files()
        if not files:
            return 0
        now = _time.time()
        max_age = RESILIENCE["checkpoint_max_age_s"]
        max_files = RESILIENCE["checkpoint_max_files"]
        aged = []
        for f in files:
            try:
                mtime = os.path.getmtime(f)
            except OSError:
                continue  # raced with another GC / a fresh write
            if max_age is not None and now - mtime > max_age:
                try:
                    os.remove(f)
                    removed += 1
                except OSError:
                    pass
            else:
                aged.append((mtime, f))
        if max_files is not None and len(aged) > max_files:
            aged.sort()  # oldest first
            for _, f in aged[: len(aged) - int(max_files)]:
                try:
                    os.remove(f)
                    removed += 1
                except OSError:
                    pass
        if removed:
            _olog.log("checkpoint_gc", removed=removed,
                      remaining=len(files) - removed)
    except Exception:
        pass
    return removed


_SOLVES = _SolveQueue()

# service counters (GET /metrics, Prometheus text format); guarded by
# their own lock so readers never contend with a solve
_METRICS_LOCK = threading.Lock()
_METRICS = {
    "requests_total": 0,      # POST /submit or /evaluate received
    "solves_total": 0,        # solves completed successfully
    "evaluates_total": 0,     # plan audits completed successfully
    "errors_total": 0,        # 4xx/5xx responses (excl. 503 sheds)
    "solve_seconds_total": 0.0,
    "last_solve_seconds": 0.0,
    # request coalescing (the batched lane path)
    "batch_solves_total": 0,        # batched dispatches completed
    "batched_requests_total": 0,    # requests served THROUGH a batch
    "batch_bypass_total": 0,        # sparse requests that skipped the window
    "coalesce_wait_seconds_total": 0.0,  # enqueue -> flush, summed
    "batch_lanes_feasible_total": 0,     # per-lane quality counters
    "batch_lane_moves_total": 0,
    "batch_lane_weight_total": 0,
    # portfolio lanes (docs/PORTFOLIO.md): single-path solves that
    # raced a config portfolio, and how many retired the ladder on a
    # first-to-certify boundary certificate
    "portfolio_solves_total": 0,
    "portfolio_early_exit_total": 0,
}
# portfolio winner-lane histogram (rendered as the labeled counter
# family kao_portfolio_winner_total{lane="N"}): which configs actually
# win is the evidence the diversity table earns its lanes
_PORTFOLIO_WINNERS: dict[int, int] = {}
# batch-size histogram: coalesced dispatch size -> count (rendered as
# the labeled counter family kao_batch_size_total{size="N"})
_BATCH_SIZES: dict[int, int] = {}
# 503 sheds by reason (rendered as kao_shed_total{reason="..."}):
# every shed path names why it shed, and the full reason set is
# pre-declared so /metrics always exposes the family at zero
_SHED_REASON_NAMES = (
    "queue_full", "service_window", "coalesce_window", "audit_busy",
    "circuit_open", "deadline", "event_storm", "stream_clients",
)
_SHED_REASONS: dict[str, int] = {}


def _count(**updates) -> None:
    with _METRICS_LOCK:
        for k, v in updates.items():
            _METRICS[k] += v


def _shed(reason: str, message: str, retry_after_s: float,
          **body_extra) -> "ApiError":
    """Count one load shed and build its 503: the response carries a
    ``Retry-After`` header (and ``retry_after_s``/``reason`` in the
    body) so well-behaved clients back off instead of hammering a
    saturated service. The body additionally names THIS worker
    (``worker``, the flight-record identity stamp) so a fleet router
    attributes the shed to the right peer and fails over with the
    precise ``retry_after_s`` float instead of the coarse integer
    header (docs/FLEET.md). Callers ``raise _shed(...)``."""
    with _METRICS_LOCK:
        _SHED_REASONS[reason] = _SHED_REASONS.get(reason, 0) + 1
    return ApiError(
        503, message, retry_after_s=retry_after_s,
        body={"reason": reason, "retry_after_s": round(retry_after_s, 3),
              "worker": _oflight.worker_identity(), **body_extra},
    )


def _breaker_guarded(key: tuple, call):
    """Run one dispatch under the per-bucket circuit breaker: an OPEN
    circuit sheds instantly with 503 + Retry-After (no compile-and-
    crash cycle); solver-side failures trip it, client-side errors
    (ApiError sheds/validation, model rejections) never do."""
    admitted, retry_after = _BREAKER.allow(key)
    if not admitted:
        # the bucket key in the body scopes the shed for a fleet
        # router: other buckets on this worker are still healthy, so
        # only THIS bucket's traffic should fail over (docs/FLEET.md)
        raise _shed(
            "circuit_open",
            "circuit open for this cluster bucket after repeated "
            "solver failures; retry later",
            retry_after_s=retry_after,
            **({"bucket": list(key)}
               if all(isinstance(x, int) for x in key) else {}),
        )
    try:
        out = call()
    except (ApiError, ValueError, KeyError, TypeError):
        # saturation sheds / model rejections — no solver verdict, not
        # this bucket's fault. If this caller held the half-open probe,
        # release it so a later request can probe again (a shed probe
        # must not wedge the circuit open forever).
        _BREAKER.release_probe(key)
        raise
    except BaseException:
        _BREAKER.record_failure(key)
        raise
    _BREAKER.record_success(key)
    return out


def _record_batch(size: int, waited_s: float, reports: list[dict]) -> None:
    """Metrics for one coalesced dispatch: size histogram, coalesce
    wait, and per-lane solve quality."""
    with _METRICS_LOCK:
        _BATCH_SIZES[size] = _BATCH_SIZES.get(size, 0) + 1
        _METRICS["batch_solves_total"] += 1
        _METRICS["batched_requests_total"] += size
        _METRICS["coalesce_wait_seconds_total"] += waited_s
        for rep in reports:
            _METRICS["batch_lanes_feasible_total"] += int(
                bool(rep.get("feasible"))
            )
            _METRICS["batch_lane_moves_total"] += int(
                rep.get("replica_moves") or 0
            )
            _METRICS["batch_lane_weight_total"] += int(
                rep.get("objective_weight") or 0
            )


def _render_histogram(lines: list, name: str, label: str,
                      snap: dict, help_text: str) -> None:
    """One Prometheus histogram family from an ExemplarHistogram
    snapshot: cumulative ``_bucket{le=}`` rows, ``_sum``/``_count``,
    HELP/TYPE pair. Shared by kao_phase_seconds and kao_solve_seconds
    so the exposition shape cannot drift between them."""
    if not snap:
        return
    lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} histogram")
    for key in sorted(snap):
        row = snap[key]
        for le, n in row["buckets"]:
            lines.append(
                f'{name}_bucket{{{label}="{key}",le="{le}"}} {n}'
            )
        lines.append(
            f'{name}_bucket{{{label}="{key}",le="+Inf"}} '
            f'{row["count"]}'
        )
        lines.append(f'{name}_sum{{{label}="{key}"}} {row["sum"]}')
        lines.append(f'{name}_count{{{label}="{key}"}} {row["count"]}')


def _render_exemplars(lines: list, name: str, label: str,
                      exemplars: list) -> None:
    """The exemplar sidecar gauge family for one histogram: the worst
    recent observation per (key, bucket) with its trace ID as a
    label."""
    if not exemplars:
        return
    lines.append(
        f"# HELP {name} worst recent observation per ({label}, "
        "bucket); trace_id resolves via /debug/solves"
    )
    lines.append(f"# TYPE {name} gauge")
    for e in exemplars:
        lines.append(
            f'{name}{{{label}="{e[label]}",le="{e["le"]}",'
            f'trace_id="{e["trace_id"]}"}} {e["value"]}'
        )


def render_metrics() -> str:
    # ONE atomic snapshot of everything behind _METRICS_LOCK: the
    # dispatchers mutate _METRICS and _BATCH_SIZES while this renders,
    # and two separate lock acquisitions let a batch land between them
    # — torn reads where kao_batch_solves_total disagrees with its own
    # size histogram
    with _METRICS_LOCK:
        snap = dict(_METRICS)
        sizes = dict(_BATCH_SIZES)
        sheds = {r: 0 for r in _SHED_REASON_NAMES}
        sheds.update(_SHED_REASONS)
        port_winners = dict(_PORTFOLIO_WINNERS)
    # portfolio geometry gauge: the width a defaulted solve races now
    # (0-vs-N is the --no-portfolio toggle made scrapeable). Read ONLY
    # from an already-imported engine module, as the reference does
    eng = sys.modules.get(
        __name__.rsplit(".", 1)[0] + ".solvers.tpu.engine"
    )
    if eng is not None:
        try:
            snap["portfolio_width"] = eng.portfolio_width_default()
        except Exception:
            pass
    # cache counters (solvers.tpu.bucket.STATS, the reference's keys):
    # here an "exec" miss is a dispatch that paid a kernel build or a
    # graph capture, so kao_cache_exec_hits climbing while
    # kao_cache_compiles_total stays flat is a warm service
    try:
        from .solvers.tpu.bucket import STATS as _cache_stats

        for k, v in _cache_stats.snapshot().items():
            snap[f"cache_{k}"] = v
    except Exception:
        pass
    try:
        for k, v in _SOLVES.stats().items():
            snap[f"queue_{k}"] = v
    except Exception:
        pass
    # runtime sanitizer counters (analysis.sanitize): zero and inert
    # unless KAO_SANITIZE / --sanitize armed the guards
    for k, v in _sanitize_mod.snapshot().items():
        snap[f"sanitizer_{k}"] = v
    # process uptime: rate() denominators and restart detection
    snap["uptime_seconds"] = round(time.time() - _START_UNIX, 3)
    # flight-recorder counters (obs.flight, docs/OBSERVABILITY.md)
    for k, v in _oflight.snapshot().items():
        if isinstance(v, (int, float)):
            snap[f"flight_{k}"] = v
    # live-stream fan-out (GET /debug/stream): subscriber count and the
    # slow-client shed counter — dropped records mean a reader fell
    # behind its bounded queue, never that the solve path blocked
    stream = _oflight.stream_stats()
    snap["stream_clients"] = stream["clients"]
    snap["stream_dropped_total"] = stream["dropped_total"]
    # device-occupancy sampler (obs.sampler): cached tick scalars only
    # — the sampler thread reads the card, a scrape never touches it
    # and never rebuilds the /healthz roofline summary
    samp = _osampler.SAMPLER.stats()
    snap["device_sampler_enabled"] = samp["enabled"]
    snap["device_sampler_samples_total"] = samp["samples_total"]
    snap["device_sampler_overhead"] = samp["overhead_frac"]
    snap["device_duty_cycle"] = samp["duty_cycle"]
    # solve-report ring occupancy: the /debug/solves payload bound in
    # action (bytes resident + reports truncated to fit)
    ring = _otrace.RECENT.stats()
    snap["trace_ring_bytes"] = ring["bytes"]
    snap["trace_ring_reports"] = ring["reports"]
    snap["trace_ring_truncated_total"] = ring["truncated_total"]
    # --checkpoint-dir hygiene gauge: live .npz count under the operator's
    # checkpoint dir; the maintenance GC (age + count caps) is what keeps this
    # bounded
    snap["checkpoint_files"] = len(_checkpoint_files())
    # cluster-watch delta API counters (docs/WATCH.md): pre-declared at
    # zero so dashboards see the families before the first event; the
    # live registry overlays its actual counts
    watch_zeroes = {
        "events_total": 0, "fenced_total": 0, "coalesced_total": 0,
        "superseded_total": 0, "storm_sheds_total": 0,
        "solves_total": 0, "warm_solves_total": 0,
        "solve_errors_total": 0, "clusters": 0,
    }
    reg = WATCH.get("registry")
    if reg is not None:
        watch_zeroes.update({
            k: v for k, v in reg.snapshot().items()
            if isinstance(v, (int, float)) and k in watch_zeroes
        })
    for k, v in watch_zeroes.items():
        snap[f"watch_{k}"] = v
    # streaming plan rollout counters (docs/ROLLOUT.md): the full
    # family set is pre-declared at zero; the live manager (built on
    # first rollout touch — never by a scrape) overlays its counts
    rollout_zeroes = {k: 0 for k in _ROLLOUT_COUNTER_NAMES}
    rmgr = ROLLOUT.get("manager")
    if rmgr is not None:
        rollout_zeroes.update({
            k: v for k, v in rmgr.snapshot().items()
            if isinstance(v, (int, float)) and k in rollout_zeroes
        })
    for k, v in rollout_zeroes.items():
        snap[f"rollout_{k}"] = v
    # resilience gauges (docs/RESILIENCE.md): circuit-breaker state and
    # whether a chaos spec is armed (a production scrape showing
    # kao_chaos_armed 1 is itself an alert)
    brk = _BREAKER.snapshot()
    snap["breaker_open_keys"] = brk["open"]
    snap["breaker_tracked_keys"] = brk["tracked"]
    snap["breaker_trips_total"] = brk["trips_total"]
    snap["chaos_armed"] = _chaos.snapshot()["armed"]
    # roofline-observatory scalars (obs.prof): cost-model capture and
    # pairing health, ledger-overrun tripwire, and the profiler's own
    # self-accounted overhead
    psnap = _oprof.snapshot()
    for k, v in psnap["counters"].items():
        snap[f"prof_{k}"] = v
    snap["prof_executables"] = len(psnap["executables"])
    snap["prof_overhead_seconds_total"] = psnap["overhead"][
        "seconds_total"]
    lines = []
    for k, v in snap.items():
        name = f"kao_{k}"
        kind = "counter" if k.endswith("_total") else "gauge"
        lines.append(f"# HELP {name} {k.replace('_', ' ')} ({kind})")
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {v}")
    # batched-dispatch size histogram: one labeled sample per observed
    # size — the operational proof coalescing is (or is not) engaging
    lines.append("# HELP kao_batch_size_total coalesced dispatch sizes")
    lines.append("# TYPE kao_batch_size_total counter")
    for size in sorted(sizes):
        lines.append(
            f'kao_batch_size_total{{size="{size}"}} {sizes[size]}'
        )
    # portfolio winner-lane histogram (docs/PORTFOLIO.md): which lane
    # configs actually win solves — a lane that never wins is a slot
    # the diversity table should respend
    lines.append("# HELP kao_portfolio_winner_total portfolio solves "
                 "won, by winning lane index")
    lines.append("# TYPE kao_portfolio_winner_total counter")
    for lane in sorted(port_winners):
        lines.append(
            f'kao_portfolio_winner_total{{lane="{lane}"}} '
            f"{port_winners[lane]}"
        )
    # decomposed map-reduce solves (docs/DECOMPOSE.md): the full
    # counter set is pre-declared at zero (the rollout-counter
    # discipline), plus the last solve's certificate-or-gap outcome
    from .decompose import STATS as _dstats

    dsnap = _dstats.snapshot()
    lines.append("# HELP kao_decompose_total decomposed map-reduce "
                 "solve events, by kind (docs/DECOMPOSE.md)")
    lines.append("# TYPE kao_decompose_total counter")
    for k in sorted(dsnap["counters"]):
        lines.append(
            f'kao_decompose_total{{kind="{k}"}} '
            f'{dsnap["counters"][k]}'
        )
    lines.append("# HELP kao_decompose_last_bound_gap bound gap of "
                 "the last decomposed solve (0 when certified)")
    lines.append("# TYPE kao_decompose_last_bound_gap gauge")
    lines.append(
        f"kao_decompose_last_bound_gap "
        f'{int(dsnap["last"].get("bound_gap") or 0)}'
    )
    lines.append("# HELP kao_decompose_last_subproblems sub-problem "
                 "count of the last decomposed solve")
    lines.append("# TYPE kao_decompose_last_subproblems gauge")
    lines.append(
        f"kao_decompose_last_subproblems "
        f'{int(dsnap["last"].get("subproblems") or 0)}'
    )
    # the solve mesh: axis sizes of the last built mesh, the counter
    # families pre-declared at zero, and one row per bucket the sharding
    # chooser has evidence for (the choice its next dispatch gets)
    msnap = _healthz_mesh()
    lines.append("# HELP kao_mesh_axis_size solve-mesh axis sizes "
                 "(chains x lanes device split, docs/MESH.md)")
    lines.append("# TYPE kao_mesh_axis_size gauge")
    for ax in sorted(msnap["axes"]):
        lines.append(
            f'kao_mesh_axis_size{{axis="{ax}"}} {msnap["axes"][ax]}'
        )
    lines.append("# HELP kao_mesh_sharding_search_evals_total sharding "
                 "candidates timed by run_sharding_search")
    lines.append("# TYPE kao_mesh_sharding_search_evals_total counter")
    lines.append(
        "kao_mesh_sharding_search_evals_total "
        f'{msnap["counters"]["search_evals"]}'
    )
    lines.append("# HELP kao_mesh_reshard_bytes_total carried-state "
                 "bytes that arrived at a dispatch under the wrong "
                 "sharding (resharding transfer)")
    lines.append("# TYPE kao_mesh_reshard_bytes_total counter")
    lines.append(
        "kao_mesh_reshard_bytes_total "
        f'{msnap["counters"]["reshard_bytes"]}'
    )
    lines.append("# HELP kao_mesh_bucket_sharding per-bucket chosen "
                 "(chains x lanes) split; value is evidence solve "
                 "count behind the choice")
    lines.append("# TYPE kao_mesh_bucket_sharding gauge")
    for bkt in sorted(msnap["buckets"]):
        row = msnap["buckets"][bkt]
        ev = row["evidence"].get(row["chosen"], {})
        lines.append(
            f'kao_mesh_bucket_sharding{{bucket="{bkt}",'
            f'spec="{row["chosen"]}"}} {int(ev.get("solves", 0))}'
        )
    # load sheds by reason: every 503 names why it shed, and the full
    # reason set is pre-declared at zero so dashboards can alert on
    # rate() without waiting for the first shed
    lines.append("# HELP kao_shed_total load sheds (503) by reason")
    lines.append("# TYPE kao_shed_total counter")
    for reason in sorted(sheds):
        lines.append(
            f'kao_shed_total{{reason="{reason}"}} {sheds[reason]}'
        )
    # graceful-degradation ladder rungs (resilience.ladder): the full
    # rung catalog is pre-declared at zero; any nonzero rate here means
    # the service is trading quality/latency for availability
    lines.append(
        "# HELP kao_degradations_total graceful-degradation ladder "
        "rungs taken (docs/RESILIENCE.md)"
    )
    lines.append("# TYPE kao_degradations_total counter")
    for rung, n in _ladder.snapshot().items():
        lines.append(f'kao_degradations_total{{rung="{rung}"}} {n}')
    # device memory in use, one gauge per card the sampler saw (on the
    # CPU it reads no device, so the family renders empty there — the
    # HELP/TYPE pair still pre-declares it)
    lines.append("# HELP kao_device_hbm_bytes device memory in use by "
                 "device (obs.sampler; --sample-devices)")
    lines.append("# TYPE kao_device_hbm_bytes gauge")
    for dev in sorted(samp["devices"]):
        lines.append(
            f'kao_device_hbm_bytes{{device="{dev}"}} '
            f'{samp["devices"][dev]["bytes_in_use"]}'
        )
    # drift alarms (obs.drift): the mid-run "this got slower" tripwire,
    # per record class and signal
    lines.extend(_odrift.render_families(_odrift.MONITOR.metric_rows()))
    # per-phase solve latency histograms, aggregated from solve traces
    # (obs.trace): which pipeline phase the wall-clock goes to, across
    # every traced solve this process has served
    _render_histogram(
        lines, "kao_phase_seconds", "phase", _otrace.phase_snapshot(),
        "solve pipeline phase latency (from solve traces)",
    )
    # end-to-end solve latency histograms per record class (obs.flight):
    # the SLO denominators — kao_phase_seconds says which PHASE ate a
    # budget, kao_solve_seconds says which CLASS of traffic is slow
    _render_histogram(
        lines, "kao_solve_seconds", "class", _oflight.solve_snapshot(),
        "end-to-end solve latency by record class (from flight "
        "records)",
    )
    # exemplar linkage (docs/OBSERVABILITY.md): the worst recent
    # observation per histogram bucket, its trace ID as a label — a
    # spike on a bucket links DIRECTLY to GET /debug/solves/<id>
    # (and ?format=chrome for the Perfetto flame chart). Rendered as
    # sidecar gauge families: the classic text exposition has no
    # native exemplar syntax, and a labeled gauge survives every
    # Prometheus scraper while carrying the same linkage.
    _render_exemplars(lines, "kao_solve_seconds_exemplar", "class",
                      _oflight.solve_exemplars())
    _render_exemplars(lines, "kao_phase_seconds_exemplar", "phase",
                      _otrace.phase_exemplars())
    # SLO engine (obs.slo): cumulative per-class counters + per-window
    # burn-rate gauges. Families are emitted only when classes exist —
    # the engine pre-declares the default classes, so they always do.
    slo = _oslo.ENGINE.snapshot()
    classes = slo.get("classes") or {}
    if classes:
        # table-driven per-class families (same factoring discipline
        # as _render_histogram): one loop, one place to add the next
        slo_families = (
            ("kao_slo_events_total", "counter",
             "flight records observed per SLO class",
             lambda c: c["events_total"]),
            ("kao_slo_latency_breaches_total", "counter",
             "observations over the class latency objective",
             lambda c: c["latency_breaches_total"]),
            ("kao_slo_quality_breaches_total", "counter",
             "infeasible/degraded plans per SLO class",
             lambda c: c["quality_breaches_total"]),
            ("kao_slo_latency_objective_seconds", "gauge",
             "configured per-class latency objective",
             lambda c: c["objective"]["latency_s"]),
            ("kao_slo_target", "gauge",
             "configured per-class success target",
             lambda c: c["objective"]["target"]),
        )
        for name, kind, help_text, get in slo_families:
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            for cls in sorted(classes):
                lines.append(
                    f'{name}{{class="{cls}"}} {get(classes[cls])}'
                )
        lines.append("# HELP kao_slo_burn_rate error-budget burn rate "
                     "per class and window (>1 burns the budget)")
        lines.append("# TYPE kao_slo_burn_rate gauge")
        for cls in sorted(classes):
            for win, w in sorted(classes[cls]["windows"].items()):
                lines.append(
                    f'kao_slo_burn_rate{{class="{cls}",'
                    f'window="{win}"}} {w["burn_rate"]}'
                )
    # causal-tracing families (docs/OBSERVABILITY.md "Distributed
    # traces"): tail-retention decisions + traceparent codec traffic,
    # rendered through the SAME shared helpers the kao-router uses so
    # the two surfaces cannot drift (obs.trace.trace_families)
    for fam in _otrace.trace_families():
        lines.extend(_expo.family_lines(*fam))
    # roofline observatory (obs.prof): per-key achieved/peak occupancy
    # + measured device seconds, keyed by the dispatch-key hash — the
    # /debug/profile table's scrapeable projection
    lines.append("# HELP kao_prof_occupancy achieved/peak occupancy "
                 "per executable and dimension (obs.prof; ratios, "
                 "peak from KAO_PROF_PEAK_*)")
    lines.append("# TYPE kao_prof_occupancy gauge")
    for row in psnap["executables"]:
        for dim, f in (("flops", "occupancy_flops"),
                       ("hbm", "occupancy_hbm")):
            if row.get(f) is not None:
                lines.append(
                    f'kao_prof_occupancy{{key="{row["key_id"]}",'
                    f'path="{row["path"]}",dim="{dim}"}} {row[f]}'
                )
    lines.append("# HELP kao_prof_device_seconds_total measured "
                 "device seconds per executable (obs.prof)")
    lines.append("# TYPE kao_prof_device_seconds_total counter")
    for row in psnap["executables"]:
        lines.append(
            f'kao_prof_device_seconds_total{{key="{row["key_id"]}",'
            f'path="{row["path"]}"}} {row["device_s"]}'
        )
    # dispatch-gap histogram: host time between consecutive ladder
    # dispatches, derived from solve-report span timestamps; the
    # exemplar sidecar links the p99 gap to its trace
    _render_histogram(
        lines, "kao_prof_dispatch_gap_seconds", "path",
        _oprof.gap_snapshot(),
        "host gap between consecutive ladder dispatches (obs.prof)",
    )
    _render_exemplars(lines, "kao_prof_dispatch_gap_seconds_exemplar",
                      "path", _oprof.gap_exemplars())
    # build identity: which code and runtime produced every number
    # above
    bi = _build_info()
    lines.append("# HELP kao_build_info build/runtime identity "
                 "(value is always 1; the labels carry the info)")
    lines.append("# TYPE kao_build_info gauge")
    lines.append(
        'kao_build_info{'
        f'version="{bi["version"]}",torch="{bi["torch"]}",'
        f'backend="{bi["backend"]}",devices="{bi["devices"]}"'
        "} 1"
    )
    return "\n".join(lines) + "\n"


class ApiError(Exception):
    """HTTP-status-carrying error. ``retry_after_s`` becomes the
    response's ``Retry-After`` header (503 sheds); ``body`` merges
    extra structured fields into the JSON error body."""

    def __init__(self, status: int, message: str, *,
                 retry_after_s: float | None = None,
                 body: dict | None = None):
        super().__init__(message)
        self.status = status
        self.retry_after_s = retry_after_s
        self.body_extra = body or {}


class _BatchGroup:
    """One pending same-bucket batch: entries + their waiters, the
    window timer, and the flush latch."""

    __slots__ = ("key", "entries", "waiters", "timer", "flushed",
                 "created", "wait_s", "budget_s")

    def __init__(self, key, wait_s, budget_s):
        self.key = key
        self.entries: list[dict] = []
        self.waiters: list[_QueueItem] = []
        self.timer = None
        self.flushed = False
        self.created = time.perf_counter()
        self.wait_s = wait_s
        self.budget_s = budget_s


class _Coalescer:
    """The request-coalescing dispatcher in front of the solve queue.

    Same-bucket TPU solves that arrive while the worker pool is busy
    are held for up to ``window_s`` (or until ``max_batch`` of them
    accumulate), then submitted as ONE batched lane solve
    (``api.optimize_batch`` -> ``engine.solve_tpu_batch``) whose
    per-lane results are demultiplexed back to the waiting requests.
    The group key is the exact executable identity — (brokers, racks,
    partition-bucket, rf-bucket) plus the shared non-seed solver knobs —
    so every batch is stackable by construction.

    Latency contract: a request that finds FREE capacity (idle worker,
    empty queue, no pending same-key group) bypasses the window and
    runs the full single-solve path — sparse traffic pays nothing for
    the batching machinery. Coalescing only engages where the request
    would have queued anyway, turning queue wait into batch width."""

    def __init__(self, window_s: float = DEFAULT_BATCH_WINDOW_MS / 1e3,
                 max_batch: int = DEFAULT_MAX_BATCH):
        self._lock = threading.Lock()
        self._groups: dict[tuple, _BatchGroup] = {}
        self.window_s = window_s
        self.max_batch = max_batch

    def configure(self, window_ms: float | None = None,
                  max_batch: int | None = None) -> None:
        with self._lock:
            if window_ms is not None:
                self.window_s = max(float(window_ms), 0.0) / 1e3
            if max_batch is not None:
                self.max_batch = max(int(max_batch), 1)

    def enabled(self) -> bool:
        return self.max_batch > 1

    def should_bypass(self, key) -> bool:
        """True when this request should skip coalescing entirely: no
        same-key group is already pending AND the pool has free
        capacity (the solve would start immediately, so holding it for
        the window could only add latency)."""
        with self._lock:
            if key in self._groups:
                return False
        q = _SOLVES.stats()
        idle = (q["active_solves"] < q["workers"]
                and q["queue_depth"] == 0)
        if idle:
            _count(batch_bypass_total=1)
        return idle

    def submit(self, key, entry: dict, wait_s: float,
               budget_s: float | None) -> dict:
        """Join (or open) the pending group for ``key`` and wait for
        the batched solve to deliver this request's result."""
        waiter = _QueueItem(None)
        flush_me = None
        with self._lock:
            grp = self._groups.get(key)
            if grp is None:
                grp = _BatchGroup(key, wait_s, budget_s)
                self._groups[key] = grp
                t = threading.Timer(self.window_s, self._flush,
                                    args=(grp,))
                t.daemon = True
                grp.timer = t
                t.start()
            grp.entries.append(entry)
            grp.waiters.append(waiter)
            if budget_s is not None:
                # the batch runs under the TIGHTEST member budget
                grp.budget_s = (
                    budget_s if grp.budget_s is None
                    else min(grp.budget_s, budget_s)
                )
            if len(grp.entries) >= self.max_batch:
                flush_me = grp
        if flush_me is not None:
            self._flush(flush_me)
        window = (
            None if budget_s is None
            else float(wait_s) + float(budget_s) + 60.0 + self.window_s
        )
        if not waiter.done.wait(window):
            waiter.abandoned = True
            raise _shed(
                "coalesce_window",
                f"batched solve did not finish within the {window:.0f}s "
                "service window; retry later",
                retry_after_s=_SOLVES._retry_after_hint(),
            )
        if waiter.exc is not None:
            raise waiter.exc
        return waiter.result

    def _flush(self, grp: _BatchGroup) -> None:
        """Close the group (idempotent: the window timer and the
        max-batch filler may race here), run its batched solve through
        the bounded queue, and demux per-lane results to the waiters."""
        with self._lock:
            if grp.flushed:
                return
            grp.flushed = True
            if self._groups.get(grp.key) is grp:
                del self._groups[grp.key]
            entries = list(grp.entries)
            waiters = list(grp.waiters)
        if grp.timer is not None:
            grp.timer.cancel()
        waited = time.perf_counter() - grp.created

        def job():
            return _run_batch_job(entries)

        # the group key is (*bucket_key, non_seed_options): the breaker
        # verdict for this dispatch lands on the bucket identity, ONCE
        # — handle_submit already did the admission check per request
        bucket_key = grp.key[:-1]
        try:
            outs = _SOLVES.submit(job, wait_s=grp.wait_s,
                                  budget_s=grp.budget_s)
        except BaseException as e:
            if isinstance(e, (ApiError, ValueError, KeyError,
                              TypeError)):
                _BREAKER.release_probe(bucket_key)  # shed: no verdict
            else:
                _BREAKER.record_failure(bucket_key)
            for w in waiters:
                w.exc = e
                w.done.set()
            return
        # per-entry results: a dict to deliver, or the ApiError shed
        # for a member whose deadline expired while the batch queued.
        # The breaker verdict needs a solve to have RUN: if every
        # member was shed pre-solve there is no evidence either way,
        # so a pending half-open probe is released, not judged
        solved = [o for o in outs if not isinstance(o, BaseException)]
        if solved:
            _BREAKER.record_success(bucket_key)
            _record_batch(len(solved), waited,
                          [o["report"] for o in solved])
        else:
            _BREAKER.release_probe(bucket_key)
        for w, out in zip(waiters, outs):
            if isinstance(out, BaseException):
                w.exc = out
            else:
                w.result = out
            w.done.set()


def _run_batch_job(entries: list[dict]) -> list:
    """Worker-pool body of one coalesced dispatch: one batched lane
    solve, per-request response dicts out (same shape as /submit's
    single-solve response) — or, per entry, the ApiError to deliver
    instead. The batch runs under ONE trace with its OWN fresh ID, and
    every member keeps ITS OWN request trace ID (one shared ID would
    alias every coalesced client, and a router-propagated trace, onto
    one trace): each
    member's envelope echoes its own ``trace_id`` plus
    ``coalesced_into`` (the batch ID), and a per-member stub report
    carrying the same link lands in the ring, so
    ``GET /debug/solves/<id>`` resolves for every member and the
    router join never collides two clients.

    Deadline contract (docs/RESILIENCE.md): each entry carries its
    request Budget. The queue wait between _flush and here is bounded
    by the worker pool, not by any member's deadline — so members
    whose deadline expired while the batch was queued are shed NOW
    with the same 503 "deadline" the single-solve path returns, and
    the solve runs on the TIGHTEST remaining member window instead of
    the full one."""
    from .api import optimize_batch

    t0 = time.perf_counter()
    results: list = [None] * len(entries)
    live: list[int] = []
    for i, e in enumerate(entries):
        rem = e["budget"].remaining() if e.get("budget") else None
        if rem is not None and rem <= 0.0:
            results[i] = _shed(
                "deadline",
                "request deadline exhausted while the batched solve "
                "was queued; retry with a larger deadline_s",
                retry_after_s=1.0,
            )
        else:
            live.append(i)
    if not live:
        return results
    entries = [entries[i] for i in live]
    member_tids = [e.get("trace_id") for e in entries]
    # the batch trace gets a FRESH ID (never a member's): member IDs
    # stay unique per client and link here via coalesced_into
    trace_id = _otrace.new_trace_id() if any(member_tids) else None
    opts = dict(entries[0]["options"])
    budgets = [e["options"].get("time_limit_s") for e in entries
               if e["options"].get("time_limit_s") is not None]
    budgets += [
        e["budget"].remaining() for e in entries
        if e.get("budget") and e["budget"].remaining() is not None
    ]
    if budgets:
        opts["time_limit_s"] = min(budgets)
    tr = _otrace.begin(trace_id, name="request_batch",
                       lanes=len(entries))
    if tr is not None:
        tr.root.set(coalesced_members=",".join(
            t for t in member_tids if t))
    kw = {k: v for k, v in opts.items() if k != "seed"}
    for k, v in _tpu_kw("tpu").items():
        kw.setdefault(k, v)
    try:
        outs = optimize_batch(
            [e["current"] for e in entries],
            [e["instance"] for e in entries],
            seeds=[e["seed"] for e in entries],
            **kw,
        )
    except BaseException as e:
        if tr is not None:
            tr.root.set(error=repr(e)[:200])
            _otrace.finish(tr)
        _olog.error("batch_solve_failed", trace_id=trace_id,
                    lanes=len(entries), error=repr(e)[:200])
        raise
    dt = time.perf_counter() - t0
    with _METRICS_LOCK:
        _METRICS["solves_total"] += len(outs)
        _METRICS["solve_seconds_total"] += dt
        _METRICS["last_solve_seconds"] = dt
    reps = [o.report() for o in outs]
    batch_rep = None
    if tr is not None:
        tr.root.set(wall_s=round(dt, 4),
                    lanes_feasible=sum(
                        1 for r in reps if r.get("feasible")))
        batch_rep = _otrace.finish(tr)
    _olog.log("solve_batch", trace_id=trace_id, lanes=len(outs),
              wall_s=round(dt, 4))
    for j, (o, rep) in enumerate(zip(outs, reps)):
        member_tid = member_tids[j]
        # member stubs follow the BATCH's tail-retention decision: a
        # dropped batch registers no stubs (a dangling coalesced_into
        # would 404, and untail-sampled stubs would flood the ring the
        # policy exists to bound)
        if member_tid and batch_rep is not None \
                and batch_rep.get("retention") != "dropped":
            _register_member_trace(member_tid, batch_rep,
                                   entries[j].get("remote_parent"),
                                   lane=j)
        results[live[j]] = {
            "assignment": o.assignment.to_dict(),
            "report": rep,
            **({"trace_id": member_tid,
                "coalesced_into": trace_id} if member_tid else {}),
        }
    return results


def _register_member_trace(member_tid: str, batch_rep: dict,
                           remote_parent: str | None,
                           lane: int) -> None:
    """One coalesced member's OWN ring entry: a stub report under the
    member's trace ID whose root span links to the shared batch report
    (``coalesced_into``) and — when the request carried a propagated
    traceparent — records its remote parent span, so the router-side
    merge still attaches this member to the exact attempt that sent
    it. Registered directly (not via a Trace): the real span tree
    lives in the batch report one hop away."""
    attrs: dict = {"coalesced_into": batch_rep["trace_id"],
                   "lane": lane}
    if remote_parent:
        attrs["parent_span_id"] = str(remote_parent)
        attrs["span_kind"] = "server"
    _otrace.RECENT.put({
        "trace_id": member_tid,
        "name": "request",
        "started_unix": batch_rep.get("started_unix"),
        "wall_s": batch_rep.get("wall_s"),
        "coalesced_into": batch_rep["trace_id"],
        "phases": batch_rep.get("phases") or {},
        "spans": {
            "name": "request",
            "start_s": 0.0,
            "wall_s": batch_rep.get("wall_s"),
            "attrs": attrs,
        },
    })


_COALESCER = _Coalescer()


def _parse_brokers(spec) -> list[int]:
    if isinstance(spec, str):
        try:
            return parse_broker_list(spec)
        except ValueError as e:
            raise ApiError(400, f"bad 'brokers' range string: {e}") from e
    if isinstance(spec, list) and all(
        isinstance(b, int) and not isinstance(b, bool) for b in spec
    ):
        return spec
    raise ApiError(400, "'brokers' must be a list of ints or a range string")


def _parse_topology(spec, broker_ids: list[int]) -> Topology | None:
    # every malformed shape must come back as a structured 400, never a
    # raw exception bubbling into a 500 (e.g. a rack map with non-string
    # keys or nested values used to die inside Topology.from_dict)
    if spec is None:
        return None
    try:
        if spec == "even-odd":
            return Topology.even_odd(broker_ids)
        if isinstance(spec, dict):
            return Topology.from_dict(spec)
    except ApiError:
        raise
    except Exception as e:
        raise ApiError(400, f"bad 'topology': {e}") from e
    raise ApiError(400, "'topology' must be a broker->rack object, 'even-odd', or null")


def _validate_rf(rf) -> None:
    if rf is None:
        return
    if isinstance(rf, bool) or not isinstance(rf, (int, dict)):
        raise ApiError(400, "'rf' must be an int, a topic->int object, or null")
    if isinstance(rf, dict) and not all(
        isinstance(k, str)
        and isinstance(v, int) and not isinstance(v, bool)
        for k, v in rf.items()
    ):
        raise ApiError(400, "'rf' object must map topic names to ints")


def handle_submit(
    payload: dict,
    *,
    lock_wait_s: float = DEFAULT_LOCK_WAIT_S,
    max_solve_s: float | None = DEFAULT_MAX_SOLVE_S,
    trace_ctx=None,
) -> dict:
    """Pure request handler (also the unit-test surface): payload dict in,
    response dict out; raises ApiError with an HTTP status on bad input,
    and 503 when the solver is saturated past ``lock_wait_s``.

    ``trace_ctx`` (an ``obs.trace.RemoteContext`` from a validated
    ``traceparent`` header) makes the solve ADOPT the propagated trace
    ID and record the remote parent span, so a router-edge trace and
    this worker's solve phases share one retrievable tree."""
    if not isinstance(payload, dict):
        raise ApiError(400, "request body must be a JSON object")
    if "assignment" not in payload:
        raise ApiError(400, "missing required field 'assignment'")
    if "brokers" not in payload:
        raise ApiError(400, "missing required field 'brokers'")
    try:
        current = Assignment.from_dict(payload["assignment"])
    except (KeyError, TypeError, ValueError) as e:
        raise ApiError(400, f"bad 'assignment': {e}") from e
    brokers = _parse_brokers(payload["brokers"])
    all_ids = sorted(set(brokers) | set(current.broker_ids()))
    topology = _parse_topology(payload.get("topology"), all_ids)
    rf = payload.get("rf")
    _validate_rf(rf)
    solver = payload.get("solver", "auto")
    if not isinstance(solver, str):
        raise ApiError(400, "'solver' must be a string")
    from .solvers.base import available_solvers

    if solver != "auto" and solver not in available_solvers():
        raise ApiError(
            400,
            f"unknown solver {solver!r}; available: "
            f"{['auto', *available_solvers()]}",
        )
    options = payload.get("options") or {}
    if not isinstance(options, dict):
        raise ApiError(400, "'options' must be an object")
    rejected = sorted(set(options) - ALLOWED_OPTIONS)
    if rejected:
        raise ApiError(
            400,
            f"unsupported option(s) {rejected}; allowed: "
            f"{sorted(ALLOWED_OPTIONS)}",
        )
    options = dict(options)  # never mutate the caller's payload
    limit = options.get("time_limit_s")
    if limit is not None and (
        isinstance(limit, bool) or not isinstance(limit, (int, float))
        or not limit > 0
    ):
        raise ApiError(400, "'time_limit_s' must be a positive number")
    if "pipeline" in options and not isinstance(
        options["pipeline"], bool
    ):
        raise ApiError(400, "'pipeline' must be a boolean")
    # portfolio lanes (docs/PORTFOLIO.md): bool only — the width is an
    # operator knob (KAO_PORTFOLIO_WIDTH), never a per-request one (a
    # client naming an arbitrary width could multiply device work)
    if "portfolio" in options and not isinstance(
        options["portfolio"], bool
    ):
        raise ApiError(400, "'portfolio' must be a boolean")
    # decomposed map-reduce solves (docs/DECOMPOSE.md): bool only —
    # group structure comes from the cluster's rack names, never the
    # client
    if "decompose" in options and not isinstance(
        options["decompose"], bool
    ):
        raise ApiError(400, "'decompose' must be a boolean")
    # fused ladder megachunks (docs/PIPELINE.md): bool only — the fused
    # width is an operator knob (KAO_MEGACHUNK / --megachunk), never a
    # per-request one (a client naming an arbitrary width could force
    # fresh compiles per request). true opts the solve into the
    # evidence-driven chooser, false pins the per-chunk ladder.
    if "megachunk" in options and not isinstance(
        options["megachunk"], bool
    ):
        raise ApiError(400, "'megachunk' must be a boolean")
    if max_solve_s is not None:
        # cap every solve: client may tighten the limit but not exceed it
        options["time_limit_s"] = (
            max_solve_s if limit is None else min(float(limit), max_solve_s)
        )
    # per-request end-to-end deadline (docs/RESILIENCE.md): the request
    # field wins, --default-deadline-s covers requests that carry none.
    # One Budget object threads the REMAINING time through queue wait
    # and solve — the solve gets what is left after validation and
    # queueing, never the full window again.
    deadline_s = payload.get("deadline_s", RESILIENCE["default_deadline_s"])
    if deadline_s is not None and (
        isinstance(deadline_s, bool)
        or not isinstance(deadline_s, (int, float)) or not deadline_s > 0
    ):
        raise ApiError(400, "'deadline_s' must be a positive number")
    budget = _rbudget.Budget(deadline_s)
    if deadline_s is not None:
        lim = options.get("time_limit_s")
        options["time_limit_s"] = (
            float(deadline_s) if lim is None
            else min(float(lim), float(deadline_s))
        )
    lock_wait_s = budget.cap(lock_wait_s)

    # request-scoped trace ID: adopted from a propagated traceparent
    # context when one arrived (the router join), generated fresh
    # otherwise; threaded into the solve (ambient obs.trace), echoed
    # in the response envelope, stamped into the flight record, and
    # retrievable via GET /debug/solves/<trace_id>
    trace_id, remote_parent = None, None
    if OBS["trace"]:
        if trace_ctx is not None:
            trace_id, remote_parent = trace_ctx.trace_id, \
                trace_ctx.span_id
        else:
            trace_id = _otrace.new_trace_id()
    try:
        # coalescing path: explicit TPU solves whose knobs the batched
        # lane solver understands may ride a shared dispatch. The
        # instance is built NOW (host-side numpy, milliseconds) so the
        # group key is the EXACT executable identity; the single-solve
        # path below reuses it either way.
        inst = None
        bucket_key = None
        # every per-bucket gate below (coalescing eligibility, circuit
        # breaker, checkpoint auto-resume, profiling budget) keys on
        # the solver that will ACTUALLY run: "auto" resolves
        # deterministically from the instance size, and at production
        # scale that is the TPU engine — a defaulted request must get
        # the same per-cluster isolation and resume behavior as an
        # explicit "solver": "tpu", not one shared ("solver", "auto")
        # circuit that a single pathological cluster could open for
        # the whole fleet
        solver_eff = solver
        if solver == "auto":
            from .models.instance import build_instance
            from .solvers.base import resolve_solver

            inst = build_instance(current, brokers, topology, rf)
            solver_eff = resolve_solver("auto", inst)
        if (
            solver_eff == "tpu"
            and _COALESCER.enabled()
            # a request carrying an EXPLICIT deadline takes the
            # single-solve path (its owner asked for precise deadline
            # semantics; _solve_job threads the remaining budget and
            # sheds pre-dispatch). Defaulted requests ride the lane —
            # the operator's --default-deadline-s must NOT disable
            # coalescing fleet-wide — and carry their Budget into the
            # batch: _run_batch_job sheds members whose deadline
            # expired while the batch was queued and runs the solve on
            # the TIGHTEST remaining member window
            and payload.get("deadline_s") is None
            and set(options) <= _BATCHABLE_OPTIONS
        ):
            from .models.instance import build_instance
            from .solvers.tpu import bucket

            if inst is None:
                inst = build_instance(current, brokers, topology, rf)
            non_seed = tuple(sorted(
                (k, v) for k, v in options.items() if k != "seed"
            ))
            bucket_key = (inst.num_brokers, inst.num_racks,
                          *bucket.bucket_shape(inst))
            key = (*bucket_key, non_seed)
            if not _COALESCER.should_bypass(key):
                # breaker admission only: the failure/success verdict
                # is recorded ONCE per batched dispatch in
                # _Coalescer._flush — per-waiter recording would turn
                # one failed batch into >= threshold trips
                admitted, retry_after = _BREAKER.allow(bucket_key)
                if not admitted:
                    raise _shed(
                        "circuit_open",
                        "circuit open for this cluster bucket after "
                        "repeated solver failures; retry later",
                        retry_after_s=retry_after,
                        bucket=list(bucket_key),
                    )
                entry = {
                    "current": current,
                    "instance": inst,
                    "seed": options.get("seed", 0),
                    "trace_id": trace_id,
                    "remote_parent": remote_parent,
                    "budget": budget,
                    "options": {k: v for k, v in options.items()
                                if k != "seed"},
                }
                return _COALESCER.submit(
                    key, entry, wait_s=lock_wait_s,
                    budget_s=options.get("time_limit_s"),
                )

        # the bucket/instance identity is needed even when the request
        # was not coalescing-eligible (non-batchable knobs, --max-batch
        # 1, an explicit deadline): the circuit breaker isolates
        # failures PER BUCKET — one pathological cluster must not open
        # the circuit for all TPU traffic — each bucket draws on ITS
        # OWN --profile-solves budget, and each cluster resumes its OWN
        # checkpoint. Build it now (host-side numpy, milliseconds); the
        # solve reuses the instance either way
        if solver_eff == "tpu" and bucket_key is None:
            from .models.instance import build_instance
            from .solvers.tpu import bucket

            if inst is None:
                inst = build_instance(current, brokers, topology, rf)
            bucket_key = (inst.num_brokers, inst.num_racks,
                          *bucket.bucket_shape(inst))

        def _solve_job():
            t0 = time.perf_counter()
            kw = dict(options)
            left = budget.remaining()
            if left is not None:
                if left <= 0.0:
                    # the queue wait consumed the whole request
                    # deadline: shed instead of starting a solve whose
                    # result nobody is waiting for
                    raise _shed(
                        "deadline",
                        "request deadline exhausted before the solve "
                        "started; retry with a larger deadline_s",
                        retry_after_s=1.0,
                        deadline_s=float(deadline_s),
                    )
                # remaining-time threading: the solve runs on what is
                # LEFT of the request deadline, not the full window
                kw["time_limit_s"] = (
                    left if kw.get("time_limit_s") is None
                    else min(float(kw["time_limit_s"]), left)
                )
            if solver_eff == "tpu" and inst is not None \
                    and RESILIENCE["checkpoint_dir"]:
                # crash-safe auto-resume: the checkpoint path is keyed
                # by instance fingerprint under the OPERATOR-chosen
                # directory (clients still cannot name paths); a
                # worker-crash retry or a repeated solve of the same
                # cluster warm-starts from the last completed plan
                import os

                from .utils.checkpoint import instance_fingerprint

                kw["checkpoint"] = os.path.join(
                    RESILIENCE["checkpoint_dir"],
                    instance_fingerprint(inst)[:32] + ".npz",
                )
            if solver_eff == "tpu" and bucket_key is not None:
                prof = _profile_dir_for(bucket_key, trace_id)
                if prof:
                    kw["profile_dir"] = prof
            for k, v in _tpu_kw(solver_eff).items():
                kw.setdefault(k, v)
            tr = _otrace.begin(trace_id, name="request", solver=solver,
                               remote_parent=remote_parent)
            try:
                res = optimize(
                    current, brokers, topology, target_rf=rf,
                    solver=solver, instance=inst, **kw,
                )
            except BaseException as e:
                if tr is not None:
                    tr.root.set(error=repr(e)[:200])
                    _otrace.finish(tr)
                _olog.error("solve_failed", trace_id=trace_id,
                            solver=solver, error=repr(e)[:200])
                raise
            dt = time.perf_counter() - t0
            port = res.solve.stats.get("portfolio") or None
            with _METRICS_LOCK:
                _METRICS["solves_total"] += 1
                _METRICS["solve_seconds_total"] += dt
                _METRICS["last_solve_seconds"] = dt
                if port:
                    _METRICS["portfolio_solves_total"] += 1
                    if port.get("early_exit"):
                        _METRICS["portfolio_early_exit_total"] += 1
                    wl = port.get("winner_lane")
                    if wl is not None:
                        _PORTFOLIO_WINNERS[int(wl)] = (
                            _PORTFOLIO_WINNERS.get(int(wl), 0) + 1
                        )
            rep = res.report()
            if tr is not None:
                tr.root.set(solver=res.solve.solver,
                            feasible=rep.get("feasible"),
                            replica_moves=rep.get("replica_moves"),
                            wall_s=round(dt, 4))
                _otrace.finish(tr)
            _olog.log("solve", trace_id=trace_id, solver=res.solve.solver,
                      wall_s=round(dt, 4), feasible=rep.get("feasible"),
                      moves=rep.get("replica_moves"),
                      proved_optimal=rep.get("proven_optimal"))
            out = {
                "assignment": res.assignment.to_dict(),
                "report": rep,
            }
            if trace_id:
                out["trace_id"] = trace_id
            return out

        brk_key = (
            bucket_key if bucket_key is not None
            else ("solver", solver_eff)
        )
        return _breaker_guarded(
            brk_key,
            lambda: _SOLVES.submit(
                _solve_job, wait_s=lock_wait_s,
                budget_s=options.get("time_limit_s"),
            ),
        )
    except ApiError:
        raise
    except (ValueError, KeyError) as e:
        msg = e.args[0] if e.args and isinstance(e.args[0], str) else str(e)
        raise ApiError(422, f"model rejected inputs: {msg}") from e
    except TypeError as e:
        raise ApiError(400, f"bad solver options: {e}") from e
    except NotImplementedError as e:
        raise ApiError(501, f"not supported by this package yet: {e}",
                       body={"reason": "not_ported"}) from e
    except RuntimeError as e:
        raise ApiError(500, f"solver failed: {e}") from e


def handle_evaluate(payload: dict, lock_wait_s: float,
                    max_solve_s: float | None = DEFAULT_MAX_SOLVE_S) -> dict:
    """POST /evaluate — audit an existing plan (``api.evaluate``):
    feasibility, violation counts, moves vs the provable minimum, and
    an optimality verdict. Same input fields as /submit plus the
    required ``plan``. No solver runs; the bound computations (LP,
    max-flow) are host-only but cost seconds at scale, so audits
    serialize on their OWN lock (a device solve never blocks them),
    shed with 503 when saturated, and cap their
    bound LPs at the same ``--max-solve-s`` budget as solves (expired
    tiers degrade to cheaper bounds rather than hold the lock)."""
    if not isinstance(payload, dict):
        raise ApiError(400, "payload must be a JSON object")
    for field in ("assignment", "brokers", "plan"):
        if field not in payload:
            raise ApiError(400, f"missing required field '{field}'")
    try:
        current = Assignment.from_dict(payload["assignment"])
        plan = Assignment.from_dict(payload["plan"])
    except (KeyError, TypeError, ValueError) as e:
        raise ApiError(400, f"bad assignment/plan: {e}") from e
    brokers = _parse_brokers(payload["brokers"])
    all_ids = sorted(set(brokers) | set(current.broker_ids()))
    topology = _parse_topology(payload.get("topology"), all_ids)
    rf = payload.get("rf")
    _validate_rf(rf)
    from .api import evaluate

    if not _AUDIT_LOCK.acquire(timeout=lock_wait_s):
        raise _shed(
            "audit_busy",
            f"auditor busy (no capacity within {lock_wait_s:.0f}s); "
            "retry later",
            retry_after_s=min(max(lock_wait_s, 1.0), 30.0),
        )
    try:
        out = evaluate(current, brokers, plan, topology, target_rf=rf,
                       time_budget_s=max_solve_s)
    except (ValueError, KeyError) as e:
        msg = e.args[0] if e.args and isinstance(e.args[0], str) else str(e)
        raise ApiError(422, f"model rejected inputs: {msg}") from e
    finally:
        _AUDIT_LOCK.release()
    _count(evaluates_total=1)
    return out


def _watch_solve_fn(state, prev_plan, budget) -> tuple[dict, dict]:
    """The registry-injected delta solver (docs/WATCH.md): build the
    post-event instance, warm-start from the previous certified plan
    (``api.optimize_delta``), and run it through the SAME serving
    machinery a /submit solve uses — the bounded worker queue, the
    per-bucket circuit breaker, and the solve-trace ring. The caller's
    ``budget`` threads into the engine, so a superseding event
    cancelling it retires this solve at the next chunk boundary."""
    from .api import optimize_delta
    from .models.instance import build_instance
    from .solvers.base import resolve_solver

    inst = build_instance(state.assignment, state.brokers,
                          state.topology, state.rf)
    solver_eff = resolve_solver("auto", inst)
    bucket_key: tuple
    if solver_eff == "tpu":
        from .solvers.tpu import bucket

        bucket_key = (inst.num_brokers, inst.num_racks,
                      *bucket.bucket_shape(inst))
    else:
        bucket_key = ("solver", solver_eff)
    trace_id = _otrace.new_trace_id() if OBS["trace"] else None
    max_solve_s = WATCH["max_solve_s"]

    def job():
        t0 = time.perf_counter()
        kw: dict = {}
        if solver_eff == "tpu":
            kw["budget"] = budget
            if max_solve_s is not None:
                kw["time_limit_s"] = max_solve_s
            prof = _profile_dir_for(bucket_key, trace_id)
            if prof:
                kw["profile_dir"] = prof
            kw.update(_tpu_kw(solver_eff))
        tr = _otrace.begin(trace_id, name="watch_event",
                           cluster=state.cluster_id, epoch=state.epoch)
        if tr is not None:
            # mid-rollout re-solve linkage (docs/ROLLOUT.md): while a
            # rollout owns this cluster's ground truth, the delta
            # re-solve trace links to the rollout's durable root trace
            # ID (persisted in the plan-store record), so the whole
            # wave story — start, re-solve, replan — joins under one ID
            rmgr = ROLLOUT.get("manager")
            if rmgr is not None:
                root_tid = rmgr.active_trace_root(state.cluster_id)
                if root_tid:
                    tr.root.set(rollout_root=root_tid)
        try:
            # flight-record tagging on THIS worker thread: the watch
            # manager's own context() does not cross the queue hop, so
            # the delta identity is re-established where the engine
            # actually runs (obs.flight, docs/OBSERVABILITY.md)
            with _oflight.context("delta", cluster=state.cluster_id,
                                  epoch=state.epoch):
                res = optimize_delta(
                    state.assignment, state.brokers, state.topology,
                    target_rf=state.rf, prev_plan=prev_plan,
                    solver=solver_eff, instance=inst, **kw,
                )
        except BaseException as e:
            if tr is not None:
                tr.root.set(error=repr(e)[:200])
                _otrace.finish(tr)
            _olog.error("watch_solve_failed", trace_id=trace_id,
                        cluster=state.cluster_id, epoch=state.epoch,
                        error=repr(e)[:200])
            raise
        dt = time.perf_counter() - t0
        with _METRICS_LOCK:
            _METRICS["solves_total"] += 1
            _METRICS["solve_seconds_total"] += dt
            _METRICS["last_solve_seconds"] = dt
        rep = res.report()
        if tr is not None:
            tr.root.set(solver=res.solve.solver,
                        feasible=rep.get("feasible"),
                        replica_moves=rep.get("replica_moves"),
                        warm_started=bool(
                            rep.get("solver_warm_started")
                        ),
                        wall_s=round(dt, 4))
            _otrace.finish(tr)
        _olog.log("watch_solve", trace_id=trace_id,
                  cluster=state.cluster_id, epoch=state.epoch,
                  solver=res.solve.solver, wall_s=round(dt, 4),
                  feasible=rep.get("feasible"),
                  moves=rep.get("replica_moves"),
                  warm=bool(rep.get("solver_warm_started")))
        if trace_id:
            rep["trace_id"] = trace_id
        return res.assignment.to_dict(), rep

    return _breaker_guarded(
        bucket_key,
        lambda: _SOLVES.submit(job, wait_s=WATCH["lock_wait_s"],
                               budget_s=max_solve_s),
    )


_WATCH_CONFIG_LOCK = threading.Lock()  # kao: guards(WATCH)


def _watch_registry() -> _wmanager.WatchRegistry:
    """The process's one watch registry, built lazily from WATCH (so
    main() and tests configure before first touch).

    Double-checked under ``_WATCH_CONFIG_LOCK`` (KAO116): this is
    called from concurrent HTTP handler threads (events, rollouts,
    /debug/watch), and the unlocked check-then-act let two first-touch
    requests each build a registry — the loser's clusters simply
    vanished from the winner's view."""
    reg = WATCH.get("registry")
    if reg is not None:
        return reg
    with _WATCH_CONFIG_LOCK:
        reg = WATCH.get("registry")
        if reg is None:
            store = (
                _wstore.PlanStore(WATCH["dir"]) if WATCH["dir"]
                else None
            )
            reg = _wmanager.WatchRegistry(
                _watch_solve_fn, store,
                window_s=WATCH["window_s"],
                max_backlog=WATCH["max_backlog"],
                solve_budget_s=WATCH["max_solve_s"],
            )
            WATCH["registry"] = reg
    return reg


def handle_cluster_event(
    cluster_id: str,
    payload: dict,
    *,
    lock_wait_s: float = DEFAULT_LOCK_WAIT_S,
    max_solve_s: float | None = DEFAULT_MAX_SOLVE_S,
) -> tuple[int, dict]:
    """POST /clusters/<id>/events — one fenced, typed state diff
    (docs/WATCH.md). Returns ``(http_status, body)``: 200 with the new
    certified plan when this request ran the solve, 202 when the event
    was coalesced behind an in-flight solve. Raises ApiError for
    malformed events (400), stale/replayed epochs (409, provably
    without a solve), impossible states (422), and storm backpressure
    (503 ``event_storm`` with Retry-After from the coalescing window)."""
    with _WATCH_CONFIG_LOCK:
        WATCH["lock_wait_s"] = lock_wait_s
        WATCH["max_solve_s"] = max_solve_s
    reg = _watch_registry()
    try:
        out = reg.handle_event(cluster_id, payload)
    except _wmanager.FencedEpoch as e:
        # the fencing contract: structured 409, idempotent (nothing was
        # applied), and PROVABLY no solve — kao_watch_fenced_total moves,
        # kao_solves_total does not, and no trace is born
        raise ApiError(
            409,
            str(e),
            body={
                "reason": "stale_epoch",
                "cluster_id": e.cluster_id,
                "epoch": e.got,
                "current_epoch": e.current,
                "expected_min_epoch": e.current + 1,
                "plan_epoch": e.plan_epoch,
            },
        ) from e
    except _wmanager.StormShed as e:
        raise _shed(
            "event_storm",
            str(e),
            retry_after_s=e.retry_after_s,
            cluster_id=e.cluster_id,
            backlog=e.backlog,
        ) from e
    except _wevents.EventError as e:
        raise ApiError(400, str(e)) from e
    except ApiError:
        raise
    except (ValueError, KeyError) as e:
        msg = e.args[0] if e.args and isinstance(e.args[0], str) else str(e)
        raise ApiError(422, f"model rejected the post-event state: "
                            f"{msg}") from e
    except RuntimeError as e:
        raise ApiError(500, f"delta solve failed: {e}") from e
    status = 202 if out.get("status") == "accepted" else 200
    return status, out


def _rollout_manager() -> _rexec.RolloutManager:
    """The process's one rollout manager, lazily built over the current
    watch registry (and rebuilt when tests swap the registry out)."""
    reg = _watch_registry()
    mgr = ROLLOUT.get("manager")
    if mgr is None or mgr.registry is not reg:
        mgr = _rexec.RolloutManager(
            reg, reg.store,
            broker_cap=ROLLOUT["broker_cap"],
            rack_cap=ROLLOUT["rack_cap"],
            packer=ROLLOUT["packer"],
            lanes=ROLLOUT["lanes"],
            trace=bool(OBS["trace"]),
        )
        ROLLOUT["manager"] = mgr
    return mgr


def handle_rollout_get(cluster_id: str) -> dict:
    """GET /clusters/<id>/rollout — the rollout record: status, wave
    schedule + per-wave transfer accounting, and the current wave as
    upstream-compatible reassignment JSON."""
    try:
        view = _rollout_manager().get(cluster_id)
    except (_wevents.EventError, ValueError) as e:
        raise ApiError(400, str(e)) from e
    if view is None:
        raise ApiError(
            404,
            f"no rollout for cluster {cluster_id!r}; start one with "
            "POST /clusters/<id>/rollout/start",
        )
    return view


def handle_rollout_command(
    cluster_id: str,
    cmd: str,
    payload: dict,
    *,
    lock_wait_s: float = DEFAULT_LOCK_WAIT_S,
) -> dict:
    """POST /clusters/<id>/rollout/{start,advance,pause,rollback} —
    one fenced rollout command (docs/ROLLOUT.md). 400 malformed, 404
    unknown cluster, 409 stale rollout epoch (structured, provably
    without touching the store) or a command the state machine cannot
    accept, 200 with the updated rollout view (including the current
    wave's reassignment JSON) otherwise."""
    mgr = _rollout_manager()
    budget = _rbudget.Budget(lock_wait_s)
    try:
        return mgr.command(cluster_id, cmd, payload, budget=budget)
    except _rstate.RolloutFenced as e:
        raise ApiError(
            409,
            str(e),
            body={
                "reason": "stale_rollout_epoch",
                "cluster_id": e.cluster_id,
                "epoch": e.got,
                "current_rollout_epoch": e.current,
                "expected_min_epoch": e.current + 1,
            },
        ) from e
    except _rstate.RolloutConflict as e:
        raise ApiError(
            409, str(e), body={"reason": "bad_state"},
        ) from e
    except _rstate.RolloutError as e:
        raise ApiError(400, str(e)) from e
    except _wevents.EventError as e:
        raise ApiError(404, str(e)) from e
    except ApiError:
        raise
    except (ValueError, KeyError) as e:
        msg = e.args[0] if e.args and isinstance(e.args[0], str) else str(e)
        raise ApiError(422, f"rollout rejected: {msg}") from e


def handle_clusters_get(cluster_id: str | None = None) -> dict:
    """GET /clusters (listing) and GET /clusters/<id> (state + last
    certified plan)."""
    reg = _watch_registry()
    if cluster_id is None:
        return {"clusters": reg.list_clusters(),
                "watch": reg.snapshot()}
    try:
        info = reg.get_cluster(cluster_id)
    except _wevents.EventError as e:
        raise ApiError(400, str(e)) from e
    if info is None:
        raise ApiError(
            404,
            f"unknown cluster {cluster_id!r}; bootstrap it with "
            "POST /clusters/<id>/events",
        )
    return info


def handle_healthz() -> dict:
    """GET /healthz: the reference's sections. ``platform`` is ``"gpu"``
    when the service solves on the card, ``"cpu"`` otherwise.

    The ``cache`` section keeps the reference's keys. The reference
    counts XLA executables there; this package builds no executable per
    shape, so here: ``executables_held`` is the number of kernel
    libraries loaded in this process; ``persistent_cache_dir`` the
    kernels' build directory (``--compile-cache``); ``persistent_cache``
    its hits (a library loaded ready-built, by an earlier process or a
    worker sharing the directory) and misses (an ``nvcc`` build here);
    ``exec_hits``/``exec_misses`` chunk dispatches that found their
    kernels built and graphs captured, or paid a build or a capture;
    ``compiles_total``/``compile_seconds_total`` those builds and
    captures; ``bucket_*``, ``warm_buckets``, ``lane_ladder`` and
    ``lane_executables`` as in the reference (``lane_executables``:
    the lane widths served per bucket)."""
    from .ops import kernels as _kernels
    from .parallel import mesh
    from .solvers.base import available_solvers
    from .solvers.tpu import bucket

    _build_info(resolve=True)  # populate the /metrics build-info cache
    return {
        "status": "ok",
        "solvers": available_solvers(),
        "platform": _platform.ensure_backend(SERVE["device"]),
        "cache": {
            "bucketing_enabled": bucket.enabled(),
            "part_ladder_head": bucket.ladder(10),
            "executables_held": len(_kernels._LIBS),
            "persistent_cache_dir": _platform.compile_cache_dir(),
            "persistent_cache": _platform.compile_cache_stats(),
            "warm_buckets": bucket.STATS.seen(),
            "lane_ladder": bucket.lane_ladder(),
            "lane_executables": mesh.lane_serve_report(),
            **bucket.STATS.snapshot(),
        },
        "queue": _SOLVES.stats(),
        "coalescing": {
            "enabled": _COALESCER.enabled(),
            "window_ms": round(_COALESCER.window_s * 1e3, 3),
            "max_batch": _COALESCER.max_batch,
        },
        "portfolio": _healthz_portfolio(),
        "megachunk": _healthz_megachunk(),
        "decompose": _healthz_decompose(),
        "mesh": _healthz_mesh(),
        "observability": {
            "trace_enabled": bool(OBS["trace"]),
            "solve_reports_held": len(_otrace.RECENT.ids()),
            "report_ring_capacity": _otrace.RECENT.capacity,
            "report_ring": _otrace.RECENT.stats(),
            "trace_tail": _otrace.TAIL.snapshot(),
            "profile_dir": OBS["profile_dir"],
            "flight": _oflight.snapshot(),
            "stream": _oflight.stream_stats(),
            "worker": _oflight.worker_identity(),
            "fleet_peers": list(FLEET["peers"]),
        },
        # device-occupancy sampler (--sample-devices; obs.sampler):
        # per-card memory, the dispatch-accumulator duty cycle, and the
        # rolling per-bucket roofline summary
        "devices": _osampler.SAMPLER.snapshot(),
        # the SLO engine's verdict (obs.slo): worst status across
        # classes + per-class burn rates (full detail: GET /debug/slo)
        "slo": _healthz_slo(),
        "sanitizer": _sanitize_mod.snapshot(),
        "resilience": {
            "chaos": _chaos.snapshot(),
            "breaker": _BREAKER.snapshot(),
            "degradations": _ladder.snapshot(),
            "default_deadline_s": RESILIENCE["default_deadline_s"],
            "checkpoint_dir": RESILIENCE["checkpoint_dir"],
            "checkpoint_files": len(_checkpoint_files()),
            "checkpoint_max_files": RESILIENCE["checkpoint_max_files"],
            "checkpoint_max_age_s": RESILIENCE["checkpoint_max_age_s"],
            "queue_wait_s": _SOLVES.queue_wait_s,
        },
        "watch": _healthz_watch(),
        "rollout": _healthz_rollout(),
    }


def _healthz_portfolio() -> dict:
    """The /healthz portfolio section: the width a defaulted sweep solve
    races, the lane-padded width it maps to, the config table and the
    adaptive table's evidence."""
    import dataclasses as _dc

    from .solvers.tpu import bucket
    from .solvers.tpu.arrays import (
        portfolio_adapt_snapshot,
        portfolio_configs,
    )
    from .solvers.tpu.engine import portfolio_width_default

    width = portfolio_width_default()
    return {
        "enabled": width > 1,
        "width": width,
        "lane_bucket": bucket.lane_bucket(width),
        "configs": [
            _dc.asdict(c) for c in portfolio_configs(width)
        ] if width > 1 else [],
        "adapt": portfolio_adapt_snapshot(),
    }


def _healthz_megachunk() -> dict:
    """The /healthz megachunk section: the resolved process default
    (``--megachunk`` / ``KAO_MEGACHUNK``), the per-bucket evidence table
    and the width "auto" picks from it (``choose_megachunk_k``), and the
    group graphs this process holds (one step graph a bucket, the CUDA
    graphs of a step's pieces, replayed once an active step of a fused
    group):
    ``engine.megachunk_snapshot()``."""
    from .solvers.tpu.engine import megachunk_snapshot

    return megachunk_snapshot()


def _healthz_mesh() -> dict:
    """The /healthz mesh section: the solve mesh's axis sizes and
    devices, the ``KAO_MESH_SHARDING`` mode, the per-bucket sharding
    evidence and current choice, the running search/reshard counters
    (``parallel.mesh.mesh_snapshot``), and the processes, with the
    multi-process probe's MEMOIZED verdict (never probed here: /healthz
    stays cheap). The same snapshot renders the ``kao_mesh_*``
    families."""
    from .parallel import distributed as _dist
    from .parallel.mesh import mesh_snapshot

    snap = mesh_snapshot()
    probe = _dist._PROBE_MEMO
    snap["processes"] = {
        "n_processes": _dist.process_count(),
        "process_index": _dist.process_index(),
        "backend": _dist.backend(),
        "multiprocess_probe": (
            {"probed": True, "ok": probe[0], "reason": probe[1]}
            if probe is not None else {"probed": False}),
    }
    return snap


def _healthz_slo() -> dict:
    """The /healthz slo section: compact — status + per-class burn
    rates, not the full event detail (that is GET /debug/slo)."""
    snap = _oslo.ENGINE.snapshot()
    return {
        "status": snap.get("status", "ok"),
        "classes": {
            cls: {
                "status": c["status"],
                "events_total": c["events_total"],
                "burn_rates": {
                    win: w["burn_rate"]
                    for win, w in c["windows"].items()
                },
            }
            for cls, c in (snap.get("classes") or {}).items()
        },
    }


def handle_debug_kernels() -> dict:
    """GET /debug/kernels — this process's hand-written CUDA kernels:
    each wrapper's launch count (process-wide, one a launch and nowhere
    else, so a fleet harness can read across processes that a routed
    solve went through them) and the build directory's traffic."""
    from .ops import kernels as _kernels

    return {"device": SERVE["device"],
            "launches": {k.name: k.launches for k in _kernels.KERNELS},
            "build": _kernels.cache_stats()}


def handle_debug_slo() -> dict:
    """GET /debug/slo — the full SLO snapshot: per-class objectives,
    multi-window burn rates, worst-recent exemplars, the drift-alarm
    state (obs.drift), and the tail of the flight-record stream."""
    return {
        "slo": _oslo.ENGINE.snapshot(),
        "flight": _oflight.snapshot(),
        "drift": _odrift.MONITOR.snapshot(),
        "exemplars": {
            "solve_seconds": _oflight.solve_exemplars(),
            "phase_seconds": _otrace.phase_exemplars(),
        },
        "recent_records": _oflight.recent(32),
    }


def handle_debug_profile() -> dict:
    """GET /debug/profile — the continuous roofline observatory: the
    per-bucket achieved-vs-peak roofline from the dispatch keys'
    analytic cost models (obs.prof), wall-clock attribution aggregated
    from the flight ledgers, the worst-attribution solves (trace_id
    links into /debug/solves/<id>), and the dispatch-gap histogram with
    p99 exemplars."""
    recent = _oflight.recent()
    psnap = _oprof.snapshot()
    return {
        "peaks": psnap["peaks"],
        "roofline": _oprof.roofline(),
        "executables": psnap["executables"],
        "attribution": _oprof.attribution_summary(recent),
        "worst_solves": _oprof.worst_solves(recent),
        "dispatch_gaps": {
            "histogram": _oprof.gap_snapshot(),
            "exemplars": _oprof.gap_exemplars(),
        },
        "counters": psnap["counters"],
        "overhead": psnap["overhead"],
    }


def _healthz_decompose() -> dict:
    """The /healthz decompose section (``decompose.config_snapshot``)."""
    from .decompose import config_snapshot

    return config_snapshot()


def handle_fleet_get() -> dict:
    """GET /debug/fleet — this worker's record ring merged with the
    recent streams of the --fleet-peers workers (obs.fleet): one
    ordered, dedup'd view with fleet-wide burn rates, drift alarms,
    and per-worker lag. A dead peer degrades to an ``errors`` entry,
    never a 500 — the merged view over the reachable workers still
    serves."""
    from concurrent.futures import ThreadPoolExecutor

    from .obs import fleet as _ofleet

    sources = [("self", _oflight.recent())]
    errors: dict = {}
    peers = list(FLEET["peers"])
    if peers:
        # fetch peers CONCURRENTLY: N dead peers must cost ~one
        # timeout on this handler thread, not N stacked timeouts
        def _fetch(url):
            return _ofleet.fetch_records(
                url, tail=FLEET["tail"], timeout=FLEET["timeout_s"],
            )

        with ThreadPoolExecutor(max_workers=min(len(peers), 8)) as ex:
            futures = [(url, ex.submit(_fetch, url)) for url in peers]
            for url, fut in futures:
                try:
                    sources.append((url, fut.result()))
                except Exception as e:
                    errors[url] = repr(e)[:200]
    view = _ofleet.build_view(sources, errors=errors or None)
    view.pop("drift_rows", None)  # exposition-internal detail
    view["peers"] = list(FLEET["peers"])
    view["stream"] = _oflight.stream_stats()
    return view


def _healthz_watch() -> dict:
    """The /healthz watch section. The registry is built lazily and its
    PlanStore touches the filesystem — a probe endpoint must degrade to
    an error field, never die with a traceback, if the watch dir went
    bad after boot (startup validates it; permissions can change)."""
    try:
        return {"dir": WATCH["dir"], **_watch_registry().snapshot()}
    except Exception as e:  # pragma: no cover - post-boot dir breakage
        return {"dir": WATCH["dir"], "error": repr(e)[:200]}


def _healthz_rollout() -> dict:
    """The /healthz rollout section — same degrade-to-error discipline
    as the watch section (the manager's lazy build touches the plan
    store)."""
    try:
        return _rollout_manager().snapshot()
    except Exception as e:  # pragma: no cover - post-boot dir breakage
        return {"error": repr(e)[:200]}


def _synthetic_cluster(brokers: int, partitions: int, rf: int,
                       racks: int):
    """A steady-state round-robin cluster of the requested shape, used
    only to drive a warmup solve whose executables land in the bucket
    (brokers, racks, rf-bucket, partition-bucket)."""
    from .models.cluster import PartitionAssignment

    parts = [
        PartitionAssignment(
            topic="warmup", partition=p,
            replicas=[(p + i) % brokers for i in range(rf)],
        )
        for p in range(partitions)
    ]
    topo = Topology.from_dict(
        {str(b): f"rack{b % racks}" for b in range(brokers)}
    )
    return Assignment(partitions=parts), list(range(brokers)), topo


def _parse_warmup_shape(sh) -> tuple[int, int, int, int]:
    """One warmup shape: {brokers, partitions, rf?, racks?} or a
    [brokers, partitions, rf?, racks?] array. Returns (B, P, R, K)."""
    if isinstance(sh, dict):
        vals = (sh.get("brokers"), sh.get("partitions"),
                sh.get("rf", 3), sh.get("racks", 1))
    elif isinstance(sh, list) and 2 <= len(sh) <= 4:
        vals = tuple(sh) + (3, 1)[len(sh) - 2:]
    else:
        raise ApiError(
            400,
            "each warmup shape must be {brokers, partitions, rf?, racks?} "
            "or a [brokers, partitions, rf?, racks?] array",
        )
    if not all(isinstance(v, int) and not isinstance(v, bool) and v > 0
               for v in vals):
        raise ApiError(400, f"warmup shape values must be positive ints: {sh}")
    b, p, r, k = vals
    if r > b:
        raise ApiError(400, f"warmup shape has rf {r} > brokers {b}")
    if k > b:
        raise ApiError(400, f"warmup shape has racks {k} > brokers {b}")
    # resource caps: the synthetic cluster is built server-side on the
    # handler thread, so a ~60-byte body must never be able to request a
    # multi-GB allocation (brokers/partitions far past any bucket this
    # service could ever serve). Caps sit an order of magnitude above
    # the jumbo benchmark config.
    if b > 65_536:
        raise ApiError(400, f"warmup brokers {b} exceeds cap 65536")
    if p > 1_000_000 or p * r > 4_000_000:
        raise ApiError(
            400,
            f"warmup shape {p} partitions x rf {r} exceeds the "
            "1M-partition / 4M-replica-slot cap",
        )
    return b, p, r, k


def handle_warmup(
    payload: dict,
    *,
    lock_wait_s: float = DEFAULT_LOCK_WAIT_S,
    max_solve_s: float | None = DEFAULT_MAX_SOLVE_S,
) -> dict:
    """POST /warmup — pre-pay the first-solve costs for a list of
    cluster shapes before they carry traffic: in this package the kernel
    builds (``nvcc``, once per process) and the chain engine's graph
    captures, counted as ``compiles`` (``bucket.STATS``). Each shape is
    solved once on a synthetic cluster with the engine pinned and the
    host-side constructor races disabled (``precompile=True`` — a
    symmetric synthetic cluster would otherwise certify on the host and
    never reach the card), through the same queue and time budget as
    real traffic. Returns per-shape bucket keys, wall clocks, and the
    compile counters each warmup actually moved.

    Counter caveat: ``compiles``/``already_warm`` are derived from
    process-global cache deltas, so a PRODUCTION solve running
    concurrently with the warmup can bleed its compiles into (or absorb
    them out of) a shape's row. Warm up before taking traffic — the
    startup ``--warmup`` path — or treat overlapping rows as
    approximate; per-solve counter attribution is the clean fix and is
    deliberately out of scope here.

    Lanes: unless ``"lanes": false``, each shape also runs one lane-padded
    batch per rung of the lane ladder (``solvers.tpu.bucket.lane_bucket``),
    the path the coalescing dispatcher sends, as the reference warms its
    lane executables; ``"portfolio"`` (default true) and ``"decompose"``
    warm those paths the same way."""
    if not isinstance(payload, dict):
        raise ApiError(400, "request body must be a JSON object")
    shapes = payload.get("shapes")
    if not isinstance(shapes, list) or not shapes:
        raise ApiError(400, "missing required field 'shapes' (non-empty list)")
    if len(shapes) > 16:
        raise ApiError(400, "at most 16 warmup shapes per request")
    engine = payload.get("engine", "sweep")
    if engine not in ("sweep", "chain"):
        raise ApiError(400, "warmup 'engine' must be 'sweep' or 'chain'")
    warm_lanes = payload.get("lanes", True)
    if not isinstance(warm_lanes, bool):
        raise ApiError(400, "warmup 'lanes' must be a boolean")
    # portfolio warmup (docs/PORTFOLIO.md): unless "portfolio": false,
    # each shape also runs one portfolio-enabled precompile solve so
    # the portfolio-width lane executable — with the SINGLE-solve
    # path's chunk schedule — is warm before traffic races it
    warm_portfolio = payload.get("portfolio", True)
    if not isinstance(warm_portfolio, bool):
        raise ApiError(400, "warmup 'portfolio' must be a boolean")
    # decompose warmup (docs/DECOMPOSE.md): "decompose": true (2
    # groups) or an explicit group count precompiles the MAP-phase
    # lane executable for each shape's sub-bucket — the shape a
    # decomposed solve actually dispatches — so the first ultra-jumbo
    # request finds the map phase warm
    warm_decompose = payload.get("decompose", False)
    if warm_decompose is True:
        warm_decompose = 2
    if warm_decompose is not False and not (
        isinstance(warm_decompose, int)
        and not isinstance(warm_decompose, bool)
        and 2 <= warm_decompose <= 16
    ):
        raise ApiError(
            400, "warmup 'decompose' must be a boolean or a group "
                 "count 2..16")
    parsed = [_parse_warmup_shape(sh) for sh in shapes]

    from .solvers.tpu import bucket

    results = []
    for b, p, r, k in parsed:
        current, broker_list, topo = _synthetic_cluster(b, p, r, k)
        # precompile=True disables the host-side constructor races: the
        # symmetric synthetic cluster would otherwise certify on the
        # host and never reach the device path this endpoint warms
        options: dict = {"engine": engine, "seed": 0, "precompile": True,
                         **_tpu_kw("tpu")}
        if max_solve_s is not None:
            options["time_limit_s"] = max_solve_s

        def _job(current=current, broker_list=broker_list, topo=topo,
                 options=options):
            t0 = time.perf_counter()
            res = optimize(current, broker_list, topo, solver="tpu",
                           **options)
            return time.perf_counter() - t0, res.solve.stats

        before = bucket.STATS.snapshot()
        pc_before = _platform.compile_cache_stats()
        try:
            wall, stats = _SOLVES.submit(
                _job, wait_s=lock_wait_s, budget_s=max_solve_s
            )
        except ApiError:
            raise
        except Exception as e:
            raise ApiError(500, f"warmup solve failed: {e}") from e
        after = bucket.STATS.snapshot()
        pc_after = _platform.compile_cache_stats()
        row = {
            "shape": {"brokers": b, "partitions": p, "rf": r, "racks": k},
            "bucket_parts": stats.get("bucket_parts"),
            "bucket_rf": stats.get("bucket_rf"),
            "engine": engine,
            "wall_s": round(wall, 3),
            "compiles": after["compiles_total"] - before["compiles_total"],
            "compile_s": round(
                after["compile_seconds_total"]
                - before["compile_seconds_total"], 3,
            ),
            "already_warm": (
                after["compiles_total"] == before["compiles_total"]
            ),
            # persistent-cache movement for this shape (docs/FLEET.md):
            # with a shared KAO_COMPILE_CACHE, a non-owner worker's
            # warmup should land ~all hits and ZERO fresh misses — the
            # fleet-warmup acceptance evidence. Same process-global-
            # delta caveat as compiles above.
            "persistent": {
                "hits": pc_after["hits"] - pc_before["hits"],
                "misses": pc_after["misses"] - pc_before["misses"],
            },
        }
        if warm_lanes:
            row.update(_warmup_lanes(
                current, broker_list, topo, engine, max_solve_s,
                lock_wait_s,
            ))
        if warm_portfolio and engine == "sweep":
            row.update(_warmup_portfolio(
                current, broker_list, topo, max_solve_s, lock_wait_s,
            ))
        if warm_decompose:
            row.update(_warmup_decompose(
                b, p, r, k, int(warm_decompose), engine, max_solve_s,
                lock_wait_s,
            ))
        results.append(row)
    return {"warmed": results, "cache": bucket.STATS.snapshot()}


def _warmup_portfolio(current, broker_list, topo,
                      max_solve_s: float | None,
                      lock_wait_s: float) -> dict:
    """Precompile the portfolio-width lane executable for one warmup
    shape: a single precompile solve with ``portfolio=True`` races the
    full config table through the lane-padded dispatch the production
    single-solve path uses — the chunk schedule (and with it the
    executable identity) matches what real portfolio traffic sends.
    Best-effort like the lane warmup; width 1 (portfolio disabled
    process-wide) is a cheap no-op row."""
    from .solvers.tpu import bucket
    from .solvers.tpu.engine import portfolio_width_default

    width = portfolio_width_default()
    if width <= 1:
        return {"portfolio_width": 1}

    def _job():
        t0 = time.perf_counter()
        options: dict = {"engine": "sweep", "seed": 0,
                         "precompile": True, "portfolio": True,
                         **_tpu_kw("tpu")}
        if max_solve_s is not None:
            options["time_limit_s"] = max_solve_s
        optimize(current, broker_list, topo, solver="tpu", **options)
        return time.perf_counter() - t0

    before = bucket.STATS.snapshot()
    try:
        wall = _SOLVES.submit(
            _job, wait_s=lock_wait_s, budget_s=max_solve_s
        )
    except Exception as e:  # best-effort: the single-path row stands
        _olog.warn("warmup_portfolio_failed", error=repr(e)[:200])
        return {"portfolio_error": repr(e)[:200]}
    after = bucket.STATS.snapshot()
    return {
        "portfolio_width": width,
        "portfolio_lane_bucket": bucket.lane_bucket(width),
        "portfolio_compiles": (
            after["compiles_total"] - before["compiles_total"]
        ),
        "portfolio_wall_s": round(wall, 3),
        "portfolio_already_warm": (
            after["compiles_total"] == before["compiles_total"]
        ),
    }


def _warmup_decompose(b: int, p: int, r: int, k: int, groups: int,
                      engine: str, max_solve_s: float | None,
                      lock_wait_s: float) -> dict:
    """Precompile the MAP-phase lane executable for one warmup shape's
    decomposed sub-bucket: a decomposed solve of (B, P, R, K) splits
    into ``groups`` sub-instances of ~(B/G, P/G, R, K/G) and dispatches
    them as ONE lane-padded batch — so that batch executable, at lane
    rung ``lane_bucket(groups)``, is what must be warm. Best-effort
    like the lane/portfolio warmups."""
    from .models.instance import build_instance
    from .solvers.tpu import bucket
    from .solvers.tpu.engine import solve_tpu_batch

    bg = max(b // groups, r, 1)
    pg = max(p // groups, 1)
    kg = max(min(k // groups if k >= groups else k, bg), 1)

    def _job():
        t0 = time.perf_counter()
        current, broker_list, topo = _synthetic_cluster(bg, pg, r, kg)
        insts = [
            build_instance(current, broker_list, topo)
            for _ in range(groups)
        ]
        kw: dict = {"seeds": list(range(groups)), "engine": engine,
                    "precompile": True, **_tpu_kw("tpu")}
        if max_solve_s is not None:
            kw["time_limit_s"] = max_solve_s
        solve_tpu_batch(insts, **kw)
        return time.perf_counter() - t0

    before = bucket.STATS.snapshot()
    try:
        wall = _SOLVES.submit(
            _job, wait_s=lock_wait_s, budget_s=max_solve_s
        )
    except Exception as e:  # best-effort: the single-path row stands
        _olog.warn("warmup_decompose_failed", error=repr(e)[:200])
        return {"decompose_error": repr(e)[:200]}
    after = bucket.STATS.snapshot()
    return {
        "decompose_groups": groups,
        "decompose_sub_shape": {
            "brokers": bg, "partitions": pg, "rf": r, "racks": kg,
        },
        "decompose_lane_bucket": bucket.lane_bucket(groups),
        "decompose_compiles": (
            after["compiles_total"] - before["compiles_total"]
        ),
        "decompose_wall_s": round(wall, 3),
        "decompose_already_warm": (
            after["compiles_total"] == before["compiles_total"]
        ),
    }


def _warmup_lanes(current, broker_list, topo, engine: str,
                  max_solve_s: float | None,
                  lock_wait_s: float) -> dict:
    """Precompile the consolidated lane-padded batch executables for
    one warmup shape: ONE small batch per lane-ladder rung >= 2, each
    padded to its rung, so every batch width 2..Lmax the coalescing
    dispatcher can send finds its executable warm. On the default
    ladder (1, 8) that is exactly one executable per bucket; a custom
    multi-rung ``KAO_LANE_BUCKETS`` ladder warms each rung once
    (the minimal width mapping to it). ``precompile=True`` keeps the
    synthetic batches out of the flight/SLO ledgers; the batch path's
    own defaults plus the service solve budget make the compiled chunk
    schedule match what the coalescing dispatcher sends under
    ``--default-deadline-s``."""
    from .models.instance import build_instance
    from .solvers.tpu import bucket
    from .solvers.tpu.engine import solve_tpu_batch

    rungs = [r for r in bucket.lane_ladder() if r >= 2]
    if not rungs:
        return {}  # lane padding off: nothing to consolidate
    # the cheapest batch width mapping to each rung: one past the
    # previous rung (first rung: width 2)
    widths, prev = [], 1
    for r in rungs:
        widths.append(min(prev + 1, r))
        prev = r

    def _job():
        t0 = time.perf_counter()
        for w in widths:
            insts = [
                build_instance(current, broker_list, topo)
                for _ in range(w)
            ]
            kw: dict = {"seeds": list(range(w)), "engine": engine,
                        "precompile": True, **_tpu_kw("tpu")}
            if max_solve_s is not None:
                kw["time_limit_s"] = max_solve_s
            solve_tpu_batch(insts, **kw)
        return time.perf_counter() - t0

    before = bucket.STATS.snapshot()
    try:
        wall = _SOLVES.submit(
            _job, wait_s=lock_wait_s, budget_s=max_solve_s
        )
    except Exception as e:  # best-effort: the single-path row stands
        _olog.warn("warmup_lanes_failed", error=repr(e)[:200])
        return {"lane_error": repr(e)[:200]}
    after = bucket.STATS.snapshot()
    return {
        "lane_bucket": rungs[-1],
        "lane_buckets": rungs,
        "lane_compiles": (
            after["compiles_total"] - before["compiles_total"]
        ),
        "lane_wall_s": round(wall, 3),
        "lanes_already_warm": (
            after["compiles_total"] == before["compiles_total"]
        ),
    }


def parse_warmup_flag(spec: str) -> list[dict]:
    """``--warmup "B:P[:R[:K]],..."`` -> /warmup shapes list."""
    shapes = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if not 2 <= len(fields) <= 4:
            raise ValueError(
                f"bad warmup shape {part!r}; want brokers:partitions[:rf[:racks]]"
            )
        vals = [int(f) for f in fields]
        shape = {"brokers": vals[0], "partitions": vals[1]}
        if len(vals) > 2:
            shape["rf"] = vals[2]
        if len(vals) > 3:
            shape["racks"] = vals[3]
        shapes.append(shape)
    if not shapes:
        raise ValueError("empty --warmup spec")
    return shapes


def start_warmup_thread(shapes: list[dict], *, engine: str = "sweep",
                        max_solve_s: float | None = DEFAULT_MAX_SOLVE_S):
    """Server-start precompile: run the configured bucket list through
    /warmup on a daemon thread so the listener is live immediately;
    early traffic simply queues behind the warmup solves."""

    def run():
        try:
            out = handle_warmup(
                {"shapes": shapes, "engine": engine},
                lock_wait_s=3600.0, max_solve_s=max_solve_s,
            )
            for row in out["warmed"]:
                _olog.log(
                    "warmup", shape=str(row["shape"]),
                    bucket_parts=row["bucket_parts"],
                    bucket_rf=row["bucket_rf"], wall_s=row["wall_s"],
                    compiles=row["compiles"],
                )
        except Exception as e:  # warmup is best-effort, never fatal
            _olog.warn("warmup_failed", error=repr(e)[:200])

    t = threading.Thread(target=run, daemon=True, name="kao-warmup")
    t.start()
    return t


class Handler(BaseHTTPRequestHandler):
    server_version = "kafka-assignment-optimizer-tpu/1.0"

    def _send(self, status: int, obj: dict,
              headers: dict | None = None) -> None:
        body = json.dumps(obj, default=str).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        # which worker answered: the flight-record identity stamp as a
        # header, so a fleet router (and anything behind it) attributes
        # every response — success or shed — without parsing the body
        w = _oflight.worker_identity()
        self.send_header(
            "X-KAO-Worker",
            f"{w['host']}:{w['pid']}:{w['port'] or 0}:{w['boot']}",
        )
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # route access logs to stderr quietly
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _route(self) -> str:
        # drop any query string (LB health probes append them) and a
        # trailing slash before matching
        path = self.path.split("?", 1)[0]
        return path.rstrip("/") or "/"

    def do_GET(self):
        route = self._route()
        if route == "/":
            # the human-usable front door (reference hosted-instance UX,
            # README.md:189-195); JSON clients negotiate the schema
            accept = self.headers.get("Accept", "")
            if "application/json" in accept and "text/html" not in accept:
                self._send(200, landing.request_schema())
                return
            body = landing.render_landing().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif route == "/schema":
            self._send(200, landing.request_schema())
        elif route == "/healthz":
            self._send(200, handle_healthz())
        elif route == "/metrics":
            body = render_metrics().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif route == "/clusters":
            self._send(200, handle_clusters_get())
        elif route.startswith("/clusters/") \
                and route.endswith("/rollout") \
                and len(route) > len("/clusters//rollout"):
            # the length guard keeps a cluster legitimately NAMED
            # "rollout" readable: GET /clusters/rollout has no cluster
            # segment before the suffix and falls through to the
            # normal cluster view below
            try:
                self._send(200, handle_rollout_get(
                    route[len("/clusters/"):-len("/rollout")]
                ))
            except ApiError as e:
                if e.status != 503:
                    _count(errors_total=1)
                self._send(e.status, {"error": str(e), **e.body_extra})
        elif route.startswith("/clusters/"):
            try:
                self._send(200, handle_clusters_get(
                    route[len("/clusters/"):]
                ))
            except ApiError as e:
                if e.status != 503:
                    _count(errors_total=1)
                self._send(e.status, {"error": str(e), **e.body_extra})
        elif route == "/debug/solves":
            # most-recent-first listing of retrievable solve reports
            self._send(200, {"trace_ids": _otrace.RECENT.ids()})
        elif route.startswith("/debug/solves/"):
            tid = route.rsplit("/", 1)[1]
            rep = _otrace.RECENT.get(tid)
            if rep is None:
                self._send(404, {
                    "error": f"no solve report for trace_id {tid!r} "
                             f"(ring holds the last "
                             f"{_otrace.RECENT.capacity} traced solves)",
                })
                return
            # ?format=chrome: the span tree as Chrome trace-event JSON
            # (obs.chrome) — save it and load in chrome://tracing or
            # Perfetto; the offline path is obs.trace_cli convert
            from urllib.parse import parse_qs, urlparse

            fmt = (parse_qs(urlparse(self.path).query)
                   .get("format") or ["json"])[0]
            if fmt == "chrome":
                self._send(200, _ochrome.to_chrome(rep))
            elif fmt == "json":
                self._send(200, rep)
            else:
                self._send(400, {
                    "error": f"unknown format {fmt!r}; "
                             "want 'json' or 'chrome'",
                })
        elif route == "/debug/slo":
            # the full SLO snapshot: per-class objectives, multi-window
            # burn rates, worst-recent exemplars, drift-alarm state,
            # and the tail of the flight-record stream
            self._send(200, handle_debug_slo())
        elif route == "/debug/profile":
            # the roofline observatory: per-bucket achieved-vs-peak
            # occupancy from the keys' analytic cost models + wall-clock
            # attribution over the flight ledgers
            self._send(200, handle_debug_profile())
        elif route == "/debug/kernels":
            self._send(200, handle_debug_kernels())
        elif route == "/debug/fleet":
            # the merged fleet view: this worker + --fleet-peers
            # (docs/OBSERVABILITY.md "Fleet plane"); peer failures
            # degrade to an "errors" field inside the handler, so
            # this always answers 200
            self._send(200, handle_fleet_get())
        elif route == "/debug/stream":
            self._stream_flight()
        else:
            _count(errors_total=1)
            self._send(404, {"error": f"no such endpoint: {self.path}"})

    def _stream_flight(self) -> None:
        """GET /debug/stream — flight records as newline-delimited
        JSON, as they land (docs/OBSERVABILITY.md "Fleet plane").

        Query params: ``follow`` (default 1; 0 = dump the ring tail
        and close — the snapshot mode /debug/fleet and kao-fleet use),
        ``tail`` (replay the last N ring records first, default 0 in
        follow mode / 512 in snapshot mode), ``kind`` (filter).

        Live mode subscribes a bounded per-client queue BEFORE the
        tail replay and skips queued records the replay already sent
        (seq-deduped), so a record landing concurrently is delivered
        exactly once. A slow client overflows its own queue — the
        newest records are dropped FOR THAT CLIENT ONLY and counted in
        ``kao_stream_dropped_total``; the solve path never blocks.
        Blank lines are heartbeats; readers skip them."""
        from urllib.parse import parse_qs, urlparse

        qs = parse_qs(urlparse(self.path).query)

        def _qint(name: str, default: int) -> int:
            try:
                return int((qs.get(name) or [default])[0])
            except (TypeError, ValueError):
                return default

        follow = (qs.get("follow") or ["1"])[0] not in ("0", "false")
        kind = (qs.get("kind") or [None])[0]
        tail = _qint("tail", 0 if follow else FLEET["tail"])
        client = None
        if follow:
            try:
                client = _oflight.subscribe()
            except RuntimeError as e:
                err = _shed("stream_clients", str(e), retry_after_s=5.0)
                self._send(err.status,
                           {"error": str(err), **err.body_extra},
                           headers={"Retry-After": "5"})
                return
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            max_seq = 0
            for rec in (_oflight.recent(tail) if tail > 0 else []):
                if kind is not None and rec.get("kind") != kind:
                    continue
                seq = rec.get("seq")
                if isinstance(seq, int):
                    max_seq = max(max_seq, seq)
                self.wfile.write(json.dumps(
                    rec, separators=(",", ":"), default=str,
                ).encode() + b"\n")
            self.wfile.flush()
            if not follow:
                return
            while True:
                rec = client.get(timeout=10.0)
                if rec is None:
                    # heartbeat: detects a dead socket within ~10 s
                    # and keeps LB idle timeouts at bay
                    self.wfile.write(b"\n")
                else:
                    seq = rec.get("seq")
                    if isinstance(seq, int) and seq <= max_seq:
                        continue  # the tail replay already sent it
                    if kind is not None and rec.get("kind") != kind:
                        continue
                    self.wfile.write(json.dumps(
                        rec, separators=(",", ":"), default=str,
                    ).encode() + b"\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # client went away: normal stream teardown
        finally:
            if client is not None:
                _oflight.unsubscribe(client)

    def do_POST(self):
        route = self._route()
        cluster_id = None
        rollout_cmd = None
        if route.startswith("/clusters/"):
            rest = route[len("/clusters/"):]
            if rest.endswith("/events"):
                cluster_id = rest[: -len("/events")]
            else:
                for cmd in ("start", "advance", "pause", "rollback"):
                    suffix = "/rollout/" + cmd
                    if rest.endswith(suffix):
                        cluster_id = rest[: -len(suffix)]
                        rollout_cmd = cmd
                        break
        if route not in ("/submit", "/evaluate", "/warmup") \
                and cluster_id is None:
            _count(errors_total=1)
            self._send(404, {"error": f"no such endpoint: {self.path}"})
            return
        _count(requests_total=1)
        # chaos slow_client (docs/RESILIENCE.md): a slow client holding
        # a handler thread — fires before the body read, exactly where
        # a real trickling upload would stall
        _chaos.sleep_if("slow_client")
        try:
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError as e:
                raise ApiError(400, f"bad Content-Length header: {e}") from e
            if n > MAX_BODY_BYTES:
                raise ApiError(413, "request body too large")
            if n < 0:
                raise ApiError(400, "negative Content-Length")
            raw = self.rfile.read(n)
            try:
                payload = json.loads(raw)
            except json.JSONDecodeError as e:
                raise ApiError(400, f"invalid JSON: {e}") from e
            lock_wait_s = getattr(self.server, "lock_wait_s",
                                  DEFAULT_LOCK_WAIT_S)
            max_solve_s = getattr(self.server, "max_solve_s",
                                  DEFAULT_MAX_SOLVE_S)
            if route == "/evaluate":
                self._send(200, handle_evaluate(
                    payload, lock_wait_s=lock_wait_s,
                    max_solve_s=max_solve_s,
                ))
                return
            if route == "/warmup":
                self._send(200, handle_warmup(
                    payload, lock_wait_s=lock_wait_s,
                    max_solve_s=max_solve_s,
                ))
                return
            if rollout_cmd is not None:
                self._send(200, handle_rollout_command(
                    cluster_id, rollout_cmd, payload,
                    lock_wait_s=lock_wait_s,
                ))
                return
            if cluster_id is not None:
                status, body = handle_cluster_event(
                    cluster_id, payload, lock_wait_s=lock_wait_s,
                    max_solve_s=max_solve_s,
                )
                self._send(status, body)
                return
            # cross-process causal tracing (docs/OBSERVABILITY.md
            # "Distributed traces"): a valid W3C traceparent header
            # makes this solve ADOPT the propagated trace ID (the
            # kao-router join); malformed headers are tolerated as a
            # fresh root. The accepted context is echoed back.
            tp_ctx = _otrace.extract(
                self.headers.get(_otrace.TRACEPARENT))
            out = handle_submit(
                payload, lock_wait_s=lock_wait_s,
                max_solve_s=max_solve_s, trace_ctx=tp_ctx,
            )
            echo = None
            if tp_ctx is not None and out.get("trace_id"):
                tp = _otrace.inject(out["trace_id"], tp_ctx.span_id)
                if tp:
                    echo = {_otrace.TRACEPARENT: tp}
            self._send(200, out, headers=echo)
        except ApiError as e:
            if e.status != 503:
                _count(errors_total=1)
            headers = None
            if e.retry_after_s is not None:
                # integer seconds per RFC 9110; never advertise 0 (a
                # client retrying immediately defeats the shed)
                import math

                headers = {
                    "Retry-After": str(max(1, math.ceil(e.retry_after_s)))
                }
            self._send(e.status, {"error": str(e), **e.body_extra},
                       headers=headers)
        except Exception as e:  # never leak a traceback as a hung socket
            _count(errors_total=1)
            self._send(500, {"error": f"internal error: {e}"})


def make_server(host: str = "127.0.0.1", port: int = 8787,
                verbose: bool = False,
                lock_wait_s: float = DEFAULT_LOCK_WAIT_S,
                max_solve_s: float | None = DEFAULT_MAX_SOLVE_S,
                device: str | None = None,
                ) -> ThreadingHTTPServer:
    """The service's HTTP server (not yet serving). ``device`` sets the
    solve device of every ``tpu`` solve (``"cuda"``, the default, or
    ``"cpu"``); left None, the current setting (``SERVE["device"]``)
    stands."""
    if device is not None:
        SERVE["device"] = _platform.pin_platform(device)
    srv = ThreadingHTTPServer((host, port), Handler)
    srv.verbose = verbose
    srv.lock_wait_s = lock_wait_s
    srv.max_solve_s = max_solve_s
    return srv


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="kafka_assignment_optimizer_tpu_torch.serve",
        description="Kafka reassignment optimizer HTTP service (POST "
                    "/submit), solving on an NVIDIA GPU",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--verbose", action="store_true", help="access logs")
    ap.add_argument("--device", default="cuda",
                    help="solve device of every tpu solve: cuda (the "
                         "default; startup fails without a card) or cpu")
    ap.add_argument("--lock-wait-s", type=float,
                    default=DEFAULT_LOCK_WAIT_S,
                    help="max seconds a request waits for the solver "
                         "before 503 (saturation shedding)")
    ap.add_argument("--max-solve-s", type=float,
                    default=DEFAULT_MAX_SOLVE_S,
                    help="time limit injected into every solve; clients "
                         "may tighten but not exceed it (0 = uncapped)")
    ap.add_argument("--workers", type=int, default=DEFAULT_WORKERS,
                    help="solve worker threads (overlapping requests run "
                         "concurrently up to this many, sharing the card)")
    ap.add_argument("--queue-depth", type=int,
                    default=DEFAULT_QUEUE_DEPTH,
                    help="bounded solve queue length; requests past it "
                         "shed with 503 after --lock-wait-s")
    ap.add_argument("--batch-window-ms", type=float,
                    default=DEFAULT_BATCH_WINDOW_MS,
                    help="request-coalescing window: same-bucket tpu "
                         "solves arriving while the pool is busy are "
                         "grouped for up to this long, then run as one "
                         "batched lane solve (sparse requests bypass "
                         "the window entirely)")
    ap.add_argument("--max-batch", type=int, default=DEFAULT_MAX_BATCH,
                    help="max lanes per coalesced solve "
                         "(1 disables coalescing)")
    ap.add_argument("--warmup", default=None, metavar="B:P[:R[:K]],...",
                    help="bucket shapes to warm at startup "
                         "(brokers:partitions[:rf[:racks]] comma list); "
                         "runs in the background, early traffic queues "
                         "behind it")
    ap.add_argument("--jit-cache", default=None, metavar="DIR",
                    help="the kernels' build directory (the reference's "
                         "spelling; same as --compile-cache)")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="the kernels' build directory (sets "
                         "KAO_COMPILE_CACHE): workers sharing one "
                         "directory build each kernel library once")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="disable the double-buffered ladder dispatch "
                         "for every solve this service runs; clients may "
                         "still opt a request back in with "
                         "options.pipeline=true")
    ap.add_argument("--no-portfolio", action="store_true",
                    help="disable portfolio lane racing by default; "
                         "clients may still opt a request back in with "
                         "options.portfolio=true")
    ap.add_argument("--megachunk", default=None, metavar="K|auto|off",
                    help="fused ladder megachunks: the default fused "
                         "width of sweep solves. An integer pins K chunks "
                         "a dispatch (one CUDA-graph replay a chunk on "
                         "the card), 'auto' engages the per-bucket "
                         "evidence chooser, 'off'/unset keeps the "
                         "per-chunk ladder. Same as KAO_MEGACHUNK; "
                         "clients may opt a request out with "
                         "options.megachunk=false")
    ap.add_argument("--no-trace", action="store_true",
                    help="disable per-request solve traces (responses "
                         "then carry no trace_id and /debug/solves "
                         "stays empty)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the first "
                         "--profile-solves tpu solves per bucket under "
                         "this directory (kernel-level traces next to "
                         "the span-level solve reports)")
    ap.add_argument("--profile-solves", type=int, default=1,
                    metavar="N",
                    help="profiled solves per bucket with "
                         "--profile-dir (default 1)")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="solve-cost flight recorder: append one compact "
                         "JSONL record per solve/delta/batch-lane under "
                         "this directory (crash-safe, auto-rotated); the "
                         "SLO engine and kao_solve_seconds run off the "
                         "same stream either way. Same as KAO_FLIGHT_DIR")
    ap.add_argument("--slo", default=None, metavar="SPEC",
                    help="per-class SLO objectives, e.g. "
                         "'solve:5:0.99,delta:2:0.995' "
                         "(class:latency_s[:target]). Burn rates on "
                         "/metrics (kao_slo_*), /healthz 'slo', and "
                         "GET /debug/slo")
    ap.add_argument("--fleet-peers", default=None, metavar="URL,URL",
                    help="peer worker base URLs for GET /debug/fleet "
                         "(e.g. 'http://10.0.0.2:8787,"
                         "http://10.0.0.3:8787'): the merged "
                         "fleet-wide flight/SLO/drift view. Peers are "
                         "operator-named only; clients cannot point "
                         "the server at URLs")
    ap.add_argument("--sample-devices", type=float, default=None,
                    metavar="HZ",
                    help="device-occupancy sampler (obs.sampler; same "
                         "as KAO_SAMPLE_DEVICES): read the card's memory "
                         "and the dispatch-accumulator duty cycle at "
                         "this rate into kao_device_hbm_bytes/"
                         "kao_device_duty_cycle and the /healthz "
                         "per-bucket roofline summary. Off by default")
    ap.add_argument("--queue-wait-s", type=float,
                    default=DEFAULT_QUEUE_WAIT_S,
                    help="maintenance drain window: how long the "
                         "periodic maintenance pass waits for in-flight "
                         "solves; echoed in queue-full 503 bodies")
    ap.add_argument("--default-deadline-s", type=float, default=None,
                    metavar="S",
                    help="per-request end-to-end deadline applied when "
                         "the request carries no 'deadline_s' field; the "
                         "solve runs on the time REMAINING after "
                         "validation and queueing")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="crash-safe auto-resume: persist per-cluster "
                         "solve checkpoints (keyed by instance "
                         "fingerprint) under this directory")
    ap.add_argument("--checkpoint-max-files", type=int, default=512,
                    metavar="N",
                    help="checkpoint-dir hygiene: keep at most this "
                         "many .npz checkpoints (oldest removed on the "
                         "maintenance pass)")
    ap.add_argument("--checkpoint-max-age-s", type=float,
                    default=7 * 24 * 3600.0, metavar="S",
                    help="checkpoint-dir hygiene: remove checkpoints "
                         "older than this on the maintenance pass")
    ap.add_argument("--watch-dir", default=None, metavar="DIR",
                    help="durable per-cluster plan store for the "
                         "cluster-watch delta API: POST "
                         "/clusters/<id>/events remembers each cluster's "
                         "last certified plan + epoch here, surviving "
                         "kill -9 + restart")
    ap.add_argument("--watch-window-ms", type=float,
                    default=_wmanager.DEFAULT_WINDOW_S * 1e3,
                    metavar="MS",
                    help="event-storm coalescing window: one re-solve "
                         "per burst, not per event")
    ap.add_argument("--watch-max-backlog", type=int,
                    default=_wmanager.DEFAULT_MAX_BACKLOG, metavar="N",
                    help="event-storm backpressure: events piling up "
                         "behind one in-flight solve past this count "
                         "shed with 503 reason=event_storm")
    ap.add_argument("--rollout-broker-cap", type=int,
                    default=_rwaves.DEFAULT_BROKER_CAP, metavar="N",
                    help="streaming plan rollout (docs/ROLLOUT.md): "
                         "default per-wave transfer cap per broker, in "
                         "transfer units (replica copies in + out); a "
                         "rollout start may override per rollout")
    ap.add_argument("--rollout-rack-cap", type=int,
                    default=_rwaves.DEFAULT_RACK_CAP, metavar="N",
                    help="default per-wave inbound transfer cap per "
                         "rack")
    ap.add_argument("--rollout-packer", default="greedy",
                    choices=["greedy", "scored"],
                    help="default wave packer: 'greedy' (first-fit-"
                         "decreasing) or 'scored' (races diverse move "
                         "orderings and keeps the packing minimizing "
                         "makespan x peak cross-rack traffic; same as "
                         "KAO_ROLLOUT_PACKER)")
    ap.add_argument("--rollout-lanes", type=int,
                    default=_rwaves.DEFAULT_LANES, metavar="N",
                    help="orderings the scored packer races (>= 1)")
    ap.add_argument("--breaker-threshold", type=int, default=3,
                    metavar="N",
                    help="consecutive solver failures on one bucket "
                         "key before its circuit opens")
    ap.add_argument("--breaker-cooldown-s", type=float, default=30.0,
                    metavar="S",
                    help="initial circuit-open cooldown; escalates "
                         "exponentially (jittered) on repeated trips")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="arm the fault-injection harness (same as "
                         "KAO_CHAOS), e.g. 'nan_chunk'. NEVER in "
                         "production: kao_chaos_armed on /metrics "
                         "exposes it")
    ap.add_argument("--sanitize", action="store_true",
                    help="runtime sanitizer mode (same as "
                         "KAO_SANITIZE=1): the ladder's NaN guard, the "
                         "consumed-state guard and the rebuild sentinel; "
                         "trips are counted on /metrics "
                         "(kao_sanitizer_*) and fail the offending solve")
    return ap


def main(argv: list[str] | None = None) -> int:
    import os

    ap = build_parser()
    args = ap.parse_args(argv)
    if args.lock_wait_s < 0:
        ap.error("--lock-wait-s must be >= 0")
    if args.max_solve_s < 0:
        ap.error("--max-solve-s must be >= 0 (0 = uncapped)")
    if args.workers < 1:
        ap.error("--workers must be >= 1")
    if args.queue_depth < 1:
        ap.error("--queue-depth must be >= 1")
    if args.batch_window_ms < 0:
        ap.error("--batch-window-ms must be >= 0")
    if args.max_batch < 1:
        ap.error("--max-batch must be >= 1")
    if args.queue_wait_s < 0:
        ap.error("--queue-wait-s must be >= 0")
    if args.default_deadline_s is not None and args.default_deadline_s <= 0:
        ap.error("--default-deadline-s must be > 0")
    if args.breaker_threshold < 1:
        ap.error("--breaker-threshold must be >= 1")
    if args.breaker_cooldown_s <= 0:
        ap.error("--breaker-cooldown-s must be > 0")
    if args.profile_solves < 0:
        ap.error("--profile-solves must be >= 0")
    warmup_shapes = None
    if args.warmup:
        try:
            warmup_shapes = parse_warmup_flag(args.warmup)
        except ValueError as e:
            ap.error(str(e))
    if args.megachunk is not None:
        from .solvers.tpu.engine import set_megachunk_default

        try:
            set_megachunk_default(args.megachunk)
        except ValueError:
            ap.error(f"--megachunk {args.megachunk!r}: expected an "
                     "integer width, 'auto', or 'off'")
    try:
        # the card unless --device cpu; no card and no --device cpu
        # stops the service here, never a silent CPU service
        SERVE["device"] = _platform.pin_platform(args.device)
    except (RuntimeError, ValueError) as e:
        ap.error(f"--device {args.device!r}: {e}")
    cache_dir = args.compile_cache or args.jit_cache
    if cache_dir:
        try:
            _platform.set_compile_cache(cache_dir)
        except OSError as e:
            ap.error(f"--compile-cache {cache_dir!r}: {e}")
    if args.sanitize:
        _sanitize_mod.enable()
    if args.no_pipeline:
        from .solvers.tpu.engine import set_pipeline_default

        set_pipeline_default(False)
    if args.no_portfolio:
        from .solvers.tpu.engine import set_portfolio_default

        set_portfolio_default(False)
    OBS["trace"] = not args.no_trace
    OBS["profile_dir"] = args.profile_dir
    OBS["profile_solves"] = args.profile_solves
    flight_dir = (args.flight_dir or os.environ.get("KAO_FLIGHT_DIR")
                  or None)
    if flight_dir:
        # fail fast at boot: an unwritable flight dir must be a clean
        # startup error, not a per-solve warn loop
        try:
            _oflight.configure(flight_dir)
        except OSError as e:
            ap.error(f"--flight-dir {flight_dir!r}: {e}")
    OBS["flight_dir"] = flight_dir
    slo_spec = args.slo or os.environ.get("KAO_SLO")
    if slo_spec:
        try:
            _oslo.ENGINE.configure(spec=slo_spec)
        except ValueError as e:
            ap.error(f"--slo/KAO_SLO: {e}")
    if args.fleet_peers:
        peers = [p.strip().rstrip("/")
                 for p in args.fleet_peers.split(",") if p.strip()]
        bad = [p for p in peers
               if not p.startswith(("http://", "https://"))]
        if bad:
            ap.error(f"--fleet-peers URLs must be http(s)://: {bad}")
        FLEET["peers"] = peers
    sample_hz = args.sample_devices
    if sample_hz is None and os.environ.get("KAO_SAMPLE_DEVICES"):
        try:
            sample_hz = float(os.environ["KAO_SAMPLE_DEVICES"])
        except ValueError:
            ap.error("KAO_SAMPLE_DEVICES must be a number (Hz)")
    if sample_hz is not None and sample_hz < 0:
        ap.error("--sample-devices must be >= 0 (0 = off)")
    if sample_hz:
        _osampler.SAMPLER.configure(sample_hz)
    _SOLVES.configure(workers=args.workers, depth=args.queue_depth,
                      queue_wait_s=args.queue_wait_s)
    _COALESCER.configure(window_ms=args.batch_window_ms,
                         max_batch=args.max_batch)
    RESILIENCE["default_deadline_s"] = args.default_deadline_s
    if args.checkpoint_max_files < 1:
        ap.error("--checkpoint-max-files must be >= 1")
    if args.checkpoint_max_age_s <= 0:
        ap.error("--checkpoint-max-age-s must be > 0")
    if args.watch_window_ms < 0:
        ap.error("--watch-window-ms must be >= 0")
    if args.watch_max_backlog < 1:
        ap.error("--watch-max-backlog must be >= 1")
    RESILIENCE["checkpoint_max_files"] = args.checkpoint_max_files
    RESILIENCE["checkpoint_max_age_s"] = args.checkpoint_max_age_s
    if args.checkpoint_dir:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        RESILIENCE["checkpoint_dir"] = args.checkpoint_dir
    if args.watch_dir:
        # fail fast at boot: an unwritable plan-store dir must be a
        # clean startup error, never a liveness-probe traceback
        try:
            os.makedirs(args.watch_dir, exist_ok=True)
        except OSError as e:
            ap.error(f"--watch-dir {args.watch_dir!r}: {e}")
    WATCH["dir"] = args.watch_dir
    WATCH["window_s"] = args.watch_window_ms / 1e3
    WATCH["max_backlog"] = args.watch_max_backlog
    WATCH["lock_wait_s"] = args.lock_wait_s
    WATCH["max_solve_s"] = args.max_solve_s or None
    WATCH["registry"] = None  # rebuilt lazily with this config
    if args.rollout_broker_cap < 1:
        ap.error("--rollout-broker-cap must be >= 1")
    if args.rollout_rack_cap < 1:
        ap.error("--rollout-rack-cap must be >= 1")
    if args.rollout_lanes < 1:
        ap.error("--rollout-lanes must be >= 1")
    ROLLOUT["broker_cap"] = args.rollout_broker_cap
    ROLLOUT["rack_cap"] = args.rollout_rack_cap
    ROLLOUT["packer"] = args.rollout_packer
    ROLLOUT["lanes"] = args.rollout_lanes
    ROLLOUT["manager"] = None  # rebuilt lazily over the new registry
    _BREAKER.configure(threshold=args.breaker_threshold,
                       cooldown_s=args.breaker_cooldown_s)
    if args.chaos:
        try:
            _chaos.arm(args.chaos)
        except ValueError as e:
            ap.error(str(e))
        _olog.warn("chaos_armed", spec=args.chaos)
    srv = make_server(
        args.host, args.port, verbose=args.verbose,
        lock_wait_s=args.lock_wait_s,
        max_solve_s=args.max_solve_s or None,
    )
    # stamp the bound port into this worker's flight-record identity
    _oflight.set_worker_port(srv.server_address[1])
    if warmup_shapes:
        start_warmup_thread(
            warmup_shapes, max_solve_s=args.max_solve_s or None
        )
    _olog.log("listening", host=args.host, port=srv.server_address[1],
              workers=args.workers, trace_enabled=OBS["trace"],
              device=SERVE["device"])
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
