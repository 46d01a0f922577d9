"""Device-occupancy sampler: a copy of the reference package's
``obs.sampler`` reading the card through PyTorch.

A single low-overhead daemon thread (default OFF; ``--sample-devices
HZ`` on serve, ``KAO_SAMPLE_DEVICES`` anywhere) periodically reads

- **the card's memory** (``torch.cuda.memory_allocated`` /
  ``memory_reserved`` / ``mem_get_info`` of every device) into
  per-device gauges (``kao_device_hbm_bytes{device=...}``: bytes
  allocated by tensors), and
- the **dispatch-accumulator duty cycle**: the flight recorder
  accumulates every completed solve's ``device_s`` + ``dispatch_s``
  (``obs.flight.duty_totals``); the sampler differences that between
  ticks and divides by wall time (``kao_device_duty_cycle``;
  EWMA-smoothed, so a 60 s solve landing its record all at once reads
  as sustained occupancy, not a spike). ``dispatch_s`` is host time
  enqueueing the ladder, so where the host paces the card the duty
  cycle counts the enqueue, not the card's busy time (a profiler's
  idle share measures that),

plus a **rolling per-bucket roofline summary** from the recent flight
records (device fraction of wall per bucket, n solves) surfaced in
``/healthz``'s ``devices`` section.

Overhead contract: each tick is a handful of dict reads plus the
memory queries — microseconds to fractions of a millisecond of CPU.
The sampler self-accounts in THREAD CPU time (``sample_seconds_total``
/ ``overhead_frac``; wall-clock would count GIL waits under a busy
solve, which cost the solve nothing) and the test suite pins the
per-tick budget. Arming the sampler never imports the solve stack and
never initializes CUDA: device reads wait until ``torch`` is already
in ``sys.modules`` and a solve has initialized CUDA; on the CPU it
reads no device. The first read is excluded from the steady-state
overhead accounting. ``/metrics`` scrapes read only the cached tick
state either way.
"""

from __future__ import annotations

import sys
import threading
import time

from . import flight as _oflight
from . import log as _olog

__all__ = ["DeviceSampler", "SAMPLER"]

DEFAULT_HZ = 1.0
ROOFLINE_WINDOW_S = 300.0  # recent-records window for the bucket summary
_DUTY_ALPHA = 0.3          # duty-cycle EWMA weight per tick


def _card_totals(torch) -> list[int]:
    """Each card's memory in bytes (``torch.cuda.mem_get_info``: a driver
    call, so read once, on the sampler's first tick)."""
    return [int(torch.cuda.mem_get_info(i)[1])
            for i in range(torch.cuda.device_count())]


def _read_devices(torch, totals: list[int]) -> dict:
    """Memory of every card: ``{"gpu:<i>": {"bytes_in_use",
    "bytes_reserved", "bytes_limit"}}`` (tensor bytes allocated and held
    by the caching allocator, host-side counters; the card's total)."""
    return {
        f"gpu:{i}": {
            "bytes_in_use": int(torch.cuda.memory_allocated(i)),
            "bytes_reserved": int(torch.cuda.memory_reserved(i)),
            "bytes_limit": total,
        }
        for i, total in enumerate(totals)
    }


class DeviceSampler:
    """The process's periodic device-occupancy sampler."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stop: threading.Event | None = None
        self._thread: threading.Thread | None = None
        self.hz = 0.0
        self.samples_total = 0
        self.sample_seconds_total = 0.0
        self._started_monotonic: float | None = None
        self._devices: dict[str, dict] = {}
        self.duty_cycle = 0.0
        self._last_tick: float | None = None
        self._last_duty_s: float | None = None
        self._totals: list[int] | None = None  # the cards' memory

    def enabled(self) -> bool:
        return self._thread is not None

    def configure(self, hz: float | None) -> None:
        """Start the sampler at ``hz`` (<= 0 or None stops it).
        Idempotent; restarts cleanly on a rate change. Each arming
        session starts its accounting fresh — a re-armed sampler's
        ``overhead_frac`` describes THIS session, not a stale one."""
        self.stop()
        if not hz or hz <= 0:
            return
        with self._lock:
            self.hz = float(hz)
            self._stop = threading.Event()
            self._started_monotonic = time.monotonic()
            self.samples_total = 0
            self.sample_seconds_total = 0.0
            self.duty_cycle = 0.0
            self._devices = {}
            self._last_tick = None
            self._last_duty_s = None
            self._thread = threading.Thread(
                target=self._run, args=(self._stop,), daemon=True,
                name="kao-device-sampler",
            )
            self._thread.start()
        _olog.log("device_sampler_started", hz=float(hz))

    def stop(self) -> None:
        with self._lock:
            stop, thread = self._stop, self._thread
            self._stop = None
            self._thread = None
        if stop is not None:
            stop.set()
        if thread is not None:
            thread.join(timeout=2.0)

    def _run(self, stop: threading.Event) -> None:
        period = 1.0 / max(self.hz, 1e-3)
        while not stop.wait(period):
            try:
                self._tick()
            except Exception as e:  # sampling must never crash serving
                _olog.warn("device_sample_failed", error=repr(e)[:200])

    def _tick(self) -> None:
        # self-accounting in THREAD CPU time, not wall: under a busy
        # solve the tick thread spends most of its wall waiting for
        # the GIL, which costs the solve nothing — thread_time is the
        # CPU the sampler actually takes from the box, the number the
        # <1% budget is about
        t0 = time.thread_time()
        now = time.monotonic()
        devices: dict[str, dict] = {}
        # device stats only from an ALREADY-imported torch whose CUDA a
        # solve initialized — arming the sampler never imports the solve
        # stack and never initializes the card
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            try:
                if self._totals is None:
                    # the FIRST read pays one-time setup on this thread
                    # (the cards' totals): excluded from the steady-state
                    # per-tick accounting
                    self._totals = _card_totals(torch)
                    t0 = time.thread_time()
                devices = _read_devices(torch, self._totals)
            except Exception:
                devices = {}
        duty = _oflight.duty_totals()
        busy = duty["device_s"] + duty["dispatch_s"]
        with self._lock:
            self._devices = devices
            if self._last_tick is not None:
                dt = max(now - self._last_tick, 1e-6)
                inst = min((busy - (self._last_duty_s or 0.0)) / dt, 1.0)
                self.duty_cycle += _DUTY_ALPHA * (
                    max(inst, 0.0) - self.duty_cycle
                )
            self._last_tick = now
            self._last_duty_s = busy
            self.samples_total += 1
            self.sample_seconds_total += time.thread_time() - t0

    def _roofline(self) -> dict:
        """Per-bucket device occupancy over the recent record window:
        {bucket: {solves, device_frac, dispatch_frac, wall_s}}."""
        cutoff = time.time() - ROOFLINE_WINDOW_S
        rows: dict[str, dict] = {}
        for rec in _oflight.recent():
            if float(rec.get("ts") or 0.0) < cutoff:
                continue
            bucket = rec.get("bucket")
            key = ("x".join(str(b) for b in bucket)
                   if isinstance(bucket, list) else "unbucketed")
            split = rec.get("split") or {}
            row = rows.setdefault(key, {
                "solves": 0, "wall_s": 0.0,
                "_device_s": 0.0, "_dispatch_s": 0.0,
            })
            row["solves"] += 1
            row["wall_s"] += float(rec.get("wall_s") or 0.0)
            row["_device_s"] += float(split.get("device_s") or 0.0)
            row["_dispatch_s"] += float(split.get("dispatch_s") or 0.0)
        out = {}
        for key, row in sorted(rows.items()):
            wall = max(row["wall_s"], 1e-9)
            out[key] = {
                "solves": row["solves"],
                "wall_s": round(row["wall_s"], 3),
                "device_frac": round(row["_device_s"] / wall, 4),
                "dispatch_frac": round(row["_dispatch_s"] / wall, 4),
            }
        return out

    def stats(self) -> dict:
        """The /metrics gauge source: cached tick scalars + the
        per-device map, nothing else — a scrape must stay O(devices),
        not rebuild the per-bucket roofline summary each poll (that
        lives in :meth:`snapshot`, the /healthz payload)."""
        with self._lock:
            enabled = self._thread is not None
            elapsed = (
                time.monotonic() - self._started_monotonic
                if enabled and self._started_monotonic is not None
                else 0.0
            )
            return {
                "enabled": int(enabled),
                "samples_total": self.samples_total,
                "overhead_frac": round(
                    self.sample_seconds_total / elapsed, 6
                ) if elapsed > 0 else 0.0,
                "duty_cycle": round(self.duty_cycle, 4),
                "devices": {k: dict(v)
                            for k, v in self._devices.items()},
            }

    def snapshot(self) -> dict:
        """The ``/healthz`` ``devices`` section: the full view incl.
        the rolling per-bucket roofline summary. Never touches the card
        (reads cached tick state + the record ring)."""
        with self._lock:
            enabled = self._thread is not None
            elapsed = (
                time.monotonic() - self._started_monotonic
                if enabled and self._started_monotonic is not None
                else 0.0
            )
            avg = (self.sample_seconds_total / self.samples_total
                   if self.samples_total else 0.0)
            out = {
                "enabled": int(enabled),
                "hz": self.hz if enabled else 0.0,
                "samples_total": self.samples_total,
                "sample_seconds_total": round(
                    self.sample_seconds_total, 6),
                "avg_sample_s": round(avg, 6),
                "overhead_frac": round(
                    self.sample_seconds_total / elapsed, 6
                ) if elapsed > 0 else 0.0,
                "duty_cycle": round(self.duty_cycle, 4),
                "devices": {k: dict(v) for k, v in self._devices.items()},
            }
        out["duty_totals"] = _oflight.duty_totals()
        out["roofline"] = self._roofline() if enabled else {}
        return out


SAMPLER = DeviceSampler()
