"""Drift alarms over the flight-record stream (docs/OBSERVABILITY.md
"Fleet plane").

``bench.py --compare`` catches build-over-build regressions at the
endpoints of a run; nothing so far catches a run getting slower (or
stopping certifying) MID-WAY — a compile-cache eviction storm, a
noisy neighbor, thermal throttling, a leaking executable cache. This
module watches two rolling signals per record class and raises an
alarm when either drifts from its learned baseline:

- ``p99`` — the rolling p99 of ``wall_s`` over the last
  ``WINDOW`` records of the class;
- ``certify_rate`` — the rolling certified fraction (fed to the
  detector as the FAILURE fraction, so the drift direction is "up is
  bad" for both signals).

Detector: an EWMA-baselined one-sided Page-Hinkley test. The baseline
is learned as the median of the first ``warmup`` signal values, then
tracked with a slow EWMA (benign drift is absorbed); the PH statistic
accumulates each step's exceedance beyond a tolerance ``delta`` and
alarms when it crosses ``lam`` — a sustained shift trips in a few
observations, a single outlier never does. After an alarm the
detector re-learns its baseline at the new level, so one regression
fires one alarm, not one per record.

Surfaces (all fed by ``obs.flight.record`` — serve, CLI, and
``kao-fleet`` merges share the same monitor class):

- ``kao_drift_alarms_total{class=,signal=}`` + the
  ``kao_drift_ph{class=,signal=}`` statistic gauge on ``/metrics``;
- the ``drift`` section of ``GET /debug/slo`` (and ``/healthz``'s
  ``slo`` block carries the alarm count);
- a zero-duration ``drift`` trace mark on whatever solve's record
  tripped the detector, so ``/debug/solves/<id>`` shows the tripwire
  inline with the phases;
- one ``drift_alarm`` structured log line per trip.
"""

from __future__ import annotations

import threading
from collections import deque

from . import log as _olog
from . import trace as _otrace

__all__ = ["PageHinkley", "DriftMonitor", "MONITOR", "SIGNALS"]

SIGNALS = ("p99", "certify_rate")

# rolling-signal geometry: the window the per-class p99/certify-rate
# is computed over, the stride between detector updates, and how many
# STRIDED signal values seed a baseline. The stride matters: the p99
# of a 32-record window is dominated by its maximum, so a single
# outlier would otherwise feed ~32 consecutive inflated updates into
# the PH sum and trip on noise — strided, it contributes at most
# ceil(WINDOW/STRIDE) updates, which the lam threshold absorbs
# (single-outlier immunity is regression-pinned).
WINDOW = 32
MIN_WINDOW = 8
STRIDE = 8
WARMUP = 4


class PageHinkley:
    """One-sided (upward) Page-Hinkley changepoint detector with an
    EWMA-tracked baseline.

    ``mode="relative"`` normalizes each step's exceedance by the
    baseline (right for latencies, scale-free); ``mode="absolute"``
    uses raw differences (right for rates already in [0, 1]).
    ``update(x)`` returns True exactly when this observation trips an
    alarm."""

    __slots__ = ("delta", "lam", "alpha", "warmup", "mode", "baseline",
                 "ph", "alarms", "_warm", "last_value")

    def __init__(self, *, delta: float, lam: float, mode: str,
                 alpha: float = 0.02, warmup: int = WARMUP):
        if mode not in ("relative", "absolute"):
            raise ValueError(f"bad PageHinkley mode {mode!r}")
        self.delta = float(delta)   # tolerated per-step drift
        self.lam = float(lam)       # cumulative exceedance that alarms
        self.alpha = float(alpha)   # baseline EWMA weight
        self.warmup = int(warmup)
        self.mode = mode
        self.baseline: float | None = None
        self.ph = 0.0
        self.alarms = 0
        self._warm: list[float] = []
        self.last_value: float | None = None

    def update(self, x: float) -> bool:
        x = float(x)
        self.last_value = x
        if self.baseline is None:
            self._warm.append(x)
            if len(self._warm) >= self.warmup:
                w = sorted(self._warm)
                self.baseline = w[len(w) // 2]
                self._warm = []
            return False
        if self.mode == "relative":
            step = x / max(self.baseline, 1e-9) - 1.0
        else:
            step = x - self.baseline
        self.ph = max(0.0, self.ph + step - self.delta)
        # slow EWMA: benign creep moves the baseline instead of the
        # statistic; an abrupt shift outruns alpha and accumulates
        self.baseline += self.alpha * (x - self.baseline)
        if self.ph > self.lam:
            self.alarms += 1
            self.ph = 0.0
            self.baseline = None  # re-learn at the new level
            return True
        return False

    def snapshot(self) -> dict:
        return {
            "baseline": (round(self.baseline, 6)
                         if self.baseline is not None else None),
            "ph": round(self.ph, 4),
            "alarms": self.alarms,
            "last_value": (round(self.last_value, 6)
                           if self.last_value is not None else None),
            "warming": self.baseline is None,
        }


# detector tuning per signal (docs/OBSERVABILITY.md "drift alarm
# tuning"): p99 is relative — a sustained >25% slowdown accumulates
# (a 2x shift trips in ~6 strided updates, a 10x shift on the first),
# while one 2x outlier tops out at ceil(32/8) x 0.75 = 3.0 < lam and
# never trips; the certify failure rate is absolute — a sustained
# >0.10 drop accumulates, one flaky lane in a window never trips
_SIGNAL_PARAMS = {
    "p99": {"mode": "relative", "delta": 0.25, "lam": 4.0},
    "certify_rate": {"mode": "absolute", "delta": 0.10, "lam": 0.5},
}


class DriftMonitor:
    """Per-(class, signal) drift detection over a record stream."""

    def __init__(self, window: int = WINDOW,
                 min_window: int = MIN_WINDOW, stride: int = STRIDE,
                 warmup: int = WARMUP, quiet: bool = False):
        self._lock = threading.Lock()
        self.window = int(window)
        self.min_window = int(min_window)
        self.stride = max(int(stride), 1)
        self.warmup = int(warmup)
        # quiet: no trace marks, no warn logs — for AGGREGATE replays
        # of historical records (obs.fleet builds a fresh monitor per
        # merge; a dashboard polling /debug/fleet must not re-announce
        # a long-resolved alarm on every poll). Counters and snapshots
        # are unaffected.
        self.quiet = bool(quiet)
        self._wall: dict[str, deque] = {}
        self._cert: dict[str, deque] = {}
        self._count: dict[str, int] = {}
        self._det: dict[tuple, PageHinkley] = {}
        # (class, signal) -> info dict of the most recent alarm
        self.last_alarms: dict[tuple, dict] = {}

    def reset(self) -> None:
        with self._lock:
            self._wall.clear()
            self._cert.clear()
            self._count.clear()
            self._det.clear()
            self.last_alarms.clear()

    def _detector(self, cls: str, signal: str) -> PageHinkley:
        det = self._det.get((cls, signal))
        if det is None:
            det = self._det[(cls, signal)] = PageHinkley(
                warmup=self.warmup, **_SIGNAL_PARAMS[signal]
            )
        return det

    def observe_record(self, rec: dict) -> list[str]:
        """Feed one flight record; returns the signals (if any) that
        tripped, after landing the mark/log side effects. Never raises
        into the solve path (the caller wraps)."""
        cls = rec.get("kind") or "solve"
        wall = float(rec.get("wall_s") or 0.0)
        q = rec.get("quality") or {}
        certified = bool(q.get("certified"))
        tripped: list[str] = []
        with self._lock:
            wq = self._wall.setdefault(cls, deque(maxlen=self.window))
            cq = self._cert.setdefault(cls, deque(maxlen=self.window))
            wq.append(wall)
            cq.append(certified)
            n = self._count[cls] = self._count.get(cls, 0) + 1
            if len(wq) >= self.min_window and n % self.stride == 0:
                xs = sorted(wq)
                p99 = xs[min(len(xs) - 1, int(0.99 * len(xs)))]
                if self._detector(cls, "p99").update(p99):
                    tripped.append("p99")
                fail = 1.0 - sum(cq) / len(cq)
                if self._detector(cls, "certify_rate").update(fail):
                    tripped.append("certify_rate")
            for sig in tripped:
                det = self._det[(cls, sig)]
                self.last_alarms[(cls, sig)] = {
                    "ts": rec.get("ts"),
                    "trace_id": rec.get("trace_id"),
                    "value": det.last_value,
                    "alarms": det.alarms,
                }
        if not self.quiet:
            for sig in tripped:
                # zero-duration trace mark: if this record landed
                # inside a live request trace, the tripwire shows up
                # inline in /debug/solves/<id>; a no-op otherwise
                _otrace.mark("drift", signal=sig, record_class=cls)
                _olog.warn("drift_alarm", record_class=cls, signal=sig,
                           value=self._det[(cls, sig)].last_value,
                           trace_id=rec.get("trace_id"))
        return tripped

    def snapshot(self) -> dict:
        """The ``/debug/slo`` ``drift`` section: per class x signal —
        baseline, current PH statistic, alarm count, last alarm."""
        with self._lock:
            classes: dict[str, dict] = {}
            total = 0
            for (cls, sig), det in self._det.items():
                row = det.snapshot()
                last = self.last_alarms.get((cls, sig))
                if last is not None:
                    row["last_alarm"] = dict(last)
                classes.setdefault(cls, {})[sig] = row
                total += det.alarms
            return {
                "signals": list(SIGNALS),
                "window": self.window,
                "alarms_total": total,
                "classes": classes,
            }

    def metric_rows(self) -> list[tuple[str, str, int, float]]:
        """(class, signal, alarms_total, ph) rows for the kao_drift_*
        exposition families (serve and kao-fleet render the same
        rows)."""
        with self._lock:
            return [
                (cls, sig, det.alarms, round(det.ph, 4))
                for (cls, sig), det in sorted(self._det.items())
            ]


def render_families(rows, stream_desc: str = "the flight stream"
                    ) -> list[str]:
    """The ``kao_drift_*`` exposition lines from :meth:`metric_rows`
    — the ONE renderer serve's ``/metrics`` and ``kao-fleet --format
    metrics`` both use, so the family names/shapes/HELP cannot drift
    between the per-worker and fleet-wide views."""
    lines = [
        f"# HELP kao_drift_alarms_total drift alarms over "
        f"{stream_desc}, by class and signal",
        "# TYPE kao_drift_alarms_total counter",
    ]
    for cls, sig, alarms, _ph in rows:
        lines.append(
            f'kao_drift_alarms_total{{class="{cls}",signal="{sig}"}} '
            f"{alarms}"
        )
    lines.append("# HELP kao_drift_ph current Page-Hinkley drift "
                 "statistic by class and signal")
    lines.append("# TYPE kao_drift_ph gauge")
    for cls, sig, _alarms, ph in rows:
        lines.append(
            f'kao_drift_ph{{class="{cls}",signal="{sig}"}} {ph}'
        )
    return lines


MONITOR = DriftMonitor()
