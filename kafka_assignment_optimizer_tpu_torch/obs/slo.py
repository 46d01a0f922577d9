"""Sliding-window SLO engine over the flight-record stream
(docs/OBSERVABILITY.md).

Each record class (``solve`` — /submit and CLI solves, ``delta`` —
cluster-watch events, ``lane`` — coalesced batch lanes) carries a
configurable objective: a latency bound and a success target. An
observation breaches **latency** when ``wall_s`` exceeds the bound,
and **quality** when the plan is infeasible or a sanitizer/degraded
terminal state made it untrustworthy. Burn rate is the standard SRE
ratio::

    burn = breach_fraction_in_window / (1 - target)

computed over MULTIPLE windows (default 5 m and 1 h): burn > 1 on the
short window alone is a blip; > 1 on BOTH is a fast burn — the page
condition (`status: "fast_burn"`). Surfaces:

- ``kao_slo_*`` families on ``/metrics`` (events/breach counters per
  class, burn-rate + objective gauges per class x window);
- the ``/healthz`` ``slo`` section (worst status across classes);
- ``GET /debug/slo`` — the full snapshot, including the worst recent
  observation per class with its trace ID (the exemplar that links a
  burn straight to ``GET /debug/solves/<id>``).

Window semantics (pinned by the boundary unit test): an observation at
age exactly ``window`` is OUT — membership is ``now - ts < window``.
``observe``/``snapshot`` accept an explicit ``now`` so tests replay a
synthetic flight log deterministically.

Configuration grammar (``--slo`` / ``KAO_SLO``)::

    class:latency_s[:target][,class:latency_s[:target]...]
    e.g. "solve:5:0.99,delta:2:0.995,lane:5:0.99"

Unknown classes are allowed (a future record kind gets an objective
before the code ships); malformed specs fail loudly at parse time.
"""

from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["SLOEngine", "ENGINE", "parse_spec", "DEFAULT_OBJECTIVES",
           "WINDOWS"]

# (seconds, label) — short to long; the LAST window bounds retention
WINDOWS = ((300.0, "5m"), (3600.0, "1h"))

DEFAULT_OBJECTIVES = {
    # /submit + CLI solves: the north-star budget (BASELINE.json)
    "solve": {"latency_s": 5.0, "target": 0.99},
    # watch deltas are warm-started and often warm-certify: tighter
    "delta": {"latency_s": 2.0, "target": 0.99},
    # coalesced batch lanes share one dispatch; same budget as solve
    "lane": {"latency_s": 5.0, "target": 0.99},
}

_MAX_EVENTS = 100_000  # hard cap on retained observations


def parse_spec(spec: str) -> dict[str, dict]:
    """``"solve:5:0.99,delta:2"`` -> objectives dict; raises ValueError
    on any malformed entry (a typo'd SLO silently defaulting would be
    an unwatched objective)."""
    out: dict[str, dict] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if not 2 <= len(fields) <= 3:
            raise ValueError(
                f"bad SLO entry {part!r}; want class:latency_s[:target]"
            )
        cls = fields[0].strip()
        if not cls.isidentifier():
            raise ValueError(f"bad SLO class name {fields[0]!r}")
        try:
            latency = float(fields[1])
            target = float(fields[2]) if len(fields) == 3 else 0.99
        except ValueError as e:
            raise ValueError(f"bad SLO numbers in {part!r}: {e}") from e
        if not latency > 0:
            raise ValueError(f"SLO latency must be > 0 in {part!r}")
        if not 0.0 < target < 1.0:
            raise ValueError(
                f"SLO target must be in (0, 1) in {part!r}"
            )
        out[cls] = {"latency_s": latency, "target": target}
    if not out:
        raise ValueError(f"empty SLO spec {spec!r}")
    return out


def _quality_ok(rec: dict) -> bool:
    q = rec.get("quality") or {}
    return bool(q.get("feasible")) and not q.get("degraded")


class SLOEngine:
    """Multi-window burn-rate accounting over flight records."""

    def __init__(self, objectives: dict | None = None,
                 windows=WINDOWS):
        self._lock = threading.Lock()
        self.windows = tuple(windows)
        self.objectives = {
            k: dict(v)
            for k, v in (objectives or DEFAULT_OBJECTIVES).items()
        }
        # (ts, class, latency_s, lat_ok, qual_ok)
        self._events: deque = deque()
        # monotonic counters (rendered as kao_slo_*_total)
        self.events_total: dict[str, int] = {}
        self.latency_breaches_total: dict[str, int] = {}
        self.quality_breaches_total: dict[str, int] = {}
        # class -> (latency_s, trace_id, ts): worst recent observation
        self._worst: dict[str, tuple] = {}

    def configure(self, spec: str | None = None,
                  objectives: dict | None = None) -> None:
        obj = parse_spec(spec) if spec else (objectives or {})
        with self._lock:
            for cls, o in obj.items():
                self.objectives[cls] = dict(o)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self.events_total.clear()
            self.latency_breaches_total.clear()
            self.quality_breaches_total.clear()
            self._worst.clear()

    def _objective(self, cls: str) -> dict:
        return self.objectives.get(cls) or self.objectives.get(
            "solve", {"latency_s": 5.0, "target": 0.99}
        )

    def observe(self, cls: str, latency_s: float, quality_ok: bool,
                trace_id: str | None = None,
                now: float | None = None) -> None:
        now = time.time() if now is None else float(now)
        obj = self._objective(cls)
        lat_ok = latency_s <= obj["latency_s"]
        with self._lock:
            self._events.append(
                (now, cls, float(latency_s), lat_ok, bool(quality_ok))
            )
            self.events_total[cls] = self.events_total.get(cls, 0) + 1
            if not lat_ok:
                self.latency_breaches_total[cls] = (
                    self.latency_breaches_total.get(cls, 0) + 1
                )
            if not quality_ok:
                self.quality_breaches_total[cls] = (
                    self.quality_breaches_total.get(cls, 0) + 1
                )
            worst = self._worst.get(cls)
            if (worst is None or latency_s >= worst[0]
                    or now - worst[2] > self.windows[-1][0]):
                self._worst[cls] = (float(latency_s), trace_id, now)
            self._prune(now)

    def observe_record(self, rec: dict) -> None:
        """The flight-recorder feed: one record in, one observation."""
        self.observe(
            rec.get("kind") or "solve",
            float(rec.get("wall_s") or 0.0),
            _quality_ok(rec),
            trace_id=rec.get("trace_id"),
            now=rec.get("ts"),
        )

    def _prune(self, now: float) -> None:
        horizon = now - self.windows[-1][0]
        ev = self._events
        while ev and (ev[0][0] <= horizon or len(ev) > _MAX_EVENTS):
            ev.popleft()

    def snapshot(self, now: float | None = None) -> dict:
        """Per class: objective, cumulative totals, per-window counts,
        breach fractions, burn rates, and the page-logic status."""
        now = time.time() if now is None else float(now)
        with self._lock:
            events = list(self._events)
            totals = dict(self.events_total)
            lat_tot = dict(self.latency_breaches_total)
            qual_tot = dict(self.quality_breaches_total)
            worst = dict(self._worst)
            objectives = {k: dict(v) for k, v in self.objectives.items()}
        classes = sorted(set(totals) | set(objectives))
        # ONE pass over the event deque, accumulating per-(class,
        # window) counts — snapshot() runs on every /metrics scrape
        # and /healthz probe, and a per-(class, window) rescan of a
        # deque near the 100k cap would make monitoring O(N*C*W)
        counts: dict[str, list] = {}
        for ts, cls, _lat, lat_ok, qual_ok in events:
            age = now - ts
            rows = counts.get(cls)
            if rows is None:
                rows = counts[cls] = [
                    [0, 0, 0, 0] for _ in self.windows
                ]
            for wi, (w_s, _label) in enumerate(self.windows):
                if age < w_s:
                    row = rows[wi]
                    row[0] += 1
                    row[1] += not lat_ok
                    row[2] += not qual_ok
                    row[3] += not (lat_ok and qual_ok)
        out: dict = {"windows": [w[1] for w in self.windows],
                     "classes": {}}
        overall = "ok"
        rank = {"ok": 0, "burn": 1, "fast_burn": 2}
        for cls in classes:
            obj = objectives.get(cls) or self._objective(cls)
            budget = 1.0 - obj["target"]
            wins = {}
            burns = []
            cls_rows = counts.get(cls) or [
                [0, 0, 0, 0] for _ in self.windows
            ]
            for wi, (w_s, label) in enumerate(self.windows):
                n, lat_b, qual_b, bad = cls_rows[wi]
                frac = (bad / n) if n else 0.0
                burn = (frac / budget) if budget > 0 else 0.0
                burns.append(burn if n else 0.0)
                wins[label] = {
                    "events": n,
                    "latency_breaches": lat_b,
                    "quality_breaches": qual_b,
                    "breach_fraction": round(frac, 6),
                    "burn_rate": round(burn, 4),
                }
            if burns and all(b > 1.0 for b in burns):
                status = "fast_burn"
            elif burns and burns[0] > 1.0:
                status = "burn"
            else:
                status = "ok"
            if rank[status] > rank[overall]:
                overall = status
            w = worst.get(cls)
            if w is not None and now - w[2] > self.windows[-1][0]:
                # same read-time staleness rule as the histogram
                # exemplars: a quiet class must not keep advertising a
                # trace the report ring evicted long ago
                w = None
            out["classes"][cls] = {
                "objective": obj,
                "events_total": totals.get(cls, 0),
                "latency_breaches_total": lat_tot.get(cls, 0),
                "quality_breaches_total": qual_tot.get(cls, 0),
                "windows": wins,
                "status": status,
                **({"worst_recent": {
                    "latency_s": round(w[0], 4),
                    "trace_id": w[1],
                    "age_s": round(now - w[2], 1),
                }} if w else {}),
            }
        out["status"] = overall
        return out


ENGINE = SLOEngine()
