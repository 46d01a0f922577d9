"""Fleet telemetry plane: merge many workers' flight streams into one
ordered view (docs/OBSERVABILITY.md "Fleet plane").

A pod-scale serving fleet is N processes each landing its own flight
records (``obs.flight``) — N rings, N SLO engines, N JSONL dirs. This
module is the aggregation layer, built BEFORE the multi-host mesh
exists so every fleet PR lands with its denominator instrumented
(aggregation as first-class map/reduce over
distributed leaves, PAPERS.md):

- **merge**: N workers' flight JSONL dirs (or live ``/debug/stream``
  snapshots) into one ordered stream. Clock-skew tolerant: WITHIN a
  worker, records are ordered by their per-worker monotonic ``seq``
  (that worker's clock cannot reorder them); ACROSS workers a k-way
  merge orders by timestamp. Duplicates — a record read from both an
  archive and a live snapshot — dedup on ``(worker, seq)``. Torn
  kill-9 tails and mid-merge rotation are absorbed by the reader
  (``obs.flight.iter_records``); records without worker/seq stamps
  are legacy and collapse to one pseudo-worker in file order.
- **fleet SLO**: the burn-rate engine re-run over the merged
  stream — the SAME ``kao_slo_*`` families a single worker exposes,
  now fleet-wide — plus ``kao_fleet_workers`` /
  ``kao_fleet_lag_seconds{worker=}``.
- **fleet drift**: the ``obs.drift`` monitor over the merged stream
  (``kao_drift_*``), so a fleet-wide mid-run slowdown trips even if
  no single worker's share crossed its own threshold.

Surfaces: the ``kao-fleet`` console script (offline dirs or live
peers) and ``GET /debug/fleet`` on any worker pointed at peer URLs
(``--fleet-peers``) — the bucket-affinity router's future data source.
"""

from __future__ import annotations

import argparse
import heapq
import json
import os
import sys
import time
import urllib.request

from . import drift as _odrift
from . import flight as _oflight
from . import slo as _oslo

__all__ = ["merge_sources", "build_view", "fetch_records",
           "render_fleet_metrics", "main"]

DEFAULT_TAIL = 512
DEFAULT_TIMEOUT_S = 5.0


# --------------------------------------------------------------------------
# merge
# --------------------------------------------------------------------------


def _rec_ts(rec: dict) -> float:
    try:
        return float(rec.get("ts") or 0.0)
    except (TypeError, ValueError):
        return 0.0


def merge_sources(sources) -> tuple[list, dict, int]:
    """``sources``: iterable of ``(label, iterable_of_records)``.
    Returns ``(records, per_worker, duplicates_dropped)``.

    Per worker: stamped records sort by ``seq`` (skew inside a worker
    cannot reorder its own stream) and dedup on ``(worker, seq)``;
    legacy records (no stamp) keep arrival order and never dedup.
    Across workers: a k-way heap merge on ``ts`` — it only ever pops
    stream heads, so per-worker seq order survives even when worker
    clocks disagree."""
    per: dict[str, list] = {}
    seen: set = set()
    dups = 0
    for label, records in sources:
        for arrival, rec in enumerate(records):
            if not isinstance(rec, dict):
                continue
            wkey = _oflight.worker_key(rec)
            seq = rec.get("seq")
            if isinstance(seq, int):
                if (wkey, seq) in seen:
                    dups += 1
                    continue
                seen.add((wkey, seq))
                order = (0, seq, arrival)
            else:
                order = (1, arrival, 0)  # legacy: after, in file order
            per.setdefault(wkey, []).append((order, rec))
    per_worker: dict[str, dict] = {}
    streams = []
    for wkey, rows in per.items():
        rows.sort(key=lambda r: r[0])
        recs = [r[1] for r in rows]
        seqs = [r.get("seq") for r in recs if isinstance(r.get("seq"), int)]
        info: dict = {
            "records": len(recs),
            "first_ts": _rec_ts(recs[0]),
            "last_ts": _rec_ts(recs[-1]),
        }
        if seqs:
            info["min_seq"] = seqs[0]
            info["max_seq"] = seqs[-1]
            # seq holes = records this merge never saw (pruned archive,
            # a worker that died mid-write): surfaced, never silent
            info["seq_gaps"] = (seqs[-1] - seqs[0] + 1) - len(seqs)
        per_worker[wkey] = info
        streams.append(recs)
    merged = list(heapq.merge(*streams, key=_rec_ts))
    return merged, per_worker, dups


def iter_source(spec: str, *, tail: int = DEFAULT_TAIL,
                timeout: float = DEFAULT_TIMEOUT_S):
    """One merge source from a CLI spec: an ``http(s)://`` worker base
    URL (live stream snapshot) or a flight JSONL file/dir."""
    if spec.startswith(("http://", "https://")):
        return fetch_records(spec, tail=tail, timeout=timeout)
    if not os.path.exists(spec):
        raise OSError(f"no such flight file or directory: {spec}")
    return list(_oflight.iter_records(spec))


def fetch_records(url: str, *, tail: int = DEFAULT_TAIL,
                  timeout: float = DEFAULT_TIMEOUT_S) -> list:
    """Snapshot a live worker's recent records over HTTP:
    ``GET <url>/debug/stream?follow=0&tail=N`` (newline-delimited
    JSON; blank heartbeat lines skipped, torn lines dropped)."""
    full = f"{url.rstrip('/')}/debug/stream?follow=0&tail={int(tail)}"
    out = []
    with urllib.request.urlopen(full, timeout=timeout) as resp:
        for raw in resp:
            line = raw.decode("utf-8", "replace").strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


# --------------------------------------------------------------------------
# the merged view
# --------------------------------------------------------------------------


def build_view(sources, *, now: float | None = None,
               objectives: dict | None = None,
               slo_spec: str | None = None,
               errors: dict | None = None) -> dict:
    """Merge ``sources`` and recompute the single-worker telemetry
    fleet-wide: burn rates (``obs.slo``, identical math to one
    worker's engine over the concatenated input — pinned by test),
    drift alarms (``obs.drift``), per-worker lag and seq coverage."""
    records, per_worker, dups = merge_sources(sources)
    if now is None:
        now = time.time()
    engine = _oslo.SLOEngine(objectives=objectives)
    if slo_spec:
        engine.configure(spec=slo_spec)
    # quiet: this replays HISTORICAL records — a dashboard polling
    # /debug/fleet must not re-log/re-mark a long-resolved alarm on
    # every poll; the snapshot still reports the alarms
    monitor = _odrift.DriftMonitor(quiet=True)
    for rec in records:
        engine.observe_record(rec)
        monitor.observe_record(rec)
    lag = 0.0
    for info in per_worker.values():
        info["lag_s"] = round(max(now - info["last_ts"], 0.0), 3)
        lag = max(lag, info["lag_s"])
    return {
        "workers": len(per_worker),
        "records": len(records),
        "duplicates_dropped": dups,
        "lag_seconds": round(lag, 3),
        "now": round(now, 3),
        "per_worker": per_worker,
        "slo": engine.snapshot(now=now),
        "drift": monitor.snapshot(),
        "drift_rows": monitor.metric_rows(),
        **({"errors": errors} if errors else {}),
    }


def merged_records(sources) -> list:
    """The ordered, dedup'd record stream alone (``--format records``)."""
    return merge_sources(sources)[0]


# --------------------------------------------------------------------------
# exposition (kao_fleet_* / kao_slo_* / kao_drift_*)
# --------------------------------------------------------------------------


def render_fleet_metrics(view: dict) -> str:
    """The merged view as Prometheus text exposition: the same
    ``kao_slo_*`` family shapes a single worker's ``/metrics`` serves
    (now fleet-wide), plus ``kao_fleet_*`` merge gauges and the
    ``kao_drift_*`` families. Validated by the exposition-format test
    suite; every family carries its HELP/TYPE pair (KAO107)."""
    from . import expo as _expo

    lines: list[str] = []

    def gauge(name: str, help_text: str, value) -> None:
        lines.extend(_expo.family_lines(name, "gauge", help_text,
                                        [(None, value)]))

    gauge("kao_fleet_workers", "distinct workers in the merged view",
          view["workers"])
    gauge("kao_fleet_records", "records in the merged view",
          view["records"])
    gauge("kao_fleet_duplicates",
          "records dropped by (worker, seq) dedup in this merge",
          view["duplicates_dropped"])
    lines.extend(_expo.family_lines(
        "kao_fleet_lag_seconds", "gauge",
        "seconds since each worker's newest record",
        [({"worker": wkey}, view["per_worker"][wkey]["lag_s"])
         for wkey in sorted(view["per_worker"])],
    ))
    lines.extend(_expo.family_lines(
        "kao_fleet_seq_gaps", "gauge",
        "per-worker sequence holes the merge never saw (pruned "
        "archives, dead workers)",
        [({"worker": wkey}, view["per_worker"][wkey]["seq_gaps"])
         for wkey in sorted(view["per_worker"])
         if view["per_worker"][wkey].get("seq_gaps") is not None],
    ))
    classes = (view.get("slo") or {}).get("classes") or {}
    if classes:
        slo_families = (
            ("kao_slo_events_total", "counter",
             "fleet-wide flight records observed per SLO class",
             lambda c: c["events_total"]),
            ("kao_slo_latency_breaches_total", "counter",
             "fleet-wide observations over the class latency objective",
             lambda c: c["latency_breaches_total"]),
            ("kao_slo_quality_breaches_total", "counter",
             "fleet-wide infeasible/degraded plans per SLO class",
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
                lines.append(f'{name}{{class="{cls}"}} '
                             f"{get(classes[cls])}")
        lines.append("# HELP kao_slo_burn_rate fleet-wide error-budget "
                     "burn rate per class and window")
        lines.append("# TYPE kao_slo_burn_rate gauge")
        for cls in sorted(classes):
            for win, w in sorted(classes[cls]["windows"].items()):
                lines.append(
                    f'kao_slo_burn_rate{{class="{cls}",window="{win}"}} '
                    f'{w["burn_rate"]}'
                )
    lines.extend(_odrift.render_families(
        view.get("drift_rows") or [], "the merged flight stream",
    ))
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# the kao-fleet CLI
# --------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="kao-fleet",
        description="Merge N workers' flight streams (JSONL dirs or "
                    "live /debug/stream URLs) into one ordered view: "
                    "fleet-wide SLO burn rates, drift alarms, "
                    "per-worker lag (docs/OBSERVABILITY.md)",
    )
    ap.add_argument("sources", nargs="+", metavar="DIR|FILE|URL",
                    help="flight JSONL dirs/files, or worker base URLs "
                         "(http://host:port — fetched via "
                         "/debug/stream?follow=0)")
    ap.add_argument("--tail", type=int, default=DEFAULT_TAIL,
                    metavar="N",
                    help="records fetched per live worker (URL "
                         "sources only; default %(default)s)")
    ap.add_argument("--timeout-s", type=float, default=DEFAULT_TIMEOUT_S,
                    help="per-worker HTTP timeout (default %(default)s)")
    ap.add_argument("--slo", default=None, metavar="SPEC",
                    help="per-class SLO objectives for the fleet "
                         "recompute, e.g. 'solve:5:0.99,delta:2' "
                         "(defaults match the serve engine)")
    ap.add_argument("--now", type=float, default=None, metavar="UNIX_TS",
                    help="evaluate windows/lag at this instant "
                         "(default: wall clock; useful on archived "
                         "dirs)")
    ap.add_argument("--format", default="json",
                    choices=["json", "metrics", "records"],
                    help="json: the merged view object; metrics: "
                         "Prometheus text (kao_fleet_*/kao_slo_*/"
                         "kao_drift_*); records: the ordered merged "
                         "stream as JSONL")
    return ap


def resolve_sources(specs, *, tail: int = DEFAULT_TAIL,
                    timeout: float = DEFAULT_TIMEOUT_S
                    ) -> tuple[list, dict]:
    """Resolve CLI/HTTP source specs into merge sources. URL specs
    fetch CONCURRENTLY — N dead peers cost ~one timeout, not N
    stacked (the same bound /debug/fleet keeps). Any failure degrades
    to an ``errors`` entry, whatever the exception type: a peer
    hanging up mid-response raises http.client.HTTPException, not an
    OSError — the merged view over the readable sources must still
    serve."""
    from concurrent.futures import ThreadPoolExecutor

    urls = [s for s in specs
            if s.startswith(("http://", "https://"))]
    fetched: dict = {}
    if urls:
        with ThreadPoolExecutor(max_workers=min(len(urls), 8)) as ex:
            futures = {
                u: ex.submit(fetch_records, u, tail=tail,
                             timeout=timeout)
                for u in urls
            }
        fetched = {u: f for u, f in futures.items()}
    sources: list = []
    errors: dict = {}
    for spec in specs:
        try:
            if spec in fetched:
                sources.append((spec, fetched[spec].result()))
            else:
                sources.append(
                    (spec, iter_source(spec, tail=tail,
                                       timeout=timeout))
                )
        except Exception as e:
            errors[spec] = repr(e)[:200]
    return sources, errors


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    sources, errors = resolve_sources(
        args.sources, tail=args.tail, timeout=args.timeout_s,
    )
    for spec, err in errors.items():
        # kao: disable=KAO106 -- "error: ..." on stderr is the CLI's UX contract
        print(f"error: {spec}: {err}", file=sys.stderr)
    if not sources:
        return 3  # every source unreadable
    if args.format == "records":
        for rec in merged_records(sources):
            # kao: disable=KAO106 -- the merged stream on stdout IS the product
            print(json.dumps(rec, separators=(",", ":"), default=str))
        return 0
    try:
        view = build_view(sources, now=args.now, slo_spec=args.slo,
                          errors=errors or None)
    except ValueError as e:  # a malformed --slo spec fails loudly
        # kao: disable=KAO106 -- "error: ..." on stderr is the CLI's UX contract
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.format == "metrics":
        # kao: disable=KAO106 -- the exposition on stdout IS the product
        print(render_fleet_metrics(view), end="")
    else:
        view.pop("drift_rows", None)  # exposition-internal detail
        # kao: disable=KAO106 -- the view JSON on stdout IS the product
        print(json.dumps(view, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
