"""Chrome trace-event export for solve reports (docs/OBSERVABILITY.md).

Converts an ``obs.trace`` solve report (the span tree behind
``GET /debug/solves/<id>``) into Chrome trace-event JSON — the format
``chrome://tracing`` and Perfetto (https://ui.perfetto.dev) load
natively, turning a JSON span tree into a zoomable flame chart.
Surfaces: ``GET /debug/solves/<id>?format=chrome`` on serve and the
``obs.trace_cli`` CLI offline. (The reference package's merged
multi-process export, ``to_chrome_fleet``, comes with ``obs/fleet.py``.)

Mapping:

- a finished span -> one complete (``ph: "X"``) event: ``ts``/``dur``
  in integer microseconds from the root start;
- a zero-duration mark (skipped phases, ``degrade`` rungs) -> an
  instant (``ph: "i"``, thread scope) event;
- a still-running span (``wall_s: null`` — e.g. a straggling bounds
  worker) -> a complete event with ``dur: 0`` and
  ``args.in_flight: true``;
- span attrs ride in ``args``; the root carries the trace ID.

Thread lanes: Chrome nests complete events on one ``tid`` purely by
interval containment, so two OVERLAPPING siblings on one lane render
corrupted. A child nests on its parent's lane while it starts past the
previous sibling placed there; an overlapping sibling (a ``wrap()``-ed
worker span — bounds prefetch, constructor race) opens a fresh lane,
exactly like the thread it actually ran on. Events are emitted sorted
by ``ts`` (longer spans first at equal ``ts``, so parents precede
children), making ``ts`` monotonic non-decreasing — pinned by the
golden-file test.
"""

from __future__ import annotations

import json

__all__ = ["to_chrome", "report_to_json"]


def _us(seconds) -> int:
    return int(round(float(seconds) * 1e6))


def _place(span: dict, lane: int, *, pid: int, offset_us: int,
           events: list, lanes_used: set, next_lane: list) -> None:
    """Emit ``span`` (and, recursively, its children with the lane
    assignment described in the module docstring) onto ``events``."""
    lanes_used.add(lane)
    ts = offset_us + _us(span.get("start_s") or 0.0)
    wall = span.get("wall_s")
    args = dict(span.get("attrs") or {})
    ev: dict = {
        "name": span.get("name") or "span",
        "ph": "X",
        "ts": ts,
        "dur": _us(wall) if wall else 0,
        "pid": pid,
        "tid": lane,
        "cat": "solve",
    }
    if wall == 0:
        ev["ph"] = "i"
        ev["s"] = "t"  # thread-scoped instant
        del ev["dur"]
    elif wall is None:
        args["in_flight"] = True
    if args:
        ev["args"] = args
    events.append(ev)
    # children: each takes the first lane (parent's first) whose
    # frontier — the end of the previous span placed DIRECTLY on
    # it under this parent — it does not overlap
    frontier: dict[int, int] = {lane: -1}
    for child in span.get("spans") or ():
        cts = offset_us + _us(child.get("start_s") or 0.0)
        cwall = child.get("wall_s")
        cend = cts + (_us(cwall) if cwall else 0)
        child_lane = next(
            (ln for ln, end in frontier.items() if cts >= end),
            None,
        )
        if child_lane is None:
            child_lane = next_lane[0]
            next_lane[0] += 1
        frontier[child_lane] = cend
        _place(child, child_lane, pid=pid, offset_us=offset_us,
               events=events, lanes_used=lanes_used,
               next_lane=next_lane)


def to_chrome(report: dict) -> dict:
    """One solve report -> ``{"traceEvents": [...], ...}`` (the Chrome
    trace-event JSON object form)."""
    events: list[dict] = []
    lanes_used: set[int] = set()
    next_lane = [1]
    root = report.get("spans") or None
    if root:
        root = dict(root)
        root["attrs"] = {
            "trace_id": report.get("trace_id"),
            **(root.get("attrs") or {}),
        }
        _place(root, 0, pid=1, offset_us=0, events=events,
               lanes_used=lanes_used, next_lane=next_lane)
    events.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
    meta = [
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0, "ts": 0,
         "args": {"name": f"kao {report.get('name') or 'solve'}"}},
    ]
    for lane in sorted(lanes_used):
        meta.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": lane,
            "ts": 0,
            "args": {"name": "main" if lane == 0 else f"worker-{lane}"},
        })
    out: dict = {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": report.get("trace_id"),
            "name": report.get("name"),
            "started_unix": report.get("started_unix"),
            "wall_s": report.get("wall_s"),
        },
    }
    if report.get("annealing"):
        out["otherData"]["annealing"] = report["annealing"]
    return out


def report_to_json(report: dict, indent: int | None = None) -> str:
    return json.dumps(to_chrome(report), indent=indent, default=str,
                      sort_keys=False)
