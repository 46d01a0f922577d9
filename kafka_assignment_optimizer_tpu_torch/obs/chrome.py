"""Chrome trace-event export for solve reports (docs/OBSERVABILITY.md).

Converts an ``obs.trace`` solve report (the span tree behind
``GET /debug/solves/<id>``) into Chrome trace-event JSON — the format
``chrome://tracing`` and Perfetto (https://ui.perfetto.dev) load
natively, turning a JSON span tree into a zoomable flame chart.
Surfaces: ``GET /debug/solves/<id>?format=chrome`` on serve, the
merged multi-process ``GET /debug/traces/<id>?format=chrome`` on the
kao-router (:func:`to_chrome_fleet`), and the ``obs.trace_cli`` CLI
offline.

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

Multi-process (:func:`to_chrome_fleet`): each process in a merged
fleet trace (``obs.causal.merge_fleet_trace``) becomes its own ``pid``
track group — the router first, then every worker, each with a
``process_name`` metadata event — aligned on the router's timeline via
the merge's per-process ``offset_s`` (wall-clock deltas between the
processes' root ``started_unix`` stamps; cross-host skew shifts a
track, never corrupts a tree).
"""

from __future__ import annotations

import json

__all__ = ["to_chrome", "to_chrome_fleet", "report_to_json"]


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


def to_chrome_fleet(merged: dict) -> dict:
    """A merged fleet trace (``obs.causal.merge_fleet_trace``) -> ONE
    Chrome trace-event JSON with per-process track groups: pid 1 is
    the router's route/attempt spans, pid 2.. are the workers' solve
    trees in :data:`merged["processes"]` order, labeled by process and
    sorted into that order in the Perfetto UI."""
    events: list[dict] = []
    meta: list[dict] = []
    groups: list[tuple[str, float | None, dict]] = []
    root = merged.get("root")
    if root:
        groups.append(("router", None, root))
    for prc in merged.get("processes") or ():
        rep = prc.get("report")
        if rep:
            label = prc.get("process") or f"process-{len(groups)}"
            groups.append((label, prc.get("offset_s"), rep))
    for sort_index, (label, offset_s, rep) in enumerate(groups):
        pid = sort_index + 1
        # negative skew clamps to the router's zero so ts stays
        # non-negative; the raw offset still rides in otherData below
        offset_us = max(_us(offset_s), 0) if offset_s else 0
        lanes_used: set[int] = set()
        next_lane = [1]
        span_root = rep.get("spans") or None
        if span_root:
            span_root = dict(span_root)
            span_root["attrs"] = {
                "trace_id": rep.get("trace_id"),
                "process": label,
                **(span_root.get("attrs") or {}),
            }
            _place(span_root, 0, pid=pid, offset_us=offset_us,
                   events=events, lanes_used=lanes_used,
                   next_lane=next_lane)
        meta.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "ts": 0,
            "args": {"name": f"kao {label}"},
        })
        meta.append({
            "name": "process_sort_index", "ph": "M", "pid": pid,
            "tid": 0, "ts": 0,
            "args": {"sort_index": sort_index},
        })
        for lane in sorted(lanes_used):
            meta.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": lane, "ts": 0,
                "args": {"name": ("main" if lane == 0
                                  else f"worker-{lane}")},
            })
    events.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": merged.get("trace_id"),
            "name": merged.get("name") or "fleet_trace",
            "processes": [
                {"pid": i + 1, "process": label,
                 "offset_s": offset_s}
                for i, (label, offset_s, _) in enumerate(groups)
            ],
        },
    }


def report_to_json(report: dict, indent: int | None = None) -> str:
    return json.dumps(to_chrome(report), indent=indent, default=str,
                      sort_keys=False)
