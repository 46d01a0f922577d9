"""Cross-process causal trace assembly (docs/OBSERVABILITY.md
"Distributed traces").

One request through the ``kao-router`` leaves span trees in SEVERAL
processes: the router's route/attempt/hedge spans, the owning worker's
solve phases, and — when a hedge fired — the duplicate's phases on a
second worker, all sharing ONE trace ID via ``traceparent``
propagation (``obs.trace.inject``/``extract``). This module re-joins
them:

- :func:`collect_remote` fans a ``GET /debug/solves/<trace_id>`` out
  to the live workers concurrently (N dead workers cost ~one timeout,
  the ``/debug/fleet`` discipline) and returns whatever reports exist;
- :func:`merge_fleet_trace` unions those remote span trees under the
  router's root report: each worker tree declares its remote parent
  (the ``parent_span_id`` its root recorded at ``extract`` time), the
  merge finds the router span carrying that ``span_id`` and marks the
  join on both sides, so the causal chain "route decision → attempt →
  worker solve phases" reads as one tree.

Time bases: span ``start_s`` offsets are per-process
(``perf_counter``-relative), so the merge carries each process's
``offset_s`` — the wall-clock delta between its root's
``started_unix`` and the router's — which the multi-process Chrome
export (``obs.chrome.to_chrome_fleet``) uses to align the track
groups. Cross-host clock skew shifts a track, never corrupts a tree;
the offset rides in the merged view so a reader can judge it.

Stdlib-only (urllib + threads): the router imports this without torch.
"""

from __future__ import annotations

import json
import threading
import urllib.request

__all__ = ["collect_remote", "merge_fleet_trace"]

DEFAULT_TIMEOUT_S = 10.0


def _fetch_http(url: str, trace_id: str, timeout_s: float) -> dict | None:
    """One worker's report for ``trace_id``, or None when the worker
    does not hold it (404 — e.g. the hedge loser's ring evicted it, or
    the request never reached this worker)."""
    try:
        # read-only telemetry fan-out: there is no client request
        # context to propagate here
        # kao: disable=KAO111 -- debug-surface GET, no active request
        with urllib.request.urlopen(
            f"{url}/debug/solves/{trace_id}", timeout=timeout_s
        ) as resp:
            return json.loads(resp.read().decode("utf-8", "replace"))
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None
        raise


def collect_remote(urls: list[str], trace_id: str, *,
                   timeout_s: float = DEFAULT_TIMEOUT_S,
                   fetch=None) -> tuple[list[dict], dict]:
    """Fan ``GET /debug/solves/<trace_id>`` out to ``urls``
    CONCURRENTLY. Returns ``(reports, errors)`` where ``reports`` is
    ``[{"process": url, "report": {...}}, ...]`` (workers without the
    trace are simply absent) and ``errors`` maps unreachable workers to
    their failure — a dead peer degrades the view, never the request.
    ``fetch`` is injectable (url, trace_id -> report|None) for tests."""
    fetch = fetch or (
        lambda u, tid: _fetch_http(u, tid, timeout_s)
    )
    reports: list[dict] = []
    errors: dict = {}
    lock = threading.Lock()

    def run(u):
        try:
            rep = fetch(u, trace_id)
        except Exception as e:
            with lock:
                errors[u] = repr(e)[:200]
            return
        if isinstance(rep, dict) and rep.get("trace_id") == trace_id:
            with lock:
                reports.append({"process": u, "report": rep})

    threads = [threading.Thread(target=run, args=(u,), daemon=True)
               for u in urls]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # deterministic order for the merged view (thread finish order
    # is not)
    reports.sort(key=lambda r: r["process"])
    return reports, errors


def _span_index(span: dict, index: dict) -> None:
    """span_id -> span dict, for every ID-carrying span in the tree."""
    sid = span.get("span_id")
    if sid:
        index[sid] = span
    for child in span.get("spans") or ():
        _span_index(child, index)


def merge_fleet_trace(trace_id: str, root_report: dict | None,
                      remotes: list[dict]) -> dict:
    """Union remote span trees under the router's root report.

    ``remotes`` entries are ``{"process": label, "report": report}``
    (the :func:`collect_remote` shape). Each remote report whose root
    recorded a ``parent_span_id`` is attached to the router span
    carrying that ``span_id``: the router span gains
    ``attrs.remote_process``, the process entry records
    ``attached_to``, and ``offset_s`` aligns its clock to the router's.
    The router report is deep-copied — the ring's copy is never
    mutated. Works degraded with ``root_report=None`` (the router's
    ring evicted its half): the worker trees still union side by
    side."""
    root = (json.loads(json.dumps(root_report, default=str))
            if root_report else None)
    index: dict = {}
    if root and root.get("spans"):
        _span_index(root["spans"], index)
    base_unix = (root or {}).get("started_unix")
    processes = []
    for entry in remotes:
        rep = entry.get("report") or {}
        span_root = rep.get("spans") or {}
        parent = (span_root.get("attrs") or {}).get("parent_span_id")
        attached_to = None
        if parent and parent in index:
            attached_to = parent
            attrs = index[parent].setdefault("attrs", {})
            attrs["remote_process"] = entry.get("process")
            attrs["remote_trace"] = True
        offset_s = None
        if base_unix is not None and rep.get("started_unix") is not None:
            offset_s = round(rep["started_unix"] - base_unix, 6)
        processes.append({
            "process": entry.get("process"),
            "attached_to": attached_to,
            "offset_s": offset_s,
            "report": rep,
        })
    return {
        "trace_id": trace_id,
        "name": "fleet_trace",
        "processes_total": len(processes) + int(root is not None),
        "root": root,
        "processes": processes,
    }
