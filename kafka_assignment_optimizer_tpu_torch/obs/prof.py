"""Continuous roofline observatory: a copy of the reference package's
``obs.prof`` (the same row schema, so ``obs.regress``,
``GET /debug/profile`` and the offline CLI read the same rows), with the
XLA cost analyses replaced by an analytic model of the three CUDA
launches.

- **Cost models**: at a dispatch key's first dispatch
  (``engine._run_ladder``'s ``_launch``: single, lanes, mega,
  mega-lanes), :func:`note_cost_model` caches the key's cost ONCE: the
  sum, over the kernel launches one dispatch makes
  (``sweep.stage_counts`` of its sweeps, each stage one launch on the
  card), of each launch's bytes and INT32 operations as
  ``ops.bench_kernel.launch_cost`` estimates them from the shapes: the
  bytes an upper estimate (each input and output once, every gathered
  read counted up to its table's size, where the bound counts each
  distinct entry once), the operations the threefry words every
  partition and chain draws at 71 instructions a word. It is an
  estimate, not the bound (``ops.bench_kernel.data_cost`` is, on a
  launch's actual inputs), so ``occupancy_hbm`` reads high where the
  chains share entries. ``peak_hbm_bytes`` is the peak of
  ``torch.cuda.max_memory_allocated`` over the key's first dispatch,
  above what was allocated at its start (the allocator's peak is reset
  there, so it holds another thread's allocations made meanwhile). A
  dispatch that launches no kernel (the chain engine, the plain
  versions' rung) has no cost to model: its row carries none. On this
  card integer work bounds the kernels, so a row's ``flops`` field
  holds INT32 operations and :func:`peaks` gives the INT32 issue rate
  in the ``flops`` slot.
- **Occupancy**: every dispatch stamps its enqueue's start
  (:func:`note_dispatch`); the engine's retire-side device wait pairs
  with it (:func:`note_device`), and the enqueue->retire window plus the
  cost model yield achieved operations/s and bytes/s versus the card's
  peaks — a rolling per-key roofline with occupancy percentiles. The
  pairing queue is a per-solve contextvar, so pipelined ladders (two
  dispatches in flight) pair honestly and concurrent serve workers
  never cross streams. The window is the host's: it holds the enqueue
  and the wait, so occupancy reads low wherever the host paces the card.
- **Dispatch gaps**: :func:`observe_gaps` derives the gap series (end
  of one ladder dispatch to the start of the next) from the solve
  report's span timestamps and lands it in an
  :class:`~obs.trace.ExemplarHistogram`, so the p99 gap carries a
  trace_id that resolves through ``GET /debug/solves/<id>``.
- **Attribution**: :func:`attribution_summary` / :func:`worst_solves`
  aggregate the flight ledgers (``obs.flight`` builds them; this module
  reads them) for ``GET /debug/profile`` and the offline CLI
  (``python -m kafka_assignment_optimizer_tpu_torch.obs.prof``), which
  runs the same aggregation over flight JSONL files and directories.

Every hook self-accounts its own wall cost (``overhead()``). Peaks are
the card's (:func:`peaks`) and env-overridable
(``KAO_PROF_PEAK_FLOPS`` / ``KAO_PROF_PEAK_BYTES_S``) — absolute
occupancy is only as good as the peak it is normalized by, so the
regression gate (``obs.regress``) compares occupancy RATIOS between
artifacts of the same environment, never absolutes.
"""

from __future__ import annotations

import argparse
import contextlib
import contextvars
import hashlib
import heapq
import json
import os
import subprocess
import sys
import threading
import time
from collections import OrderedDict, deque

from . import flight as _oflight
from .trace import ExemplarHistogram

__all__ = [
    "note_cost_model", "note_dispatch", "note_device", "reset_pending",
    "accounted",
    "observe_gaps", "forget_key", "clear", "peaks", "snapshot",
    "roofline", "attribution_summary", "worst_solves", "overhead",
    "gap_snapshot", "gap_exemplars", "main",
]

# dispatch-gap histogram bounds: warm ladder gaps sit in the 0.1-5 ms
# band; the tail buckets catch a host stall or GC pause between chunks
GAP_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
               0.5, 2.0)

# rolling occupancy window per executable: enough dispatches to make
# p99 meaningful on a long ladder, bounded so a service never grows
_OCC_SAMPLES = 256
# cost-model cache bound: entries are a few floats; oldest keys go first
_COST_MAX = 128

# the CPU's occupancy denominators: order-of-magnitude placeholders
# (override with KAO_PROF_PEAK_FLOPS / KAO_PROF_PEAK_BYTES_S); a card's
# are read from the card (:func:`peaks`)
_CPU_PEAKS = (100e9, 50e9)
# device-memory rate by device name (NVIDIA's data sheets), bytes/s
_HBM_BYTES_S = {
    "H100 80GB HBM3": 3.35e12,
    "H100 SXM": 3.35e12,
    "H100 NVL": 3.9e12,
    "H100 PCIe": 2.0e12,
    "H200": 4.8e12,
}
INT32_LANES_PER_SM = 64  # Hopper issues 64 INT32 operations a clock per SM
_CARD_PEAKS: list = []  # (int32 ops/s, bytes/s) of card 0, read once

_LOCK = threading.Lock()
# exec key -> cost model row (captured once per compile)
_COST: OrderedDict = OrderedDict()
# exec key -> runtime totals + rolling occupancy samples
_RUNTIME: dict = {}
_COUNTERS = {
    "captures_total": 0,       # cost models captured (one per key)
    "capture_errors_total": 0,  # a key whose dispatch launches no kernel
    "reuses_total": 0,         # dispatches served by a cached model
    "unpaired_device_total": 0,  # device waits with no pending dispatch
    "ledger_overruns_total": 0,  # ledgers whose parts exceeded wall+eps
}
# profiler self-accounting: wall seconds spent inside the note_* hooks
# (the <2% overhead assertion reads this; sampler.py idiom)
_OVERHEAD = {"seconds_total": 0.0, "ops_total": 0}

# per-solve pairing queue: (exec_key, enqueue_end_ts) in dispatch
# order. Contextvar — each serve worker thread pairs its own stream.
_PENDING: contextvars.ContextVar = contextvars.ContextVar(
    "kao_prof_pending", default=None
)

GAP_HIST = ExemplarHistogram(GAP_BUCKETS)


def _account(t0: float) -> None:
    dt = time.perf_counter() - t0
    with _LOCK:
        _OVERHEAD["seconds_total"] += dt
        _OVERHEAD["ops_total"] += 1


@contextlib.contextmanager
def accounted():
    """Count the block's wall time as the profiler's own overhead (the
    engine's cost-model preparation at a key's first dispatch)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _account(t0)


def _card_peaks() -> tuple[float, float]:
    """Card 0's INT32 issue rate (SMs x 64 lanes x the maximum SM clock)
    and device-memory rate (the data sheet's by device name, else twice
    the memory clock times the bus width), read once per process."""
    if not _CARD_PEAKS:
        import torch

        props = torch.cuda.get_device_properties(0)
        khz = getattr(props, "clock_rate", 0)
        if not khz:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.max.sm",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=60).stdout
            khz = float(out.split()[0]) * 1e3
        ops = props.multi_processor_count * INT32_LANES_PER_SM * khz * 1e3
        bw = next((v for k, v in _HBM_BYTES_S.items() if k in props.name),
                  None)
        if bw is None:
            bw = (2.0 * getattr(props, "memory_clock_rate", 0) * 1e3
                  * getattr(props, "memory_bus_width", 0) / 8)
        _CARD_PEAKS[:] = [float(ops), float(bw)]
    return _CARD_PEAKS[0], _CARD_PEAKS[1]


def peaks() -> dict:
    """The occupancy denominators of this process's device:
    ``{"platform", "flops", "bytes_s"}`` (env-overridable). ``platform``
    is ``"gpu"`` once this process has initialized CUDA (a solve or a
    bench touched the card; the card's INT32 rate stands in ``flops``),
    else ``"cpu"``. Never initializes CUDA itself."""
    torch = sys.modules.get("torch")
    platform = "cpu"
    flops, bw = _CPU_PEAKS
    if torch is not None and torch.cuda.is_initialized():
        platform = "gpu"
        flops, bw = _card_peaks()
    try:
        flops = float(os.environ.get("KAO_PROF_PEAK_FLOPS") or flops)
    except ValueError:
        pass
    try:
        bw = float(os.environ.get("KAO_PROF_PEAK_BYTES_S") or bw)
    except ValueError:
        pass
    return {"platform": platform, "flops": flops, "bytes_s": bw}


# --------------------------------------------------------------------------
# cost-model capture (the engine's dispatch calls this once per key)
# --------------------------------------------------------------------------


def _extract_cost(desc: dict) -> dict:
    """INT32 operations / bytes / peak memory of one dispatch from its
    description ``{"launches": {kernel name: count}, "shape":
    ops.bench_kernel.dispatch_shape(...), "peak_hbm_bytes": x}``: the
    analytic cost of its launches (``ops.bench_kernel.dispatch_cost``).
    A dispatch that launches nothing gets None (consumers skip None
    denominators)."""
    from ..ops.bench_kernel import dispatch_cost

    launches = {k: int(v) for k, v in (desc.get("launches") or {}).items()
                if v}
    flops = bytes_accessed = None
    if launches:
        cost = dispatch_cost(launches, desc["shape"])
        flops = float(cost["int_ops"])
        bytes_accessed = float(cost["bytes"])
    peak = desc.get("peak_hbm_bytes")
    return {"flops": flops, "bytes_accessed": bytes_accessed,
            "peak_hbm_bytes": None if peak is None else float(peak),
            "launches": launches}


def note_cost_model(key: tuple, desc: dict, compile_s: float) -> None:
    """Capture + cache the analytic cost of a key's dispatch (``desc`` as
    :func:`_extract_cost` takes it; called by the engine at the key's
    first dispatch, ``compile_s`` the kernel builds that dispatch paid).
    Never raises."""
    t0 = time.perf_counter()
    try:
        row = _extract_cost(desc)
        row["compile_s"] = round(float(compile_s), 4)
        ok = row["flops"] is not None or row["bytes_accessed"] is not None
        with _LOCK:
            _COST[key] = row
            _COST.move_to_end(key)
            while len(_COST) > _COST_MAX:
                old = _COST.popitem(last=False)[0]
                _RUNTIME.pop(old, None)
            _COUNTERS["captures_total"] += 1
            if not ok:
                _COUNTERS["capture_errors_total"] += 1
    except Exception:
        with _LOCK:
            _COUNTERS["capture_errors_total"] += 1
    finally:
        _account(t0)


def has_cost_model(key: tuple) -> bool:
    with _LOCK:
        return key in _COST


def forget_key(key: tuple) -> None:
    """Drop one key's cost model + runtime totals."""
    with _LOCK:
        _COST.pop(key, None)
        _RUNTIME.pop(key, None)


def clear() -> None:
    """Full reset (tests)."""
    with _LOCK:
        _COST.clear()
        _RUNTIME.clear()
        for k in _COUNTERS:
            _COUNTERS[k] = 0
        _OVERHEAD["seconds_total"] = 0.0
        _OVERHEAD["ops_total"] = 0
    GAP_HIST.reset()


# --------------------------------------------------------------------------
# dispatch/device pairing -> occupancy samples
# --------------------------------------------------------------------------


def reset_pending() -> None:
    """Fresh pairing queue for a new solve (flight.start_accounting
    calls this): an abandoned speculative dispatch from a previous
    solve must not mispair with this solve's first device wait."""
    d = _PENDING.get()
    if d is not None:
        d.clear()


def note_dispatch(key: tuple, started: float) -> None:
    """One dispatch ENQUEUED (the engine's chunk or group call
    returned): stamp the pairing queue and count the dispatch against
    the key's cost model. The occupancy window opens at ``started`` (a
    ``time.perf_counter`` reading taken before the enqueue), where the
    reference opens it at the enqueue's end: the host here enqueues a
    chunk launch by launch while the card runs them, so only a window
    opened before the first launch holds all of the dispatch's device
    work."""
    t0 = time.perf_counter()
    try:
        d = _PENDING.get()
        if d is None:
            d = deque(maxlen=8)
            _PENDING.set(d)
        d.append((key, float(started)))
        with _LOCK:
            if key in _COST:
                _COUNTERS["reuses_total"] += 1
            rt = _RUNTIME.get(key)
            if rt is None:
                rt = _RUNTIME[key] = {
                    "dispatches": 0, "device_s": 0.0, "window_s": 0.0,
                    "samples": deque(maxlen=_OCC_SAMPLES),
                }
            rt["dispatches"] += 1
    finally:
        _account(t0)


def note_device(seconds: float) -> None:
    """The device wait that retires the oldest in-flight dispatch (the
    engine's retire wait, through ``obs.flight.note_device``): close the
    enqueue->retire window, attribute device seconds, and take one
    occupancy sample against the key's cost model."""
    t0 = time.perf_counter()
    try:
        d = _PENDING.get()
        if not d:
            with _LOCK:
                _COUNTERS["unpaired_device_total"] += 1
            return
        key, t_enq = d.popleft()
        window = max(t0 - t_enq, float(seconds), 1e-9)
        pk = peaks()
        with _LOCK:
            cost = _COST.get(key)
            rt = _RUNTIME.get(key)
            if rt is None:
                rt = _RUNTIME[key] = {
                    "dispatches": 0, "device_s": 0.0, "window_s": 0.0,
                    "samples": deque(maxlen=_OCC_SAMPLES),
                }
            rt["device_s"] += float(seconds)
            rt["window_s"] += window
            if cost:
                occ_f = occ_b = None
                if cost.get("flops"):
                    occ_f = (cost["flops"] / window) / pk["flops"]
                if cost.get("bytes_accessed"):
                    occ_b = (cost["bytes_accessed"] / window) / pk["bytes_s"]
                if occ_f is not None or occ_b is not None:
                    rt["samples"].append((occ_f, occ_b))
    finally:
        _account(t0)


def note_ledger_overrun() -> None:
    """flight's ledger builder reports a components-exceed-wall ledger
    here (the sums-to-wall invariant's failure counter)."""
    with _LOCK:
        _COUNTERS["ledger_overruns_total"] += 1


# --------------------------------------------------------------------------
# dispatch-gap series from span timestamps (trace linkage)
# --------------------------------------------------------------------------


def _dispatch_spans(span: dict, out: list) -> None:
    if span.get("name") == "dispatch" and span.get("wall_s") is not None:
        out.append((span["start_s"], span["start_s"] + span["wall_s"]))
    for child in span.get("spans") or ():
        _dispatch_spans(child, out)


def observe_gaps(report: dict, trace_id: str | None = None) -> None:
    """Derive the dispatch-gap series of one traced solve from its
    span timestamps (gap = end of one ladder dispatch to the start of
    the next) and land it in the exemplar histogram — the p99 gap's
    trace_id resolves via ``GET /debug/solves/<id>``. Never raises."""
    t0 = time.perf_counter()
    try:
        spans: list = []
        _dispatch_spans(report.get("spans") or {}, spans)
        spans.sort()
        for (_s0, e0), (s1, _e1) in zip(spans, spans[1:]):
            gap = s1 - e0
            if gap >= 0:
                GAP_HIST.observe("ladder", gap, trace_id=trace_id)
    except Exception:
        pass
    finally:
        _account(t0)


def gap_snapshot() -> dict:
    return GAP_HIST.snapshot()


def gap_exemplars() -> list:
    return GAP_HIST.exemplars("path")


# --------------------------------------------------------------------------
# snapshots: per-executable rows + per-bucket roofline
# --------------------------------------------------------------------------

_TAGS = {"lanes", "mega", "mega-lanes"}


def _pct(sorted_vals: list, q: float):
    if not sorted_vals:
        return None
    i = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return round(sorted_vals[i], 6)


def _render_key(key: tuple) -> dict:
    """Human fields from one ``(solver_key, arg_signature)`` dispatch key
    (``engine._prof_key``: ``((device,), chains, steps_per_round,
    engine, scorer, tag)`` and the chains' ``((shape, dtype),)``): the
    dispatch-path tag, engine/scorer, device count, and the bucket dims
    (trailing two dims of the largest-rank shape — the padded [P, R]).
    A spec-suffixed tag (``"lanes@4x2"``, the reference's lane split)
    renders its base as the path and the split as its own field."""
    solver_key, arg_sig = key
    tag = "single"
    sharding = None
    engine = scorer = None
    ndev = chains = None
    try:
        last = solver_key[-1]
        if isinstance(last, str):
            base, _, spec = last.partition("@")
            if base in _TAGS:
                tag = base
                sharding = spec or None
        ndev = len(solver_key[0])
        chains = int(solver_key[1])
        engine, scorer = solver_key[3], solver_key[4]
    except Exception:
        pass
    bucket = None
    try:
        big = max((s for s, _dt in arg_sig), key=len)
        if len(big) >= 2:
            bucket = [int(big[-2]), int(big[-1])]
    except Exception:
        pass
    kid = hashlib.sha1(repr(key).encode()).hexdigest()[:12]
    return {"key_id": kid, "path": tag, "sharding": sharding,
            "engine": engine, "scorer": scorer, "devices": ndev,
            "chains": chains, "bucket": bucket}


def snapshot() -> dict:
    """Full observatory state: per-key roofline rows (cost model +
    measured totals + occupancy percentiles), counters, peaks, and the
    profiler's own overhead accounting."""
    pk = peaks()
    with _LOCK:
        cost = {k: dict(v) for k, v in _COST.items()}
        runtime = {
            k: {"dispatches": v["dispatches"],
                "device_s": v["device_s"], "window_s": v["window_s"],
                "samples": list(v["samples"])}
            for k, v in _RUNTIME.items()
        }
        counters = dict(_COUNTERS)
        ovh = dict(_OVERHEAD)
    rows = []
    for key in set(cost) | set(runtime):
        c = cost.get(key) or {}
        rt = runtime.get(key) or {}
        row = {**_render_key(key), **{
            "flops": c.get("flops"),
            "bytes_accessed": c.get("bytes_accessed"),
            "peak_hbm_bytes": c.get("peak_hbm_bytes"),
            "compile_s": c.get("compile_s"),
            "launches": c.get("launches"),
            "dispatches": rt.get("dispatches", 0),
            "device_s": round(rt.get("device_s", 0.0), 4),
            "window_s": round(rt.get("window_s", 0.0), 4),
        }}
        win = rt.get("window_s") or 0.0
        n = rt.get("dispatches") or 0
        if win > 0 and n:
            if c.get("flops"):
                row["achieved_flops_s"] = round(c["flops"] * n / win, 1)
                row["occupancy_flops"] = round(
                    row["achieved_flops_s"] / pk["flops"], 6)
            if c.get("bytes_accessed"):
                row["achieved_bytes_s"] = round(
                    c["bytes_accessed"] * n / win, 1)
                row["occupancy_hbm"] = round(
                    row["achieved_bytes_s"] / pk["bytes_s"], 6)
        occ_f = sorted(s[0] for s in rt.get("samples", ()) if s[0] is not None)
        occ_b = sorted(s[1] for s in rt.get("samples", ()) if s[1] is not None)
        if occ_f:
            row["occupancy_flops_p50"] = _pct(occ_f, 0.50)
            row["occupancy_flops_p99"] = _pct(occ_f, 0.99)
        if occ_b:
            row["occupancy_hbm_p50"] = _pct(occ_b, 0.50)
            row["occupancy_hbm_p90"] = _pct(occ_b, 0.90)
            row["occupancy_hbm_p99"] = _pct(occ_b, 0.99)
        rows.append(row)
    rows.sort(key=lambda r: -(r.get("device_s") or 0.0))
    if ovh["ops_total"]:
        ovh["avg_op_s"] = round(
            ovh["seconds_total"] / ovh["ops_total"], 9)
    ovh["seconds_total"] = round(ovh["seconds_total"], 6)
    return {"peaks": pk, "executables": rows, "counters": counters,
            "overhead": ovh}


def roofline() -> list:
    """Per-bucket aggregation of :func:`snapshot` rows (the
    ``/debug/profile`` table): executables grouped by bucket dims, with
    summed device/window seconds and the occupancy of the dominant
    (most device seconds) executable per bucket."""
    snap = snapshot()
    groups: dict = {}
    for row in snap["executables"]:
        bk = tuple(row["bucket"] or ())
        g = groups.setdefault(bk, {
            "bucket": row["bucket"], "executables": 0, "dispatches": 0,
            "device_s": 0.0, "window_s": 0.0, "paths": [],
        })
        g["executables"] += 1
        g["dispatches"] += row["dispatches"]
        g["device_s"] = round(g["device_s"] + row["device_s"], 4)
        g["window_s"] = round(g["window_s"] + row["window_s"], 4)
        if row["path"] not in g["paths"]:
            g["paths"].append(row["path"])
        best = g.get("_best_dev", -1.0)
        if row["device_s"] > best:
            g["_best_dev"] = row["device_s"]
            for f in ("occupancy_flops", "occupancy_hbm",
                      "occupancy_hbm_p50", "occupancy_hbm_p99",
                      "flops", "bytes_accessed", "peak_hbm_bytes"):
                if row.get(f) is not None:
                    g[f] = row[f]
    out = []
    for g in groups.values():
        g.pop("_best_dev", None)
        out.append(g)
    out.sort(key=lambda g: -(g["device_s"] or 0.0))
    return out


def overhead() -> dict:
    with _LOCK:
        return dict(_OVERHEAD)


# --------------------------------------------------------------------------
# ledger aggregation (records in -> attribution out; shared by
# /debug/profile and the offline kao-prof CLI)
# --------------------------------------------------------------------------

LEDGER_FIELDS = ("queue_wait_s", "constructor_s", "compile_s",
                 "dispatch_gap_s", "device_s", "transfer_s",
                 "boundary_s", "other_s")


def attribution_summary(records: list) -> dict:
    """Aggregate attribution over flight records carrying a ledger:
    per-kind mean share of wall for every ledger component, plus the
    sums-to-wall conformance count."""
    per_kind: dict = {}
    for rec in records:
        led = rec.get("ledger")
        if not isinstance(led, dict):
            continue
        wall = float(led.get("wall_s") or 0.0)
        k = rec.get("kind") or "solve"
        g = per_kind.setdefault(k, {
            "solves": 0, "wall_s": 0.0, "ok": 0,
            **{f: 0.0 for f in LEDGER_FIELDS},
        })
        g["solves"] += 1
        g["wall_s"] += wall
        g["ok"] += int(bool(led.get("ok")))
        for f in LEDGER_FIELDS:
            g[f] += float(led.get(f) or 0.0)
    for g in per_kind.values():
        wall = g["wall_s"]
        g["shares"] = {
            f: round(g[f] / wall, 4) if wall > 0 else None
            for f in LEDGER_FIELDS
        }
        for f in LEDGER_FIELDS:
            g[f] = round(g[f], 4)
        g["wall_s"] = round(wall, 4)
    return per_kind


def worst_solves(records: list, n: int = 5) -> list:
    """The n solves losing the most wall to non-device time (the
    worst-attribution list): rows link by trace_id into
    ``GET /debug/solves/<id>`` and the Perfetto export."""
    rows = []
    for rec in records:
        led = rec.get("ledger")
        if not isinstance(led, dict):
            continue
        wall = float(led.get("wall_s") or 0.0)
        lost = wall - float(led.get("device_s") or 0.0)
        rows.append({
            "trace_id": rec.get("trace_id"),
            "kind": rec.get("kind"),
            "bucket": rec.get("bucket"),
            "wall_s": round(wall, 4),
            "lost_s": round(lost, 4),
            "lost_share": round(lost / wall, 4) if wall > 0 else None,
            "ledger": {f: led.get(f) for f in LEDGER_FIELDS},
            "ok": bool(led.get("ok")),
        })
    rows.sort(key=lambda r: -r["lost_s"])
    return rows[:n]


# --------------------------------------------------------------------------
# the offline CLI: attribution over flight JSONL files and directories
# --------------------------------------------------------------------------


def _rec_ts(rec: dict) -> float:
    try:
        return float(rec.get("ts") or 0.0)
    except (TypeError, ValueError):
        return 0.0


def _merge_sources(sources) -> tuple[list, dict, int]:
    """The reference's fleet merge (``obs.fleet.merge_sources``), kept
    here until that module is ported. ``sources``: iterable of ``(label, iterable_of_records)``.
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



def _iter_source(spec: str) -> list:
    """One merge source: a flight JSONL file or directory. (Live worker
    URLs come with the reference's ``obs/fleet.py``, not ported yet.)"""
    if spec.startswith(("http://", "https://")):
        raise OSError(f"{spec}: reading a live worker needs obs/fleet.py, "
                      "which this package does not have yet")
    if not os.path.exists(spec):
        raise OSError(f"no such flight file or directory: {spec}")
    return list(_oflight.iter_records(spec))


def _fmt_share(v) -> str:
    return f"{100.0 * v:5.1f}%" if v is not None else "    --"


def main(argv: list | None = None) -> int:
    """The reference's ``kao-prof``: wall-clock attribution over flight
    JSONL files/dirs — the offline view of ``GET /debug/profile``.
    Several sources merge as the reference's fleet merge does
    (seq-dedup, per-worker order)."""
    ap = argparse.ArgumentParser(
        prog="python -m kafka_assignment_optimizer_tpu_torch.obs.prof",
        description="offline wall-clock attribution + worst-solve "
                    "report over flight JSONL dirs (fleet-wide when "
                    "given several sources; docs/OBSERVABILITY.md "
                    "'Reading a roofline')")
    ap.add_argument("sources", nargs="+",
                    help="flight JSONL file(s)/dir(s)")
    ap.add_argument("--kind", default=None,
                    help="only records of this kind (solve/lane/delta)")
    ap.add_argument("--top", type=int, default=5,
                    help="worst-attribution solves to list (default 5)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    args = ap.parse_args(argv)

    try:
        sources = [(s, _iter_source(s)) for s in args.sources]
    except OSError as e:
        # kao: disable=KAO106 -- CLI stderr diagnostic, not serve-path
        print(f"kao-prof: {e}", file=sys.stderr)
        return 2
    records, per_worker, dups = _merge_sources(sources)
    if args.kind:
        records = [r for r in records if r.get("kind") == args.kind]
    summary = attribution_summary(records)
    worst = worst_solves(records, args.top)
    out = {
        "records": len(records),
        "workers": len(per_worker),
        "duplicates_dropped": dups,
        "attribution": summary,
        "worst_solves": worst,
    }
    if args.json:
        print(json.dumps(out, indent=2))  # kao: disable=KAO106 -- CLI stdout is the product
        return 0
    print(f"{len(records)} records from {len(per_worker)} worker(s)"  # kao: disable=KAO106 -- CLI stdout is the product
          + (f", {dups} duplicates dropped" if dups else ""))
    for kind, g in sorted(summary.items()):
        print(f"\n[{kind}] {g['solves']} solves, "  # kao: disable=KAO106 -- CLI stdout is the product
              f"{g['wall_s']:.2f}s wall, ledgers ok "
              f"{g['ok']}/{g['solves']}")
        for f in LEDGER_FIELDS:
            print(f"  {f:<15} {_fmt_share(g['shares'][f])} "  # kao: disable=KAO106 -- CLI stdout is the product
                  f"({g[f]:.3f}s)")
    if worst:
        print("\nworst-attribution solves (most non-device wall):")  # kao: disable=KAO106 -- CLI stdout is the product
        for row in worst:
            print(f"  {row['lost_s']:7.3f}s lost / "  # kao: disable=KAO106 -- CLI stdout is the product
                  f"{row['wall_s']:7.3f}s wall  "
                  f"kind={row['kind']} trace={row['trace_id']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
