"""Shape bucketing: the canonical padded shape a model is lowered to.

A copy of the partition and max-RF ladders of
``kafka_assignment_optimizer_tpu.solvers.tpu.bucket``. The padded shape
is part of the search trajectory (the random bits are drawn per padded
row, and exchange partners pair across padded rows), so the port pads
exactly as the reference does and both replay the same ladder.

Padded rows are inert by construction (``arrays.from_instance``): rf=0,
slot_valid false, zero weights, zero diversity caps; every proposal on
them is rejected, and the returned plan is sliced back to the real shape
before any host-side oracle sees it. The broker and rack axes are never
padded: their band penalties are global.

Config:

- ``KAO_BUCKETS=off``           disable bucketing (raw shapes).
- ``KAO_BUCKETS=64,1024,16384`` override the partition ladder with an
  explicit comma list (instances above the largest rung keep their raw
  partition count).
- ``KAO_LANE_BUCKETS=off`` keeps raw lane counts; ``KAO_LANE_BUCKETS=2,4,8``
  overrides the lane ladder (a malformed value keeps the default).
"""

from __future__ import annotations

import os
import threading

# partition ladder: geometric from 32 up — 1.5x below 1024 partitions,
# 1.25x from there, rounded to multiples of 8 (256 from 4096 up)
_LADDER_BASE = 32
_LADDER_GROWTH_SMALL = 1.5
_LADDER_GROWTH_BIG = 1.25
_LADDER_BIG_AT = 1024
_LADDER_ALIGN = 8
_LADDER_TILE_AT = 4096
_LADDER_TILE = 256

# max-RF ladder: one rung per common value, then multiples of 4
_RF_LADDER = (1, 2, 3, 4, 5, 6, 8)

# lane ladder: a lane batch (the portfolio, a multi-instance batch) pads
# its lane count up to a rung; padding lanes rerun lane 0 and are never
# read. Rung 1 keeps a single lane raw; batches above the top rung stay
# raw
_LANE_LADDER = (1, 8)


def _round_up(v: int, align: int) -> int:
    return -(-int(v) // align) * align


def enabled() -> bool:
    return os.environ.get("KAO_BUCKETS", "").lower() not in (
        "off", "0", "none", "false",
    )


def _custom_ladder() -> list[int] | None:
    """Explicit partition ladder from ``KAO_BUCKETS``, or None."""
    raw = os.environ.get("KAO_BUCKETS", "")
    if not raw or raw.lower() in ("on", "1", "true"):
        return None
    try:
        rungs = sorted({int(x) for x in raw.split(",") if x.strip()})
    except ValueError:
        return None  # malformed override: fall back to the default ladder
    return rungs or None


def _next_rung(v: int) -> int:
    growth = (
        _LADDER_GROWTH_SMALL if v < _LADDER_BIG_AT else _LADDER_GROWTH_BIG
    )
    align = _LADDER_TILE if v >= _LADDER_TILE_AT else _LADDER_ALIGN
    return _round_up(v * growth, align)


def part_bucket(num_parts: int) -> int:
    """Smallest ladder rung >= num_parts (identity when bucketing is
    disabled; instances above a custom ladder's top rung stay raw)."""
    p = int(num_parts)
    if not enabled():
        return p
    custom = _custom_ladder()
    if custom is not None:
        for rung in custom:
            if rung >= p:
                return rung
        return p
    v = _LADDER_BASE
    while v < p:
        v = _next_rung(v)
    return v


def _lane_ladder() -> tuple[int, ...] | None:
    """The active lane ladder, or None when lane padding is off."""
    raw = os.environ.get("KAO_LANE_BUCKETS", "")
    if raw.lower() in ("off", "0", "none", "false"):
        return None
    if not raw or raw.lower() in ("on", "1", "true"):
        return _LANE_LADDER
    try:
        rungs = sorted({int(x) for x in raw.split(",") if x.strip()})
    except ValueError:
        return _LANE_LADDER  # malformed override: the default ladder
    return tuple(rungs) or _LANE_LADDER


def lane_bucket(lanes: int) -> int:
    """Smallest lane-ladder rung >= lanes (identity when lane padding is
    off, or above the top rung)."""
    n = int(lanes)
    ladder = _lane_ladder()
    if ladder is None:
        return n
    for rung in ladder:
        if rung >= n:
            return rung
    return n


def lane_ladder() -> list[int]:
    """The active lane ladder's rungs; empty when lane padding is off."""
    ladder = _lane_ladder()
    return [] if ladder is None else list(ladder)


def rf_bucket(max_rf: int) -> int:
    r = int(max_rf)
    if not enabled():
        return r
    for rung in _RF_LADDER:
        if rung >= r:
            return rung
    return _round_up(r, 4)


def ladder(n: int = 16) -> list[int]:
    """The first ``n`` rungs of the active partition ladder (a custom
    ``KAO_BUCKETS`` ladder's rungs, at most ``n``)."""
    custom = _custom_ladder()
    if custom is not None:
        return custom[:n]
    out, v = [], _LADDER_BASE
    for _ in range(n):
        out.append(v)
        v = _next_rung(v)
    return out


def bucket_shape(inst) -> tuple[int, int]:
    """(partition-bucket, rf-bucket) for a ProblemInstance."""
    return part_bucket(inst.num_parts), rf_bucket(inst.max_rf)


class CacheStats:
    """Process-wide cache counters under the reference's keys (its
    ``bucket.STATS``, which counts XLA executables). This package compiles
    no executable per shape, so here:

    - ``bucket_hits``/``bucket_misses``/``padded_solves``: as in the
      reference, a solve whose bucket key was seen before or not, and a
      solve whose arrays were padded;
    - ``exec_hits``: a chunk dispatch whose kernels were built and whose
      graphs were captured already; ``exec_misses``: one that paid a
      kernel build (``nvcc``) or a CUDA-graph capture;
      ``exec_fallbacks``: one that ran on the plain versions after a
      kernel fault;
    - ``compiles_total``/``compile_seconds_total``: the kernel builds and
      graph captures those misses paid, and their seconds.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._seen_buckets: set = set()
        self._c = {
            "bucket_hits": 0,
            "bucket_misses": 0,
            "padded_solves": 0,
            "exec_hits": 0,
            "exec_misses": 0,
            "compiles_total": 0,
            "compile_seconds_total": 0.0,
            "exec_fallbacks": 0,
        }

    def record_bucket(self, key: tuple, padded: bool) -> bool:
        """Record one solve's bucket key; returns True on a bucket hit."""
        with self._lock:
            hit = key in self._seen_buckets
            self._seen_buckets.add(key)
            self._c["bucket_hits" if hit else "bucket_misses"] += 1
            if padded:
                self._c["padded_solves"] += 1
        return hit

    def record_exec(self, hit: bool, compile_s: float = 0.0,
                    fallback: bool = False) -> None:
        with self._lock:
            self._c["exec_hits" if hit else "exec_misses"] += 1
            if not hit and not fallback:
                self._c["compiles_total"] += 1
                self._c["compile_seconds_total"] += float(compile_s)
            if fallback:
                self._c["exec_fallbacks"] += 1

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
            out["buckets_seen"] = len(self._seen_buckets)
        out["compile_seconds_total"] = round(out["compile_seconds_total"], 4)
        return out

    def seen(self) -> list:
        """The bucket keys this process has solved."""
        with self._lock:
            return sorted(list(k) for k in self._seen_buckets
                          if isinstance(k, tuple))


STATS = CacheStats()
