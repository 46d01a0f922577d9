"""Observability of the solve path, copies of the reference package's
jax-free ``obs`` modules:

- ``obs.trace`` — the nested-span tracer: every traced solve produces a
  solve report (span tree + annealing trajectory summary) registered in
  a ring buffer keyed by trace ID (``GET /debug/solves/<trace_id>``),
  with per-phase latency histograms; W3C ``traceparent`` inject/extract.
- ``obs.log`` — one-line ``key=value`` structured logger; appends the
  active trace ID.
- ``obs.flight`` — the per-solve flight recorder: one compact
  cost+quality record per solve/delta/batch-lane, in memory and as
  crash-safe JSONL (``--flight-dir``), feeding ``kao_solve_seconds``.
- ``obs.expo`` — the Prometheus text-exposition helpers.
"""

from . import log, trace  # noqa: F401
