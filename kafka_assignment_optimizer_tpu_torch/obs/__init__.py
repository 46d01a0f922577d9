"""Observability of the solve path, copies of the reference package's
``obs`` modules (``obs.prof`` and ``obs.sampler`` read the card through
PyTorch where the reference read JAX):

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
- ``obs.prof`` — the roofline observatory: each ladder dispatch key's
  analytic cost (the three CUDA launches' bytes and INT32 operations),
  enqueue-to-retire occupancy, ledger attribution, dispatch gaps
  (``GET /debug/profile``; ``python -m ...obs.prof`` offline).
- ``obs.sampler`` — the device sampler: card memory and the duty cycle
  (``--sample-devices``, ``/healthz`` ``devices``).
- ``obs.slo``, ``obs.drift`` — burn rates and drift alarms over the
  flight stream (``GET /debug/slo``).
- ``obs.regress`` — the bench-artifact regression gate.
- ``obs.chrome``, ``obs.trace_cli`` — solve reports as Chrome
  trace-event JSON (``?format=chrome``) and the offline tooling.
"""

from . import log, trace  # noqa: F401
