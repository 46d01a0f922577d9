"""Observability of the solve path: so far the structured log lines the
degradation ladder, the chaos harness and the decomposed solve emit."""
