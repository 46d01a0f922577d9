"""Resilience primitives of the solve path: the per-solve deadline
budget."""
