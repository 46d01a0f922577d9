"""Solver backend registry.

This package has one backend so far, ``"tpu"`` — the name the reference
package gives its device annealing engine, kept so that calls match the
reference's call for call (it runs on the card here). ``"auto"``
resolves to it; the reference's exact backends (``milp``, ``lp_solve``,
``native``) are not part of this package yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass
class SolveResult:
    """A solved candidate in broker-index space plus solver telemetry."""

    a: np.ndarray  # [P, R] int32 broker indices, slot 0 = leader
    solver: str
    wall_clock_s: float = 0.0
    objective: int | None = None  # preservation weight achieved
    optimal: bool = False  # proven optimal
    stats: dict = field(default_factory=dict)


_REGISTRY: dict[str, Callable[..., SolveResult]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def _load_all() -> None:
    from .tpu import engine  # noqa: F401  (registers "tpu")


def available_solvers() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def get_solver(name: str) -> Callable[..., SolveResult]:
    """The registered solver ``name``; ``"auto"`` is the device engine,
    the only backend of this package."""
    _load_all()
    if name == "auto":
        name = "tpu"
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown solver {name!r}; available: {available_solvers()}"
        )
    return _REGISTRY[name]
