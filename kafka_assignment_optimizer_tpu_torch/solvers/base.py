"""Solver backend registry.

The same backends, under the same names, as the reference package:

- ``milp``     exact 0-1 ILP via scipy/HiGHS (host)
- ``lp_solve`` the upstream solver's LP dialect through an ``lp_solve``
  binary, or the bundled work-alike CLI (host)
- ``native``   bundled C++ branch-and-bound (host)
- ``tpu``      the annealing engine — the name is the reference's; here it
  runs on the card unless the caller passes ``device="cpu"``
- ``auto``     the exact ILP for small instances, ``tpu`` at scale

The host backends touch no device and take no ``device`` keyword.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..models.instance import ProblemInstance


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


def available_solvers() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def get_solver(name: str) -> Callable[..., SolveResult]:
    _load_all()
    if name == "auto":
        return _auto_solve
    if name not in _REGISTRY:
        detail = ""
        if name in _LOAD_ERRORS:
            detail = f"; backend failed to import:\n{_LOAD_ERRORS[name]}"
        raise KeyError(
            f"unknown solver {name!r}; available: {available_solvers()}{detail}"
        )
    return _REGISTRY[name]


_LOAD_ERRORS: dict[str, str] = {}


def _load_all() -> None:
    # import for registration side effects; optional backends degrade
    # softly but record *why* they are unavailable
    import importlib
    import traceback

    from . import milp  # noqa: F401

    for name, mod in [
        ("lp_solve", ".lp"),
        ("native", ".native"),
        ("tpu", ".tpu.engine"),
    ]:
        if name in _REGISTRY or name in _LOAD_ERRORS:
            continue
        try:
            importlib.import_module(mod, package=__package__)
        except Exception:
            _LOAD_ERRORS[name] = traceback.format_exc(limit=3)


def resolve_solver(name: str, inst: ProblemInstance) -> str:
    """The concrete registry solver ``name`` will run on ``inst``:
    ``"auto"`` is the exact ILP when its variable space (``2·B·P``) is at
    most 20,000, else the device engine — whether or not the engine
    imported, so that a broken engine raises (with its import error)
    instead of a large solve running on the host; every other name
    passes through."""
    if name != "auto":
        return name
    nvars = 2 * inst.num_brokers * inst.num_parts
    return "milp" if nvars <= 20_000 else "tpu"


def _auto_solve(inst: ProblemInstance, **kw) -> SolveResult:
    """The solver ``resolve_solver("auto", inst)`` names. The host
    backends take no ``device``: the keyword reaches the device engine
    only."""
    name = resolve_solver("auto", inst)
    if name != "tpu":
        kw.pop("device", None)
    return get_solver(name)(inst, **kw)
