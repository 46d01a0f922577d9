"""Reduce-phase stitch: per-group local plans -> one global plan.

Pure index translation — each group's local broker indices map back
through its global broker list (local null ``B_g`` -> global null
``B``), and each group's partition rows scatter into their original
global positions. Because sub-feasibility nests under the flat
instance (see split.py), the stitched plan needs no repair; the
orchestrator still runs the flat instance's oracle
(``inst.violations``) over the result so quality is never taken on
faith.

A copy of ``kafka_assignment_optimizer_tpu.decompose.stitch``;
per-partition work stays vectorized, Python loops range only over
groups.
"""

from __future__ import annotations

import numpy as np

from ..models.instance import ProblemInstance
from .split import Split


def stitch(inst: ProblemInstance, sp: Split,
           lane_plans: list[np.ndarray]) -> np.ndarray:
    """Scatter each group's local plan ``[P_g, R]`` back into a global
    ``[P, R]`` candidate in flat broker-index space."""
    P, R = inst.a0.shape
    B = inst.num_brokers
    a = np.full((P, R), B, np.int32)
    for g in range(sp.n_groups):
        glob = np.append(sp.broker_idx[g], B).astype(np.int32)
        a[sp.part_idx[g]] = glob[np.asarray(lane_plans[g], np.int64)]
    return a


def lane_feasible(lane_results) -> list[bool]:
    """Per-lane feasibility flags from the map phase's SolveResults."""
    return [bool(r is not None and r.stats.get("feasible"))
            for r in lane_results]
