"""High-level entry points: ``optimize()`` — parse, build the model, solve,
decode, diff (the reference package's ``api.optimize``, call for call) —
``optimize_delta()``, the same warm-started from the previous plan after
a cluster event, ``optimize_batch()``, L prebuilt instances in one lane
ladder, and ``evaluate()``, the audit of an existing plan against the
model and its bounds (host work only).

The solve runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence

from .models.cluster import Assignment, MoveReport, Topology, move_diff
from .models.instance import ProblemInstance, build_instance
from .solvers.base import SolveResult, get_solver


@dataclass
class OptimizeResult:
    """The plan, the move diff vs the current assignment, and solver
    telemetry."""

    assignment: Assignment
    moves: MoveReport
    solve: SolveResult
    instance: ProblemInstance = field(repr=False, default=None)
    wall_clock_s: float = 0.0

    @property
    def replica_moves(self) -> int:
        return self.moves.replica_moves

    def report(self) -> dict:
        viol = self.instance.violations(self.solve.a)
        return {
            "solver": self.solve.solver,
            "replica_moves": self.moves.replica_moves,
            "leader_changes": self.moves.leader_changes,
            "objective_weight": self.instance.preservation_weight(
                self.solve.a),
            # the tightest weight bound already computed for this
            # instance (memoized by a certificate), else the
            # unconstrained per-partition optimum
            "objective_upper_bound": (
                self.instance.best_known_weight_ub()
                if self.instance.best_known_weight_ub() is not None
                else self.instance.max_weight()
            ),
            "violations": viol,
            "feasible": all(v == 0 for v in viol.values()),
            "proven_optimal": self.solve.optimal,
            "solver_wall_clock_s": round(self.solve.wall_clock_s, 4),
            "total_wall_clock_s": round(self.wall_clock_s, 4),
            "brokers": self.instance.num_brokers,
            "partitions": self.instance.num_parts,
            "racks": self.instance.num_racks,
            **{f"solver_{k}": v for k, v in self.solve.stats.items()
               if isinstance(v, (int, float, str, bool))},
            # the degradation rungs the solve took: a list, which the
            # scalar fold above drops, but a degraded plan must not read
            # as a searched one
            **({"degradations": list(self.solve.stats["degradations"])}
               if self.solve.stats.get("degradations") else {}),
            # which portfolio lane produced the plan, and the fused
            # ladder's provenance: dicts, which the scalar fold drops,
            # but they belong on the serving surface
            **({"solver_portfolio": dict(self.solve.stats["portfolio"])}
               if self.solve.stats.get("portfolio") else {}),
            **({"solver_megachunk": dict(self.solve.stats["megachunk"])}
               if self.solve.stats.get("megachunk") else {}),
        }


def optimize(
    current: Assignment | str | dict,
    broker_list: Sequence[int],
    topology: Topology | dict | None = None,
    target_rf: int | dict | None = None,
    solver: str = "auto",
    instance: ProblemInstance | None = None,
    **solver_kwargs,
) -> OptimizeResult:
    """Compute a minimal-move, constraint-satisfying reassignment plan.

    Arguments mirror the reference package's ``optimize``: the current
    assignment (JSON text, dict, or :class:`Assignment`), the target
    broker list, the broker->rack topology, and optionally a new
    replication factor. ``device`` (a keyword of the ``tpu`` solver,
    which ``"auto"`` passes on only when it resolves there) picks the
    solve device: the card by default, ``"cpu"`` on request. The ``tpu``
    solver's other keywords pass through as in the reference, among
    them ``pipeline`` (the double-buffered ladder, on by default),
    ``megachunk`` (K chunks a fused group) and ``checkpoint`` (an
    ``.npz`` to resume from and save to).
    """
    t0 = time.perf_counter()
    if isinstance(current, str):
        current = Assignment.from_json(current)
    elif isinstance(current, dict):
        current = Assignment.from_dict(current)
    if isinstance(topology, dict):
        topology = Topology.from_dict(topology)
    inst = (
        instance if instance is not None
        else build_instance(current, broker_list, topology, target_rf)
    )
    t_build = time.perf_counter()
    result = get_solver(solver)(inst, **solver_kwargs)
    result.stats["build_s"] = round(t_build - t0, 4)
    plan = inst.decode(result.a)
    out = OptimizeResult(
        assignment=plan,
        moves=move_diff(current, plan),
        solve=result,
        instance=inst,
        wall_clock_s=time.perf_counter() - t0,
    )
    if result.solver != "tpu":
        # the device engine records its own flight record; the exact
        # host backends have none, so theirs lands here
        from .obs import flight as _flight

        _flight.record_optimize(out)
    return out


def optimize_delta(
    current: Assignment | str | dict,
    broker_list: Sequence[int],
    topology: Topology | dict | None = None,
    target_rf: int | dict | None = None,
    prev_plan: Assignment | str | dict | None = None,
    solver: str = "auto",
    instance: ProblemInstance | None = None,
    **solver_kwargs,
) -> OptimizeResult:
    """One step of the cluster-watch delta path: :func:`optimize`,
    warm-started from ``prev_plan`` — the previous plan adapted to the
    post-event topology (dead brokers and racks evicted, surviving
    replicas kept in place, ``watch.adapt.adapt_plan``). Adaptation that
    produces no usable candidate takes the ``warm_start_rejected`` rung
    and the solve runs cold; solvers without a warm-start path (the
    exact host backends certify from scratch anyway) ignore it.
    ``device`` as for :func:`optimize`.
    """
    if isinstance(current, str):
        current = Assignment.from_json(current)
    elif isinstance(current, dict):
        current = Assignment.from_dict(current)
    if isinstance(topology, dict):
        topology = Topology.from_dict(topology)
    if isinstance(prev_plan, str):
        prev_plan = Assignment.from_json(prev_plan)
    elif isinstance(prev_plan, dict):
        prev_plan = Assignment.from_dict(prev_plan)

    inst = (
        instance if instance is not None
        else build_instance(current, broker_list, topology, target_rf)
    )
    from .solvers.base import resolve_solver

    solver_eff = resolve_solver(solver, inst)
    if solver_eff != "tpu":
        # the host backends take no device
        solver_kwargs.pop("device", None)
    if prev_plan is not None and solver_eff == "tpu":
        from .resilience import ladder as _ladder
        from .watch.adapt import adapt_plan

        warm_a, reason = adapt_plan(inst, prev_plan)
        if warm_a is None:
            # rejection is a ladder step, not a silent downgrade (the
            # engine's own validator covers the in-engine cases)
            _ladder.note_rung("warm_start_rejected", reason=reason[:200])
        else:
            solver_kwargs.setdefault("warm_start", warm_a)
    return optimize(
        current, broker_list, topology, target_rf=target_rf,
        solver=solver_eff, instance=inst, **solver_kwargs,
    )


def optimize_batch(
    currents: Sequence[Assignment],
    instances: Sequence[ProblemInstance],
    seeds: int | Sequence[int] = 0,
    **solver_kwargs,
) -> list[OptimizeResult]:
    """Solve L independent prebuilt instances in one lane ladder
    (``solvers.tpu.engine.solve_tpu_batch``) and decode each lane back to
    its own plan and move diff. ``currents[i]`` must be the assignment
    ``instances[i]`` was built from (the diff is computed against it).
    ``device`` picks the solve device: the card by default, ``"cpu"`` on
    request; ``pipeline`` and ``megachunk`` schedule the lane ladder."""
    if len(currents) != len(instances):
        raise ValueError(
            f"{len(currents)} assignments for {len(instances)} instances"
        )
    from .solvers.tpu.engine import solve_tpu_batch

    t0 = time.perf_counter()
    results = solve_tpu_batch(list(instances), seeds=seeds, **solver_kwargs)
    wall = time.perf_counter() - t0
    out = []
    for current, inst, res in zip(currents, instances, results):
        plan = inst.decode(res.a)
        out.append(OptimizeResult(
            assignment=plan,
            moves=move_diff(current, plan),
            solve=res,
            instance=inst,
            wall_clock_s=wall,
        ))
    return out


def evaluate(
    current: Assignment | str | dict,
    broker_list: Sequence[int],
    plan: Assignment | str | dict,
    topology: Topology | dict | None = None,
    target_rf: int | dict | None = None,
    time_budget_s: float | None = None,
) -> dict:
    """Audit an EXISTING plan — ours, another tool's, or
    ``kafka-reassign-partitions`` output — against the same model and
    bounds every solver uses (the reference package's ``api.evaluate``).
    Returns a JSON-able report: feasibility with per-constraint
    violation counts, replica moves vs the provable minimum, objective
    weight vs its provable upper bound, and whether the plan is
    certifiably globally optimal. Host work only: no device is touched.
    ``time_budget_s`` caps the bound LPs; expired tiers fall back to
    cheaper bounds (looser verdicts, never a blown deadline)."""
    if isinstance(current, str):
        current = Assignment.from_json(current)
    elif isinstance(current, dict):
        current = Assignment.from_dict(current)
    if isinstance(plan, str):
        plan = Assignment.from_json(plan)
    elif isinstance(plan, dict):
        plan = Assignment.from_dict(plan)
    if isinstance(topology, dict):
        topology = Topology.from_dict(topology)

    inst = build_instance(current, broker_list, topology, target_rf)
    if time_budget_s is not None:
        inst.set_bounds_deadline(time_budget_s)
    a = inst.encode(plan)
    viol = inst.violations(a)
    feasible = all(v == 0 for v in viol.values())
    # diff the plan AS GIVEN (an infeasible plan may reference
    # ineligible brokers, which the index space cannot round-trip)
    moves = move_diff(current, plan)
    weight = inst.preservation_weight(a)
    return {
        "feasible": feasible,
        "violations": viol,
        "replica_moves": moves.replica_moves,
        "min_moves_lower_bound": inst.move_lower_bound_exact(),
        "leader_changes": moves.leader_changes,
        "objective_weight": weight,
        "objective_upper_bound": inst.weight_upper_bound(level=2),
        # exact-flow-tier declines (int32 overflow -> LP fallback):
        # nonzero means the bound above may be the looser tier
        "flow_bound_declines": getattr(inst, "_flow_big_declines", 0),
        "proven_optimal": feasible and inst.certify_optimal(a),
        "brokers": inst.num_brokers,
        "partitions": inst.num_parts,
        "racks": inst.num_racks,
    }
