"""PyTorch port: the exact host backends — ``milp`` (scipy/HiGHS),
``native`` (the bundled C++ branch-and-bound) and ``lp_solve`` (the
bundled lp_solve work-alike CLI) — give the JAX package's plan and
objective, and ``"auto"`` resolves as the reference resolves."""

import numpy as np
import pytest

from kafka_assignment_optimizer_tpu import build_instance as jax_build
from kafka_assignment_optimizer_tpu.solvers import base as jbase
from kafka_assignment_optimizer_tpu_torch import optimize
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.solvers import base

from tests.test_torch_engine import port_cluster
from tests.test_tpu_engine import random_cluster

CLUSTERS = [dict(n_brokers=8, n_parts=10, rf=2, n_racks=2, drop=1),
            dict(n_brokers=9, n_parts=8, rf=3, n_racks=3, drop=1)]


def _pair(case, demo, seed):
    if case is None:
        current, brokers, topo = demo
    else:
        current, brokers, topo = random_cluster(
            np.random.default_rng(seed), **case)
    return (jax_build(current, brokers, topo),
            build_instance(*port_cluster(current, brokers, topo)))


@pytest.mark.parametrize("solver", ["milp", "native", "lp_solve"])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_exact_backend_matches_reference(solver, which, demo):
    case = None if which == 0 else CLUSTERS[which - 1]
    ij, it = _pair(case, demo, which)
    ref = jbase.get_solver(solver)(ij)
    got = base.get_solver(solver)(it)
    assert got.solver == ref.solver
    assert got.optimal == ref.optimal
    assert got.objective == ref.objective
    np.testing.assert_array_equal(got.a, ref.a)
    assert it.is_feasible(got.a)
    if solver == "lp_solve":
        assert got.stats["backend"] == ref.stats["backend"]


def test_lp_solve_reports_bundled_backend(demo):
    res = optimize(*port_cluster(*demo), solver="lp_solve")
    rep = res.report()
    assert rep["solver_backend"] == "bundled_lp_cli"
    assert rep["proven_optimal"] and res.replica_moves == 1


def test_auto_resolves_as_reference(demo):
    ij, it = _pair(None, demo, 0)
    assert base.resolve_solver("auto", it) == \
        jbase.resolve_solver("auto", ij) == "milp"
    # past 20,000 MILP variables: the device engine (resolve only)
    big = random_cluster(np.random.default_rng(0), n_brokers=64,
                         n_parts=200, rf=3, n_racks=4, drop=0)
    ij, it = (jax_build(*big), build_instance(*port_cluster(*big)))
    assert 2 * it.num_brokers * it.num_parts > 20_000
    assert base.resolve_solver("auto", it) == \
        jbase.resolve_solver("auto", ij) == "tpu"
    assert base.resolve_solver("native", it) == "native"
    assert set(base.available_solvers()) == {
        "milp", "native", "lp_solve", "tpu"}


def test_auto_raises_when_the_engine_fails_to_import(monkeypatch, demo):
    """A device engine that fails to import must not turn ``"auto"`` on a
    large instance into a host solve: it resolves to ``tpu`` all the same
    and the solve raises with the import error, while a small instance
    still runs the exact ILP."""
    import sys

    monkeypatch.delitem(base._REGISTRY, "tpu")
    monkeypatch.setattr(base, "_LOAD_ERRORS", {})
    monkeypatch.setitem(
        sys.modules, "kafka_assignment_optimizer_tpu_torch.solvers.tpu.engine",
        None)
    assert "tpu" not in base.available_solvers()
    assert "tpu" in base._LOAD_ERRORS
    big = random_cluster(np.random.default_rng(0), n_brokers=64,
                         n_parts=200, rf=3, n_racks=4, drop=0)
    it = build_instance(*port_cluster(*big))
    assert base.resolve_solver("auto", it) == "tpu"
    with pytest.raises(KeyError, match="backend failed to import"):
        base.get_solver("auto")(it, device="cpu")
    small = base.get_solver("auto")(_pair(None, demo, 0)[1], device="cpu")
    assert small.solver == "milp" and small.optimal
