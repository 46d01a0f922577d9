"""PyTorch port: the optimality machinery the engine's certificates stand
on — the exact move lower bound, the weight upper bound (tier 0 and the
tight tier 1), the exact leader reseat, ``certify_optimal`` and the
native min-cost max-flow — equal to the JAX package's on the same
instances (the demo, seeded random clusters, and a case whose balance
bands bind)."""

import numpy as np
import pytest

from kafka_assignment_optimizer_tpu import build_instance as jax_build
from kafka_assignment_optimizer_tpu.native import mcmf as jax_mcmf
from kafka_assignment_optimizer_tpu.solvers.milp import solve_milp
from kafka_assignment_optimizer_tpu.solvers.tpu.seed import (
    greedy_seed as jax_greedy_seed,
)
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.native import mcmf
from kafka_assignment_optimizer_tpu_torch.solvers.tpu.seed import greedy_seed

from tests.test_torch_engine import port_cluster
from tests.test_tpu_engine import random_cluster

CASES = {
    "cluster0": dict(seed=0, n_brokers=10, n_parts=30, rf=3, n_racks=3,
                     drop=1),
    "cluster1": dict(seed=1, n_brokers=12, n_parts=24, rf=2, n_racks=2,
                     drop=2),
    "cluster2": dict(seed=2, n_brokers=9, n_parts=20, rf=3, n_racks=3,
                     drop=0),
    # a scale-out: the old brokers hold every replica, so the new
    # brokers' replica floors bind
    "caps_bind": dict(seed=3, n_brokers=8, n_parts=24, rf=2, n_racks=2,
                      drop=-4),
}


def _case(name, demo):
    if name == "demo":
        return demo
    kw = dict(CASES[name])
    rng = np.random.default_rng(kw.pop("seed"))
    drop = kw.pop("drop")
    current, brokers, topo = random_cluster(rng, drop=max(drop, 0), **kw)
    if drop < 0:  # grow the cluster by -drop empty brokers
        nb = kw["n_brokers"]
        brokers = list(range(nb - drop))
        topo.rack_of.update({b: f"r{b % kw['n_racks']}"
                             for b in range(nb, nb - drop)})
    return current, brokers, topo


@pytest.mark.parametrize("name", ["demo", *CASES])
def test_bounds_reseat_and_certificate_match_reference(name, demo):
    current, brokers, topo = _case(name, demo)
    ij = jax_build(current, brokers, topo)
    it = build_instance(*port_cluster(current, brokers, topo))
    if name == "caps_bind":
        assert it.caps_bind()
    assert it.move_lower_bound_exact() == ij.move_lower_bound_exact()
    assert it.weight_upper_bound() == ij.weight_upper_bound()
    assert it.weight_upper_bound(tight=True) == ij.weight_upper_bound(
        tight=True)
    assert it.best_known_weight_ub() == ij.best_known_weight_ub()
    seed = greedy_seed(it)
    np.testing.assert_array_equal(seed, jax_greedy_seed(ij))
    for a in (seed, solve_milp(ij).a):
        a = np.asarray(a, np.int32)
        np.testing.assert_array_equal(it.best_leader_assignment(a),
                                      ij.best_leader_assignment(a))
        assert it.certify_optimal(a) == ij.certify_optimal(a)
        assert it.certify_optimal(a, allow_tight=False) == \
            ij.certify_optimal(a, allow_tight=False)


def test_mcmf_matches_reference():
    """The bundled min-cost max-flow kernel (its own copy of the C++
    source, built with g++ at first use) on seeded layered networks."""
    rng = np.random.default_rng(11)
    for _ in range(4):
        n_mid = int(rng.integers(3, 9))
        s, t = 0, 2 * n_mid + 1
        src, dst = [], []
        for i in range(1, n_mid + 1):
            src.append(s)
            dst.append(i)
            for j in rng.choice(n_mid, size=3, replace=False):
                src.append(i)
                dst.append(n_mid + 1 + int(j))
        for j in range(n_mid + 1, 2 * n_mid + 1):
            src.append(j)
            dst.append(t)
        cap = rng.integers(1, 5, size=len(src))
        cost = rng.integers(-3, 6, size=len(src))
        cost[np.asarray(src) == s] = 0
        args = (np.asarray(src), np.asarray(dst), cap, cost, s, t,
                2 * n_mid + 2)
        f_t, c_t, arcs_t = mcmf(*args)
        f_j, c_j, arcs_j = jax_mcmf(*args)
        assert (f_t, c_t) == (f_j, c_j)
        np.testing.assert_array_equal(arcs_t, arcs_j)
