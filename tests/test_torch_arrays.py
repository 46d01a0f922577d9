"""PyTorch port: ``prng`` against ``jax.random`` and the model lowering
against the JAX package's ``arrays.from_instance``, leaf by leaf.

Also the helpers the other ``test_torch_*`` files share: one seeded
instance lowered by BOTH packages onto identical inputs (the JAX leaves
carried over with ``from_numpy``), and seeded perturbed chain
populations."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_assignment_optimizer_tpu import build_instance as jax_build
from kafka_assignment_optimizer_tpu.solvers.tpu import arrays as jarrays
from kafka_assignment_optimizer_tpu.solvers.tpu.seed import (
    greedy_seed as jax_greedy_seed,
)
from kafka_assignment_optimizer_tpu_torch import prng
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import arrays
from kafka_assignment_optimizer_tpu_torch.solvers.tpu.seed import greedy_seed

from tests.test_tpu_engine import random_cluster


def leaves(mj) -> dict:
    """The JAX ModelArrays leaves as numpy arrays."""
    return {f.name: np.asarray(getattr(mj, f.name))
            for f in dataclasses.fields(mj)}


def pair(rng, nb=14, npart=40, rf=3, nr=3, drop=1, bucket=None):
    """(inst, JAX model, port model on the CPU) for one seeded cluster;
    ``bucket`` = (parts, rf) pads both the way the engine does."""
    current, brokers, topo = random_cluster(rng, nb, npart, rf, nr,
                                            drop=drop)
    inst = jax_build(current, brokers, topo)
    kw = {} if bucket is None else dict(num_parts=bucket[0],
                                         max_rf=bucket[1])
    mj = jarrays.from_instance(inst, **kw)
    return inst, mj, arrays.from_numpy(leaves(mj), "cpu")


def chains(inst, mj, rng, n):
    """n chains: the greedy seed with seeded random slot noise (so the
    histograms and penalties differ per chain), padded slots null."""
    a0 = jarrays.pad_candidate(np.asarray(jax_greedy_seed(inst)), mj)
    a = np.broadcast_to(a0, (n, *a0.shape)).copy()
    sl = rng.integers(0, inst.max_rf, size=(n, inst.num_parts))
    bk = rng.integers(0, inst.num_brokers, size=(n, inst.num_parts))
    a[np.arange(n)[:, None], np.arange(inst.num_parts)[None, :], sl] = bk
    a[~np.broadcast_to(np.asarray(mj.slot_valid), a.shape)] = \
        inst.num_brokers
    return a.astype(np.int32)


def fast_jit(fn, **kw):
    """``jax.jit`` at the lowest XLA backend optimization level: the
    reference functions run on tiny shapes, where only the compile
    time counts."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0},
                   **kw)


def assert_same(x, y, what=""):
    """Exact equality of a JAX/numpy value and a torch/numpy value."""
    if isinstance(y, torch.Tensor):
        y = y.numpy()
    np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                  err_msg=what)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_prng_matches_jax_random(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert_same(kj, kt, "PRNGKey")
    assert_same(jax.random.split(kj), prng.split(kt), "split")
    assert_same(jax.random.split(kj, 5), prng.split(kt, 5), "split 5")
    assert_same(jax.random.fold_in(kj, 7), prng.fold_in(kt, 7), "fold_in")
    for shape in [(), (3,), (4, 5, 8)]:
        bj = np.asarray(jax.random.bits(kj, shape, jnp.uint32))
        assert_same(bj.astype(np.int64), prng.bits(kt, shape), "bits")
        assert_same(bj.astype(np.int64), prng.bits(kt, shape, "cpu"),
                    "bits on a torch device")
    # one compile per shape: the (6,) cases share theirs
    for shape, lo, hi in [((), 1, 5), ((), 1, 2), ((8, 1), 0, 74),
                          ((6,), 3, 3), ((6,), 0, 2**31 - 1),
                          ((6,), -5, 2**30 + 3)]:
        rj = np.asarray(jax.random.randint(kj, shape, lo, hi))
        assert_same(rj, prng.randint(kt, shape, lo, hi), "randint")
        assert_same(rj, prng.randint(kt, shape, lo, hi, "cpu"),
                    "randint on a torch device")


@pytest.mark.parametrize("bucket", [None, (48, 4)])
def test_from_instance_matches_reference_leaf_by_leaf(rng, bucket):
    current, brokers, topo = random_cluster(rng, 12, 30, 3, 3, drop=1)
    inst_j = jax_build(current, brokers, topo)
    inst_t = build_instance(current, brokers, topo)
    kw = {} if bucket is None else dict(num_parts=bucket[0],
                                         max_rf=bucket[1])
    lj = leaves(jarrays.from_instance(inst_j, **kw))
    mt = arrays.from_instance(inst_t, "cpu", **kw)
    mc = arrays.from_numpy(lj, "cpu")
    for name, x in lj.items():
        assert_same(x, getattr(mt, name), name)
        assert_same(x, getattr(mc, name), name)
        assert getattr(mt, name).dtype == getattr(mc, name).dtype
    # the host copies of the model and the seed agree too
    np.testing.assert_array_equal(greedy_seed(inst_t),
                                  jax_greedy_seed(inst_j))
    assert inst_t.max_weight() == inst_j.max_weight()
    assert inst_t.move_lower_bound() == inst_j.move_lower_bound()


def test_state_from_numpy_leaves_are_independent(rng):
    a = rng.integers(0, 5, size=(3, 6, 2)).astype(np.int32)
    st = arrays.state_from_numpy(
        (a, np.zeros(3), np.ones(3), a, prng.PRNGKey(1)), "cpu")
    assert st[0].data_ptr() != st[3].data_ptr()
    assert st[0].dtype == torch.int32 and st[4].dtype == np.uint32
    assert_same(a, st[3])


def test_u01_and_temps_match_reference():
    bits = np.array([0, 255, 256, 2**32 - 1, 2**31, 123456789], np.uint32)
    assert_same(jarrays.u01(jnp.asarray(bits)),
                arrays.u01(torch.tensor(bits.astype(np.int64))))
    assert_same(jarrays.geometric_temps(2.0, 0.02, 37),
                arrays.geometric_temps(2.0, 0.02, 37))
