"""PyTorch port: the steepest-descent polish against the JAX package's
``polish`` on the same candidates — the same moves in the same order
(first index on ties), so the same final plan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_assignment_optimizer_tpu.solvers.tpu.polish import (
    polish as jax_polish,
)
from kafka_assignment_optimizer_tpu_torch.solvers.tpu.polish import polish

from tests.test_torch_arrays import assert_same, fast_jit, pair

_J_POLISH = fast_jit(jax_polish, static_argnames=("max_moves",))


def _candidates(inst, rng, n):
    """Random candidates with distinct brokers in every row."""
    out = []
    for _ in range(n):
        a = np.full(inst.a0.shape, inst.num_brokers, np.int32)
        for p in range(inst.num_parts):
            rf = int(inst.rf[p])
            a[p, :rf] = rng.choice(inst.num_brokers, size=rf, replace=False)
        out.append(a)
    return out


@pytest.mark.parametrize("case", [
    dict(nb=10, npart=14, rf=3, nr=3, drop=1),
    dict(nb=8, npart=10, rf=2, nr=2, drop=0),
])
def test_polish_matches_reference(case, rng):
    inst, mj, mt = pair(rng, **case)
    for a in _candidates(inst, rng, 2) + [inst.a0.copy()]:
        ref = np.asarray(_J_POLISH(mj, jnp.asarray(a)))
        got = polish(mt, torch.from_numpy(a))
        assert_same(ref, got)
        assert inst.preservation_weight(got.numpy()) >= 0


def test_polish_respects_move_cap(rng):
    inst, mj, mt = pair(rng, nb=10, npart=14, rf=3, nr=3, drop=1)
    a = _candidates(inst, rng, 1)[0]
    ref = np.asarray(_J_POLISH(mj, jnp.asarray(a), max_moves=2))
    got = polish(mt, torch.from_numpy(a), max_moves=2)
    assert_same(ref, got)
    assert int((got.numpy() != a).any(1).sum()) <= 2
