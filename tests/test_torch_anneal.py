"""PyTorch port: the chain engine (``solvers/tpu/anneal.py``) against the
JAX package's — ``init_chain`` and whole rounds of ``make_round_runner``
(the steps of every chain and the best snapshot), each followed by
``_migrate`` (the one-device migration of the reference's mesh path),
give the reference's ``ChainState`` field for field, on a small
instance and on a bucket-padded one (``rf = 0`` rows, null slot
columns)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from kafka_assignment_optimizer_tpu.parallel.mesh import (
    AXIS,
    _shard_map,
    make_mesh,
)
from kafka_assignment_optimizer_tpu.solvers.tpu import anneal as janneal
from kafka_assignment_optimizer_tpu.solvers.tpu import arrays as jarrays
from kafka_assignment_optimizer_tpu.solvers.tpu.seed import (
    greedy_seed as jax_greedy_seed,
)
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import anneal, arrays

from tests.test_torch_arrays import assert_same, fast_jit, pair

N, STEPS = 16, 64
FIELDS = ("a", "cnt", "lcnt", "rcnt", "pen", "w", "key")


def _ref_round():
    """The reference's round on its mesh of one device (its engine's
    path: ``axis_name`` set, so the round ends with the migration)."""
    run = janneal.make_round_runner(STEPS, AXIS)
    sharded = _shard_map(
        run, mesh=make_mesh(1),
        in_specs=(P(), P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)),
    )
    return fast_jit(sharded)


_J_ROUND = _ref_round()


def _leaves(st) -> dict:
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def assert_state(ref, got, what):
    for name in FIELDS:
        x = np.asarray(getattr(ref, name))
        if name == "key":
            x = x.astype(np.int64)
        assert_same(x, getattr(got, name), f"{what}: {name}")


@pytest.mark.parametrize("bucket", [None, (48, 4)])
def test_init_chain_and_rounds_match_reference(bucket, rng):
    inst, mj, mt = pair(rng, nb=12, npart=40, rf=2, nr=2, drop=2,
                        bucket=bucket)
    seed = jarrays.pad_candidate(np.asarray(jax_greedy_seed(inst)), mj)
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    stj = jax.vmap(lambda k: janneal.init_chain(mj, jnp.asarray(seed), k))(
        keys)
    stt = anneal.init_chain(
        mt, torch.from_numpy(seed),
        torch.tensor(np.asarray(keys).astype(np.int64)))
    assert_state(stj, stt, "init_chain")
    bkj = janneal.best_key(stj)
    baj = jnp.broadcast_to(jnp.asarray(seed), (N, *seed.shape))
    bkt, bat = anneal.best_key(stt), stt.a.clone()
    assert_same(bkj, bkt, "best_key")
    run = anneal.make_round_runner(STEPS)
    for i, temp in enumerate((1.5, 0.3)):
        if i:
            # carry the reference's state across, as the engine's chunks
            # would: the port continues from the reference's leaves
            stt = arrays.chain_state_from_numpy(_leaves(stj), "cpu")
            bkt = torch.from_numpy(np.array(bkj))
            bat = torch.from_numpy(np.array(baj))
        stj, bkj, baj = _J_ROUND(mj, stj, bkj, baj, jnp.float32(temp))
        stt, bkt, bat = run(mt, stt, bkt, bat, np.float32(temp))
        # the round's migration, as the solver runs it after every round
        stt = anneal._migrate(stt, anneal.best_key(stt), 1)
        assert_state(stj, stt, f"round {i}")
        assert_same(bkj, bkt, f"round {i}: best_key")
        assert_same(baj, bat, f"round {i}: best_a")
        assert stt.a.dtype == torch.int32 and stt.a.data_ptr() != \
            bat.data_ptr()
