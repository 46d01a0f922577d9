"""PyTorch port: B1 (exact chain scoring and histograms) and the plain
scorers against the JAX package — the XLA scorer, the sweep's
from-scratch histograms, the numpy oracle, and once the Pallas kernel in
interpret mode. Exact equality: every output is an integer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_assignment_optimizer_tpu.ops.score import (
    moves_batch as jax_moves,
    moves_one as jax_moves_one,
    score_batch as jax_score_batch,
    score_one as jax_score_one,
)
from kafka_assignment_optimizer_tpu.ops.score_pallas import (
    score_batch_pallas,
)
from kafka_assignment_optimizer_tpu.solvers.tpu import sweep as jsweep
from kafka_assignment_optimizer_tpu_torch.ops import score as tscore
from kafka_assignment_optimizer_tpu_torch.ops import score_cuda

from tests.test_torch_arrays import assert_same, chains, fast_jit, pair


@pytest.mark.parametrize("case", [
    dict(nb=12, npart=20, rf=3, nr=3, drop=1),
    dict(nb=20, npart=33, rf=4, nr=5, drop=2, bucket=(48, 4)),
    dict(nb=6, npart=9, rf=1, nr=2, drop=0),
    # B1 takes any broker count: its kernel counts in device memory above
    # about 29,000 brokers, held on the card to this plain version
    dict(nb=40_001, npart=12, rf=3, nr=4, drop=1),
])
def test_score_matches_xla_scorer_and_oracle(case, rng):
    inst, mj, mt = pair(rng, **case)
    a = chains(inst, mj, rng, 4)
    a[1] = rng.integers(0, inst.num_brokers, size=a.shape[1:])  # infeasible
    aj, at = jnp.asarray(a), torch.from_numpy(a)

    ref = fast_jit(jax_score_batch)(aj, mj)
    got = tscore.score_batch(at, mt)
    for f in ref._fields:
        assert_same(getattr(ref, f), getattr(got, f), f)
    assert_same(fast_jit(jax_moves)(aj, mj), tscore.moves_batch(at, mt), "moves")
    one_j = fast_jit(jax_score_one)(aj[2], mj)
    one_t = tscore.score_one(at[2], mt)
    for f in one_j._fields:
        assert_same(getattr(one_j, f), getattr(one_t, f), f)
    assert int(fast_jit(jax_moves_one)(aj[2], mj)) == int(
        tscore.moves_one(at[2], mt))

    # B1's plain version == the sweep's from-scratch scorer
    for x, y in zip(fast_jit(jsweep._full_scores_xla)(mj, aj),
                    score_cuda.full_scores(mt, at)):
        assert_same(x, y)
    out, cnt, lcnt, rcnt = score_cuda.score(mt, at)  # CPU: plain version
    assert_same(ref.weight, out[:, 0])
    assert_same(np.stack([ref.pen_broker, ref.pen_leader, ref.pen_rack,
                          ref.pen_part_rack], 1), out[:, 1:5])
    # column 5: the moves, the reference's XLA moves_batch; zeros after
    assert_same(fast_jit(jax_moves)(aj, mj), out[:, 5], "B1 moves")
    assert (out[:, 6:] == 0).all()

    # the numpy oracle on the real (unpadded) rows
    for n in range(a.shape[0]):
        real = a[n, :inst.num_parts, :inst.max_rf]
        v = inst.violations(real)
        assert int(out[n, 0]) == inst.preservation_weight(real)
        assert out[n, 1:5].tolist() == [
            v["broker_balance"], v["leader_balance"], v["rack_balance"],
            v["part_rack_diversity"]]


def test_score_matches_pallas_interpret(rng):
    inst, mj, mt = pair(rng, nb=10, npart=17, rf=3, nr=3, drop=1)
    a = chains(inst, mj, rng, 3)
    ref = score_batch_pallas(jnp.asarray(a), mj, interpret=True)
    out, cnt, lcnt, rcnt = score_cuda.score_plain(mt, torch.from_numpy(a))
    assert_same(ref.weight, out[:, 0])
    assert_same(ref.pen_broker, out[:, 1])
    assert_same(ref.pen_leader, out[:, 2])
    assert_same(ref.pen_rack, out[:, 3])
    assert_same(ref.pen_part_rack, out[:, 4])
    assert_same(ref.cnt, cnt)
    assert_same(ref.lcnt, lcnt)
    assert_same(ref.rcnt, rcnt)
    # the Pallas kernel leaves the moves to XLA (columns 5-7 zero)
    assert_same(jax_moves(jnp.asarray(a), mj), out[:, 5], "B1 moves")

