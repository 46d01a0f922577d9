"""PyTorch port: the lanes against the JAX package — the lane configs as
model data (``stack_models``, ``with_config``), the lane ladder, the
lane kernels' plain versions on a batch whose tables and bands differ,
``init_lane_state`` and the lane stepper over two chunks (every state
leaf equal to the reference's ``make_lane_stepper_fn`` on its mesh of
one, and lane 0 equal to the port's single-model stepper), and the
batch path (``solve_tpu_batch``, ``optimize_batch``) plan for plan.

The kernel wrappers run their plain versions here (CPU tensors); the
card holds the lane kernels to them (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_assignment_optimizer_tpu import build_instance as jax_build
from kafka_assignment_optimizer_tpu.api import optimize_batch as j_opt_batch
from kafka_assignment_optimizer_tpu.parallel import mesh as jpm
from kafka_assignment_optimizer_tpu.solvers.tpu import arrays as jarrays
from kafka_assignment_optimizer_tpu.solvers.tpu import bucket as jbucket
from kafka_assignment_optimizer_tpu.solvers.tpu import engine as jengine
from kafka_assignment_optimizer_tpu.solvers.tpu import sweep as js
from kafka_assignment_optimizer_tpu.utils import gen as jgen
from kafka_assignment_optimizer_tpu_torch import optimize_batch, prng
from kafka_assignment_optimizer_tpu_torch.models.cluster import Assignment
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.ops import (
    exchange_cuda,
    kernels,
    score_cuda,
    site_cuda,
)
from kafka_assignment_optimizer_tpu_torch.parallel import mesh as tpm
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import (
    arrays,
    bucket,
    engine,
)
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import sweep as ts

from tests.test_torch_arrays import (
    assert_same,
    chains,
    fast_jit,
    leaves,
    pair,
)
from tests.test_torch_engine import port_cluster

BUCKET = (48, 4)
N_STEP = 3
# lane configs of the stepper test: the default, a low penalty scale,
# and the compound move turned off
CFG_LANES = (0, 1, 5)

# the reference's lane stepper on its mesh of one device (the port's
# lanes always run the one-device migration)
_J_LANE_STEP = fast_jit(jax.vmap(
    js.make_lane_stepper_fn(N_STEP, axis_name="x"),
    in_axes=(None, 0, None), axis_name="x"))
_J_SITE_LANES = fast_jit(jax.vmap(js._site_sweep_delta))
_J_EXCH_LANES = fast_jit(jax.vmap(js._exchange_sweep_delta))
_J_SCORES_LANES = fast_jit(jax.vmap(js._histograms))


def _stacked(mj, mt, cfg_idx):
    cj = [jarrays.portfolio_configs(8)[i] for i in cfg_idx]
    ct = [arrays.portfolio_configs(8)[i] for i in cfg_idx]
    msj = jarrays.stack_models([jarrays.with_config(mj, c) for c in cj])
    mst = arrays.stack_models([arrays.with_config(mt, c) for c in ct])
    return msj, mst


def test_stack_models_and_configs_match_reference(rng):
    inst, mj, mt = pair(rng, bucket=BUCKET)
    msj, mst = _stacked(mj, mt, range(8))
    for f, x in leaves(msj).items():
        assert_same(x, getattr(mst, f), f)
    assert mst.num_lanes == 8 and mt.num_lanes == 0
    assert (mst.num_parts, mst.max_rf) == BUCKET
    # the portfolio's lanes share the model tables (lane stride 0) and
    # carry their own config scalars
    assert mst.w_lead.stride(0) == 0 and mst.lam.stride(0) == 1
    for i, c in enumerate(arrays.portfolio_configs(8)):
        lane = arrays.lane_model(mst, i)
        assert arrays.model_config(lane) == dataclasses.asdict(c)
        assert arrays.model_config(lane) == jarrays.model_config(
            jarrays.with_config(mj, jarrays.portfolio_configs(8)[i]))
    # a stack of the reference's stacked leaves is the port's stack
    ms2 = arrays.from_numpy(leaves(msj), "cpu")
    for f in leaves(msj):
        assert torch.equal(getattr(ms2, f), getattr(mst, f)), f
    # lanes must share a bucket
    _i2, _mj2, mt2 = pair(np.random.default_rng(3), bucket=(72, 4))
    with pytest.raises(ValueError, match="common bucket"):
        arrays.stack_models([mt, mt2])


def test_lane_groups_split_launches_past_the_limit(monkeypatch, rng):
    """More lanes than one launch takes run as launches of up to
    ``MAX_LANES`` lanes each, each on its lanes of the stacked model
    (views, the shared tables still at lane stride 0), the outputs
    concatenated in lane order; up to the limit, one launch on the model
    itself."""
    _inst, _mj, mt = pair(rng, bucket=BUCKET)
    ms = arrays.stack_models([arrays.with_config(mt, c)
                              for c in arrays.portfolio_configs(7)])
    monkeypatch.setattr(kernels, "MAX_LANES", 3)
    seen = []

    def launch(m, a, keys, temps):
        seen.append((m, a.shape[0], np.asarray(keys), list(temps)))
        return a + 1, (a * 2, torch.tensor(temps))

    a = torch.arange(7 * 2).reshape(7, 2)
    keys = np.stack([prng.fold_in(prng.PRNGKey(3), i) for i in range(7)])
    temps = [0.5 * i for i in range(7)]
    out = kernels.in_lane_groups(launch)(ms, a, keys, temps)
    assert [n for _m, n, _k, _t in seen] == [3, 3, 1]
    assert torch.equal(out[0], a + 1) and torch.equal(out[1][0], a * 2)
    assert out[1][1].tolist() == temps
    for (m, n, k, t), lo in zip(seen, (0, 3, 6)):
        assert m is arrays.lane_range(ms, lo, lo + n)
        assert m.num_lanes == n and m.w_lead.stride(0) == 0
        np.testing.assert_array_equal(k, keys[lo:lo + n])
        assert t == temps[lo:lo + n]
        assert m.lane_scalars() == tuple(x[lo:lo + n]
                                         for x in ms.lane_scalars())
        for j in range(n):
            for f, x in leaves(arrays.lane_model(m, j)).items():
                assert np.array_equal(
                    x, leaves(arrays.lane_model(ms, lo + j))[f]), f
    seen.clear()
    m3 = arrays.lane_range(ms, 0, 3)
    kernels.in_lane_groups(launch)(m3, a[:3], keys[:3], temps[:3])
    assert len(seen) == 1 and seen[0][0] is m3


@pytest.mark.parametrize("env", ["", "off", "2,4,8", "x,y", "16", "on"])
def test_lane_bucket_matches_reference(monkeypatch, env):
    monkeypatch.setenv("KAO_LANE_BUCKETS", env)
    for n in range(1, 10):
        assert bucket.lane_bucket(n) == jbucket.lane_bucket(n), (env, n)
    assert bucket.lane_ladder() == jbucket.lane_ladder()


def _lane_batch(n_inst=3, n=4):
    """Three instances of one bucket whose tables and bands differ, each
    with seeded chain noise; both packages' stacked models."""
    insts, mjs, mts, pops = [], [], [], []
    for i in range(n_inst):
        r = np.random.default_rng(10 + i)
        # 13 brokers in 3 racks in every lane; the bands differ
        inst, mj, mt = pair(r, nb=14 + i % 2, npart=40 - 4 * i, rf=3,
                            nr=3, drop=1 + i % 2, bucket=BUCKET)
        insts.append(inst)
        mjs.append(mj)
        mts.append(mt)
        pops.append(chains(inst, mj, r, n))
    return (insts, jarrays.stack_models(mjs), arrays.stack_models(mts),
            np.stack(pops))


def test_lane_kernels_plain_versions_match_reference():
    """The lane kernels' plain versions (B1, the site and the exchange
    sweep lane by lane, through the wrappers on CPU tensors) against the
    reference's functions under ``jax.vmap``, on a batch whose tables and
    bands differ, each lane with its own key and temperature."""
    _insts, msj, mst, a = _lane_batch()
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    assert mst.w_lead.stride(0) != 0  # the instances' own tables
    bands = mst.lane_scalars()[0]
    assert len(set(bands)) > 1  # and bands
    _f, _r, *hj = _J_SCORES_LANES(msj, aj)
    out, *ht = score_cuda.score_lanes(mst, at)
    for x, y in zip(hj, ht):
        assert_same(x, y)
    for lane in range(a.shape[0]):
        ref = score_cuda.score_plain(arrays.lane_model(mst, lane), at[lane])
        assert torch.equal(ref[0], out[lane])
    temps = [float(np.float32(t)) for t in (2.0, 0.3, 0.05)]
    kj = jnp.stack([jax.random.PRNGKey(20 + i) for i in range(3)])
    kt = [prng.PRNGKey(20 + i) for i in range(3)]
    tj = jnp.asarray(np.float32(temps))
    for fn_j, fn_t in ((_J_SITE_LANES, site_cuda.site_step_lanes),
                       (_J_EXCH_LANES, exchange_cuda.exchange_step_lanes)):
        outj = fn_j(msj, aj, *hj, kj, tj)
        outt = fn_t(mst, at, *ht, kt, temps)
        for x, y in zip(outj, outt):
            assert_same(x, y)
        assert (outt[0].numpy() != a).any()
    # the exchange lanes' records against each lane's own sweep
    _a2, _l2, rec, m_out, _m_in = exchange_cuda.exchange_sweep_lanes(
        mst, at, ht[1], kt, temps)
    for lane in range(3):
        solo = exchange_cuda.exchange_sweep_cuda(
            arrays.lane_model(mst, lane), at[lane], ht[1][lane], kt[lane],
            temps[lane])
        for x, y in zip(rec, solo[2]):
            assert torch.equal(x[lane], y)
        assert torch.equal(m_out[lane], solo[3])


@pytest.mark.parametrize("key_seed", [5])
def test_lane_stepper_matches_reference_and_solo(rng, key_seed):
    """``init_lane_state`` and two chunks of 8 sweeps of the lane stepper
    (L=3 lanes on portfolio configs 0, 1 and 5) equal the reference's
    ``init_lane_state`` and ``make_lane_stepper_fn`` leaf for leaf, and
    lane 0 equals the port's single-model stepper from ``init_sweep_state``
    with the same key."""
    inst, mj, mt = pair(rng, bucket=BUCKET)
    msj, mst = _stacked(mj, mt, CFG_LANES)
    seed = jarrays.pad_candidate(
        np.asarray(chains(inst, mj, np.random.default_rng(1), 1)[0]), mj)
    L = len(CFG_LANES)
    lane_seeds = np.stack([seed] * L)
    key = jax.random.PRNGKey(key_seed)
    kj = jnp.stack([key] + [jax.random.fold_in(key, i)
                            for i in range(1, L)])
    kt = np.stack([prng.PRNGKey(key_seed)]
                  + [prng.fold_in(prng.PRNGKey(key_seed), i)
                     for i in range(1, L)])
    assert_same(kj, kt)
    sj = tuple(np.asarray(x) for x in jpm.init_lane_state(
        msj, lane_seeds, kj, jpm.make_mesh(1), N_STEP))
    st = tpm.init_lane_state(mst, lane_seeds, kt, N_STEP)
    for x, y in zip(arrays.state_from_numpy(sj, "cpu"), st):
        assert_same(x, y)
    solo = tpm.init_sweep_state(arrays.lane_model(mst, 0),
                                torch.from_numpy(seed), kt[0], N_STEP)
    for x, y in zip(solo, st):
        assert_same(x, y[0])

    temps = np.asarray(jarrays.geometric_temps(2.0, 0.02, 16))
    step_t = ts.make_lane_stepper_fn(N_STEP, scorer="torch")
    step_s = ts.make_sweep_stepper_fn(N_STEP, scorer="torch")
    sj = tuple(jnp.asarray(x) for x in sj)
    moved = 0
    for chunk in (temps[:8], temps[8:]):
        sj, top_aj, top_kj, cv_j = _J_LANE_STEP(msj, sj, jnp.asarray(chunk))
        st, top_at, top_kt, cv_t = step_t(mst, st, chunk)
        solo, top_as, top_ks, cv_s = step_s(arrays.lane_model(mst, 0), solo,
                                            chunk)
        for x, y in zip(sj, st):
            assert_same(np.asarray(x)[0], y)
        assert_same(np.asarray(top_aj)[0], top_at)
        assert_same(np.asarray(top_kj)[0], top_kt)
        assert_same(np.asarray(cv_j)[0], cv_t)
        for x, y in zip(solo, st):
            assert_same(x, y[0])
        assert_same(top_as, top_at[0])
        assert_same(cv_s, cv_t[0])
        moved = int((st[0] != torch.from_numpy(seed)).any(-1).sum())
    assert moved > 0
    # the lanes' configs make their trajectories differ
    assert not torch.equal(st[0][0], st[0][1])


def _adv(seed, **kw):
    args = dict(n_brokers=32, n_topics_low=3, n_topics_high=3,
                parts_per_topic=10, seed=seed)
    args.update(kw)
    return jgen.adversarial(**args)


# three instances of mixed sizes (60, 54 and 48 partitions) that share
# one bucket, the reference's and the port's, with their currents
@pytest.fixture(scope="module")
def batch_cases():
    scens = [_adv(7), _adv(8, parts_per_topic=9), _adv(9, parts_per_topic=8)]
    ref = [jax_build(s.current, s.broker_list, s.topology) for s in scens]
    port = [port_cluster(s.current, s.broker_list, s.topology)
            for s in scens]
    return scens, ref, port


BATCH_KW = dict(engine="sweep", batch=4, rounds=16)
REF_KW = dict(n_devices=1, pipeline=False, megachunk=1)


def _served(mesh_mod, run):
    """``(run(), the lane dispatches run recorded)``: ``mesh_mod``'s
    lane-serve record is emptied for the run and restored after."""
    saved = mesh_mod._LANE_SERVED
    mesh_mod._LANE_SERVED = {}
    try:
        return run(), mesh_mod.lane_serve_report()
    finally:
        mesh_mod._LANE_SERVED = saved


@pytest.fixture(scope="module")
def ref_batch(batch_cases):
    scens, ref, _port = batch_cases
    return _served(jpm, lambda: j_opt_batch(
        [s.current for s in scens], ref, seeds=0, **BATCH_KW, **REF_KW))


@pytest.fixture(scope="module")
def port_batch(batch_cases):
    _scens, _ref, port = batch_cases
    insts = [build_instance(*c) for c in port]
    return insts, _served(tpm, lambda: engine.solve_tpu_batch(
        insts, seeds=0, device="cpu", **BATCH_KW))


def test_solve_tpu_batch_matches_reference(port_batch, ref_batch):
    ref_batch, _served_ref = ref_batch
    insts, (out, _served_port) = port_batch
    buckets = {r.stats["bucket_parts"] for r in out}
    assert buckets == {72} and len({i.num_parts for i in insts}) == 3
    for i, (rj, rt) in enumerate(zip(ref_batch, out)):
        rj = rj.solve
        np.testing.assert_array_equal(rt.a, rj.a)
        for f in ("engine", "lanes", "lane", "lane_bucket", "rounds_run",
                  "timed_out", "bucket_parts", "bucket_rf", "seed_moves",
                  "moves", "feasible", "violations", "score_curve"):
            assert rt.stats[f] == rj.stats[f], (i, f)
        assert rt.stats["lanes"] == 3 and rt.stats["lane_bucket"] == 8
    # lane 1 alone is the same solve: batching changes no lane's plan
    solo = engine.solve_tpu_batch([insts[1]], seeds=1, device="cpu",
                                  **BATCH_KW)[0]
    np.testing.assert_array_equal(solo.a, out[1].a)
    assert solo.stats["lane_bucket"] == 1


def test_lane_serve_report_matches_reference(port_batch, ref_batch):
    """The batch solve records its lane dispatch as the reference's does
    (bucket, raw width, padded width), and the report of a sequence of
    dispatches is the reference's."""
    _out, served_ref = ref_batch
    _insts, (_out, served_port) = port_batch
    assert served_port == served_ref == {
        "31x8x72x4": {"lane_buckets": [8], "served_lane_counts": [3],
                      "dispatches": 1}}
    calls = [((13, 3, 72, 4), 3, 8), ((13, 3, 72, 4), 1, 1),
             ((20, 5, 48, 4), 8, 8), ((13, 3, 72, 4), 5, 8)]

    def note(mesh_mod):
        for call in calls:
            mesh_mod.note_lane_serve(*call)

    assert _served(tpm, lambda: note(tpm))[1] == \
        _served(jpm, lambda: note(jpm))[1]


def test_optimize_batch_matches_reference(batch_cases, ref_batch):
    """The decoded plans and the move diffs equal the reference's."""
    ref_batch, _served_ref = ref_batch
    scens, _ref, port = batch_cases
    insts = [build_instance(*c) for c in port]
    out = optimize_batch([c[0] for c in port], insts, seeds=0,
                         device="cpu", **BATCH_KW)
    for rj, rt in zip(ref_batch, out):
        assert Assignment.from_json(rj.assignment.to_json()).to_json() == \
            rt.assignment.to_json()
        assert rt.moves.replica_moves == rj.moves.replica_moves
        assert rt.moves.leader_changes == rj.moves.leader_changes
        assert rt.report()["feasible"] == rj.report()["feasible"]
    with pytest.raises(ValueError, match="assignments for"):
        optimize_batch([port[0][0]], insts, device="cpu")


def test_chain_lanes_batch_matches_reference(batch_cases):
    """The chain engine's lane path (the batch default off the card below
    512 partitions): two chunks (a deadline far away cuts the 2 rounds
    into two) with each lane's reseed between, plan for plan."""
    _scens, ref, port = batch_cases
    kw = dict(batch=4, rounds=2, time_limit_s=600.0)
    rj = jengine.solve_tpu_batch(ref[:2], seeds=[3, 4], **kw, **REF_KW)
    insts = [build_instance(*c) for c in port[:2]]
    rt = engine.solve_tpu_batch(insts, seeds=[3, 4], device="cpu", **kw)
    for x, y in zip(rj, rt):
        assert y.stats["engine"] == x.stats["engine"] == "chain"
        assert y.stats["rounds_run"] == x.stats["rounds_run"] == 2
        np.testing.assert_array_equal(y.a, x.a)
        assert y.stats["score_curve"] == x.stats["score_curve"]


def test_solve_tpu_batch_unstackable_falls_back(batch_cases):
    """Lanes whose broker or rack axes differ cannot stack: each is
    solved alone by ``solve_tpu``, tagged, and equal to that solve."""
    _scens, _ref, port = batch_cases
    s = _adv(7, n_brokers=48, n_topics_low=4, n_topics_high=4)
    other = build_instance(*port_cluster(s.current, s.broker_list,
                                         s.topology))
    insts = [build_instance(*port[0]), other]
    kw = dict(engine="sweep", batch=2, rounds=8, portfolio=False)
    out = engine.solve_tpu_batch(insts, seeds=0, device="cpu", **kw)
    assert len(out) == 2
    for i, res in enumerate(out):
        assert res.stats["lane_fallback"] == (
            "brokers/racks differ across lanes")
        assert res.stats["feasible"]
        alone = engine.solve_tpu(insts[i], seed=i, device="cpu", **kw)
        np.testing.assert_array_equal(res.a, alone.a)
    # trace is ported: one report covers the fallback's lanes
    traced = engine.solve_tpu_batch(insts, device="cpu", trace=True, **kw)
    rep = traced[0].stats["solve_report"]
    assert [sp["name"] for sp in rep["spans"]["spans"]] == ["lane", "lane"]
    assert traced[1].stats["trace_id"] == rep["trace_id"]
    # n_devices is ported: each unstackable lane is its own two-shard
    # solve (held to the reference's in tests/test_torch_mesh.py)
    two = engine.solve_tpu_batch(insts, seeds=0, device="cpu", n_devices=2,
                                 **kw)
    for i, res in enumerate(two):
        alone = engine.solve_tpu(insts[i], seed=i, device="cpu",
                                 n_devices=2, **kw)
        np.testing.assert_array_equal(res.a, alone.a)
        assert res.stats["devices"] == alone.stats["devices"] == 2
    with pytest.raises(ValueError, match="seeds for"):
        engine.solve_tpu_batch(insts, seeds=[1], device="cpu")
    assert engine.solve_tpu_batch([], device="cpu") == []
