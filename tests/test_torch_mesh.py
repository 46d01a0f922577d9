"""PyTorch port: the sharded solve mesh against the reference's, on the CPU.

The reference shards its chain population over a device mesh and runs
its own tests on 8 virtual CPU devices (``tests/conftest.py``). The
port's mesh holds the same C logical chain shards on the CPU
(``device="cpu", n_devices=C``), so it is held to the reference bit for
bit: the grammar, the candidates and the never-guessing chooser; the
per-shard winners and carried state of a sharded lane solve under every
(chains x lanes) split; ``solve_tpu`` at ``n_devices`` 2 and 8; the batch
path under ``KAO_MESH_SHARDING=8x1, 4x2, 2x4``; the chain engine; a
megachunk whose certificate exits; and a mesh spread over several
devices (blocks) equal to the one-device mesh. The outputs are integers:
the tolerance is exact equality. The reference's runs are computed once
a module (its compiles dominate the time).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_assignment_optimizer_tpu import build_instance as jax_build
from kafka_assignment_optimizer_tpu.api import optimize as jax_optimize
from kafka_assignment_optimizer_tpu.parallel import mesh as jmesh
from kafka_assignment_optimizer_tpu.solvers.tpu import arrays as jarrays
from kafka_assignment_optimizer_tpu.solvers.tpu import engine as jengine
from kafka_assignment_optimizer_tpu.solvers.tpu.seed import (
    greedy_seed as jax_greedy_seed,
)
from kafka_assignment_optimizer_tpu.utils import gen as jgen
from kafka_assignment_optimizer_tpu_torch import prng
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.parallel import mesh as pm
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import arrays, engine

from tests.test_torch_engine import port_cluster
from tests.test_torch_pipeline import (
    KW,
    _no_worker,
    assert_same,
    no_race,  # noqa: F401  (a fixture)
    port_solve,
    the_cluster,
)

N_DEV = 8  # the reference's virtual CPU devices (tests/conftest.py)
# eight positions over two devices: "cpu" and "cpu:0" compare unequal, so
# the mesh keeps them apart (a block each, the several-card layout)
SPREAD = ["cpu", "cpu:0"] * 4
BKT = (32, 8, 90, 3)
# the engine parity knobs: the pipeline case, a shorter ladder
SOLO = dict(rounds=16, portfolio=False)
FIELDS = ("engine", "rounds_run", "score_curve", "final_cert", "moves",
          "feasible", "pipeline", "dispatches", "megachunk", "devices",
          "chains_per_device", "degradations")


def _adv(seed: int):
    sc = jgen.adversarial(n_brokers=32, n_topics_low=3, n_topics_high=3,
                          parts_per_topic=10, seed=seed)
    return (jax_build(sc.current, sc.broker_list, sc.topology),
            build_instance(*port_cluster(sc.current, sc.broker_list,
                                         sc.topology)))


@pytest.fixture(autouse=True)
def _fresh_evidence():
    pm.reset_mesh_adapt()
    jmesh.reset_mesh_adapt()
    yield
    pm.reset_mesh_adapt()
    jmesh.reset_mesh_adapt()


# ------------------------------------------------------------ unit layer

def test_parse_mesh_sharding_grammar():
    assert pm.parse_mesh_sharding("auto") == ("auto", None)
    assert pm.parse_mesh_sharding("") == ("auto", None)
    assert pm.parse_mesh_sharding("off") == ("off", None)
    assert pm.parse_mesh_sharding("4x2") == ("spec", (4, 2))
    assert pm.parse_mesh_sharding(" 8X1 ") == ("spec", (8, 1))
    assert pm.parse_mesh_sharding("4by2")[0] == "invalid"
    assert pm.parse_mesh_sharding("0x8")[0] == "invalid"
    for v in ("auto", "off", "4x2", "8X1", "4by2", "0x8", ""):
        assert pm.parse_mesh_sharding(v) == jmesh.parse_mesh_sharding(v)


def test_candidate_shardings_divisibility():
    for n, lanes in ((8, 4), (8, 6), (8, 1), (1, 4), (4, 8)):
        assert pm.candidate_shardings(n, lanes) == \
            jmesh.candidate_shardings(n, lanes)
    assert pm.candidate_shardings(8, 4) == [(8, 1), (4, 2), (2, 4)]


def test_mesh_geometry_and_blocks():
    """The grid, its validation, and the blocks: every position on one
    device is one block (one launch for all shards), distinct devices a
    block each, a lane split placing lane blocks as the reference's
    ``P('chains', 'lanes')``."""
    mesh = pm.make_mesh(N_DEV, lane_devices=2, device="cpu")
    assert pm.mesh_spec(mesh) == (4, 2) and mesh.size == N_DEV
    assert (pm.AXIS, pm.AXIS_LANES) == ("chains", "lanes")
    with pytest.raises(ValueError, match="does not divide"):
        pm.make_mesh(N_DEV, lane_devices=3, device="cpu")
    assert pm.mesh_spec(pm.make_mesh(N_DEV, device="cpu")) == (N_DEV, 1)
    assert pm.make_mesh(device="cpu").size == 1
    (b,) = mesh.blocks(4)
    assert (b.c0, b.c1, b.l0, b.l1) == (0, 8, 0, 4)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.blocks(3)
    split = pm.make_mesh(lane_devices=2, device=["cpu", "cpu:0"] * 2)
    assert [(b.c0, b.c1, b.l0, b.l1) for b in split.blocks(4)] == [
        (0, 2, 0, 2), (0, 2, 2, 4), (2, 4, 0, 2), (2, 4, 2, 4)]
    assert pm.make_mesh(1, device=["cpu", "cpu"]).size == 1


def test_choose_sharding_never_guesses(monkeypatch):
    monkeypatch.delenv(pm.MESH_ENV, raising=False)
    assert pm.choose_sharding(BKT, 8, 4) == (8, 1)
    for _ in range(pm.MESH_MIN_SOLVES):
        pm.note_sharding_evidence(BKT, (4, 2), lanes=4, solves=1,
                                  device_s=0.5)
    assert pm.choose_sharding(BKT, 8, 4) == (8, 1)
    for _ in range(pm.MESH_MIN_SOLVES):
        pm.note_sharding_evidence(BKT, (8, 1), lanes=4, solves=1,
                                  device_s=1.0)
    assert pm.choose_sharding(BKT, 8, 4) == (4, 2)
    assert pm.choose_sharding(BKT, 8, 4, multi=True) == (8, 1)
    monkeypatch.setenv(pm.MESH_ENV, "2x4")
    assert pm.choose_sharding(BKT, 8, 4) == (2, 4)
    monkeypatch.setenv(pm.MESH_ENV, "off")
    assert pm.choose_sharding(BKT, 8, 4) == (8, 1)
    monkeypatch.setenv(pm.MESH_ENV, "3x3")
    assert pm.choose_sharding(BKT, 8, 4) == (8, 1)


def test_make_solve_mesh_gating_and_snapshot(monkeypatch):
    """Only a multi-lane sweep dispatch over several devices is
    lane-split (on one device every split is the same one block, so the
    chains-only split stands whatever the evidence or the override);
    the snapshot (the /healthz mesh section) shows the last mesh, the
    evidence and the counters, and a reset drops both."""
    monkeypatch.delenv(pm.MESH_ENV, raising=False)
    kw = dict(device=SPREAD)
    assert pm.mesh_spec(pm.make_solve_mesh(N_DEV, **kw)) == (N_DEV, 1)
    assert pm.mesh_spec(pm.make_solve_mesh(N_DEV, lanes=4, engine="chain",
                                           **kw)) == (N_DEV, 1)
    assert pm.mesh_spec(pm.make_solve_mesh(1, lanes=4, **kw)) == (1, 1)
    for _ in range(pm.MESH_MIN_SOLVES):
        pm.note_sharding_evidence(BKT, (8, 1), lanes=4, solves=1,
                                  device_s=1.0)
        pm.note_sharding_evidence(BKT, (4, 2), lanes=4, solves=1,
                                  device_s=0.5)
    assert pm.mesh_spec(pm.make_solve_mesh(
        N_DEV, lanes=4, bucket_key=BKT, **kw)) == (4, 2)
    assert pm.mesh_spec(pm.make_solve_mesh(
        N_DEV, lanes=4, bucket_key=BKT, device="cpu")) == (N_DEV, 1)
    monkeypatch.setenv(pm.MESH_ENV, "2x4")
    assert pm.mesh_spec(pm.make_solve_mesh(
        N_DEV, lanes=4, bucket_key=BKT, device="cpu")) == (N_DEV, 1)
    monkeypatch.delenv(pm.MESH_ENV)
    assert pm.mesh_spec(pm.make_solve_mesh(
        N_DEV, lanes=4, bucket_key=BKT, multi=True, **kw)) == (N_DEV, 1)
    snap = pm.mesh_snapshot()
    assert snap["axes"] == {pm.AXIS: N_DEV, pm.AXIS_LANES: 1}
    assert snap["devices"] == SPREAD
    assert snap["sharding_mode"] == "auto"
    assert snap["min_solves"] == pm.MESH_MIN_SOLVES
    (row,) = snap["buckets"].values()
    assert row["chosen"] == "4x2" and row["evidence"]["4x2"]["solves"] == 2
    assert set(snap["counters"]) == {"search_evals", "reshard_bytes"}
    pm.reset_mesh_adapt()
    assert pm.mesh_counters() == {"search_evals": 0, "reshard_bytes": 0}
    assert pm.mesh_snapshot()["buckets"] == {}


# ---------------------------------------------------------- parity layer

@pytest.fixture(scope="module")
def lanes4():
    """Four adversarial lanes of one bucket, both packages' inputs, and
    the reference's sharded lane solve on its 8 devices (default split,
    8 sweeps, 2 chains a shard)."""
    pairs = [_adv(s) for s in (7, 8, 9, 10)]
    mj = jarrays.stack_models([jarrays.from_instance(p[0]) for p in pairs])
    mt = arrays.stack_models([arrays.from_instance(p[1], "cpu")
                              for p in pairs])
    seeds = np.stack([np.asarray(jax_greedy_seed(p[0]), np.int32)
                      for p in pairs])
    keys = jnp.stack([jax.random.PRNGKey(s) for s in range(4)])
    temps = jarrays.geometric_temps(2.0, 0.02, 8)
    mesh = jmesh.make_mesh(N_DEV)
    st = jmesh.init_lane_state(mj, seeds, keys, mesh, 2)
    want = jmesh.solve_lanes(mj, mesh, 2, temps, state=st)
    want = (tuple(np.asarray(x) for x in jax.tree.leaves(want[0])),
            *(np.asarray(x) for x in want[1:]))
    return mt, seeds, np.asarray(keys), temps, want


def _port_lanes(lanes4, mesh):
    mt, seeds, keys, temps, _want = lanes4
    st = pm.init_lane_state(mt, seeds, keys, 2, mesh)
    return pm.solve_lanes(mt, 2, temps, state=st, mesh=mesh)


def _assert_lane_out(got, want):
    for name, x, y in zip(("best_a", "best_k", "curve"), got[1:], want[1:]):
        np.testing.assert_array_equal(x.cpu().numpy(), y, err_msg=name)
    for i, (x, y) in enumerate(zip(got[0][:4], want[0][:4])):
        np.testing.assert_array_equal(x.numpy(), y, err_msg=f"leaf {i}")
    np.testing.assert_array_equal(got[0][4], want[0][4])


@pytest.mark.parametrize("dl", [1, 2, 4])
def test_sharded_lane_solve_equals_reference(lanes4, dl):
    """THE parity pin: the port's 8 shards x 4 lanes under every (dc,
    dl) split give the reference's per-shard winners, curves and carried
    state (``[8, 4, ...]``, keys included), bit for bit."""
    got = _port_lanes(lanes4, pm.make_mesh(N_DEV, lane_devices=dl,
                                           device="cpu"))
    _assert_lane_out(got, lanes4[-1])


def test_blocks_over_devices_equal_one_device(lanes4):
    """A mesh over several devices runs a block of shards on each (its
    own launches), the migration's values crossing between them: the
    outputs equal the one-device mesh's, chains-only and lane-split."""
    for dl in (1, 2):
        mesh = pm.make_mesh(lane_devices=dl, device=SPREAD)
        assert len(mesh.blocks(4)) == N_DEV
        got = _port_lanes(lanes4, mesh)
        for x, y in zip(got[1:], lanes4[-1][1:]):
            np.testing.assert_array_equal(x.numpy(), y)


def test_sharding_search_files_evidence(lanes4, monkeypatch):
    """The search runs every candidate through ``solve_lanes``, holds
    each split's winners to the default's, and files its timings in the
    evidence table production solves read."""
    monkeypatch.delenv(pm.MESH_ENV, raising=False)
    mt, seeds, keys, temps, _want = lanes4
    res = pm.run_sharding_search(arrays.lane_range(mt, 0, 2), seeds[:2],
                                 keys[:2], temps, n_devices=4,
                                 chains_per_device=2, bucket_key=BKT,
                                 repeats=1, device="cpu")
    assert [r["spec"] for r in res] == ["4x1", "2x2"]
    assert all(r["parity_vs_default"] for r in res)
    assert all(r["warm_s"] > 0 for r in res)
    assert pm.mesh_counters()["search_evals"] == 2
    (row,) = pm.mesh_snapshot()["buckets"].values()
    assert set(row["evidence"]) == {"4x1", "2x2"}


# ---------------------------------------------------------- engine layer

@pytest.fixture(scope="module")
def ref_solo():
    """The reference's pipelined sweep solo at 2 and 8 devices."""
    cl = the_cluster()
    return {n: jax_optimize(*cl, precompile=True,
                            **{**KW, **SOLO, "n_devices": n})
            for n in (2, 8)}


@pytest.mark.parametrize("n", [2, 8])
def test_solve_tpu_sharded_equals_reference(no_race, ref_solo, n):
    """``optimize`` (``solve_tpu``) at ``n_devices`` 2 and 8 on the CPU:
    the reference's plan, moves, curve and stats; ``C`` shards of
    ``batch // C`` chains."""
    got = port_solve(the_cluster(), n_devices=n, **SOLO)
    assert_same(got, ref_solo[n], FIELDS)
    s = got.solve.stats
    assert s["devices"] == n and s["chains_per_device"] == max(1, 8 // n)
    assert s["mesh"] == {"axes": {"chains": n, "lanes": 1},
                         "devices": ["cpu"] * n, "processes": 1}


def test_chain_engine_sharded_equals_reference(no_race):
    """The chain engine at ``n_devices=2``: its round-end migration over
    the two shards (owner by lowest shard index, first index) gives the
    reference's plan and curve."""
    cl = the_cluster()
    kw = dict(engine="chain", rounds=3, batch=8, steps_per_round=64,
              n_devices=2)
    want = jax_optimize(*cl, precompile=True, **{**KW, **kw})
    got = port_solve(cl, **kw)
    assert_same(got, want, ("engine", "rounds_run", "score_curve", "moves",
                            "feasible", "devices", "chains_per_device"))


@pytest.fixture(scope="module")
def batch4():
    """Four adversarial instances, both packages, and the reference's
    batch at 8 devices (default split)."""
    pairs = [_adv(s) for s in (7, 8, 9, 10)]
    kw = dict(seeds=0, engine="sweep", batch=16, rounds=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(jmesh.MESH_ENV, raising=False)
        want = jengine.solve_tpu_batch([p[0] for p in pairs], n_devices=N_DEV,
                                       **kw)
    return [p[1] for p in pairs], kw, want


@pytest.mark.parametrize("spec", ["8x1", "4x2", "2x4"])
def test_batch_under_forced_split_equals_reference(batch4, monkeypatch,
                                                   spec):
    """``solve_tpu_batch`` at 8 shards over two devices under
    ``KAO_MESH_SHARDING``: every split gives the reference's plans (the
    split moves placement, never results), each lane its best shard, and
    the dispatch files sharding evidence for its split."""
    insts, kw, want = batch4
    monkeypatch.setenv(pm.MESH_ENV, spec)
    got = engine.solve_tpu_batch(insts, n_devices=N_DEV, device=SPREAD,
                                 **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.a, w.a, err_msg=f"lane {i}")
        assert g.objective == w.objective
        for f in ("moves", "feasible", "score_curve", "devices",
                  "chains_per_device", "rounds_run"):
            assert g.stats[f] == w.stats[f], (i, f)
        assert g.stats["mesh"]["axes"] == dict(zip(
            ("chains", "lanes"), (int(x) for x in spec.split("x"))))
    (row,) = pm.mesh_snapshot()["buckets"].values()
    assert spec in row["evidence"]


def test_megachunk_certificate_exit_sharded(monkeypatch):
    """The engine-level early exit at ``n_devices=2`` (the megachunk
    test's case): the armed group's certificate, reduced over both
    shards and every portfolio lane, exits after its first chunk; the
    plan, ``stats["megachunk"]`` and the winning lane equal the
    reference's."""
    from tests.test_torch_megachunk import NO_DEADLINE

    monkeypatch.setattr(jengine, "_construct_worker", _no_worker)
    monkeypatch.setattr(engine, "_construct_worker", _no_worker)
    sc = jgen.SCENARIOS["decommission"](**jgen.SMOKE_KWARGS["decommission"])
    inst_j = jax_build(sc.current, sc.broker_list, sc.topology,
                       target_rf=sc.target_rf)
    inst_t = build_instance(*port_cluster(sc.current, sc.broker_list,
                                          sc.topology), sc.target_rf)
    for inst in (inst_j, inst_t):
        inst.move_lower_bound_exact()
        monkeypatch.setattr(inst, "weight_upper_bound", lambda *a, **k: 1)
    kw = dict(seed=0, engine="sweep", batch=8, rounds=32,
              time_limit_s=NO_DEADLINE, cert_min_savings_s=-1.0,
              megachunk=4, n_devices=2)
    want = jengine.solve_tpu(inst_j, **kw)
    got = engine.solve_tpu(inst_t, device="cpu", **kw)
    s = got.stats
    assert s["megachunk"]["early_exit"] is True and s["devices"] == 2
    assert s["rounds_run"] < s["rounds"] and s["feasible"]
    np.testing.assert_array_equal(got.a, want.a)
    for f in ("megachunk", "rounds_run", "moves", "early_stopped",
              "dispatches", "devices", "chains_per_device"):
        assert s.get(f) == want.stats.get(f), f
    assert s["portfolio"]["winner_lane"] == \
        want.stats["portfolio"]["winner_lane"]


def test_one_shard_mesh_is_the_unsharded_stepper():
    """C=1 unchanged: a mesh of one shard gives the one-shard layout's
    state and winners with a leading shard axis of one."""
    _inst_j, inst = _adv(7)
    m = arrays.from_instance(inst, "cpu")
    seed = torch.from_numpy(np.asarray(
        jax_greedy_seed(_inst_j), np.int32))
    temps = arrays.geometric_temps(2.0, 0.02, 8)
    key = prng.PRNGKey(3)
    plain = pm.solve_on_mesh(m, seed, key, pm.make_mesh(device="cpu"), 2,
                             8, 1, engine="sweep", temps=temps)
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import sweep

    st = pm.init_sweep_state(m, seed, key, 2)
    one = sweep.make_sweep_stepper_fn(2)(m, st, temps)
    for x, y in zip(plain[1:], one[1:]):
        assert torch.equal(x[0], y)
    for x, y in zip(plain[0][:4], one[0][:4]):
        assert torch.equal(x[0], y)
