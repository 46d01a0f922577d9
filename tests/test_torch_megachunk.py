"""PyTorch port: ladder megachunks against the reference's, on the CPU.

A megachunk runs K consecutive sweep chunks as one fused group; each
step is the unchanged chunk stepper on the carried state, so every width
replays the K=1 ladder bit for bit with ceil(chunks / K) dispatches. On
the reference's own seeded case the port's plans, curves and
``stats["megachunk"]`` equal the reference's for K in {1, 2, 8}, sync and
pipelined; at the mesh level a forced certificate retires a group after
its first step (``execd``) and replays identically; at the engine level
the armed group's early exit certifies before the group's end, as the
reference's does; a fault inside a group drains to the per-chunk ladder
(``megachunk_to_chunked``); the batch ladder fuses disarmed; explicit
widths resolve as the reference's, its "auto" width is refused, and the
warm estimates are keyed by width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_assignment_optimizer_tpu import build_instance as jax_build
from kafka_assignment_optimizer_tpu.parallel import mesh as jmesh
from kafka_assignment_optimizer_tpu.resilience import chaos as jchaos
from kafka_assignment_optimizer_tpu.solvers.tpu import arrays as jarrays
from kafka_assignment_optimizer_tpu.solvers.tpu import engine as jengine
from kafka_assignment_optimizer_tpu.utils import gen as jgen
from kafka_assignment_optimizer_tpu_torch import prng
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.parallel import mesh
from kafka_assignment_optimizer_tpu_torch.resilience import chaos
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import (
    arrays,
    engine,
    sweep,
)
from kafka_assignment_optimizer_tpu_torch.solvers.tpu.seed import greedy_seed

from tests.test_torch_engine import port_cluster
from tests.test_torch_pipeline import (
    NO_DEADLINE,
    _no_worker,
    assert_same,
    no_race,  # noqa: F401  (a fixture)
    port_solve,
    ref_solve,
    the_cluster,
)
from tests.test_tpu_engine import random_cluster

# the scheduling fields a fused ladder changes; everything else equals
# the unfused ladder's
SEARCH = ("engine", "rounds_run", "score_curve", "final_cert", "moves",
          "feasible", "portfolio", "degradations")


@pytest.fixture(scope="module")
def base():
    """The port's unfused ladder on the case (K=1, synchronous)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("_construct_worker", "_exact_worker", "_reseat_worker"):
            mp.setattr(engine, name, _no_worker)
        return port_solve(the_cluster(), pipeline=False)


@pytest.mark.parametrize("pipeline", [False, True])
def test_megachunk_equals_chunked_and_reference(no_race, base, pipeline):
    """K in {1, 2, 8}: the fused plans and curves equal the unfused
    ladder's and the reference's, ``stats["megachunk"]`` equals the
    reference's and ``dispatches == ceil(chunks / K)``."""
    cl = the_cluster()
    n_chunks = base.solve.stats["dispatches"]
    assert n_chunks == 4
    for k in (1, 2, 8):
        want = ref_solve(cl, pipeline=pipeline, megachunk=k)
        got = port_solve(cl, pipeline=pipeline, megachunk=k)
        assert_same(got, want, SEARCH + ("megachunk", "dispatches",
                                         "pipeline"))
        assert_same(got, base, SEARCH)
        mg = got.solve.stats["megachunk"]
        assert mg["k"] == min(k, n_chunks)
        assert mg["mode"] == ("static" if k > 1 else "off")
        assert mg["chunks"] == n_chunks and not mg["early_exit"]
        assert got.solve.stats["dispatches"] == -(-n_chunks // mg["k"])
        assert got.solve.stats["pipeline"] is pipeline


def test_megachunk_mesh_forced_exit_and_disarmed_group():
    """``solve_megachunk`` over 4 steps of 4 sweeps, 2 chains: thresholds
    every chain meets from the seed retire the group after step 0 —
    ``execd`` [True, False, False, False], the certificate flagged — with
    every output equal to the reference's mesh of one device and a replay
    equal to the first run; disarmed, the group equals 4 chunk steps."""
    current, brokers, topo = random_cluster(np.random.default_rng(0), 10, 16,
                                            2, 2, drop=1)
    inst_j = jax_build(current, brokers, topo)
    inst_t = build_instance(*port_cluster(current, brokers, topo))
    temps = arrays.geometric_temps(2.0, 0.05, 16)
    segs = np.stack([temps[i * 4:(i + 1) * 4] for i in range(4)])
    forced = dict(cert_k=-(2 ** 31) + 1, cert_mv=2 ** 31 - 1)
    m_j = jarrays.from_instance(inst_j)
    seed_j = jnp.asarray(greedy_seed(inst_t), jnp.int32)
    jm = jmesh.make_mesh(n_devices=1)
    st = jmesh.init_sweep_state(m_j, seed_j, jax.random.PRNGKey(3), jm, 2)
    want = jmesh.solve_megachunk(m_j, jm, 2, jnp.asarray(segs), st,
                                 steps_per_round=2, scorer="xla", **forced)
    want = [np.asarray(x).reshape(np.asarray(x).shape[1:])
            for x in want[1:]]

    m = arrays.from_instance(inst_t, "cpu")
    seed = torch.from_numpy(np.asarray(greedy_seed(inst_t), np.int32))

    def run(**kw):
        st = mesh.init_sweep_state(m, seed, prng.PRNGKey(3), 2)
        out = mesh.solve_megachunk(m, 2, segs, st, **kw)
        return [np.asarray(x) for x in out[1:]], out[0]

    first, _ = run(**forced)
    again, _ = run(**forced)
    assert first[-1].tolist() == [True, False, False, False]
    assert bool(first[3])
    for name, g, w, a in zip(("top_a", "top_k", "cert_a", "cert_ok",
                              "cert_mv", "curves", "execd"),
                             first, want, again):
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(g, a, err_msg=name)
    # disarmed: every step runs, as 4 chunk steps do
    fused, st_f = run()
    assert fused[-1].all() and not fused[3]
    step = sweep.make_sweep_stepper_fn(2)
    st = mesh.init_sweep_state(m, seed, prng.PRNGKey(3), 2)
    curves = []
    for seg in segs:
        st, top_a, top_k, cv = step(m, st, seg)
        curves.append(cv.numpy())
    np.testing.assert_array_equal(fused[0], top_a.numpy())
    np.testing.assert_array_equal(fused[1], top_k.numpy())
    np.testing.assert_array_equal(fused[5], np.stack(curves))
    for x, y in zip(st_f[:4], st[:4]):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(st_f[4], st[4])


def test_megachunk_early_exit_certifies_at_engine_level(monkeypatch):
    """The reference's engine-level early exit, both packages: bounds
    prewarmed, the constructor stood down, the certificate's economics
    off (a negative threshold) and the weight bound forced to 1, so the
    armed group exits after its first chunk of four and the host
    certifies the snapshot; equal plans and ``stats["megachunk"]``, and a
    replay equal to the first run."""
    monkeypatch.setattr(jengine, "_construct_worker", _no_worker)
    monkeypatch.setattr(engine, "_construct_worker", _no_worker)
    sc = jgen.SCENARIOS["decommission"](**jgen.SMOKE_KWARGS["decommission"])
    inst_j = jax_build(sc.current, sc.broker_list, sc.topology,
                       target_rf=sc.target_rf)
    current, brokers, topo = port_cluster(sc.current, sc.broker_list,
                                          sc.topology)
    inst_t = build_instance(current, brokers, topo, sc.target_rf)
    for inst in (inst_j, inst_t):
        inst.move_lower_bound_exact()
        monkeypatch.setattr(inst, "weight_upper_bound", lambda *a, **k: 1)
    kw = dict(seed=0, engine="sweep", batch=8, rounds=32,
              time_limit_s=NO_DEADLINE, cert_min_savings_s=-1.0,
              megachunk=4)
    want = jengine.solve_tpu(inst_j, n_devices=1, **kw)
    got = engine.solve_tpu(inst_t, device="cpu", **kw)
    again = engine.solve_tpu(inst_t, device="cpu", **kw)
    s = got.stats
    mg = s["megachunk"]
    assert mg["k"] == 4 and mg["early_exit"] is True and mg["chunks"] < 4
    assert s["rounds_run"] < s["rounds"] and s["feasible"]
    assert s["moves"] == inst_t.move_lower_bound_exact()
    np.testing.assert_array_equal(got.a, want.a)
    for f in ("megachunk", "rounds_run", "moves", "early_stopped",
              "pipeline", "dispatches"):
        assert s.get(f) == want.stats.get(f), (f, s.get(f),
                                               want.stats.get(f))
    # the winning lane and config; the certificate's time is the clock's
    assert ({k: v for k, v in s["portfolio"].items()
             if k != "certified_at_s"}
            == {k: v for k, v in want.stats["portfolio"].items()
                if k != "certified_at_s"})
    np.testing.assert_array_equal(again.a, got.a)
    assert again.stats["megachunk"] == mg
    assert again.stats["rounds_run"] == s["rounds_run"]


@pytest.mark.parametrize("pipeline", [False, True])
def test_megachunk_fault_drains_to_chunked(no_race, base, pipeline):
    """A fault inside a fused group (``megachunk_fault``) steps down
    ``megachunk_to_chunked``; the per-chunk ladder finishes with the
    unfused plan, in both packages."""
    cl = the_cluster()
    try:
        chaos.arm("megachunk_fault")
        jchaos.arm("megachunk_fault")
        got = port_solve(cl, pipeline=pipeline, megachunk=2)
        want = ref_solve(cl, pipeline=pipeline, megachunk=2)
    finally:
        chaos.disarm()
        jchaos.disarm()
    assert got.solve.stats["degradations"] == ["megachunk_to_chunked"]
    assert_same(got, want, SEARCH + ("megachunk", "dispatches"))
    assert_same(got, base, [f for f in SEARCH if f != "degradations"])


def test_batch_megachunk_is_disarmed_and_equal():
    """The batch lane ladder fused at K=2: its groups run disarmed, each
    lane equals the reference's batch and the unfused batch."""
    rng = np.random.default_rng(0)
    clusters = [random_cluster(rng, 12, 40 + 4 * i, 3, 3, drop=1)
                for i in range(3)]
    jinsts = [jax_build(*c) for c in clusters]
    tinsts = [build_instance(*port_cluster(*c)) for c in clusters]
    kw = dict(engine="sweep", rounds=32, time_limit_s=NO_DEADLINE)
    base = engine.solve_tpu_batch(tinsts, seeds=0, pipeline=False,
                                  device="cpu", **kw)
    for p in (True, False):
        want = jengine.solve_tpu_batch(jinsts, seeds=0, pipeline=p,
                                       megachunk=2, n_devices=1, **kw)
        got = engine.solve_tpu_batch(tinsts, seeds=0, pipeline=p,
                                     megachunk=2, device="cpu", **kw)
        for g, w, b in zip(got, want, base):
            np.testing.assert_array_equal(g.a, w.a)
            np.testing.assert_array_equal(g.a, b.a)
            for f in ("score_curve", "moves", "megachunk", "dispatches"):
                assert g.stats[f] == w.stats[f], (f, p)
            assert g.stats["score_curve"] == b.stats["score_curve"]
        assert got[0].stats["megachunk"] == {
            "k": 2, "mode": "static", "groups": 2, "dispatches": 2,
            "chunks": 4, "early_exit": False}


def test_megachunk_explicit_widths_resolve_as_reference():
    """Every value short of "auto" resolves to the reference's ``(K,
    mode)``: None, False, "off" and 1 keep the per-chunk ladder, an int or
    a numeric string pins K (capped by the chunk count), and a ladder
    that does not fuse (the chain engine, one chunk) stays off."""
    for v, sup, n in ((None, True, 4), (2, True, 1), (8, True, 4),
                      ("3", True, 8), ("off", True, 8), (4, False, 8),
                      (False, True, 8), (1, True, 8), (0, True, 8),
                      (-3, True, 8), ("x", True, 8)):
        got = engine._mega_width(engine._resolve_megachunk(v),
                                 "sweep" if sup else "chain", n)
        assert got == jengine._resolve_megachunk(v, sup, False, n, ()), (
            v, sup, n)


@pytest.mark.parametrize("value", ["auto", " AUTO ", True])
def test_megachunk_auto_is_refused(no_race, monkeypatch, value):
    """The reference's "auto" width assumes a fused group pays its host
    time once; a group here is the chunk stepper called K times, so
    ``megachunk="auto"`` (or True) raises in both entry points before any
    solve work, and ``KAO_MEGACHUNK`` is not read: a defaulted solve runs
    the per-chunk ladder whatever it says."""
    inst = build_instance(*port_cluster(*the_cluster()))
    with pytest.raises(NotImplementedError, match="megachunk"):
        engine.solve_tpu(inst, device="cpu", megachunk=value)
    with pytest.raises(NotImplementedError, match="megachunk"):
        engine.solve_tpu_batch([inst], device="cpu", megachunk=value)
    assert not hasattr(engine, "set_megachunk_default")
    monkeypatch.setenv("KAO_MEGACHUNK", "4")
    if value == "auto":
        st = port_solve(the_cluster()).solve.stats
        assert st["megachunk"]["mode"] == "off" and st["dispatches"] == 4


def test_megachunk_warm_estimate_is_width_keyed(no_race):
    """A fused solve files its per-chunk time under its own width and
    leaves the width-1 entry the per-chunk deadline gate reads alone."""
    cl = the_cluster()
    engine._WARM_CHUNKS._d.clear()
    port_solve(cl, megachunk=None)
    before = dict(engine._WARM_CHUNKS._d)
    assert before and all(k[-2] == 1 for k in before)
    port_solve(cl, megachunk=2)
    after = dict(engine._WARM_CHUNKS._d)
    for k, v in before.items():
        assert after[k] == v, k
    assert [k for k in after if k[-2] == 2]
