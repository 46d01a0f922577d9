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
(``megachunk_to_chunked``); the batch ladder fuses disarmed; every width
resolves as the reference's, "auto" included; the measured width's
evidence table and chooser equal the reference's, ``KAO_MEGACHUNK``
resolves alike, and an "auto" solve given the same evidence runs at the
reference's width with its plan; the group with its ``done`` flag and
its keys on the device equals the reference's group (disarmed, a padded
tail, a forced exit), and the chunk step with device keys the
reference's lane stepper; the warm estimates are keyed by width.
"""

import json
import os
import subprocess
import sys

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


# (megachunk, engine fuses, multi, chunks): the explicit widths, "auto"
# and True below quorum, and "auto" under a process group
RESOLVE_CASES = [
    (None, True, False, 4), (2, True, False, 1), (8, True, False, 4),
    ("3", True, False, 8), ("off", True, False, 8), (4, False, False, 8),
    (False, True, False, 8), (1, True, False, 8), (0, True, False, 8),
    (-3, True, False, 8), ("x", True, False, 8), ("auto", True, False, 8),
    (" AUTO ", True, False, 8), (True, True, False, 8),
    ("auto", True, True, 8), (True, True, True, 8), ("auto", False, False, 8),
    (4, True, True, 8),
]


@pytest.mark.parametrize("case", RESOLVE_CASES)
def test_megachunk_explicit_widths_resolve_as_reference(case):
    """Every value resolves to the reference's ``(K, mode)``: None, False,
    "off" and 1 keep the per-chunk ladder, an int or a numeric string pins
    K (capped by the chunk count), "auto" and True read the evidence table
    (1 below quorum) but never under a process group, and a ladder that
    does not fuse (the chain engine, one chunk) stays off."""
    v, sup, multi, n = case
    key = ("resolve-case",)

    def outcome(mod):
        try:
            return mod._resolve_megachunk(v, sup, multi, n, key)
        except ValueError as e:  # " AUTO ": int() of the unstripped value
            return ("ValueError", str(e))

    assert outcome(engine) == outcome(jengine), case


# (label, evidence notes: (dispatches, dispatch_s, chunks, device_s) a
# solve): below quorum, and at quorum for each candidate width
CHOOSER_CASES = {
    "below quorum": [(8, 0.8, 8, 0.008)] * 15,
    "K=1": [(8, 0.0008, 8, 0.8)] * 16,
    "K=2": [(8, 0.008, 8, 0.08)] * 16,
    "K=4": [(8, 0.008, 8, 0.04)] * 16,
    "K=8": [(8, 0.8, 8, 0.008)] * 16,
    "mixed": [(8, 0.008, 8, 0.08)] * 10 + [(2, 0.001, 8, 0.02)] * 8,
}


@pytest.mark.parametrize("label", list(CHOOSER_CASES))
def test_chooser_matches_reference(label):
    """After the same ``note_megachunk_evidence`` calls, ``choose_megachunk_k``
    and ``megachunk_snapshot`` equal the reference's (the port's snapshot
    adds the group graphs it holds); ``reset_megachunk_adapt`` empties
    both."""
    key = ("lanes", 8, "sweep", 8, 1, 10240, 4, 16, "cuda")
    for mod in (engine, jengine):
        mod.reset_megachunk_adapt()
        for d, ds, c, dv in CHOOSER_CASES[label]:
            mod.note_megachunk_evidence(key, dispatches=d, dispatch_s=ds,
                                        chunks=c, device_s=dv)
        mod.note_megachunk_evidence(key, dispatches=0, dispatch_s=1.0,
                                    chunks=1, device_s=1.0)  # ignored
    try:
        got, want = engine.choose_megachunk_k(key), \
            jengine.choose_megachunk_k(key)
        assert got == want
        if label.startswith("K="):
            assert got == int(label[2:])
        snap = engine.megachunk_snapshot()
        assert set(snap.pop("graphs")) >= {"graphs", "captures", "max"}
        assert snap == jengine.megachunk_snapshot()
    finally:
        for mod in (engine, jengine):
            mod.reset_megachunk_adapt()
    assert engine.megachunk_snapshot()["buckets"] == {}


@pytest.mark.parametrize("value", ["auto", "4", "off", "x", ""])
def test_kao_megachunk_env_resolves_as_reference(value):
    """``KAO_MEGACHUNK`` read at import: both packages resolve the same
    process default (a malformed value is unset), and
    ``set_megachunk_default`` takes the flag spellings alike."""
    code = (
        "import json\n"
        "from kafka_assignment_optimizer_tpu.solvers.tpu import engine as j\n"
        "from kafka_assignment_optimizer_tpu_torch.solvers.tpu import "
        "engine as t\n"
        "out = [[j.megachunk_default(), t.megachunk_default()]]\n"
        "for v in ('auto', '2', 'off', True, False, 3, None):\n"
        "    j.set_megachunk_default(v); t.set_megachunk_default(v)\n"
        "    out.append([j.megachunk_default(), t.megachunk_default()])\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, KAO_MEGACHUNK=value, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out[0][0] == out[0][1] == {"auto": "auto", "4": 4}.get(value)
    for j, t in out[1:]:
        assert j == t


@pytest.mark.parametrize("width", [2, 4])
def test_auto_solve_matches_reference(no_race, width):
    """A CPU solve under ``megachunk="auto"``: each package's first auto
    solve names its evidence key; the same 16 solves of evidence, chosen
    to give ``width``, are then filed under it in both, and the next
    auto solve runs fused at that width, with ``stats["megachunk"]``
    (mode "auto"), the plan and the curve equal to the reference's and
    to the unfused ladder's."""
    cl = the_cluster()
    ev = {2: (8, 0.008, 8, 0.08), 4: (8, 0.008, 8, 0.04)}[width]
    base = port_solve(cl, pipeline=True)
    out = {}
    for mod, run in ((engine, port_solve), (jengine, ref_solve)):
        mod.reset_megachunk_adapt()
        first = run(cl, pipeline=True, megachunk="auto")
        assert first.solve.stats["megachunk"]["mode"] == "auto"
        assert first.solve.stats["megachunk"]["k"] == 1
        (key,) = [eval(k) for k in mod.megachunk_snapshot()["buckets"]]
        mod.reset_megachunk_adapt()
        for _ in range(16):
            d, ds, c, dv = ev
            mod.note_megachunk_evidence(key, dispatches=d, dispatch_s=ds,
                                        chunks=c, device_s=dv)
        out[mod] = run(cl, pipeline=True, megachunk="auto")
        mod.reset_megachunk_adapt()
    got, want = out[engine], out[jengine]
    assert_same(got, want, SEARCH + ("megachunk", "dispatches"))
    assert_same(got, base, SEARCH)
    mg = got.solve.stats["megachunk"]
    assert (mg["k"], mg["mode"], mg["chunks"]) == (width, "auto", 4)
    assert got.solve.stats["dispatches"] == 4 // width


def test_batch_auto_matches_reference():
    """``solve_tpu_batch(megachunk="auto")``: below quorum the lane
    ladder runs per chunk in mode "auto", equal to the reference's batch,
    and files its evidence (one solve) under its lanes key."""
    rng = np.random.default_rng(1)
    clusters = [random_cluster(rng, 12, 40 + 4 * i, 3, 3, drop=1)
                for i in range(2)]
    jinsts = [jax_build(*c) for c in clusters]
    tinsts = [build_instance(*port_cluster(*c)) for c in clusters]
    kw = dict(engine="sweep", rounds=32, time_limit_s=NO_DEADLINE,
              seeds=0, megachunk="auto")
    for mod in (engine, jengine):
        mod.reset_megachunk_adapt()
    try:
        want = jengine.solve_tpu_batch(jinsts, n_devices=1, **kw)
        got = engine.solve_tpu_batch(tinsts, device="cpu", **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.a, w.a)
            for f in ("score_curve", "moves", "megachunk", "dispatches"):
                assert g.stats[f] == w.stats[f], f
        assert got[0].stats["megachunk"]["mode"] == "auto"
        (ev,) = engine.megachunk_snapshot()["buckets"].values()
        assert ev["solves"] == 1 and ev["chunks"] == 4
        assert str(engine.megachunk_snapshot()["buckets"]).count(
            "'lanes'") == 1
    finally:
        for mod in (engine, jengine):
            mod.reset_megachunk_adapt()


@pytest.mark.parametrize("replays", [False, True])
def test_only_auto_dispatches_file_evidence(no_race, monkeypatch, replays):
    """The chooser's evidence comes only from ladders whose every
    dispatch is one chunk dispatched as "auto" dispatches it: a fused
    ladder (K=2) files nothing; where "auto" replays the step graph (a
    card, stood in here by ``_auto_replays``: the group then runs
    eagerly on the CPU) the default ladder's eager chunks file nothing
    either, and an "auto" solve files one solve of its 4 chunks."""
    cl = the_cluster()
    monkeypatch.setattr(engine, "_auto_replays",
                        lambda *_a, **_k: replays)
    engine.reset_megachunk_adapt()
    try:
        fused = port_solve(cl, pipeline=True, megachunk=2)
        assert fused.solve.stats["megachunk"]["k"] == 2
        assert engine.megachunk_snapshot()["buckets"] == {}
        port_solve(cl, pipeline=True)
        filed = engine.megachunk_snapshot()["buckets"]
        assert (filed == {}) is replays
        engine.reset_megachunk_adapt()
        auto = port_solve(cl, pipeline=True, megachunk="auto")
        assert_same(auto, fused, SEARCH)
        (ev,) = engine.megachunk_snapshot()["buckets"].values()
        assert (ev["solves"], ev["chunks"], ev["dispatches"]) == (1, 4, 4)
    finally:
        engine.reset_megachunk_adapt()


# ---------------------------------------- the group with its device done

# (label, active, armed): every step disarmed; a padded tail (the third
# step inactive); armed with thresholds every chain meets from its seed
GROUP_CASES = [("disarmed", (True, True, True), False),
               ("padded tail", (True, True, False), False),
               ("forced exit", (True, True, True), True)]
FORCED = dict(cert_k=-(2 ** 31) + 1, cert_mv=2 ** 31 - 1)


@pytest.fixture(scope="module")
def group_case():
    """One seeded cluster at a padded bucket, both packages' models (one
    and three lanes) and seeds, and a group of 3 steps of 4 sweeps."""
    from tests.test_torch_arrays import chains, pair
    from tests.test_torch_lanes import BUCKET, CFG_LANES, _stacked

    rng = np.random.default_rng(3)
    inst, mj, mt = pair(rng, bucket=BUCKET)
    msj, mst = _stacked(mj, mt, CFG_LANES)
    seed = jarrays.pad_candidate(
        np.asarray(chains(inst, mj, np.random.default_rng(1), 1)[0]), mj)
    temps = np.asarray(jarrays.geometric_temps(2.0, 0.02, 12)).reshape(3, 4)
    return dict(mj=mj, mt=mt, msj=msj, mst=mst, seed=seed, temps=temps,
                L=len(CFG_LANES))


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("case", GROUP_CASES, ids=[c[0] for c in GROUP_CASES])
def test_group_with_device_done_matches_reference(group_case, lanes, case):
    """The fused group with its ``done`` flag on the device and its keys
    as device keys (``make_mega_stepper_fn`` and, at L=3,
    ``make_mega_lane_stepper_fn``) equals the reference's group on its
    mesh of one device: the carried state and keys, the tops, ``cert_*``,
    the curves (zeros for a skipped step) and ``execd``, disarmed, with a
    padded tail and armed with an exit after the first step; a host key
    state comes back with host keys, read once after the group."""
    g = group_case
    _label, active, armed = case
    arm = FORCED if armed else {}
    N = 2
    jm = jmesh.make_mesh(n_devices=1)
    act = np.asarray(active)
    if lanes:
        L = g["L"]
        kj = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(7), i)
                        for i in range(L)])
        kt = np.stack([prng.fold_in(prng.PRNGKey(7), i) for i in range(L)])
        seeds = np.stack([g["seed"]] * L)
        sj = jmesh.init_lane_state(g["msj"], seeds, kj, jm, N)
        want = jmesh.solve_lanes_megachunk(
            g["msj"], jm, N, jnp.asarray(g["temps"]), sj,
            active=jnp.asarray(act), scorer="xla", **arm)
        st = mesh.init_lane_state(g["mst"], seeds, kt, N)
        fn = sweep.make_mega_lane_stepper_fn(N)
        m = g["mst"]
    else:
        sj = jmesh.init_sweep_state(g["mj"], jnp.asarray(g["seed"]),
                                    jax.random.PRNGKey(7), jm, N)
        want = jmesh.solve_megachunk(g["mj"], jm, N, jnp.asarray(g["temps"]),
                                     sj, active=jnp.asarray(act),
                                     scorer="xla", **arm)
        st = mesh.init_sweep_state(g["mt"], torch.from_numpy(g["seed"]),
                                   prng.PRNGKey(7), N)
        fn = sweep.make_mega_stepper_fn(N)
        m = g["mt"]
    args = (g["temps"], act, *(
        (FORCED["cert_k"], FORCED["cert_mv"]) if armed
        else (sweep.MEGA_DISARMED_KEY, sweep.MEGA_DISARMED_MOVES)))
    host = fn(m, st, *args)
    dst = (*st[:4], prng.to_device_keys(st[4], "cpu"))
    dev = fn(m, dst, *args)
    assert isinstance(dev[0][4], torch.Tensor)
    assert isinstance(host[0][4], np.ndarray)
    for got in (host, dev):
        for x, y in zip(want[0], got[0]):
            np.testing.assert_array_equal(np.asarray(x)[0], np.asarray(y))
        for name, x, y in zip(("top_a", "top_k", "cert_a", "cert_ok",
                               "cert_mv", "curves", "execd"),
                              want[1:], got[1:]):
            np.testing.assert_array_equal(np.asarray(x)[0], np.asarray(y),
                                          err_msg=name)
    execd = np.asarray(dev[7]).reshape(-1, 3)[0].tolist()
    assert execd == ([True, False, False] if armed else list(active))
    curves = np.asarray(dev[6]).reshape(-1, 3, 4)
    assert (curves[:, [j for j in range(3) if not execd[j]]] == 0).all()


@pytest.mark.parametrize("case", GROUP_CASES, ids=[c[0] for c in GROUP_CASES])
def test_eager_group_skips_what_the_host_knows(group_case, monkeypatch, case):
    """Run eagerly, a group runs a step only where the host's ``active``
    holds (a padded tail's step runs no sweep at all), and only an armed
    group combines the exit flags over its blocks (``Layout.any``, a
    copy between cards and an all_reduce across processes): a disarmed
    group never calls it (the test above holds the results to the
    reference's)."""
    g = group_case
    _label, active, armed = case
    calls = {"sweeps": 0, "any": 0}
    real_sweeps, real_any = sweep._sweeps, mesh.Layout.any

    def counted_sweeps(*a, **k):
        calls["sweeps"] += 1
        return real_sweeps(*a, **k)

    def counted_any(self, flags):
        calls["any"] += 1
        return real_any(self, flags)

    monkeypatch.setattr(sweep, "_sweeps", counted_sweeps)
    monkeypatch.setattr(mesh.Layout, "any", counted_any)
    st = mesh.init_sweep_state(g["mt"], torch.from_numpy(g["seed"]),
                               prng.PRNGKey(7), 2)
    out = sweep.make_mega_stepper_fn(2)(
        g["mt"], st, g["temps"], np.asarray(active), *(
            (FORCED["cert_k"], FORCED["cert_mv"]) if armed
            else (sweep.MEGA_DISARMED_KEY, sweep.MEGA_DISARMED_MOVES)))
    assert calls == {"sweeps": sum(active), "any": sum(active) * armed}
    assert out[7].tolist() == ([True, False, False] if armed
                               else list(active))


@pytest.mark.parametrize("L", [1, 3])
def test_device_key_lane_chunk_matches_reference(group_case, L):
    """One chunk of the lane stepper with device keys (the chunk step as
    a fused ladder runs it), at L=1 and L=3, equals the reference's
    ``make_lane_stepper_fn`` on its mesh of one device."""
    from tests.test_torch_lanes import _J_LANE_STEP, N_STEP

    g = group_case
    msj, mst = g["msj"], g["mst"]
    if L == 1:
        msj = jarrays.stack_models([g["mj"]])
        mst = arrays.stack_models([g["mt"]])
    kj = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(8), i)
                    for i in range(L)])
    kt = np.stack([prng.fold_in(prng.PRNGKey(8), i) for i in range(L)])
    seeds = np.stack([g["seed"]] * L)
    sj = tuple(jnp.asarray(x) for x in jmesh.init_lane_state(
        msj, seeds, kj, jmesh.make_mesh(n_devices=1), N_STEP))
    st = mesh.init_lane_state(mst, seeds, kt, N_STEP)
    st = (*st[:4], prng.to_device_keys(st[4], "cpu"))
    step = sweep.make_lane_stepper_fn(N_STEP)
    temps = g["temps"].reshape(-1)
    for chunk in (temps[:8], temps[8:]):
        sj, top_aj, top_kj, cv_j = _J_LANE_STEP(msj, sj, jnp.asarray(chunk))
        st, top_at, top_kt, cv_t = step(mst, st, chunk)
        for x, y in zip(sj, st):
            np.testing.assert_array_equal(np.asarray(x)[0], np.asarray(y))
        np.testing.assert_array_equal(np.asarray(top_aj)[0], top_at)
        np.testing.assert_array_equal(np.asarray(cv_j)[0], cv_t)


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
