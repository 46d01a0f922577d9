"""PyTorch port: the pipelined ladder against the reference's, on the CPU.

The reference runs its sweep ladder double-buffered by default: chunk i+1
is dispatched before chunk i is retired, and the result is bit-identical
to the synchronous ladder. The port does the same, so on the reference's
own seeded case (``random_cluster(rng, 12, 48, 3, 3, drop=1)``, 32
sweeps, a never-binding deadline that cuts 4 chunks, the boundary
certificate off) the port's plan, ``rounds_run``, ``score_curve``,
``final_cert`` and ``degradations`` equal the reference's, pipelined and
with ``pipeline=False``; the chain engine never speculates; the batch
lane ladder pipelines; the injected kernel fault at a mid-ladder chunk
takes the kernel->plain rung (``pallas_to_xla``, drained first when
pipelined) and still gives the reference's plan; a real kernel launch
failure raises in both modes; and the keywords still not ported raise.

The reference side passes ``precompile=True``, as its own tests do: that
switches its constructor races off, so a race finishing between two
chunks cannot decide the outcome. The port refuses ``precompile=True``;
its side stands the race workers down instead (``no_race``).
"""

import numpy as np
import pytest

from kafka_assignment_optimizer_tpu.api import optimize as jax_optimize
from kafka_assignment_optimizer_tpu.models.instance import (
    build_instance as jax_build,
)
from kafka_assignment_optimizer_tpu.resilience import chaos as jchaos
from kafka_assignment_optimizer_tpu.solvers.tpu import engine as jengine
from kafka_assignment_optimizer_tpu_torch.api import optimize
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.resilience import chaos, ladder
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine, sweep

from tests.test_torch_engine import port_cluster
from tests.test_tpu_engine import random_cluster

NO_DEADLINE = 3600.0
# the reference's parity knobs (tests/test_pipeline_parity.py): a 4-chunk
# sweep schedule, the boundary certificate off; its mesh of one device
KW = dict(solver="tpu", engine="sweep", seed=0, batch=8,
          time_limit_s=NO_DEADLINE, cert_min_savings_s=1e9, rounds=32)
FIELDS = ("engine", "rounds_run", "score_curve", "final_cert",
          "degradations", "moves", "feasible", "pipeline", "dispatches",
          "megachunk", "portfolio", "resumed_from_checkpoint",
          "early_stopped")


def _no_worker(*_a, **_k):
    return None, False, False


@pytest.fixture(scope="module")
def no_race():
    """The port's race workers stood down for the module: the
    reference's ``precompile=True`` does the same on its side."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("_construct_worker", "_exact_worker", "_reseat_worker"):
            mp.setattr(engine, name, _no_worker)
        yield


@pytest.fixture
def chaos_off():
    yield
    chaos.disarm()
    jchaos.disarm()


def the_cluster():
    """The reference parity tests' case, from the ``rng`` fixture's
    seed."""
    return random_cluster(np.random.default_rng(0), 12, 48, 3, 3, drop=1)


def ref_solve(cluster, **kw):
    return jax_optimize(*cluster, precompile=True, n_devices=1,
                        **{**KW, **kw})


def port_solve(cluster, **kw):
    return optimize(*port_cluster(*cluster), device="cpu", **{**KW, **kw})


def assert_same(got, want, fields=FIELDS):
    """The port's solve ``got`` equals the reference's ``want``: the
    plan, the weight, and each stats field."""
    np.testing.assert_array_equal(got.solve.a, want.solve.a)
    assert got.solve.objective == want.solve.objective
    for f in fields:
        assert got.solve.stats.get(f) == want.solve.stats.get(f), (
            f, got.solve.stats.get(f), want.solve.stats.get(f))


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's solves of the case, pipelined and synchronous."""
    cl = the_cluster()
    return {p: ref_solve(cl, pipeline=p) for p in (True, False)}


def test_sweep_pipelined_equals_sync_and_reference(no_race, ref_runs):
    """The default (``pipeline=None``) runs the pipelined walker; it and
    ``pipeline=False`` give the reference's plan, curve and stats."""
    cl = the_cluster()
    got = {p: port_solve(cl, pipeline=p) for p in (None, True, False)}
    assert ref_runs[True].solve.stats["pipeline"] is True
    assert got[None].solve.stats["pipeline"] is True
    assert got[False].solve.stats["pipeline"] is False
    assert got[None].solve.stats["dispatches"] == 4
    assert_same(got[None], ref_runs[True])
    assert_same(got[True], ref_runs[True])
    assert_same(got[False], ref_runs[False])
    # the scheduling differs, the search does not
    assert_same(got[True], got[False],
                [f for f in FIELDS if f != "pipeline"])
    st = got[True].solve.stats
    assert st["rounds_run"] == 32 and st["feasible"]
    assert st["boundary_overlap_s"] >= 0 and st["dispatch_s"] > 0


def test_chain_pipeline_flag_is_inert(no_race):
    """The chain engine's reseed is a data dependency: ``pipeline=True``
    never speculates, and equals the reference's either way."""
    cl = random_cluster(np.random.default_rng(0), 10, 20, 2, 2, drop=1)
    kw = dict(engine="chain", rounds=8, steps_per_round=120)
    for p in (True, False):
        want = ref_solve(cl, pipeline=p, **kw)
        got = port_solve(cl, pipeline=p, **kw)
        assert got.solve.stats["pipeline"] is False
        assert_same(got, want)


def _arm_at_second_chunk(monkeypatch, point: str) -> None:
    """Arm ``point`` in both packages on the second chunk dispatch, just
    before its chaos hooks fire (a mid-ladder fault)."""
    for mod, harness in ((engine, chaos), (jengine, jchaos)):
        real = mod._chaos_chunk_hooks
        calls = {"n": 0}

        def hooks(real=real, calls=calls, harness=harness):
            calls["n"] += 1
            if calls["n"] == 2:
                harness.arm(point)
            real()

        monkeypatch.setattr(mod, "_chaos_chunk_hooks", hooks)


@pytest.mark.parametrize("pipeline", [False, True])
def test_pallas_fault_midladder_takes_the_plain_rung(no_race, ref_runs,
                                                     monkeypatch, chaos_off,
                                                     pipeline):
    """The injected kernel fault at chunk 1 re-runs that chunk on the
    plain versions (``pallas_to_xla``; pipelined, the speculation drains
    first: ``pipelined_to_sync``), loses no chunk and gives the
    reference's plan, which is the unfaulted one."""
    _arm_at_second_chunk(monkeypatch, "pallas_fault")
    cl = the_cluster()
    want = ref_solve(cl, pipeline=pipeline)
    got = port_solve(cl, pipeline=pipeline)
    st = got.solve.stats
    assert st["degradations"] == (
        ["pallas_to_xla", "pipelined_to_sync"] if pipeline
        else ["pallas_to_xla"])
    assert "pallas_fault" in st["pallas_fallback"]
    assert st["scorer"] == "torch" and st["rounds_run"] == 32
    assert_same(got, want)
    assert_same(got, ref_runs[pipeline],
                [f for f in FIELDS if f != "degradations"])


def _failing_bundle(real):
    """A kernel bundle whose site sweep fails to launch, as a CUDA launch
    error surfaces (a ``RuntimeError``)."""
    def make(scorer):
        b = real(scorer)

        def broken(*_a):
            raise RuntimeError("CUDA error: unspecified launch failure")

        return b._replace(site_step=broken)

    return make


@pytest.mark.parametrize("pipeline", [False, True])
def test_real_kernel_failure_raises(no_race, monkeypatch, pipeline):
    """Only the injected fault takes the plain rung: a real launch
    failure raises, in both walkers and in the batch ladder, with no rung
    taken and no host fallback."""
    monkeypatch.setattr(sweep, "_make_lane_scorer",
                        _failing_bundle(sweep._make_lane_scorer))
    before = ladder.snapshot()
    cl = the_cluster()
    with pytest.raises(RuntimeError, match="launch failure"):
        port_solve(cl, pipeline=pipeline)
    with pytest.raises(RuntimeError, match="launch failure"):
        port_solve(cl, pipeline=pipeline, megachunk=2)
    inst = build_instance(*port_cluster(*cl))
    with pytest.raises(RuntimeError, match="launch failure"):
        engine.solve_tpu_batch([inst, inst], engine="sweep", rounds=32,
                               time_limit_s=NO_DEADLINE, pipeline=pipeline,
                               device="cpu")
    assert ladder.snapshot() == before
    assert not engine._is_pallas_lowering(
        RuntimeError("CUDA error: unspecified launch failure"))


def test_batch_lane_ladder_pipelined_equals_reference():
    """``solve_tpu_batch`` pipelined and synchronous: each lane's plan,
    curve and moves equal the reference's batch, lane for lane."""
    rng = np.random.default_rng(0)
    clusters = [random_cluster(rng, 12, 40 + 4 * i, 3, 3, drop=1)
                for i in range(3)]
    jinsts = [jax_build(*c) for c in clusters]
    tinsts = [build_instance(*port_cluster(*c)) for c in clusters]
    kw = dict(engine="sweep", rounds=32, time_limit_s=NO_DEADLINE)
    for p in (True, False):
        want = jengine.solve_tpu_batch(jinsts, seeds=0, pipeline=p,
                                       n_devices=1, **kw)
        got = engine.solve_tpu_batch(tinsts, seeds=0, pipeline=p,
                                     device="cpu", **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.a, w.a)
            for f in ("score_curve", "moves", "rounds_run", "pipeline",
                      "dispatches", "megachunk"):
                assert g.stats[f] == w.stats[f], (f, p)
        assert got[0].stats["pipeline"] is p


def test_process_default_and_unported_keywords(no_race):
    """``set_pipeline_default(False)`` makes a defaulted solve
    synchronous; ``n_devices`` above 1 solves as the reference's mesh
    does, and ``precompile=True`` and ``trace`` (ported with the service)
    are accepted by both entry points."""
    cl = the_cluster()
    assert engine._PIPELINE_DEFAULT is jengine._PIPELINE_DEFAULT is True
    engine.set_pipeline_default(False)
    try:
        assert port_solve(cl).solve.stats["pipeline"] is False
    finally:
        engine.set_pipeline_default(True)
    inst = build_instance(*port_cluster(*cl))
    # n_devices above 1 is ported: the pipelined batch ladder on two
    # shards gives the reference's two-device plan
    kw = dict(engine="sweep", sweeps=8, batch=4, n_devices=2)
    want = jengine.solve_tpu_batch([jax_build(*cl)], **kw)
    got = engine.solve_tpu_batch([inst], device="cpu", **kw)
    np.testing.assert_array_equal(got[0].a, want[0].a)
    for f in ("devices", "chains_per_device", "moves", "score_curve",
              "pipeline"):
        assert got[0].stats[f] == want[0].stats[f], f
    out = engine.solve_tpu_batch([inst], device="cpu", trace=True,
                                 precompile=True, engine="sweep", sweeps=8,
                                 batch=2)
    assert out[0].stats["solve_report"]["name"] == "solve_tpu_batch"
