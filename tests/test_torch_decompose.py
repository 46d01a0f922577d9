"""PyTorch port: the decomposed solve against the JAX package. ``split``
and ``stitch`` field for field on the smoke ``ultra_jumbo`` instance;
``should_decompose`` under the keyword, ``KAO_DECOMPOSE``,
``KAO_DECOMPOSE_AUTO_PARTS`` and a custom ``KAO_BUCKETS`` ladder; C6 —
with ``KAO_DECOMPOSE=1`` the smoke solve (``seed=0, rounds=6``) is
``"decomposed"`` with the reference's plan and ``stats["decompose"]``;
and the ways back to the flat path: a stitch that stays infeasible and
a reduce fault (``decompose_to_flat``), an unsplittable instance and a
warm start."""

import os

import numpy as np
import pytest

from kafka_assignment_optimizer_tpu import build_instance as jax_build
from kafka_assignment_optimizer_tpu import decompose as jdecompose
from kafka_assignment_optimizer_tpu.decompose.split import split as jsplit
from kafka_assignment_optimizer_tpu.decompose.stitch import stitch as jstitch
from kafka_assignment_optimizer_tpu.resilience import chaos as jchaos
from kafka_assignment_optimizer_tpu.resilience import ladder as jladder
from kafka_assignment_optimizer_tpu.solvers.tpu import engine as jengine
from kafka_assignment_optimizer_tpu.solvers.tpu.seed import (
    greedy_seed as jgreedy,
)
from kafka_assignment_optimizer_tpu.utils import gen as jgen
from kafka_assignment_optimizer_tpu.watch import adapt as jadapt
from kafka_assignment_optimizer_tpu_torch import decompose
from kafka_assignment_optimizer_tpu_torch.decompose.split import split
from kafka_assignment_optimizer_tpu_torch.decompose.stitch import (
    lane_feasible,
    stitch,
)
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.resilience import chaos, ladder
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine
from kafka_assignment_optimizer_tpu_torch.solvers.tpu.seed import greedy_seed
from kafka_assignment_optimizer_tpu_torch.utils import gen

from tests.test_torch_engine import REF_KW, port_cluster

SUB_FIELDS = ("broker_ids", "rack_of_broker", "topic_of_part", "part_id",
              "rf", "a0", "w_leader", "w_follower", "rack_lo", "rack_hi",
              "part_rack_hi")
STATS_FIELDS = ("engine", "map_engine", "moves", "feasible",
                "proved_optimal", "rounds_run", "warm_started",
                "degradations", "timed_out", "construct_path")


@pytest.fixture(autouse=True)
def _disarmed():
    for c, lad in ((jchaos, jladder), (chaos, ladder)):
        c.disarm()
        lad.reset()
    yield
    for c, lad in ((jchaos, jladder), (chaos, ladder)):
        c.disarm()
        lad.reset()


def _pair(scen):
    """A reference-package scenario as each package's instance."""
    return (jax_build(scen.current, scen.broker_list, scen.topology),
            build_instance(*port_cluster(scen.current, scen.broker_list,
                                         scen.topology)))


def _smoke():
    s = jgen.ultra_jumbo(seed=0, **jgen.SMOKE_KWARGS["ultra_jumbo"])
    port = gen.ultra_jumbo(seed=0, **gen.SMOKE_KWARGS["ultra_jumbo"])
    assert port.current.to_json() == s.current.to_json()
    assert port.broker_list == s.broker_list
    assert port.topology.rack_of == s.topology.rack_of
    return s


def _small():
    """A 2,000-partition case of the family (4 AZs of 500): one AZ's
    greedy seed keeps 2 violations that 16 sweeps of its lane do not
    repair, as at the published size."""
    return jgen.ultra_jumbo(partitions=2_000, seed=0)


# the sweep map, 16 rounds, in both packages (the CPU default below 512
# partitions an AZ is the chain engine); the flat path takes the same
SMALL_KW = dict(seed=0, engine="sweep", rounds=16, batch=4,
                cert_min_savings_s=1e9)


def _prewarmed(scen):
    inst_j, inst_t = _pair(scen)
    for inst in (inst_j, inst_t):
        inst.move_lower_bound_exact()
        inst.weight_upper_bound()
    return inst_j, inst_t


def _same(rj, rt, fields=STATS_FIELDS):
    np.testing.assert_array_equal(rt.a, rj.a)
    assert rt.objective == rj.objective and rt.optimal == rj.optimal
    for f in fields:
        assert rt.stats.get(f) == rj.stats.get(f), (
            f, rt.stats.get(f), rj.stats.get(f))


def test_split_and_stitch_match_reference():
    inst_j, inst_t = _pair(_smoke())
    sj, st = jsplit(inst_j), split(inst_t)
    assert st.n_groups == sj.n_groups == 3
    assert st.group_names == sj.group_names
    assert st.moved_for_slack == sj.moved_for_slack
    assert st.uniform_shape and sj.uniform_shape
    for f in ("group_of_rack", "group_of_part", "boundary"):
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f))
    for g in range(st.n_groups):
        np.testing.assert_array_equal(st.part_idx[g], sj.part_idx[g])
        np.testing.assert_array_equal(st.broker_idx[g], sj.broker_idx[g])
        a, b = st.subs[g], sj.subs[g]
        assert a.rack_names == b.rack_names and a.topics == b.topics
        for f in ("broker_lo", "broker_hi", "leader_lo", "leader_hi"):
            assert getattr(a, f) == getattr(b, f), f
        for f in SUB_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    # stitch: the sub-instances' current placements, and random plans
    rng = np.random.default_rng(0)
    for plans in ([s.a0 for s in st.subs],
                  [rng.integers(0, s.num_brokers + 1, size=s.a0.shape)
                   .astype(np.int32) for s in st.subs]):
        np.testing.assert_array_equal(stitch(inst_t, st, plans),
                                      jstitch(inst_j, sj, plans))
    assert lane_feasible([None]) == [False]


@pytest.mark.parametrize("extra", [0, 1])
def test_greedy_seed_of_an_az_lane_matches_reference(extra):
    """The first AZ of ``ultra_jumbo(n_az=3, racks_per_az=4,
    partitions=1200)`` (400 partitions): the greedy repair's band pass
    moves one replica back and forth between two brokers until its repair
    cap, which the port skips to the state the cap leaves (one more move
    when an odd number of repairs is left: the default cap and one more
    cover both). Equal to the reference's, in both of the port's forms."""
    s = jgen.ultra_jumbo(n_az=3, racks_per_az=4, partitions=1200, seed=0)
    inst_j, inst_t = _pair(s)
    sub_j, sub_t = jsplit(inst_j).subs[0], split(inst_t).subs[0]
    cap = 4 * int(sub_t.rf.sum()) + 64 + extra
    ref = jgreedy(sub_j, max_repairs=cap)
    np.testing.assert_array_equal(greedy_seed(sub_t, max_repairs=cap), ref)
    np.testing.assert_array_equal(
        greedy_seed(sub_t, max_repairs=cap, impl="legacy"), ref)


def test_should_decompose_matches_reference(monkeypatch):
    inst_j, inst_t = _pair(_smoke())

    def both(requested=None):
        got = decompose.should_decompose(inst_t, requested)
        assert got == jdecompose.should_decompose(inst_j, requested)
        return got

    assert both(True) is True and both(False) is False
    monkeypatch.setenv("KAO_DECOMPOSE", "1")
    assert both() is True and both(False) is False
    monkeypatch.setenv("KAO_DECOMPOSE", "0")
    assert both() is False
    monkeypatch.delenv("KAO_DECOMPOSE")
    assert both() is False  # auto: 600 partitions, below 150,000
    monkeypatch.setenv("KAO_DECOMPOSE_AUTO_PARTS", str(inst_t.num_parts))
    assert both() is True
    monkeypatch.delenv("KAO_DECOMPOSE_AUTO_PARTS")
    monkeypatch.setenv("KAO_BUCKETS", "64,256")  # 600 > the top rung
    assert both() is True
    assert decompose.config_snapshot()["sub_bucket_ladder"] == [64, 256]
    monkeypatch.setenv("KAO_BUCKETS", "64,1024")
    assert both() is False


@pytest.fixture(scope="module")
def c6():
    """C6: the smoke instance under ``KAO_DECOMPOSE=1``, ``seed=0,
    rounds=6``, once in each package (the map engine is the chain engine
    on the CPU below 512 partitions)."""
    inst_j, inst_t = _pair(_smoke())
    saved = os.environ.get("KAO_DECOMPOSE")
    os.environ["KAO_DECOMPOSE"] = "1"
    try:
        rj = jengine.solve_tpu(inst_j, seed=0, rounds=6, **REF_KW)
        rt = engine.solve_tpu(inst_t, seed=0, rounds=6, device="cpu",
                              **REF_KW)
        attempt = decompose.STATS.snapshot()["attempt"]
    finally:
        if saved is None:
            os.environ.pop("KAO_DECOMPOSE", None)
        else:
            os.environ["KAO_DECOMPOSE"] = saved
    return inst_t, rj, rt, attempt


def test_decomposed_solve_matches_reference(c6):
    inst, rj, rt, attempt = c6
    _same(rj, rt)
    assert rt.stats["decompose"] == rj.stats["decompose"]
    assert rt.stats["engine"] == "decomposed"
    assert rt.stats["map_engine"] == "chain"
    assert (rt.stats["moves"], rt.objective) == (181, 3_307)
    d = rt.stats["decompose"]
    assert (d["subproblems"], d["iterations"], d["bound_gap"]) == (3, 2, 209)
    assert d["sub_shape"]["lane_bucket"] == 8
    assert inst.is_feasible(rt.a) and not rt.optimal
    # the port's record of the attempt's last iteration
    assert attempt["iteration"] == 2 and attempt["stitch_violations"] == 0
    assert attempt["lane_violations"] == [0, 0, 0]
    assert [len(attempt["times"][k]) for k in ("map", "reduce")] == [2, 2]


@pytest.mark.parametrize("fault", [None, "decompose_reduce"])
def test_failed_reduce_degrades_to_flat_as_reference(fault):
    """The stitched plan stays infeasible after both iterations (the
    lanes keep their seeds' violations: the published size's outcome),
    or ``decompose_reduce`` fires after the first map: either way the
    rung is noted, the counters move, and the flat path's plan equals the
    reference's."""
    inst_j, inst_t = _prewarmed(_small())
    before = decompose.STATS.snapshot()["counters"]["fallback"]
    if fault:
        jchaos.arm(fault)
    rj = jengine.solve_tpu(inst_j, decompose=True, **SMALL_KW, **REF_KW)
    if fault:
        chaos.arm(fault)
    rt = engine.solve_tpu(inst_t, decompose=True, device="cpu", **SMALL_KW,
                          **REF_KW)
    _same(rj, rt)
    assert rt.stats["engine"] == "sweep"
    assert rt.stats["degradations"] == ["decompose_to_flat"]
    assert ladder.snapshot()["decompose_to_flat"] == 1
    assert decompose.STATS.snapshot()["counters"]["fallback"] == before + 1
    assert inst_t.is_feasible(rt.a)
    if not fault:
        att = decompose.STATS.snapshot()["attempt"]
        assert att["iteration"] == 2 and att["stitch_violations"] > 0
        assert att["lane_violations"] == [0, 2, 0, 0]


def test_unsplittable_instance_falls_through_as_reference():
    """Racks named without an AZ prefix: no split, the flat path."""
    s = jgen.decommission(n_brokers=32, n_topics=4, parts_per_topic=50)
    inst_j, inst_t = _pair(s)
    assert split(inst_t) is None
    before = decompose.STATS.snapshot()["counters"]["unsplittable"]
    rj = jengine.solve_tpu(inst_j, seed=0, decompose=True, **REF_KW)
    rt = engine.solve_tpu(inst_t, seed=0, decompose=True, device="cpu",
                          **REF_KW)
    _same(rj, rt)
    assert rt.stats["engine"] != "decomposed" and rt.stats["feasible"]
    assert decompose.STATS.snapshot()["counters"]["unsplittable"] == (
        before + 1)


def test_warm_start_skips_decomposition_as_reference(monkeypatch):
    """Even with ``KAO_DECOMPOSE=1`` a warm start (flat-plan shaped)
    keeps the flat path."""
    monkeypatch.setenv("KAO_DECOMPOSE", "1")
    s = _small()
    inst_j, inst_t = _prewarmed(s)
    warm, _why = jadapt.adapt_plan(inst_j, s.current)
    before = decompose.STATS.snapshot()["counters"]
    rj = jengine.solve_tpu(inst_j, warm_start=warm, **SMALL_KW, **REF_KW)
    rt = engine.solve_tpu(inst_t, warm_start=warm, device="cpu",
                          **SMALL_KW, **REF_KW)
    _same(rj, rt)
    assert rt.stats["engine"] != "decomposed"
    assert decompose.STATS.snapshot()["counters"] == before
