"""PyTorch port: the delta API against the JAX package — ``adapt_plan``
(the previous plan adapted to the post-event cluster), the engine's
warm-start admission (``_validate_warm_start``), ``optimize_delta`` end
to end, and a warm-started solve whose warm candidate does not certify,
so the ladder runs from it. Plans, reasons, rungs and ``warm_started``
equal the reference's."""

import numpy as np
import pytest

from kafka_assignment_optimizer_tpu import api as japi
from kafka_assignment_optimizer_tpu.models import cluster as jcluster
from kafka_assignment_optimizer_tpu.models.instance import (
    build_instance as jax_build,
)
from kafka_assignment_optimizer_tpu.resilience import ladder as jladder
from kafka_assignment_optimizer_tpu.solvers.tpu import engine as jengine
from kafka_assignment_optimizer_tpu.utils import gen as jgen
from kafka_assignment_optimizer_tpu.watch import adapt as jadapt
from kafka_assignment_optimizer_tpu_torch import optimize_delta
from kafka_assignment_optimizer_tpu_torch.models import cluster
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.resilience import ladder
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine
from kafka_assignment_optimizer_tpu_torch.solvers.tpu.seed import greedy_seed
from kafka_assignment_optimizer_tpu_torch.watch import adapt

from tests.test_torch_engine import REF_KW, assert_same, port_cluster


@pytest.fixture(autouse=True)
def _reset_rungs():
    jladder.reset()
    ladder.reset()
    yield
    jladder.reset()
    ladder.reset()


def _assign(P=8, B=4, rf=2):
    return {
        "version": 1,
        "partitions": [
            {"topic": "t", "partition": p,
             "replicas": [(p + i) % B for i in range(rf)]}
            for p in range(P)
        ],
    }


def _pair(current: dict, brokers, rack_of: dict):
    """The same cluster as each package's instance."""
    out = []
    for mod, build in ((jcluster, jax_build), (cluster, build_instance)):
        out.append(build(mod.Assignment.from_dict(current), list(brokers),
                         mod.Topology(rack_of=dict(rack_of)), None))
    return out


def _even_odd(B):
    return {b: ("even" if b % 2 == 0 else "odd") for b in range(B)}


# the three cases of the reference's own adapt tests: two brokers
# drained (evict and refill), partition growth over the same drain, and
# a recovery (brokers 6 and 7 back; the bands repaired move-minimally)
ADAPT_CASES = {
    "evict": (_assign(P=24, B=8, rf=3), range(6), _assign(P=24, B=8, rf=3)),
    "growth": (_assign(P=28, B=8, rf=3), range(6), _assign(P=24, B=8, rf=3)),
    "recovery": (_assign(P=24, B=6, rf=3), range(8),
                 _assign(P=24, B=6, rf=3)),
}


@pytest.mark.parametrize("case", sorted(ADAPT_CASES))
def test_adapt_plan_matches_reference(case):
    current, brokers, prev = ADAPT_CASES[case]
    inst_j, inst_t = _pair(current, brokers, _even_odd(8))
    aj, why_j = jadapt.adapt_plan(inst_j, jcluster.Assignment.from_dict(prev))
    at, why_t = adapt.adapt_plan(inst_t, cluster.Assignment.from_dict(prev))
    assert why_t == why_j and why_t.startswith("ok")
    np.testing.assert_array_equal(at, aj)
    if case == "recovery":
        assert int(inst_t.move_count(at)) == 2 * int(inst_t.broker_lo)


def test_validate_warm_start_matches_reference():
    """A candidate whose only violation is the leader band is reseated at
    admission; an all-zero one (a duplicate broker in every partition) is
    rejected onto the ladder."""
    current = _assign(P=24, B=6, rf=3)
    inst_j, inst_t = _pair(current, range(8), _even_odd(8))
    prev = jcluster.Assignment.from_dict(current)
    a, _why = jadapt.adapt_plan(inst_j, prev)
    assert inst_t.violations(a)["leader_balance"] > 0
    oj = jengine._validate_warm_start(inst_j, a)
    ot = engine._validate_warm_start(inst_t, a)
    np.testing.assert_array_equal(ot, oj)
    assert sum(inst_t.violations(ot).values()) == 0
    bad = np.zeros((inst_t.num_parts, inst_t.max_rf), dtype=np.int32)
    assert jengine._validate_warm_start(inst_j, bad) is None
    assert engine._validate_warm_start(inst_t, bad) is None
    assert ladder.snapshot()["warm_start_rejected"] == 1
    assert jladder.snapshot()["warm_start_rejected"] == 1


def test_rejected_warm_start_solves_cold_as_reference():
    current = _assign(P=12, B=6, rf=2)
    inst_j, inst_t = _pair(current, range(6), _even_odd(6))
    bad = np.zeros((inst_t.num_parts, inst_t.max_rf), dtype=np.int32)
    rj = jengine.solve_tpu(inst_j, seed=0, time_limit_s=30, warm_start=bad)
    rt = engine.solve_tpu(inst_t, seed=0, time_limit_s=30, warm_start=bad,
                          device="cpu")
    assert_same(rj, rt)
    assert rt.stats["feasible"] and rt.stats["warm_started"] is False
    assert rt.stats["degradations"] == ["warm_start_rejected"]


def test_optimize_delta_matches_reference():
    """Brokers 6 and 7 drained: the adapted previous plan certifies in the
    race (``construct_path "warm"``), with no device touched."""
    current = _assign(P=24, B=8, rf=3)
    topo_j = jcluster.Topology(rack_of=_even_odd(8))
    topo_t = cluster.Topology(rack_of=_even_odd(8))
    rj = japi.optimize_delta(
        jcluster.Assignment.from_dict(current), list(range(6)), topo_j,
        prev_plan=current, solver="tpu", **REF_KW)
    rt = optimize_delta(
        cluster.Assignment.from_dict(current), list(range(6)), topo_t,
        prev_plan=current, solver="tpu", device="cpu")
    assert rt.assignment.to_json() == rj.assignment.to_json()
    assert rt.replica_moves == rj.replica_moves
    for f in ("engine", "construct_path", "warm_started", "proved_optimal",
              "moves", "feasible"):
        assert rt.solve.stats.get(f) == rj.solve.stats.get(f), f
    assert rt.solve.stats["construct_path"] == "warm"
    assert rt.solve.stats["warm_started"] is True
    # "auto" resolves to the exact MILP here: the previous plan is ignored
    got = optimize_delta(cluster.Assignment.from_dict(current),
                         list(range(6)), topo_t, prev_plan=current,
                         device="cpu")
    assert got.solve.solver == "milp"
    assert got.replica_moves == rt.replica_moves


def test_uncertified_warm_start_seeds_the_ladder():
    """``gen.adversarial(n_brokers=24, n_racks=4, n_topics_low=3,
    n_topics_high=3, parts_per_topic=10, seed=2)`` (slack caps, no
    symmetry: with knobs set no constructor races), warm-started from the
    greedy repair's own plan, as if the previous rebalance had applied
    it: the candidate ties the greedy seed's rank, so it seeds the
    ladder, but at 8 moves against the exact bound's 7 it does not
    certify, so the ladder runs from it."""
    s = jgen.adversarial(n_brokers=24, n_racks=4, n_topics_low=3,
                         n_topics_high=3, parts_per_topic=10, seed=2)
    inst_j = jax_build(s.current, s.broker_list, s.topology)
    inst_t = build_instance(*port_cluster(s.current, s.broker_list,
                                          s.topology))
    prev = inst_t.decode(greedy_seed(inst_t))
    warm, _why = adapt.adapt_plan(inst_t, prev)
    for inst in (inst_j, inst_t):
        inst.move_lower_bound_exact()
        inst.weight_upper_bound()
    assert inst_t.move_count(warm) == 8
    assert inst_t.move_lower_bound_exact() == 7
    kw = dict(seed=0, engine="sweep", sweeps=16, portfolio=False,
              cert_min_savings_s=1e9, warm_start=warm)
    rj = jengine.solve_tpu(inst_j, **kw, n_devices=1, pipeline=False,
                           megachunk=1)
    rt = engine.solve_tpu(inst_t, **kw, device="cpu")
    assert_same(rj, rt)
    assert rt.stats["warm_started"] is True
    assert rt.stats["construct_path"] is None
    assert rt.stats["seed_moves"] == rj.stats["seed_moves"] == 8
    assert rt.stats["engine"] == "sweep" and rt.stats["rounds_run"] == 16
    assert rt.stats["feasible"]


# the watch manager behind the service's delta API, in both packages: the
# demo cluster bootstrapped, broker 7 drained, the RF raised to 3 (each
# post-event state small enough for "auto" to send it to the exact MILP),
# then a replayed epoch fenced with the reference's structured 409
EVENTS = [
    {"type": "bootstrap", "epoch": 1,
     "assignment": cluster.demo_assignment().to_dict(),
     "brokers": list(range(19)), "topology": "even-odd"},
    {"type": "broker_drain", "epoch": 2, "brokers": [7]},
    {"type": "rf_change", "epoch": 3, "rf": 3},
]


@pytest.fixture
def watch_servers(monkeypatch):
    from kafka_assignment_optimizer_tpu import serve as jserve
    from kafka_assignment_optimizer_tpu_torch import serve

    for mod in (jserve, serve):
        monkeypatch.setitem(mod.WATCH, "dir", None)
        monkeypatch.setitem(mod.WATCH, "registry", None)
        monkeypatch.setitem(mod.WATCH, "window_s", 0.0)
    monkeypatch.setitem(serve.SERVE, "device", "cpu")
    yield jserve, serve
    for mod in (jserve, serve):
        mod.WATCH["registry"] = None


def test_watch_event_sequence_matches_reference(watch_servers):
    jserve, serve = watch_servers
    for ev in EVENTS:
        (sj, bj), (st, bt) = (mod.handle_cluster_event("c1", dict(ev))
                              for mod in (jserve, serve))
        assert (st, bt["status"], bt["epoch"], bt["plan_epoch"]) == \
            (sj, bj["status"], bj["epoch"], bj["plan_epoch"]) == \
            (200, "planned", ev["epoch"], ev["epoch"])
        assert bt["assignment"] == bj["assignment"]
        for f in ("replica_moves", "feasible", "proven_optimal", "solver",
                  "objective_weight", "violations"):
            assert bt["report"][f] == bj["report"][f], (ev["type"], f)
    plan = bt["assignment"]["partitions"]
    assert all(7 not in p["replicas"] and len(p["replicas"]) == 3
               for p in plan)
    errs = []
    for mod in (jserve, serve):
        with pytest.raises(mod.ApiError) as ei:
            mod.handle_cluster_event("c1", dict(EVENTS[1]))
        errs.append((ei.value.status, ei.value.body_extra))
    assert errs[1] == errs[0] and errs[1][0] == 409
    got = [mod.handle_clusters_get("c1") for mod in (jserve, serve)]
    assert {k: got[1][k] for k in ("epoch", "plan_epoch", "plan")} == \
        {k: got[0][k] for k in ("epoch", "plan_epoch", "plan")}
