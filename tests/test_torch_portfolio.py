"""PyTorch port: the portfolio against the JAX package. ``portfolio=None``
races the eight ``PORTFOLIO_TABLE`` configs as lanes, as the reference
does (it used to run one lane here); the resolved width, the config
table and its adaptive order, and whole solves — plan, ``rounds_run``,
``final_cert`` and ``stats["portfolio"]`` — equal the reference's on its
mesh of one device, with the boundary certificate off, tried at every
boundary, and forced mid-ladder.

Timing decides whether a boundary certificate is tried
(``cert_min_savings_s`` against the measured chunk time, and whether the
bounds prefetch has ended), so every compared solve memoizes the bounds
first and pins ``cert_min_savings_s`` to 0 (always) or 1e9 (never)."""

import dataclasses

import numpy as np
import pytest

from kafka_assignment_optimizer_tpu import build_instance as jax_build
from kafka_assignment_optimizer_tpu.solvers.tpu import arrays as jarrays
from kafka_assignment_optimizer_tpu.solvers.tpu import engine as jengine
from kafka_assignment_optimizer_tpu.utils import gen as jgen
from kafka_assignment_optimizer_tpu_torch.models.cluster import (
    Assignment,
    Topology,
)
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import arrays, engine
from kafka_assignment_optimizer_tpu_torch.utils import gen

from tests.test_torch_engine import port_cluster

# the reference's mesh of one device and its sequential ladder; the
# portfolio is left at its default
REF_KW = dict(n_devices=1, pipeline=False, megachunk=1)
KNOBS = dict(engine="sweep", batch=8, rounds=32)
FIELDS = ("engine", "rounds_run", "final_cert", "moves", "feasible",
          "violations", "proved_optimal", "early_stopped", "timed_out",
          "score_curve")


def _adv9():
    s = jgen.adversarial(n_brokers=32, n_topics_low=3, n_topics_high=3,
                         parts_per_topic=10, seed=9)
    return (jax_build(s.current, s.broker_list, s.topology),
            build_instance(*port_cluster(s.current, s.broker_list,
                                         s.topology)))


def _messy1():
    current, brokers, topo, rf = jgen.messy_case(1)
    port = gen.messy_case(1)
    assert port[0].to_json() == current.to_json()
    assert port[1:] == (brokers, Topology(rack_of=dict(topo.rack_of)), rf)
    return (jax_build(current, brokers, topo, rf),
            build_instance(Assignment.from_json(port[0].to_json()),
                           *port[1:]))


CASES = {"adv9": (_adv9, 0), "messy1": (_messy1, 1)}


def _solve_pair(case, portfolio, cert_s, **kw):
    make, seed = CASES[case]
    inst_j, inst_t = make()
    for inst in (inst_j, inst_t):
        inst.move_lower_bound_exact()
        inst.weight_upper_bound()
    args = dict(seed=seed, portfolio=portfolio, cert_min_savings_s=cert_s,
                **KNOBS, **kw)
    return (jengine.solve_tpu(inst_j, **REF_KW, **args),
            engine.solve_tpu(inst_t, device="cpu", **args))


def _port_stats(st):
    p = st.get("portfolio")
    return None if p is None else {k: v for k, v in p.items()
                                   if k != "certified_at_s"}


# (case, portfolio, cert_min_savings_s): the reference's results, once
RUNS = [("adv9", None, 1e9), ("adv9", None, 0.0), ("messy1", None, 1e9),
        ("messy1", False, 1e9)]


@pytest.fixture(scope="module")
def solved():
    return {run: _solve_pair(*run) for run in RUNS}


def _assert_same(rj, rt):
    np.testing.assert_array_equal(rt.a, rj.a)
    assert rt.objective == rj.objective and rt.optimal == rj.optimal
    for f in FIELDS:
        assert rt.stats.get(f) == rj.stats.get(f), (
            f, rt.stats.get(f), rj.stats.get(f))
    assert _port_stats(rt.stats) == _port_stats(rj.stats)


@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"{r[0]}-{r[1]}-{r[2]}")
def test_portfolio_solve_matches_reference(solved, run):
    rj, rt = solved[run]
    _assert_same(rj, rt)
    p = rt.stats.get("portfolio")
    if run[1] is None:
        assert p["width"] == 8 and p["lane_bucket"] == 8
        assert p["winner_config"] == dataclasses.asdict(
            arrays.portfolio_configs(8)[p["winner_lane"]])
    else:
        assert p is None


def test_portfolio_default_is_not_the_solo_solve(solved):
    """The fault this closes (ROADMAP C5): with ``portfolio`` left at
    None the port ran the solo config, and on ``messy_case(1)`` the
    portfolio's plan is not the solo plan (here both are feasible; the
    portfolio's preserves more weight), in both packages alike."""
    port_j, port_t = solved[("messy1", None, 1e9)]
    solo_j, solo_t = solved[("messy1", False, 1e9)]
    assert port_t.stats["feasible"] and solo_t.stats["feasible"]
    assert port_t.objective == port_j.objective == 18
    assert solo_t.objective == solo_j.objective == 17
    assert port_t.stats["portfolio"]["winner_lane"] == 6


def test_boundary_certificate_races_the_lanes(solved):
    """With the certificate tried at every boundary the first lane to
    certify retires the ladder after its first chunk."""
    _rj, rt = solved[("adv9", None, 0.0)]
    p = rt.stats["portfolio"]
    assert rt.stats["early_stopped"] and p["early_exit"]
    assert rt.stats["rounds_run"] == 16 and rt.optimal
    assert p["winner_lane"] == 0 and p["certified_at_s"] > 0


def test_forced_midladder_certificate_matches_reference():
    """The reference's forced mid-ladder certificate (its
    ``test_portfolio.py``): the move bound accepts any candidate and the
    weight bound is met, so the first feasible boundary winner certifies.
    Same winner lane, rounds run and plan as the reference."""
    inst_j, inst_t = _adv9()
    out = []
    for eng, inst, kw in ((jengine, inst_j, REF_KW),
                          (engine, inst_t, dict(device="cpu"))):
        inst.move_lower_bound_exact = lambda: 10**9
        inst.weight_upper_bound = lambda tight=False: -1
        out.append(eng.solve_tpu(inst, seed=0, portfolio=True,
                                 cert_min_savings_s=0.0, **KNOBS, **kw))
    rj, rt = out
    pj, pt = rj.stats["portfolio"], rt.stats["portfolio"]
    assert rt.stats["early_stopped"] and pt["early_exit"]
    assert pt["winner_lane"] == pj["winner_lane"] is not None
    assert rt.stats["rounds_run"] == rj.stats["rounds_run"] < 32
    assert pt.get("certified_at_s") is not None
    np.testing.assert_array_equal(rt.a, rj.a)


def test_portfolio_widths_and_keywords(demo, monkeypatch):
    """``portfolio=True`` races the default width, an int names it (padded
    up the lane ladder), and 1 or False is the solo solve; None defers to
    the process default, as in the reference."""
    for v in (None, True, False, 0, 1, 2, 4, 8, 12):
        assert engine._resolve_portfolio_width(v) == \
            jengine._resolve_portfolio_width(v), v
    monkeypatch.setattr(engine, "_PORTFOLIO_DEFAULT", False)
    monkeypatch.setattr(jengine, "_PORTFOLIO_DEFAULT", False)
    assert engine._resolve_portfolio_width(None) == 1
    assert engine.portfolio_width_default() == \
        jengine.portfolio_width_default() == 1
    monkeypatch.undo()
    assert engine.portfolio_width_default() == 8
    inst = build_instance(*port_cluster(*demo))
    kw = dict(device="cpu", engine="sweep", sweeps=8, batch=2)
    for portfolio, width in ((True, 8), (4, 4)):
        res = engine.solve_tpu(inst, portfolio=portfolio, **kw)
        p = res.stats["portfolio"]
        assert (p["width"], p["lane_bucket"]) == (width, 8)
        assert p["winner_config"] == dataclasses.asdict(
            arrays.portfolio_configs(width)[p["winner_lane"]])
        assert res.stats["feasible"] and res.stats["moves"] == 1
    for portfolio in (False, 1):
        res = engine.solve_tpu(inst, portfolio=portfolio, **kw)
        assert "portfolio" not in res.stats


def test_portfolio_table_and_adaptive_order_match_reference(monkeypatch):
    assert [dataclasses.asdict(c) for c in arrays.PORTFOLIO_TABLE] == [
        dataclasses.asdict(c) for c in jarrays.PORTFOLIO_TABLE]
    assert dataclasses.asdict(arrays.DEFAULT_CONFIG) == dataclasses.asdict(
        jarrays.DEFAULT_CONFIG)

    def table(mod, w):
        return [dataclasses.asdict(c) for c in mod.portfolio_configs(w)]

    for w in range(1, 11):
        assert table(arrays, w) == table(jarrays, w)
    for mod in (arrays, jarrays):
        mod.reset_portfolio_adapt()
    try:
        monkeypatch.delenv("KAO_PORTFOLIO_ADAPT", raising=False)
        for mod in (arrays, jarrays):
            for _ in range(mod.ADAPT_MIN_SOLVES + 4):
                mod.note_portfolio_result(mod.PORTFOLIO_TABLE[5])
            mod.note_portfolio_result(None)
        # the gate off pins the table; evidence is banked all the same
        assert table(arrays, 8) == table(jarrays, 8)
        assert arrays.portfolio_adapt_snapshot() == \
            jarrays.portfolio_adapt_snapshot()
        monkeypatch.setenv("KAO_PORTFOLIO_ADAPT", "1")
        assert table(arrays, 8) == table(jarrays, 8)
        assert arrays.portfolio_configs(2)[1] == arrays.PORTFOLIO_TABLE[5]
        assert arrays.portfolio_adapt_snapshot() == \
            jarrays.portfolio_adapt_snapshot()
    finally:
        for mod in (arrays, jarrays):
            mod.reset_portfolio_adapt()
