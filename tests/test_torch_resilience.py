"""PyTorch port: the degradation ladder, the chaos harness and the host
fallback against the JAX package. The deadline rung lands in
``stats["degradations"]`` as the reference's does; an injected NaN in a
chunk (``nan_chunk``) sends both packages to the host fallback with the
same plan and rungs, on a single solve and on one lane of an unstackable
batch; and the fallback is taken only for injected faults and
``FloatingPointError`` — a kernel's ``RuntimeError`` raises.

Each package has its own chaos harness and rung counters: both are armed
and reset together, and left disarmed."""

import numpy as np
import pytest
import torch

from kafka_assignment_optimizer_tpu import build_instance as jax_build
from kafka_assignment_optimizer_tpu.resilience import chaos as jchaos
from kafka_assignment_optimizer_tpu.resilience import ladder as jladder
from kafka_assignment_optimizer_tpu.solvers.tpu import engine as jengine
from kafka_assignment_optimizer_tpu.utils import gen as jgen
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.resilience import chaos, ladder
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine, sweep

from tests.test_torch_engine import (
    REF_KW,
    assert_same,
    port_cluster,
    solve_both,
)

# the reference's small-but-annealing knobs (tests/test_resilience.py),
# on the sweep engine
KNOBS = dict(seed=0, batch=8, rounds=4, steps_per_round=60, engine="sweep")


@pytest.fixture(autouse=True)
def _disarmed():
    for c, lad in ((jchaos, jladder), (chaos, ladder)):
        c.disarm()
        c.reset_counters()
        lad.reset()
    yield
    for c, lad in ((jchaos, jladder), (chaos, ladder)):
        c.disarm()
        c.reset_counters()
        lad.reset()


def _both(case, prewarm=True):
    current, brokers, topo = case
    inst_j = jax_build(current, brokers, topo)
    inst_t = build_instance(*port_cluster(current, brokers, topo))
    if prewarm:
        for inst in (inst_j, inst_t):
            inst.move_lower_bound_exact()
            inst.weight_upper_bound()
    return inst_j, inst_t


def test_deadline_rung_matches_reference(demo):
    """C7: the deadline cuts the demo's sweep ladder after its first
    chunk, and both packages record the one rung it took."""
    rj, rt = solve_both(demo, prewarm_bounds=True, engine="sweep",
                        time_limit_s=0.001, cert_min_savings_s=1e9)
    assert_same(rj, rt)
    assert rt.stats["degradations"] == rj.stats["degradations"] == [
        "deadline_truncated"]
    assert rt.stats["timed_out"] and rt.stats["warm_started"] is False
    assert rt.stats["resumed_from_checkpoint"] is False
    assert ladder.snapshot()["deadline_truncated"] == 1


def test_nan_chunk_host_fallback_matches_reference(demo):
    """An injected NaN in the first chunk: the host fallback's plan,
    flagged degraded, oracle-verified, equal in both packages."""
    inst_j, inst_t = _both(demo)
    jchaos.arm("nan_chunk")
    rj = jengine.solve_tpu(inst_j, **KNOBS, **REF_KW)
    chaos.arm("nan_chunk")
    rt = engine.solve_tpu(inst_t, device="cpu", **KNOBS, **REF_KW)
    assert chaos.snapshot()["fired"] == {"nan_chunk": 1}
    np.testing.assert_array_equal(rt.a, rj.a)
    assert rt.objective == rj.objective == inst_t.preservation_weight(rt.a)
    assert rt.optimal == rj.optimal
    for f in ("engine", "degraded", "degradations", "feasible", "moves",
              "proved_optimal", "warm_started", "resumed_from_checkpoint",
              "constructed", "rounds_run"):
        assert rt.stats[f] == rj.stats[f], f
    assert rt.stats["engine"] == "host_fallback"
    assert rt.stats["degraded"] == "anneal_to_construct"
    assert rt.stats["degradations"] == ["anneal_to_construct"]
    assert rt.stats["feasible"] and inst_t.is_feasible(rt.a)
    assert ladder.snapshot()["anneal_to_construct"] == 1


def test_batch_lane_fallback_rungs_stay_per_lane():
    """An unstackable batch solves its lanes one by one; the fault in lane
    0's solve flags lane 0 only, and both lanes equal the reference's."""
    def adv(seed, **overrides):
        kw = dict(n_brokers=32, n_topics_low=3, n_topics_high=3,
                  parts_per_topic=10, seed=seed)
        kw.update(overrides)
        s = jgen.adversarial(**kw)
        return _both((s.current, s.broker_list, s.topology))

    (aj, at), (bj, bt) = adv(7), adv(7, n_brokers=48, n_topics_low=4,
                                    n_topics_high=4)
    jchaos.arm("nan_chunk:1:1")
    rj = jengine.solve_tpu_batch([aj, bj], seeds=0, rounds=8, batch=8,
                                 **REF_KW)
    chaos.arm("nan_chunk:1:1")
    rt = engine.solve_tpu_batch([at, bt], seeds=0, rounds=8, batch=8,
                                device="cpu")
    assert chaos.snapshot()["fired"].get("nan_chunk", 0) == 1
    for x, y in zip(rj, rt):
        np.testing.assert_array_equal(y.a, x.a)
        assert y.stats.get("degradations") == x.stats.get("degradations")
        assert y.stats["lane_fallback"] == x.stats["lane_fallback"]
    assert rt[0].stats["degraded"] == "anneal_to_construct"
    assert rt[0].stats["degradations"] == ["anneal_to_construct"]
    assert "degradations" not in rt[1].stats
    assert rt[1].stats["feasible"] and rt[1].stats["engine"] == "chain"


def test_degradable_only_chaos_faults_and_nan_aborts():
    assert engine._degradable(chaos.ChaosFault("nan_chunk"))
    assert engine._degradable(FloatingPointError("nan"))
    assert not engine._degradable(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    assert not engine._degradable(torch.cuda.OutOfMemoryError(
        "CUDA out of memory"))
    assert not engine._degradable(ImportError("no module"))
    # the same verdicts as the reference's classifier
    assert jengine._degradable(jchaos.ChaosFault("nan_chunk"))
    assert not jengine._degradable(RuntimeError("CUDA error"))


def test_kernel_failure_raises_instead_of_falling_back(demo, monkeypatch):
    """A site sweep whose (plain) kernel fails as a launch does raises out
    of ``solve_tpu``: no host plan hides the device."""
    def failed_launch(*_a, **_k):
        raise RuntimeError("B2+B3 site sweep (kao_site_sweep) failed to "
                           "launch: CUDA error 700")

    monkeypatch.setattr(sweep, "site_lanes_delta", failed_launch)
    _inst_j, inst_t = _both(demo)
    with pytest.raises(RuntimeError, match="failed to launch"):
        engine.solve_tpu(inst_t, device="cpu", **KNOBS, **REF_KW)
    assert ladder.snapshot()["anneal_to_construct"] == 0


def test_chaos_spec_parses_as_the_reference_does():
    spec = "seed=7,delay=0.1,nan_chunk:0.5:2,chunk_overrun:1:-1"
    assert chaos.parse_spec(spec) == jchaos.parse_spec(spec)
    assert set(chaos.POINTS) == set(jchaos.POINTS)
    assert ladder.RUNGS == jladder.RUNGS
    for bad in ("nan_chunc", "nan_chunk:2", "nan_chunk:1:0", "seed=x", ""):
        with pytest.raises(ValueError):
            chaos.parse_spec(bad)
