"""PyTorch port: the solve trace and the flight recorder against the JAX
package's. The same pinned sweep solve, traced in both packages, gives
the same span-name tree (the reference's second run: its first run also
holds the XLA compile's span, which has no counterpart in a warm
process), the same phase names and annealing summary keys; the flight
record of the solve has the reference's keys, field for field; the W3C
``traceparent`` codec is the reference's; a log line under an active
trace carries its ID."""

import io

import pytest

from kafka_assignment_optimizer_tpu.models.instance import (
    build_instance as jax_build,
)
from kafka_assignment_optimizer_tpu.obs import flight as jflight
from kafka_assignment_optimizer_tpu.obs import trace as jtrace
from kafka_assignment_optimizer_tpu.solvers.tpu import engine as jengine
from kafka_assignment_optimizer_tpu_torch.models.cluster import (
    demo_assignment,
    demo_broker_list,
    demo_topology,
)
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.obs import flight, log, trace
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine

# the service's pinned sweep solve of the demo: one 8-sweep chunk
KW = dict(seed=0, engine="sweep", sweeps=8, batch=4, portfolio=False,
          time_limit_s=300.0)


def _tree(sp: dict) -> tuple:
    return (sp["name"], tuple(_tree(c) for c in sp.get("spans", ())))


def _keys(d, prefix="") -> set:
    """Every key path of a nested dict."""
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("worker",):
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.fixture(scope="module")
def solves():
    """The traced pinned solve in both packages (the reference's warm
    run), with the flight record each landed."""
    def jsolve():
        inst = jax_build(demo_assignment(), demo_broker_list(),
                         demo_topology())
        return jengine.solve_tpu(inst, n_devices=1, trace=True, **KW)

    jsolve()  # the compile run
    jflight.reset_recent()
    rj = jsolve()
    recj = jflight.recent()[-1]
    flight.reset_recent()
    inst = build_instance(demo_assignment(), demo_broker_list(),
                          demo_topology())
    rt = engine.solve_tpu(inst, trace=True, device="cpu", **KW)
    rect = flight.recent()[-1]
    return rj, rt, recj, rect


def test_span_tree_matches_reference(solves):
    rj, rt, _, _ = solves
    repj, rept = rj.stats["solve_report"], rt.stats["solve_report"]
    assert _tree(rept["spans"]) == _tree(repj["spans"])
    assert set(rept["phases"]) == set(repj["phases"])
    assert set(rept) == set(repj)
    assert set(rept["annealing"]) == set(repj["annealing"])
    assert rept["annealing"]["rounds"] == repj["annealing"]["rounds"] == 8
    assert rt.stats["trace_id"] == rept["trace_id"]
    assert trace.RECENT.get(rept["trace_id"]) is not None
    names = [c["name"] for c in rept["spans"]["spans"]]
    assert names == ["bounds", "constructor", "seed", "ladder", "polish",
                     "verify"]
    # the plan is the reference's
    assert rt.stats["moves"] == rj.stats["moves"]
    assert rt.objective == rj.objective


def test_flight_record_keys_match_reference(solves):
    _, rt, recj, rect = solves
    assert _keys(rect) == _keys(recj)
    assert rect["trace_id"] == rt.stats["trace_id"]
    assert rect["kind"] == recj["kind"] == "solve"
    assert rect["quality"] == {**recj["quality"],
                               "objective": rect["quality"]["objective"]}
    assert rect["quality"]["objective"] == recj["quality"]["objective"]
    assert rect["split"]["dispatches"] == recj["split"]["dispatches"]
    assert rect["ledger"]["ok"] is True


def test_nested_solve_lands_one_record():
    """The flight recorder's nesting guard: a solve inside a recorded
    solve (a batch lane, the chain retry) feeds the outer record."""
    flight.reset_recent()
    tok = flight.start_accounting()
    try:
        inst = build_instance(demo_assignment(), demo_broker_list(),
                              demo_topology())
        engine.solve_tpu(inst, device="cpu", **KW)
    finally:
        flight.end_accounting(tok)
    assert flight.recent() == []


def test_traceparent_codec_matches_reference():
    tid, sid = trace.new_trace_id(), trace.new_span_id()
    assert trace.inject(tid, sid) == jtrace.inject(tid, sid)
    for v in (trace.inject(tid, sid), "00-" + "0" * 32 + "-" + "1" * 16
              + "-01", "garbage", None, "00-abc-def-01"):
        got, want = trace.extract(v), jtrace.extract(v)
        assert (got is None) == (want is None), v
        if got is not None:
            assert tuple(got) == tuple(want)


def test_log_line_carries_the_active_trace_id():
    tr = trace.begin(True, name="solve")
    buf = io.StringIO()
    log.log("probe", _stream=buf, x=1)
    trace.finish(tr)
    assert f"trace_id={tr.trace_id}" in buf.getvalue()
    buf = io.StringIO()
    log.log("probe", _stream=buf)
    assert "trace_id" not in buf.getvalue()
