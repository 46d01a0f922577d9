"""PyTorch port: the sanitizer analogue (``analysis/sanitize.py``) against
the JAX package's. Armed (``enable()``, as ``KAO_SANITIZE=1`` or
``--sanitize`` do), the injected ``nan_chunk`` fault gives the same
outcome in both packages — a ``FloatingPointError`` out of the solve and
out of ``/submit`` (no host fallback), one NaN abort counted — and
``_degradable`` declines the ``FloatingPointError`` while armed and
takes it while disarmed, as the reference does. The port's three guards
(the chunk's NaN guard, the consumed-state guard, the rebuild sentinel)
trip and count under the reference's counter names, which ``/metrics``
renders."""

import numpy as np
import pytest
import torch

from kafka_assignment_optimizer_tpu import serve as jserve
from kafka_assignment_optimizer_tpu.analysis import sanitize as jsan
from kafka_assignment_optimizer_tpu.models.instance import (
    build_instance as jax_build,
)
from kafka_assignment_optimizer_tpu.resilience import chaos as jchaos
from kafka_assignment_optimizer_tpu.solvers.tpu import engine as jengine
from kafka_assignment_optimizer_tpu_torch import serve
from kafka_assignment_optimizer_tpu_torch.analysis import sanitize as san
from kafka_assignment_optimizer_tpu_torch.models.cluster import (
    demo_assignment,
    demo_broker_list,
    demo_topology,
)
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.resilience import chaos
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine

KW = dict(seed=0, engine="sweep", sweeps=8, batch=4, portfolio=False,
          time_limit_s=300.0)
SUBMIT = {"assignment": demo_assignment().to_dict(), "brokers": "0-18",
          "topology": "even-odd", "solver": "tpu",
          "options": {"engine": "sweep", "sweeps": 8, "batch": 4,
                      "portfolio": False, "n_devices": 1}}


@pytest.fixture(scope="module", autouse=True)
def servers():
    """One server of each package (the port's on the CPU); the
    handlers are driven in-process."""
    srvs = [jserve.make_server(port=0),
            serve.make_server(port=0, device="cpu")]
    # the failed solves below must not open a circuit for later files
    breakers = [(mod, mod._BREAKER) for mod in (jserve, serve)]
    for mod, brk in breakers:
        mod._BREAKER = type(brk)()
    yield
    for mod, brk in breakers:
        mod._BREAKER = brk
    for srv in srvs:
        srv.server_close()
    serve.SERVE["device"] = "cuda"


@pytest.fixture
def armed():
    """Both sanitizers armed with zeroed counters and ``nan_chunk``
    armed in both chaos harnesses; everything disarmed after."""
    for s in (san, jsan):
        s.reset()
        s.enable()
    jchaos.arm("nan_chunk")
    chaos.arm("nan_chunk")
    yield
    jchaos.disarm()
    chaos.disarm()
    for s in (san, jsan):
        s.disable()
        s.reset()


def _instances():
    return (jax_build(demo_assignment(), demo_broker_list(),
                      demo_topology()),
            build_instance(demo_assignment(), demo_broker_list(),
                           demo_topology()))


def test_nan_chunk_armed_matches_reference(armed):
    inst_j, inst_t = _instances()
    errs = []
    for solve, inst, kw in ((jengine.solve_tpu, inst_j, {"n_devices": 1}),
                            (engine.solve_tpu, inst_t, {"device": "cpu"})):
        with pytest.raises(FloatingPointError) as ei:
            solve(inst, **KW, **kw)
        errs.append(str(ei.value))
    assert errs[1] == errs[0]
    # the guards' counters; the compile ones count each package's own
    # builds (the reference's XLA compiles and their log lines)
    for k in ("nan_aborts_total", "donation_reuse_total",
              "recompiles_total", "enabled"):
        assert san.snapshot()[k] == jsan.snapshot()[k], k
    assert san.snapshot()["nan_aborts_total"] == 1


def test_nan_chunk_armed_submit_matches_reference(armed):
    """Through the service: the same exception type and message out of
    ``handle_submit`` (the HTTP layer answers it with 500 ``internal
    error``), the same counters."""
    got = []
    for mod in (jserve, serve):
        with pytest.raises(FloatingPointError) as ei:
            mod.handle_submit(dict(SUBMIT))
        got.append(str(ei.value))
    assert got[1] == got[0]
    assert san.snapshot()["nan_aborts_total"] \
        == jsan.snapshot()["nan_aborts_total"] == 1


def test_nan_chunk_armed_http_matches_reference(armed):
    """Over HTTP: both services answer the sanitized ``nan_chunk`` solve
    with the status and body ``chip_smoke.py`` expects of the port's
    service on the card, and count one NaN abort on ``/metrics``."""
    import json
    import threading
    import urllib.error
    import urllib.request

    import chip_smoke

    for mod, kw in ((jserve, {}), (serve, {"device": "cpu"})):
        srv = mod.make_server(port=0, **kw)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/submit",
            data=json.dumps(SUBMIT).encode(), method="POST")
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                got = (r.status, json.loads(r.read()))
        except urllib.error.HTTPError as e:
            got = (e.code, json.loads(e.read()))
        finally:
            srv.shutdown()
            srv.server_close()
        assert got == chip_smoke.SANITIZED_NAN_CHUNK, mod.__name__
        assert "kao_sanitizer_nan_aborts_total 1" in \
            mod.render_metrics().splitlines()


def test_degradable_declines_fpe_while_armed():
    e = FloatingPointError("nan")
    for s, eng in ((san, engine), (jsan, jengine)):
        s.disable()
        assert eng._degradable(e) is True
        s.enable()
        try:
            assert eng._degradable(e) is False
            assert eng._degradable(s.DonationReuseError("x")) is False
        finally:
            s.disable()
            s.reset()
    # disarmed, nan_chunk takes the host fallback in both packages
    chaos.arm("nan_chunk")
    try:
        _, inst_t = _instances()
        r = engine.solve_tpu(inst_t, device="cpu", **KW)
    finally:
        chaos.disarm()
    assert r.stats["degradations"] == ["anneal_to_construct"]
    assert san.snapshot()["nan_aborts_total"] == 0


def test_guards_trip_and_count():
    """The NaN guard on a chunk's float tensors, the consumed-state guard
    and the rebuild sentinel: inert while disarmed, each trip counted
    under the reference's counter names while armed."""
    nan = torch.tensor([1.0, float("nan")])
    state = (torch.zeros(2, 3, dtype=torch.int32), torch.zeros(2))
    san.check_device((nan,))  # disarmed: no check, no sync
    san.consume_state(state)
    san.check_state(state)
    san.enable()
    try:
        san.check_device((torch.ones(3), torch.zeros(2, dtype=torch.int32)))
        with pytest.raises(FloatingPointError):
            san.check_device((torch.ones(3), nan))
        with pytest.raises(san.SanitizerError):
            san.check_host(np.array([1.0, np.inf], np.float32))
        san.check_state(state)
        san.consume_state(state)
        with pytest.raises(san.DonationReuseError):
            san.check_state(state, ("chunk", 3))
        san.check_state((state[0].clone(), state[1]))  # a fresh state
        for _ in range(san.compile_budget()):
            san.note_compile(("kernel", "score-x.so"))
        with pytest.raises(san.RecompileBudgetError):
            san.note_compile(("kernel", "score-x.so"))
        snap = san.snapshot()
        assert set(snap) == set(jsan.snapshot())
        assert (snap["donation_reuse_total"], snap["recompiles_total"],
                snap["nan_aborts_total"]) == (1, 1, 1)
        text = serve.render_metrics()
        assert "kao_sanitizer_donation_reuse_total 1" in text
        assert "kao_sanitizer_enabled 1" in text
    finally:
        san.disable()
        san.reset()


def test_armed_ladder_runs_clean():
    """Armed, a solve with no fault runs every guard at every chunk and
    trips none: the plan is the disarmed solve's."""
    _, inst_t = _instances()
    kw = dict(KW, sweeps=16)
    ref = engine.solve_tpu(inst_t, device="cpu", **kw)
    san.enable()
    try:
        _, inst_t = _instances()
        got = engine.solve_tpu(inst_t, device="cpu", **kw)
    finally:
        snap = san.snapshot()
        san.disable()
        san.reset()
    np.testing.assert_array_equal(got.a, ref.a)
    assert snap["nan_aborts_total"] == snap["donation_reuse_total"] == 0
