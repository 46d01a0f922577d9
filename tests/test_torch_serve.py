"""PyTorch port: the HTTP service against the JAX package's — one server
of each package at module scope (the port's on the CPU), their handlers
driven in-process with the same requests, plus one HTTP round trip each.
``/submit`` (the exact MILP, a pinned sweep solve, a coalesced pair in
one window), ``/evaluate``, the error table of ``tests/test_serve.py``,
``/`` and ``/schema`` (byte-equal), the ``/metrics`` families and the
``/healthz`` keys (the same sets), the routes once deferred
(``/debug/fleet``, ``/clusters/<id>/rollout*``), the measurement surfaces
(``/debug/profile``, ``/debug/slo``, ``?format=chrome``, ``--slo``,
``--profile-dir``, ``--sample-devices``), every flag of the JAX service
(each one working in the port) and the import boundary:
the port's service loads neither JAX nor the JAX package. Plans, status
codes and integer fields are equal exactly."""

import ast
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from kafka_assignment_optimizer_tpu import landing as jlanding
from kafka_assignment_optimizer_tpu import serve as jserve
from kafka_assignment_optimizer_tpu.models.cluster import demo_assignment
from kafka_assignment_optimizer_tpu_torch import landing, serve

REPO = Path(__file__).resolve().parent.parent

DEMO = {"assignment": demo_assignment().to_dict(), "brokers": "0-18",
        "topology": "even-odd"}
# the pinned sweep solve: one 8-sweep chunk (no chunk boundary, so no
# timing-dependent certificate), the reference on one device
PINNED = {"engine": "sweep", "sweeps": 8, "batch": 4, "seed": 0,
          "portfolio": False, "n_devices": 1}
# report fields equal across the packages
REPORT_FIELDS = (
    "solver", "replica_moves", "leader_changes", "objective_weight",
    "objective_upper_bound", "violations", "feasible", "proven_optimal",
    "brokers", "partitions", "racks", "solver_engine", "solver_moves",
    "solver_rounds_run", "solver_final_cert", "solver_construct_path",
    "solver_feasible", "solver_lane", "solver_lanes", "solver_lane_bucket",
    "solver_bucket_parts", "solver_bucket_rf", "degradations",
)


def _serve(mod, **kw):
    srv = mod.make_server(port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module", autouse=True)
def servers():
    j, jurl = _serve(jserve)
    t, turl = _serve(serve, device="cpu")
    yield {"jax": jurl, "port": turl}
    for srv in (j, t):
        srv.shutdown()
        srv.server_close()
    serve.SERVE["device"] = "cuda"


def _http(url, path, payload=None, headers=None):
    req = urllib.request.Request(
        url + path, method="GET" if payload is None else "POST",
        data=None if payload is None else json.dumps(payload).encode(),
        headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def assert_same_response(oj, ot):
    assert ot["assignment"] == oj["assignment"]
    for f in REPORT_FIELDS:
        assert ot["report"].get(f) == oj["report"].get(f), (
            f, ot["report"].get(f), oj["report"].get(f))


def test_submit_demo_milp_matches_reference(servers):
    """The demo through the exact MILP, and one HTTP round trip to each
    service: the same plan and report, a trace ID, the worker header."""
    p = {**DEMO, "solver": "milp"}
    oj, ot = jserve.handle_submit(dict(p)), serve.handle_submit(dict(p))
    assert_same_response(oj, ot)
    assert ot["report"]["replica_moves"] == 1
    assert ot["report"]["proven_optimal"] is True
    bodies = []
    for name in ("jax", "port"):
        st, raw, hdr = _http(servers[name], "/submit", p)
        assert st == 200, raw
        body = json.loads(raw)
        assert body["trace_id"] and hdr.get("X-KAO-Worker")
        bodies.append(body)
    assert_same_response(*bodies)


def test_submit_pinned_sweep_matches_reference():
    """A pinned sweep solve of the demo (8 sweeps, 4 chains, no
    portfolio) under the service's 300 s cap: the same plan, engine,
    rounds and final certificate, and the solve report's trace ID is
    the response's."""
    p = {**DEMO, "solver": "tpu", "options": dict(PINNED)}
    oj, ot = jserve.handle_submit(dict(p)), serve.handle_submit(dict(p))
    assert_same_response(oj, ot)
    assert ot["report"]["solver_engine"] == "sweep"
    assert ot["report"]["solver_rounds_run"] == 8
    assert ot["report"]["solver_time_limit_s"] == 300.0
    rep = serve._otrace.RECENT.get(ot["trace_id"])
    assert rep is not None and rep["name"] == "request"


def test_coalesced_pair_matches_reference(monkeypatch):
    """Two pinned requests (seeds 0 and 1) in one coalescing window: one
    batched ``optimize_batch`` in each package, the lanes padded to the
    same lane bucket, and each lane's plan equal to the reference's."""
    outs = {}
    for name, mod in (("jax", jserve), ("port", serve)):
        co = mod._COALESCER
        monkeypatch.setattr(co, "should_bypass", lambda key: False)
        monkeypatch.setattr(co, "max_batch", 2)
        monkeypatch.setattr(co, "window_s", 60.0)
        with mod._METRICS_LOCK:
            before = mod._METRICS["batch_solves_total"]
        res = [None, None]

        def run(i, mod=mod, res=res):
            res[i] = mod.handle_submit({
                **DEMO, "solver": "tpu",
                "options": {**PINNED, "seed": i}})

        ths = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        # request 1 starts once request 0 has joined the pending group:
        # a lane is the arrival order, which the threads alone leave to
        # the scheduler
        ths[0].start()
        deadline = time.monotonic() + 120
        while not any(g.entries for g in list(co._groups.values())):
            assert time.monotonic() < deadline, "request 0 never queued"
            time.sleep(0.01)
        ths[1].start()
        for t in ths:
            t.join(timeout=300)
        with mod._METRICS_LOCK:
            assert mod._METRICS["batch_solves_total"] == before + 1
        outs[name] = res
    for oj, ot in zip(outs["jax"], outs["port"]):
        assert ot["coalesced_into"] and ot["trace_id"]
        assert_same_response(oj, ot)
    assert [o["report"]["solver_lane"] for o in outs["port"]] == [0, 1]
    assert outs["port"][0]["report"]["solver_lane_bucket"] == 8


def test_evaluate_matches_reference(servers):
    """The audit of the solved demo plan and of the current assignment
    (broker 19 still holds a replica): equal reports, in-process and
    over HTTP."""
    plan = jserve.handle_submit({**DEMO, "solver": "milp"})["assignment"]
    for p in (plan, DEMO["assignment"]):
        req = {**DEMO, "plan": p}
        rj = jserve.handle_evaluate(dict(req), lock_wait_s=30.0)
        rt = serve.handle_evaluate(dict(req), lock_wait_s=30.0)
        assert rt == rj
    assert rt["feasible"] is False
    st_j, raw_j, _ = _http(servers["jax"], "/evaluate", {**DEMO,
                                                          "plan": plan})
    st_t, raw_t, _ = _http(servers["port"], "/evaluate", {**DEMO,
                                                           "plan": plan})
    assert st_j == st_t == 200
    assert json.loads(raw_t) == json.loads(raw_j)
    assert json.loads(raw_t)["proven_optimal"] is True


# the error table of tests/test_serve.py
ERRORS = [
    ({}, 400),
    ({"assignment": {"version": 1, "partitions": []}}, 400),
    ({"assignment": "nope", "brokers": "0-3"}, 400),
    ({"assignment": {"version": 1, "partitions": []}, "brokers": "x"}, 400),
    ({**DEMO, "rf": "three"}, 400),
    ({**DEMO, "solver": "unknown-backend"}, 400),
    ({"assignment": DEMO["assignment"], "brokers": "0,1", "rf": 5}, 422),
    ({**DEMO, "solver": "milp", "options": {"checkpoint": "/x.npz"}}, 400),
    ({**DEMO, "solver": "tpu", "options": {"portfolio": 3}}, 400),
    ({**DEMO, "solver": "tpu", "options": {"time_limit_s": -1}}, 400),
]


@pytest.mark.parametrize("payload,want", ERRORS)
def test_error_table_matches_reference(payload, want):
    got = []
    for mod in (jserve, serve):
        with pytest.raises(mod.ApiError) as ei:
            mod.handle_submit(dict(payload))
        got.append((ei.value.status, str(ei.value)))
    assert got[1] == got[0]
    assert got[1][0] == want


def test_landing_and_schema_byte_equal(servers):
    assert landing.render_landing() == jlanding.render_landing()
    assert landing.request_schema() == jlanding.request_schema()
    for path in ("/", "/schema"):
        got = [_http(servers[n], path)[:2] for n in ("jax", "port")]
        assert got[1] == got[0] and got[1][0] == 200


def _families(text: str) -> set:
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def test_metrics_families_and_healthz_keys(servers):
    """The port renders exactly the families of the reference's
    ``/metrics`` (the ``kao_rollout_*`` ones declared at zero), and
    ``/healthz`` exactly its sections."""
    fj = _families(jserve.render_metrics())
    ft = _families(serve.render_metrics())
    assert ft == fj, (ft - fj, fj - ft)
    assert {"kao_sanitizer_nan_aborts_total", "kao_phase_seconds",
            "kao_solve_seconds", "kao_rollout_started_total"} <= ft
    kj, kt = set(jserve.handle_healthz()), set(serve.handle_healthz())
    assert kt == kj
    hz = serve.handle_healthz()
    assert hz["platform"] == "cpu"
    assert set(hz["cache"]) == set(jserve.handle_healthz()["cache"])
    st, raw, _ = _http(servers["port"], "/metrics")
    assert st == 200 and _families(raw.decode()) == ft


@pytest.mark.parametrize("method,path", [
    ("GET", "/debug/fleet"), ("GET", "/clusters/c1/rollout"),
    ("POST", "/clusters/c1/rollout/start"),
])
def test_deferred_routes_answer_501(servers, method, path):
    """The routes that answered 501 before the rollout and the fleet
    view were ported now answer as the reference's service does: the
    same status and error body (``/debug/fleet``: 200 with the
    reference's keys)."""
    got = []
    for name in ("jax", "port"):
        st, raw, _ = _http(servers[name], path,
                           {} if method == "POST" else None)
        got.append((st, json.loads(raw)))
    (sj, bj), (st, bt) = got
    assert st == sj and st != 501, (st, bt)
    if path == "/debug/fleet":
        assert st == 200 and set(bt) == set(bj)
        assert bt["workers"] == bj["workers"]
    else:
        assert bt == bj


def test_debug_profile_slo_and_chrome_match_reference(servers):
    """After a pinned sweep solve through each service: ``/debug/profile``
    and ``/debug/slo`` answer 200 with the reference's sections, the
    profile's roofline holds the solve's bucket, and ``?format=chrome``
    gives the Chrome export of the solve's report (the reference's
    ``obs.chrome`` on the same report)."""
    from kafka_assignment_optimizer_tpu.obs import chrome as jchrome

    p = {**DEMO, "solver": "tpu", "options": dict(PINNED)}
    bodies = {}
    for name in ("jax", "port"):
        st, raw, _ = _http(servers[name], "/submit", p)
        assert st == 200, raw
        tid = json.loads(raw)["trace_id"]
        got = {}
        for path in ("/debug/profile", "/debug/slo",
                     f"/debug/solves/{tid}?format=chrome",
                     f"/debug/solves/{tid}"):
            st, raw, _ = _http(servers[name], path)
            assert st == 200, (name, path, raw[:200])
            got[path.split("?")[-1].split("/")[-1]] = json.loads(raw)
        bodies[name] = got
    j, t = bodies["jax"], bodies["port"]
    assert set(t["profile"]) == set(j["profile"])
    assert set(t["slo"]) == set(j["slo"])
    assert set(t["slo"]["slo"]["classes"]) == set(j["slo"]["slo"]["classes"])
    assert [g["bucket"] for g in t["profile"]["roofline"]]
    assert t["profile"]["peaks"]["platform"] == "cpu"
    chrome_t = t["format=chrome"]
    report = next(v for k, v in t.items() if k not in (
        "profile", "slo", "format=chrome"))
    assert chrome_t == jchrome.to_chrome(report)
    assert set(chrome_t) == set(j["format=chrome"])


@pytest.mark.parametrize("argv,env", [
    (["--slo", "solve"], {}),
    (["--slo", "solve:x:0.9"], {}),
    (["--profile-solves", "-1"], {}),
    (["--sample-devices", "-1"], {}),
    ([], {"KAO_SLO": "solve:5:2"}),
    ([], {"KAO_SAMPLE_DEVICES": "fast"}),
])
def test_measurement_flags_refuse_bad_values_as_reference(argv, env,
                                                          monkeypatch,
                                                          capsys):
    """``--slo``/``KAO_SLO``, ``--profile-solves`` and
    ``--sample-devices``/``KAO_SAMPLE_DEVICES`` are the reference's: a
    bad value stops both services at startup (exit 2), before serving."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    codes = []
    for main, extra in ((jserve.main, []),
                        (serve.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as ei:
            main([*argv, *extra, "--port", "0"])
        codes.append(ei.value.code)
        capsys.readouterr()
    assert codes == [2, 2]
    assert not serve._osampler.SAMPLER.enabled()


def test_profiled_solves_per_bucket_as_reference(tmp_path, monkeypatch):
    """``--profile-dir`` with ``--profile-solves N``: the first N tpu
    solves of a bucket get a capture directory of their own, the rest
    none — the reference's budget, keyed the same way."""
    got = []
    for mod in (jserve, serve):
        monkeypatch.setitem(mod.OBS, "profile_dir", str(tmp_path))
        monkeypatch.setitem(mod.OBS, "profile_solves", 2)
        monkeypatch.setattr(mod, "_PROFILED_BUCKETS", {})
        got.append([mod._profile_dir_for(("b", 12, 64), f"t{i}")
                    for i in range(3)]
                   + [mod._profile_dir_for(("c", 12, 64), "t9")])
    assert got[1] == got[0]
    assert got[1][2] is None and got[1][3]


def _reference_flags() -> list:
    """Every ``--flag`` the JAX service's ``main`` declares."""
    tree = ast.parse(Path(jserve.__file__).read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    return [c.args[0].value for c in ast.walk(main)
            if isinstance(c, ast.Call) and getattr(c.func, "attr", "")
            == "add_argument" and c.args
            and isinstance(c.args[0], ast.Constant)]


# the flags once refused at startup, a value each, and where main()
# puts it
ONCE_DEFERRED = {
    "--fleet-peers": ("http://127.0.0.1:9", lambda: serve.FLEET["peers"],
                      ["http://127.0.0.1:9"]),
    "--rollout-broker-cap": ("2", lambda: serve.ROLLOUT["broker_cap"], 2),
    "--rollout-rack-cap": ("3", lambda: serve.ROLLOUT["rack_cap"], 3),
    "--rollout-packer": ("scored", lambda: serve.ROLLOUT["packer"],
                         "scored"),
    "--rollout-lanes": ("5", lambda: serve.ROLLOUT["lanes"], 5),
}


def test_every_reference_flag_works_or_is_refused(capsys, monkeypatch):
    """Each flag of the JAX service parses in the port's service. The
    flags once refused at startup (``--fleet-peers``, ``--rollout-*``)
    now start it and land where the reference's ``main`` puts them, and
    a bad value of each stops both services (exit 2); ``--megachunk
    auto|K|off`` sets the engine's process default in both. The port's
    service also refuses to start without a card unless ``--device
    cpu``."""
    flags = _reference_flags()
    assert len(flags) > 30
    ap = serve.build_parser()
    known = {a for act in ap._actions for a in act.option_strings}
    for flag in flags:
        assert flag in known, flag

    class _Stub:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    monkeypatch.setattr(serve, "make_server", lambda *a, **k: _Stub())
    monkeypatch.setitem(serve.SERVE, "device", serve.SERVE["device"])
    for mod in (serve, jserve):
        monkeypatch.setattr(mod, "ROLLOUT", dict(mod.ROLLOUT))
        monkeypatch.setattr(mod, "FLEET", dict(mod.FLEET))
    for mod in (serve, jserve):
        monkeypatch.setattr(mod, "WATCH", dict(mod.WATCH))
    for flag, (value, where, want) in ONCE_DEFERRED.items():
        assert flag in flags, flag
        assert serve.main([flag, value, "--device", "cpu"]) == 0, flag
        assert where() == want, flag
        bad = "ftp://x" if flag == "--fleet-peers" else "0"
        codes = []
        for main in (jserve.main, serve.main):
            with pytest.raises(SystemExit) as ei:
                main([flag, bad, "--device", "cpu"] if main is serve.main
                     else [flag, bad, "--port", "0"])
            codes.append(ei.value.code)
        assert codes == [2, 2], flag
        capsys.readouterr()
    assert "--device" in known
    # the measured width: --megachunk auto lands where the reference's
    # does (the engine's process default), and a bad width stops both
    from kafka_assignment_optimizer_tpu.solvers.tpu import (
        engine as jengine,
    )
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine

    for mod in (engine, jengine):
        monkeypatch.setattr(mod, "_MEGACHUNK_DEFAULT",
                            mod._MEGACHUNK_DEFAULT)
    for value, want in (("auto", "auto"), ("4", 4), ("off", None)):
        assert serve.main(["--megachunk", value, "--device", "cpu"]) == 0
        # the reference's main hands the flag to the same setter
        jengine.set_megachunk_default(value)
        assert engine.megachunk_default() == jengine.megachunk_default() \
            == want, value
    for main in (jserve.main, serve.main):
        with pytest.raises(SystemExit) as ei:
            main(["--megachunk", "two", "--device", "cpu"]
                 if main is serve.main else ["--megachunk", "two"])
        assert ei.value.code == 2
    capsys.readouterr()
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as ei:
            serve.main(["--port", "0"])
        assert ei.value.code == 2
        assert "no CUDA device" in capsys.readouterr().err


def test_service_never_imports_jax():
    """Importing the port's service, and a CPU ``/submit`` through it (the
    exact MILP and a pinned sweep), ``/evaluate``, ``/healthz``,
    ``/metrics``, ``/debug/profile``, ``/debug/slo``, ``/debug/fleet``,
    the rollout manager and the fleet modules (``rollout``, ``fleet``,
    ``obs.fleet``, ``obs.causal``), load neither JAX nor the JAX
    package."""
    code = (
        "import sys\n"
        "from kafka_assignment_optimizer_tpu_torch import serve\n"
        "from kafka_assignment_optimizer_tpu_torch.models.cluster import "
        "demo_assignment\n"
        "serve.make_server(port=0, device='cpu').server_close()\n"
        "p = {'assignment': demo_assignment().to_dict(), 'brokers': '0-18',"
        " 'topology': 'even-odd'}\n"
        "o = serve.handle_submit({**p, 'solver': 'milp'})\n"
        "assert o['report']['replica_moves'] == 1\n"
        "o = serve.handle_submit({**p, 'solver': 'tpu', 'options': "
        "{'engine': 'sweep', 'sweeps': 8, 'batch': 2}})\n"
        "assert o['report']['feasible']\n"
        "assert serve.handle_evaluate({**p, 'plan': o['assignment']}, "
        "30.0)['feasible']\n"
        "serve.handle_healthz(); serve.render_metrics()\n"
        "serve.handle_debug_profile(); serve.handle_debug_slo()\n"
        "from kafka_assignment_optimizer_tpu_torch import fleet, rollout\n"
        "from kafka_assignment_optimizer_tpu_torch.fleet import router\n"
        "from kafka_assignment_optimizer_tpu_torch.obs import causal\n"
        "from kafka_assignment_optimizer_tpu_torch.obs import fleet as of\n"
        "serve.handle_fleet_get(); serve._healthz_rollout()\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'kafka_assignment_optimizer_tpu'"
        " or n.startswith('kafka_assignment_optimizer_tpu.')]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_cli_evaluate_events_and_refusals_match_reference(tmp_path, capsys):
    """The CLI's ``--evaluate`` (the audit on stdout, exit 3 for the
    infeasible current assignment) and ``--events`` (the watch replay:
    the final plan on stdout, a line an event) give the reference's
    output and exit codes; ``--emit-waves`` writes the reference's wave
    files byte for byte."""
    from kafka_assignment_optimizer_tpu.cli import main as jmain
    from kafka_assignment_optimizer_tpu_torch.cli import main as tmain

    cur = tmp_path / "cur.json"
    cur.write_text(json.dumps(DEMO["assignment"]))
    events = tmp_path / "events.json"
    events.write_text(json.dumps([
        {"type": "bootstrap", "epoch": 1, "assignment": DEMO["assignment"],
         "brokers": list(range(19)), "topology": "even-odd"},
        {"type": "broker_drain", "epoch": 2, "brokers": [3]},
        {"type": "broker_drain", "epoch": 2, "brokers": [4]},
    ]))
    runs = (
        ["-i", str(cur), "--broker-list", "0-18", "--topology", "even-odd",
         "--evaluate", str(cur)],
        ["--events", str(events), "--solver", "milp"],
    )
    for argv in runs:
        got = []
        for main in (jmain, tmain):
            rc = main(list(argv))
            out = capsys.readouterr()
            lines = [ln for ln in out.err.splitlines()
                     if ln.startswith("event[")]
            got.append((rc, json.loads(out.out), lines))
        assert got[1] == got[0], argv
    assert got[1][0] == 3 and len(got[1][2]) == 3  # the replayed epoch
    files = []
    for name, main in (("jax", jmain), ("port", tmain)):
        d = tmp_path / f"waves-{name}"
        assert main(["-i", str(cur), "--broker-list", "0-18", "--topology",
                     "even-odd", "--solver", "milp", "--emit-waves",
                     str(d), "--wave-broker-cap", "1"]) == 0
        capsys.readouterr()
        files.append({f.name: f.read_bytes() for f in d.iterdir()})
    assert files[1] == files[0] and files[1]


def test_served_stop_at_the_first_boundary_matches_reference():
    """A pinned sweep request whose greedy seed is already at the move
    bound (the adversarial family) stops at the first chunk boundary in
    both services once the remaining chunks' estimated time passes the
    boundary certificate's 1 s savings gate (the chunks slowed here by
    the chaos harness's ``chunk_overrun`` delay, as a profiler session
    slows them on the card): 2 dispatches (the next chunk already in
    flight), 16 sweeps, no final certificate, a certified ladder span,
    and the same plan."""
    from kafka_assignment_optimizer_tpu.resilience import chaos as jchaos
    from kafka_assignment_optimizer_tpu.utils import gen as jgen
    from kafka_assignment_optimizer_tpu_torch.resilience import chaos

    s = jgen.adversarial(**jgen.SMOKE_KWARGS["adversarial"])
    p = {"assignment": s.current.to_dict(), "brokers": list(s.broker_list),
         "topology": s.topology.to_dict(), "solver": "tpu",
         "options": {"engine": "sweep", "batch": 8, "rounds": 128,
                     "seed": 0, "portfolio": False, "n_devices": 1}}
    got = []
    for mod, harness in ((jserve, jchaos), (serve, chaos)):
        harness.arm("delay=0.3,chunk_overrun:1:-1")
        try:
            out = mod.handle_submit(json.loads(json.dumps(p)))
        finally:
            harness.disarm()
        rep = out["report"]
        ladder = next(sp for sp in _tree(mod._otrace.RECENT.get(
            out["trace_id"])["spans"]) if sp["name"] == "ladder")
        got.append((out["assignment"], rep["solver_dispatches"],
                    rep["solver_rounds_run"], rep.get("solver_final_cert"),
                    rep["replica_moves"], rep["proven_optimal"],
                    ladder["attrs"]["boundary_certified"]))
    assert got[1] == got[0]
    assert got[1][1:] == (2, 16, None, got[1][4], True, True)


def _tree(span):
    yield span
    for child in span.get("spans", ()):
        yield from _tree(child)


def test_megachunk_option_and_healthz_match_reference(monkeypatch):
    """``options.megachunk: true`` opts a solve into the measured width
    (no 501), false pins the per-chunk ladder; each answer equals the
    reference service's, ``solver_megachunk`` included; and ``/healthz``'s
    ``megachunk`` section is the engine's ``megachunk_snapshot()``, equal
    to the reference's after the same evidence (the port's adds the group
    graphs it holds). A non-bool value is a 400 in both."""
    from kafka_assignment_optimizer_tpu.solvers.tpu import (
        engine as jengine,
    )
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine

    for mod in (engine, jengine):
        mod.reset_megachunk_adapt()
    try:
        for flag in (True, False):
            p = {**DEMO, "solver": "tpu",
                 "options": {**PINNED, "megachunk": flag}}
            oj = jserve.handle_submit(dict(p))
            ot = serve.handle_submit(dict(p))
            assert_same_response(oj, ot)
            assert ot["report"].get("solver_megachunk") == \
                oj["report"].get("solver_megachunk")
        key = ("single", "sweep", 1, 4, 1, 48, 4, 16, "cuda")
        for mod in (engine, jengine):
            mod.reset_megachunk_adapt()
            for _ in range(16):
                mod.note_megachunk_evidence(key, dispatches=8,
                                            dispatch_s=0.008, chunks=8,
                                            device_s=0.08)
        got = serve.handle_healthz()["megachunk"]
        want = jserve.handle_healthz()["megachunk"]
        assert set(got.pop("graphs")) >= {"graphs", "captures", "max"}
        assert got == want and got["chosen"][repr(key)] == 2
        for mod in (serve, jserve):
            with pytest.raises(mod.ApiError) as ei:
                mod.handle_submit({**DEMO, "solver": "tpu",
                                   "options": {**PINNED, "megachunk": 2}})
            assert ei.value.status == 400
    finally:
        for mod in (engine, jengine):
            mod.reset_megachunk_adapt()
