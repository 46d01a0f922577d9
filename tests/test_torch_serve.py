"""PyTorch port: the HTTP service against the JAX package's — one server
of each package at module scope (the port's on the CPU), their handlers
driven in-process with the same requests, plus one HTTP round trip each.
``/submit`` (the exact MILP, a pinned sweep solve, a coalesced pair in
one window), ``/evaluate``, the error table of ``tests/test_serve.py``,
``/`` and ``/schema`` (byte-equal), the ``/metrics`` families and the
``/healthz`` keys (their difference is exactly the subsystems the port
has not ported yet, which answer 501), the measurement surfaces
(``/debug/profile``, ``/debug/slo``, ``?format=chrome``, ``--slo``,
``--profile-dir``, ``--sample-devices``), every flag of the JAX service
(working in the port, or refused at startup) and the import boundary:
the port's service loads neither JAX nor the JAX package. Plans, status
codes and integer fields are equal exactly."""

import ast
import json
import subprocess
import sys
import threading
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
# the reference's subsystems the port has not ported yet
DEFERRED_HEALTHZ = {"rollout"}
DEFERRED_FAMILY_PREFIXES = ("kao_rollout_",)


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
        for t in ths:
            t.start()
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
    """The port renders every family of the reference's ``/metrics``
    except the deferred subsystems' (and nothing else), and ``/healthz``
    every section except theirs."""
    fj = _families(jserve.render_metrics())
    ft = _families(serve.render_metrics())
    assert ft <= fj, ft - fj
    missing = fj - ft
    assert missing and all(f.startswith(DEFERRED_FAMILY_PREFIXES)
                           for f in missing), missing
    assert not {f for f in ft if f.startswith(DEFERRED_FAMILY_PREFIXES)}
    assert {"kao_sanitizer_nan_aborts_total", "kao_phase_seconds",
            "kao_solve_seconds"} <= ft
    kj, kt = set(jserve.handle_healthz()), set(serve.handle_healthz())
    assert kj - kt == DEFERRED_HEALTHZ and kt <= kj
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
    tid = serve._otrace.new_trace_id()
    if "{tid}" in path:
        tr = serve._otrace.begin(tid, name="request")
        serve._otrace.finish(tr)
        path = path.format(tid=tid)
    st, raw, _ = _http(servers["port"], path,
                       {} if method == "POST" else None)
    body = json.loads(raw)
    assert st == 501, body
    assert body["reason"] == "not_ported" and body["module"]


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


def test_every_reference_flag_works_or_is_refused(capsys):
    """Each flag of the JAX service parses in the port's service, and
    either is one the port serves or stops ``main`` at startup with a
    message naming the module still to port. The port's service also
    refuses to start without a card unless ``--device cpu``."""
    flags = _reference_flags()
    assert len(flags) > 30
    ap = serve.build_parser()
    known = {a for act in ap._actions for a in act.option_strings}
    deferred = {f for f, _m in serve._DEFERRED_FLAGS.values()}
    for flag in flags:
        assert flag in known, flag
        if flag in deferred:
            with pytest.raises(SystemExit) as ei:
                serve.main([flag, "1", "--device", "cpu"])
            assert ei.value.code == 2, flag
            err = capsys.readouterr().err
            assert "not supported by this package yet" in err, flag
    assert "--device" in known
    with pytest.raises(SystemExit) as ei:
        serve.main(["--megachunk", "auto", "--device", "cpu"])
    assert ei.value.code == 2
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as ei:
            serve.main(["--port", "0"])
        assert ei.value.code == 2
        assert "no CUDA device" in capsys.readouterr().err


def test_service_never_imports_jax():
    """Importing the port's service, and a CPU ``/submit`` through it (the
    exact MILP and a pinned sweep), ``/evaluate``, ``/healthz``,
    ``/metrics``, ``/debug/profile`` and ``/debug/slo``, load neither JAX
    nor the JAX package."""
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
    output and exit codes; ``--emit-waves`` exits 2 naming the module
    still to port."""
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
    assert tmain(["-i", str(cur), "--broker-list", "0-18", "--emit-waves",
                  str(tmp_path)]) == 2
    assert "not supported by this package yet" in capsys.readouterr().err
