"""PyTorch port: the fleet plane against the JAX package's.

- ``fleet.affinity``: ``bucket_key_of``, ``shape_key``,
  ``rendezvous_rank`` and ``rank_workers`` on the same payloads and
  worker lists, and ``bucket_key_of`` against the port worker's own
  ledger (``/healthz`` ``cache.warm_buckets``) after a CPU solve;
- ``fleet.router``: both packages' routers over the same scripted fake
  workers with the same request sequences (warm-first routing, failover
  on a dead worker, a shed honouring ``retry_after_s``, the 503 with
  ``Retry-After``, sticky cluster owners, the two-phase warmup partition,
  the hedge winner, one merged trace across router and worker);
- ``obs.causal.merge_fleet_trace`` and ``obs.chrome.to_chrome_fleet`` on
  the same inputs (``tests/golden/chrome_trace.json`` is ``to_chrome``'s
  golden, so the two packages' outputs are held to each other);
- ``obs.fleet``: ``merge_sources``, ``build_view`` and ``kao-fleet
  --json`` on the same flight directories, torn and duplicated lines
  included;
- the import boundary: ``fleet.router`` loads neither torch nor jax.

Excluded from the comparisons, and named where they are: trace and span
IDs (fresh per request), timestamps, ports, and the remaining cooldown
behind a ``retry_after_s``.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from kafka_assignment_optimizer_tpu.fleet import affinity as jaff
from kafka_assignment_optimizer_tpu.fleet import health as jhealth
from kafka_assignment_optimizer_tpu.fleet import router as jrouter
from kafka_assignment_optimizer_tpu.models.cluster import demo_assignment
from kafka_assignment_optimizer_tpu.obs import causal as jcausal
from kafka_assignment_optimizer_tpu.obs import chrome as jchrome
from kafka_assignment_optimizer_tpu.obs import fleet as jfleet
from kafka_assignment_optimizer_tpu.obs import flight as jflight
from kafka_assignment_optimizer_tpu.obs import trace as jtrace
from kafka_assignment_optimizer_tpu_torch import serve
from kafka_assignment_optimizer_tpu_torch.fleet import affinity as taff
from kafka_assignment_optimizer_tpu_torch.fleet import health as thealth
from kafka_assignment_optimizer_tpu_torch.fleet import router as trouter
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.models.cluster import (
    Assignment,
    Topology,
    parse_broker_list,
)
from kafka_assignment_optimizer_tpu_torch.obs import causal as tcausal
from kafka_assignment_optimizer_tpu_torch.obs import chrome as tchrome
from kafka_assignment_optimizer_tpu_torch.obs import fleet as tfleet
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import bucket

REPO = Path(__file__).resolve().parent.parent

DEMO = {"assignment": demo_assignment().to_dict(), "brokers": "0-18",
        "topology": "even-odd", "solver": "tpu"}


def _payloads() -> dict:
    """Payloads that exercise every branch of ``payload_shape``."""
    demo = DEMO["assignment"]
    wide = {"version": 1, "partitions": [
        {"topic": f"t{p % 3}", "partition": p,
         "replicas": [(p + i) % 40 for i in range(1 + p % 4)]}
        for p in range(300)]}
    topo = {str(b): f"r{b % 5}" for b in range(40)}
    return {
        "demo": DEMO,
        "demo_list_brokers": {**DEMO, "brokers": list(range(19))},
        "demo_no_topology": {**DEMO, "topology": None},
        "demo_rf_int": {**DEMO, "rf": 2},
        "demo_rf_map": {**DEMO, "rf": {"x.y.z.t": 2}},
        "wide_rack_map": {"assignment": wide, "brokers": "0-39",
                          "topology": topo},
        "wide_subset": {"assignment": wide, "brokers": "0-29",
                        "topology": topo, "rf": 4},
        "bad_rf_bool": {**DEMO, "rf": True},
        "bad_rf_big": {**DEMO, "rf": 40},
        "bad_topology": {**DEMO, "topology": 7},
        "bad_brokers": {**DEMO, "brokers": []},
        "no_partitions": {**DEMO, "assignment": {"version": 1,
                                                  "partitions": []}},
        "missing": {"brokers": "0-3"},
    }


PAYLOADS = _payloads()


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_bucket_key_matches_reference_and_the_worker(name):
    """``payload_shape`` and ``bucket_key_of`` equal the reference's; a
    well-formed payload's key is the one the port's service computes
    from the instance it builds (``(brokers, racks, *bucket_shape)``)."""
    p = PAYLOADS[name]
    assert taff.payload_shape(p) == jaff.payload_shape(p)
    key = taff.bucket_key_of(p)
    assert key == jaff.bucket_key_of(p)
    if name.startswith(("bad_", "no_", "missing")):
        assert key is None
        return
    current = Assignment.from_dict(p["assignment"])
    spec = p["brokers"]
    brokers = (parse_broker_list(spec) if isinstance(spec, str)
               else list(spec))
    all_ids = sorted(set(brokers) | set(current.broker_ids()))
    topo = p.get("topology")
    topo = (None if topo is None else Topology.even_odd(all_ids)
            if topo == "even-odd" else Topology.from_dict(topo))
    inst = build_instance(current, brokers, topo, p.get("rf"))
    assert key == (inst.num_brokers, inst.num_racks,
                   *bucket.bucket_shape(inst))


def test_rendezvous_and_shape_keys_match_reference():
    """``rendezvous_rank``, ``rank_workers`` (with and without a warm
    map) and ``shape_key`` give the reference's orders and keys."""
    workers = [f"http://10.0.0.{i}:8787" for i in range(1, 6)]
    keys = [None, ("cluster", "prod"), *[
        (b, k, bucket.part_bucket(p), bucket.rf_bucket(r))
        for b, k, p, r in ((19, 2, 10, 3), (256, 8, 10_000, 3),
                           (512, 16, 50_000, 3), (12, 4, 64, 3))]]
    warm = {workers[3]: {keys[3]}, workers[1]: {keys[3], keys[4]}}
    for key in keys:
        for ws in (workers, workers[:2], workers[::-1]):
            assert taff.rendezvous_rank(key, ws) \
                == jaff.rendezvous_rank(key, ws)
            for wm in (None, warm):
                assert taff.rank_workers(key, ws, wm) \
                    == jaff.rank_workers(key, ws, wm)
    for shape in ((256, 10_000, 3, 8), (512, 50_000, 3, 16),
                  (12, 64, 3, 4), (19, 10, 3, 2)):
        assert taff.shape_key(*shape) == jaff.shape_key(*shape)


def test_bucket_key_is_in_the_workers_warm_ledger():
    """After one pinned sweep solve through the port's service on the
    CPU, ``/healthz`` ``cache.warm_buckets`` holds the payload's
    ``bucket_key_of`` — the key the router looks up."""
    serve.SERVE["device"] = "cpu"
    try:
        p = {**DEMO, "options": {"engine": "sweep", "sweeps": 8,
                                 "batch": 4, "seed": 0,
                                 "portfolio": False}}
        out = serve.handle_submit(json.loads(json.dumps(p)))
        assert out["report"]["solver_engine"] == "sweep"
        warm = {tuple(k) for k in
                serve.handle_healthz()["cache"]["warm_buckets"]}
    finally:
        serve.SERVE["device"] = "cuda"
    assert taff.bucket_key_of(p) in warm


def test_router_module_loads_neither_torch_nor_jax():
    """The router front process (and the modules it imports) boots
    without torch or jax."""
    code = (
        "import sys\n"
        "import kafka_assignment_optimizer_tpu_torch.fleet.router\n"
        "import kafka_assignment_optimizer_tpu_torch.obs.fleet\n"
        "bad = [n for n in sys.modules if n in ('torch', 'jax')"
        " or n.startswith(('torch.', 'jax.', "
        "'kafka_assignment_optimizer_tpu.'))]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-500:]


# -- both routers over the same fake workers ------------------------------


class _FakeWorker:
    """A scripted worker: ``/healthz`` with a warm-bucket ledger,
    ``/submit``, ``/warmup`` and ``/clusters`` per its ``mode``, and the
    causal-tracing contract (it adopts the router's traceparent and
    serves the remote-parented report on ``/debug/solves/<id>``)."""

    def __init__(self, warm=(), mode="ok", retry_after_s=0.2, solve_s=0.0):
        self.warm = [list(k) for k in warm]
        self.mode = mode
        self.retry_after_s = retry_after_s
        self.solve_s = solve_s
        self.requests: list = []
        self.reports: dict = {}
        self._lock = threading.Lock()
        fake = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _json(self, status, obj, headers=None):
                body = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/healthz"):
                    self._json(200, {"status": "ok",
                                     "cache": {"warm_buckets": fake.warm},
                                     "queue": {"depth": 0}})
                elif self.path.startswith("/debug/solves/"):
                    tid = self.path.rsplit("/", 1)[1].split("?")[0]
                    rep = fake.reports.get(tid)
                    self._json(404 if rep is None else 200,
                               rep or {"error": "no such trace"})
                elif self.path.startswith("/clusters"):
                    self._json(200, {"clusters": {}, "worker": fake.url})
                else:
                    self._json(404, {"error": "nope"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                with fake._lock:
                    fake.requests.append((self.path, payload))
                if fake.mode == "shed":
                    self._json(503, {
                        "error": "queue full", "reason": "queue_full",
                        "retry_after_s": fake.retry_after_s,
                        "worker": {"host": "fake", "pid": 1}},
                        headers={"Retry-After": "1"})
                    return
                if fake.solve_s:
                    time.sleep(fake.solve_s)
                if self.path == "/warmup":
                    self._json(200, {"warmed": [
                        {"shape": sh, "compiles": 1,
                         "persistent": {"hits": 0, "misses": 1}}
                        for sh in payload.get("shapes", [])]})
                    return
                ctx = jtrace.extract(self.headers.get("traceparent"))
                if ctx is not None and self.path == "/submit":
                    fake.reports[ctx.trace_id] = {
                        "trace_id": ctx.trace_id, "name": "request",
                        "started_unix": 1000.25, "wall_s": 0.02,
                        "spans": {"name": "request", "start_s": 0.0,
                                  "wall_s": 0.02,
                                  "attrs": {"parent_span_id": ctx.span_id,
                                            "span_kind": "server"},
                                  "spans": [{"name": "ladder",
                                             "start_s": 0.001,
                                             "wall_s": 0.01}]}}
                self._json(200, {"worker": fake.url, "path": self.path,
                                 "epoch": payload.get("epoch"),
                                 "report": {"feasible": True},
                                 **({"trace_id": ctx.trace_id}
                                    if ctx else {})})

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def reset(self):
        with self._lock:
            self.requests = []
            self.reports = {}

    def posts(self, prefix="/"):
        with self._lock:
            return [(p, b) for p, b in self.requests if p.startswith(prefix)]

    def kill(self):
        self.srv.shutdown()
        self.srv.server_close()


def _dead_url() -> str:
    """A local port nothing listens on."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


ROUTERS = {"jax": (jrouter, jhealth), "port": (trouter, thealth)}


def _call(url, method, path, payload=None):
    req = urllib.request.Request(
        url + path, method=method,
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _route_both(urls: list, fakes: list, drive, **kw) -> dict:
    """Run ``drive(url, router)`` against each package's router over the
    same workers (the reference's first), the fakes reset before each."""
    out = {}
    for name, (rmod, hmod) in ROUTERS.items():
        for f in fakes:
            f.reset()
        tracker = hmod.FleetTracker(urls, interval_s=3600, timeout_s=2.0)
        tracker.poll_once()
        router = rmod.Router(tracker, lock_wait_s=kw.get("lock_wait_s",
                                                         3.0),
                             solve_timeout_s=10.0, connect_timeout_s=2.0,
                             **{k: v for k, v in kw.items()
                                if k != "lock_wait_s"})
        srv = rmod.make_router_server("127.0.0.1", 0, router)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            out[name] = drive(
                f"http://127.0.0.1:{srv.server_address[1]}", router)
        finally:
            srv.shutdown()
            srv.server_close()
    return out


DEMO_KEY = jaff.bucket_key_of(DEMO)


def _counters(router) -> dict:
    return router.snapshot()["counters"]


def test_routers_route_warm_and_fail_over_alike():
    """Warm-first routing (the worker rendezvous would not pick is the
    warm one), then failover past a dead worker ranked first, and a shed
    worker whose ``retry_after_s`` cooldown keeps later requests off it:
    the same answering workers, the same knocks on each worker and the
    same counters."""
    a, b = _FakeWorker(), _FakeWorker()
    try:
        first = jaff.rendezvous_rank(DEMO_KEY, [a.url, b.url])[0]
        warm_w = b if first == a.url else a
        warm_w.warm = [list(DEMO_KEY)]

        def warm_route(url, router):
            st, body, hdr = _call(url, "POST", "/submit", DEMO)
            return st, body["worker"], _counters(router)

        got = _route_both([a.url, b.url], [a, b], warm_route)
        assert got["port"] == got["jax"]
        assert got["port"][1] == warm_w.url

        def failover(url, router):
            rows = [_call(url, "POST", "/submit", DEMO)[:2]
                    for _ in range(4)]
            rows = [(st, {"worker": body["worker"]}) for st, body in rows]
            snap = router.snapshot()
            return rows, snap["counters"], snap["fleet"]["live"]

        # a dead worker that rendezvous ranks first (no warm ledger)
        warm_w.warm = []
        dead = next(u for u in iter(_dead_url, None)
                    if jaff.rendezvous_rank(DEMO_KEY,
                                            [u, warm_w.url])[0] == u)
        got = _route_both([dead, warm_w.url], [warm_w], failover)
        assert got["port"] == got["jax"]
        rows, counters, live = got["port"]
        assert all(st == 200 and body["worker"] == warm_w.url
                   for st, body in rows)
        assert counters["retries_total"]["connect_fail"] >= 1
        assert dead not in live

        shed = _FakeWorker(warm=[DEMO_KEY], mode="shed", retry_after_s=30.0)
        try:
            def shed_route(url, router):
                rows = [_call(url, "POST", "/submit", DEMO)[:2]
                        for _ in range(3)]
                return ([(st, body["worker"]) for st, body in rows],
                        len(shed.posts("/submit")), _counters(router))

            other = a if warm_w is b else b
            got = _route_both([shed.url, other.url], [shed, other],
                              shed_route)
            assert got["port"] == got["jax"]
            assert got["port"][1] == 1
            assert got["port"][2]["retries_total"]["shed"] == 1
        finally:
            shed.kill()
    finally:
        a.kill()
        b.kill()


def test_routers_exhaust_with_503_and_retry_after_alike():
    """Every worker shedding: both routers answer 503
    ``fleet_exhausted`` with a ``Retry-After`` header (the remaining
    cooldown behind ``retry_after_s`` is excluded: it is a clock
    reading)."""
    a = _FakeWorker(mode="shed", retry_after_s=20.0)
    try:
        def exhaust(url, router):
            st, body, hdr = _call(url, "POST", "/submit", DEMO)
            return (st, body["reason"], body["retry_after_s"] > 0,
                    int(hdr["Retry-After"]) >= 1, _counters(router))

        got = _route_both([a.url], [a], exhaust, lock_wait_s=0.5)
        assert got["port"] == got["jax"]
        assert got["port"][:4] == (503, "fleet_exhausted", True, True)
    finally:
        a.kill()


def test_routers_keep_clusters_sticky_and_partition_warmup_alike():
    """Cluster commands stick to one owner per cluster id, the same
    owners in both routers; the fleet warmup partitions shapes by
    bucket owner (phase 1) and spreads the rest (phase 2) identically,
    with the same fresh-compile accounting."""
    a, b = _FakeWorker(), _FakeWorker()
    try:
        def sticky(url, router):
            for cid in (f"c{i}" for i in range(6)):
                for epoch in (1, 2):
                    st, _b, _h = _call(url, "POST",
                                       f"/clusters/{cid}/events",
                                       {"type": "bootstrap",
                                        "epoch": epoch})
                    assert st == 200
            owners = {w.url: sorted({p.split("/")[2] for p, _ in
                                     w.posts("/clusters/")})
                      for w in (a, b)}
            st, body, _h = _call(url, "GET", "/clusters/c0")
            return owners, (st, body["worker"]), _counters(router)

        got = _route_both([a.url, b.url], [a, b], sticky)
        assert got["port"] == got["jax"]
        owners = got["port"][0]
        assert not set(owners[a.url]) & set(owners[b.url])

        shapes = [{"brokers": 12, "partitions": 64, "rf": 3, "racks": 4},
                  {"brokers": 12, "partitions": 200, "rf": 3, "racks": 4},
                  {"brokers": 256, "partitions": 10_000, "rf": 3,
                   "racks": 8}]

        def warmup(url, router):
            st, out, _h = _call(url, "POST", "/warmup", {"shapes": shapes})
            st2, out2, _h = _call(url, "POST", "/warmup",
                                  {"shapes": shapes, "spread": "owners"})
            keep = ("partition", "phase2", "fresh_compiles",
                    "spread_fresh_compiles", "errors")
            return (st, {k: out.get(k) for k in keep}, st2,
                    out2.get("phase2"))

        got = _route_both([a.url, b.url], [a, b], warmup)
        assert got["port"] == got["jax"]
        st, out, st2, phase2 = got["port"]
        assert st == st2 == 200 and phase2 == {}
        assert out["fresh_compiles"] == 3 == out["spread_fresh_compiles"]
    finally:
        a.kill()
        b.kill()


def test_routers_hedge_and_merge_one_trace_alike():
    """A deadline-carrying ``/submit`` whose warm primary stalls past
    ``--hedge-ms`` is won by the hedge on the other worker, in both
    routers; ``GET /debug/traces/<id>`` merges the router's spans with
    the worker's under one trace ID, and ``?format=chrome`` gives pid 1
    to the router and pid 2 onward to the workers. Span trees are
    compared by span names and attributes, trace and span IDs and
    timestamps excluded."""
    slow = _FakeWorker(warm=[DEMO_KEY], solve_s=0.5)
    fast = _FakeWorker()

    def names(span):
        return [span.get("name"),
                sorted(k for k in (span.get("attrs") or {})
                       if not k.endswith(("_id", "_s")) and k != "worker"),
                [names(c) for c in span.get("spans") or ()]]

    try:
        def hedge(url, router):
            st, body, hdr = _call(url, "POST", "/submit",
                                  {**DEMO, "deadline_s": 30})
            tid = body["trace_id"]
            st2, merged, _h = _call(url, "GET", f"/debug/traces/{tid}")
            st3, chrome, _h = _call(url, "GET",
                                    f"/debug/traces/{tid}?format=chrome")
            procs = [(p["process"], p["attached_to"] is not None)
                     for p in merged["processes"]]
            pids = sorted({e["pid"] for e in chrome["traceEvents"]})
            labels = {e["pid"]: e["args"]["name"]
                      for e in chrome["traceEvents"]
                      if e["name"] == "process_name"}
            c = _counters(router)
            return (st, body["worker"], body["route"]["hedge_won"], st2,
                    names(merged["root"]["spans"]), procs, st3, pids,
                    labels, c["hedges_total"], c["hedge_wins_total"],
                    merged["trace_id"] == tid == chrome["otherData"][
                        "trace_id"])

        got = _route_both([slow.url, fast.url], [slow, fast], hedge,
                          hedge_ms=100.0, hedge_budget=2)
        assert got["port"] == got["jax"]
        (st, worker, won, st2, _tree, procs, st3, pids, labels, hedges,
         wins, same_id) = got["port"]
        assert (st, st2, st3) == (200, 200, 200)
        assert worker == fast.url and won is True
        assert (hedges, wins) == (1, 1) and same_id
        assert pids[0] == 1 and len(pids) >= 2 and labels[1] == "kao router"
        assert any(att for _p, att in procs)
    finally:
        slow.kill()
        fast.kill()


def test_router_metrics_and_healthz_match_reference():
    """After the same request, ``/healthz`` (role, routing, the worker's
    warm ledger) and the ``kao_router_*`` / ``kao_trace_*`` families of
    ``/metrics`` are the reference's."""
    a = _FakeWorker(warm=[DEMO_KEY])
    try:
        def surfaces(url, router):
            _call(url, "POST", "/submit", DEMO)
            _st, hz, _h = _call(url, "GET", "/healthz")
            with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
                text = r.read().decode()
            fams = sorted(ln.split()[2] for ln in text.splitlines()
                          if ln.startswith("# TYPE"))
            return (hz["role"], hz["routing"],
                    hz["fleet"]["workers"][a.url]["warm_buckets"], fams)

        got = _route_both([a.url], [a], surfaces)
        assert got["port"] == got["jax"]
        assert got["port"][2] == [list(DEMO_KEY)]
        assert "kao_router_affinity_rate" in got["port"][3]
    finally:
        a.kill()


# -- merge_fleet_trace and to_chrome_fleet on the same inputs -------------


def _trace_inputs():
    """A router root report with two attempt spans (made by the
    reference's ``obs.trace``), three worker reports: one attached to
    each attempt (one with a negative clock offset) and one whose parent
    the router does not hold."""
    tid = "c11e207f00d5c0de"
    tr = jtrace.begin(tid, name="route", route="/submit")
    with jtrace.span("route_decision", worker="w1"):
        pass
    with jtrace.span("attempt", worker="w1") as a1:
        jtrace.inject()  # assigns the span its ID, as a routed call does
    with jtrace.span("attempt", worker="w2", hedge=True) as a2:
        jtrace.inject()
    root = jtrace.finish(tr)
    root["started_unix"] = 1000.0

    def worker(parent, started, wall):
        return {"trace_id": tid, "name": "request", "started_unix": started,
                "wall_s": wall,
                "spans": {"name": "request", "start_s": 0.0, "wall_s": wall,
                          "attrs": {"parent_span_id": parent,
                                    "span_kind": "server"},
                          "spans": [{"name": "ladder", "start_s": 0.001,
                                     "wall_s": wall / 2},
                                    {"name": "verify", "start_s": wall / 2,
                                     "wall_s": None}]}}

    remotes = [{"process": "http://w1", "report": worker(a1.sid(),
                                                         1000.01, 0.4)},
               {"process": "http://w2", "report": worker(a2.sid(),
                                                         999.9, 0.2)},
               {"process": "http://w3", "report": worker("feedbeef",
                                                         1000.5, 0.1)}]
    return tid, root, remotes


def test_merge_fleet_trace_and_chrome_fleet_match_reference():
    """The merged tree (attachments, offsets, the router copy left
    untouched) and its Chrome export (pids, process labels, sort
    indices, lanes, events) are the reference's exactly; so is the
    degraded merge without the router's half."""
    tid, root, remotes = _trace_inputs()
    before = json.dumps(root, sort_keys=True)
    mj = jcausal.merge_fleet_trace(tid, root, remotes)
    mt = tcausal.merge_fleet_trace(tid, root, remotes)
    assert mt == mj
    assert json.dumps(root, sort_keys=True) == before
    assert [p["attached_to"] is not None for p in mt["processes"]] \
        == [True, True, False]
    assert tchrome.to_chrome_fleet(mt) == jchrome.to_chrome_fleet(mj)
    chrome = tchrome.to_chrome_fleet(mt)
    assert sorted({e["pid"] for e in chrome["traceEvents"]}) == [1, 2, 3, 4]
    degraded = [tcausal.merge_fleet_trace(tid, None, remotes),
                jcausal.merge_fleet_trace(tid, None, remotes)]
    assert degraded[0] == degraded[1]
    assert tchrome.to_chrome_fleet(degraded[0]) \
        == jchrome.to_chrome_fleet(degraded[1])
    # collect_remote with an injected fetch: reports sorted, a raising
    # worker in errors, a missing one absent
    table = {"http://w1": remotes[0]["report"], "http://w2": None}

    def fetch(u, t):
        if u == "http://dead":
            raise OSError("refused")
        return table.get(u)

    urls = ["http://w2", "http://dead", "http://w1"]
    assert tcausal.collect_remote(urls, tid, fetch=fetch) \
        == jcausal.collect_remote(urls, tid, fetch=fetch)


# -- obs.fleet on the same flight directories ------------------------------


def _rec(worker: str, seq: int, ts: float, wall_s: float = 0.1,
         kind: str = "solve") -> dict:
    return {"ts": ts, "kind": kind, "wall_s": wall_s, "seq": seq,
            "worker": {"host": worker, "pid": 1, "port": None,
                       "boot": worker},
            "quality": {"feasible": True, "certified": seq % 3 == 0,
                        "degraded": False},
            "trace_id": f"{worker}{seq:04d}"}


@pytest.fixture(scope="module")
def flight_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("flight")
    dirs = []
    streams = {
        "a": [_rec("a", i + 1, 100.0 + 2 * i, 0.1 + 0.05 * i)
              for i in range(12)],
        "b": [_rec("b", i + 1, 101.0 + 2 * i, 6.0 if i % 5 == 0 else 0.2)
              for i in range(12)],
        "c": [_rec("c", i + 1, 150.0 + i, kind="delta") for i in range(5)],
    }
    streams["b"][6]["ts"] = streams["b"][4]["ts"] - 0.5  # clock skew
    for name, recs in streams.items():
        d = root / name
        rec = jflight.FlightRecorder()
        rec.configure(str(d), max_bytes=1 << 20, max_files=8)
        for r in recs:
            rec.write(r)
        rec.configure(None)
        dirs.append(str(d))
    with open(Path(dirs[2]) / "flight.jsonl", "a") as fh:
        fh.write('{"ts": 999, "seq": 6, "torn')  # a kill -9 tail
    return dirs


def test_fleet_merge_and_view_match_reference(flight_dirs):
    """``merge_sources`` (per-worker seq order, cross-worker ts order,
    dedup on ``(worker, seq)``, a torn tail skipped) and ``build_view``
    at a fixed ``now`` (burn rates, drift, per-worker lag and gaps) on
    the same sources, one directory read twice, equal the reference's."""
    sources = [(d, list(jflight.iter_records(d))) for d in flight_dirs]
    sources.append((flight_dirs[0] + "-again", sources[0][1]))
    mj = jfleet.merge_sources(sources)
    mt = tfleet.merge_sources(sources)
    assert mt == mj
    merged, per_worker, dups = mt
    assert (len(merged), dups) == (29, 12)
    vj = jfleet.build_view(sources, now=200.0, slo_spec="solve:5:0.99")
    vt = tfleet.build_view(sources, now=200.0, slo_spec="solve:5:0.99")
    assert vt == vj
    assert vt["workers"] == 3
    assert tfleet.render_fleet_metrics(vt) == jfleet.render_fleet_metrics(vj)


def test_kao_fleet_cli_matches_reference(flight_dirs, capsys):
    """``kao-fleet DIR DIR DIR --json --now T`` prints the reference's
    view; a missing directory is the same error."""
    outs = []
    for main in (jfleet.main, tfleet.main):
        rc = main([*flight_dirs, "--format", "json", "--now", "200"])
        outs.append((rc, json.loads(capsys.readouterr().out)))
    assert outs[1] == outs[0] and outs[1][0] == 0
    assert outs[1][1]["records"] == 29
    codes = []
    for main in (jfleet.main, tfleet.main):
        codes.append(main([flight_dirs[0] + "-missing", "--format",
                           "json"]))
        capsys.readouterr()
    assert codes[1] == codes[0]


def test_worker_debug_fleet_merges_its_peers(tmp_path):
    """A port worker's ``GET /debug/fleet`` with ``--fleet-peers`` set to
    another port worker merges both rings: the view counts two workers
    and the sum of their records, as the reference's handler does."""
    peer = _FakePeer([_rec("p", i + 1, 100.0 + i) for i in range(4)])
    saved = list(serve.FLEET["peers"])
    serve.FLEET["peers"] = [peer.url, _dead_url()]
    try:
        view = serve.handle_fleet_get()
    finally:
        serve.FLEET["peers"] = saved
        peer.kill()
    own = len(serve._oflight.recent())
    assert view["records"] == own + 4
    assert view["peers"][0] == peer.url and len(view["errors"]) == 1
    assert set(view) >= {"workers", "records", "per_worker", "slo",
                         "drift", "stream"}


class _FakePeer:
    """A worker's ``/debug/stream`` snapshot (NDJSON), nothing else."""

    def __init__(self, records):
        body = "".join(json.dumps(r) + "\n" for r in records).encode()

        class H(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def kill(self):
        self.srv.shutdown()
        self.srv.server_close()


def test_debug_kernels_reports_the_launch_counters():
    """``GET /debug/kernels`` on a port worker names the three kernels
    with their launch counters, which a CPU solve leaves where they were
    (on a CPU tensor a wrapper runs its plain version and launches
    nothing), and the build directory's traffic."""
    from kafka_assignment_optimizer_tpu_torch.ops import kernels

    srv = serve.make_server(port=0, device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        before = _call(url, "GET", "/debug/kernels")[1]
        serve.handle_submit({**DEMO, "options": {
            "engine": "sweep", "sweeps": 8, "batch": 2,
            "portfolio": False}})
        st, after, _h = _call(url, "GET", "/debug/kernels")
    finally:
        srv.shutdown()
        srv.server_close()
        serve.SERVE["device"] = "cuda"
    assert st == 200 and after["device"] == "cpu"
    assert set(after["launches"]) == {k.name for k in kernels.KERNELS}
    assert after["launches"] == before["launches"]
    assert {"dir", "hits", "misses"} <= set(after["build"])

