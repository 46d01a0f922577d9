"""PyTorch port: the streaming plan rollout against the JAX package's.

The same inputs go through both packages: ``pack_waves`` (greedy, and
scored with 1, 3 and 8 lanes) on the golden pair of
``tests/golden/waves/``, on seeded instances and on ``decommission``'s
current assignment with a drain plan at its published size (256 brokers,
10,000 partitions); ``--emit-waves`` through both CLIs in process; the
rollout state machine driven by the same command sequences through both
packages' managers; and one HTTP round on each package's service (the
port's with ``device="cpu"``). Waves, caps, ``raised``, scores, winner
lanes, statuses, wave indices, epochs, status codes and error bodies are
equal exactly. Excluded everywhere: trace IDs (fresh per process), the
``rollout_root`` links that carry them, and the durations in the watch
solves' reports (``*wall_clock_s``, ``*build_s``).
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from kafka_assignment_optimizer_tpu import serve as jserve
from kafka_assignment_optimizer_tpu.cli import main as jmain
from kafka_assignment_optimizer_tpu.models import cluster as jcluster
from kafka_assignment_optimizer_tpu.rollout import exec as jexec
from kafka_assignment_optimizer_tpu.rollout import waves as jwaves
from kafka_assignment_optimizer_tpu.watch import manager as jman
from kafka_assignment_optimizer_tpu.watch import store as jstore
from kafka_assignment_optimizer_tpu_torch import serve
from kafka_assignment_optimizer_tpu_torch.cli import main as tmain
from kafka_assignment_optimizer_tpu_torch.models import cluster as tcluster
from kafka_assignment_optimizer_tpu_torch.rollout import exec as texec
from kafka_assignment_optimizer_tpu_torch.rollout import waves as twaves
from kafka_assignment_optimizer_tpu_torch.utils import gen
from kafka_assignment_optimizer_tpu_torch.watch import manager as tman
from kafka_assignment_optimizer_tpu_torch.watch import store as tstore

GOLDEN = Path(__file__).parent / "golden" / "waves"

# each package's modules, keyed by name
PKG = {
    "jax": (jcluster, jwaves, jexec, jman, jstore),
    "port": (tcluster, twaves, texec, tman, tstore),
}


def _assign(P=8, B=4, rf=2, off=0):
    return {"version": 1, "partitions": [
        {"topic": "t", "partition": p,
         "replicas": [(p + i + off) % B for i in range(rf)]}
        for p in range(P)]}


def _seeded_pair(seed: int) -> tuple[dict, dict, dict]:
    """A random cluster (14 brokers, 3 racks, 60 partitions, RF 2-3)
    and a target that reshuffles about half its partitions, flips some
    leaders, grows one partition the current assignment lacks and
    drops one it has."""
    rng = np.random.default_rng(seed)
    B, racks = 14, 3
    cur, tgt = [], []
    for p in range(60):
        rf = int(rng.integers(2, 4))
        reps = [int(b) for b in rng.choice(B, rf, replace=False)]
        cur.append({"topic": f"t{p % 4}", "partition": p, "replicas": reps})
        new = list(reps)
        r = rng.random()
        if r < 0.4:
            new = [int(b) for b in rng.choice(B, rf, replace=False)]
        elif r < 0.55:
            new = new[1:] + new[:1]
        if p != 59:
            tgt.append({"topic": f"t{p % 4}", "partition": p,
                        "replicas": new})
    tgt.append({"topic": "grown", "partition": 0, "replicas": [1, 2, 3]})
    topo = {str(b): f"r{b % racks}" for b in range(B)}
    return ({"version": 1, "partitions": cur},
            {"version": 1, "partitions": tgt}, topo)


def _decommission_pair() -> tuple[dict, dict, dict]:
    """``decommission`` at its published size and a drain plan: each
    replica on a broker outside the target list moves to a seeded
    broker of the same rack that the partition does not hold."""
    s = gen.SCENARIOS["decommission"]()
    keep = sorted(s.broker_list)
    topo = s.topology.to_dict()
    by_rack: dict = {}
    for b in keep:
        by_rack.setdefault(s.topology.rack(b), []).append(b)
    rng = np.random.default_rng(0)
    tgt = []
    for p in s.current.partitions:
        reps = list(p.replicas)
        for i, b in enumerate(reps):
            if b not in set(keep):
                pool = [x for x in by_rack[s.topology.rack(b)]
                        if x not in reps]
                reps[i] = int(pool[int(rng.integers(len(pool)))])
        tgt.append({"topic": p.topic, "partition": p.partition,
                    "replicas": reps})
    return (s.current.to_dict(), {"version": 1, "partitions": tgt}, topo)


PAIRS = {
    "golden": (_assign(P=4, B=4, rf=2), _assign(P=4, B=4, rf=2, off=1),
               {str(b): ("even" if b % 2 == 0 else "odd")
                for b in range(4)}),
    **{f"seeded{i}": _seeded_pair(i) for i in range(3)},
    "decommission": _decommission_pair(),
}
# (broker cap, rack cap) of each pair: the golden pair's, the defaults,
# a cap below the largest move (raised), and the defaults at scale
CAPS = {"golden": (1, 4), "seeded0": (4, 16), "seeded1": (1, 2),
        "seeded2": (2, 5), "decommission": (4, 16)}
PACKERS = [("greedy", 8), ("scored", 1), ("scored", 3), ("scored", 8)]


def _pack(name: str, pair: str, packer: str, lanes: int, seed: int = 0):
    cl, wv = PKG[name][0], PKG[name][1]
    cur, tgt, topo = PAIRS[pair]
    b, r = CAPS[pair]
    return wv.pack_waves(cl.Assignment.from_dict(cur),
                         cl.Assignment.from_dict(tgt),
                         cl.Topology.from_dict(topo),
                         caps=wv.WaveCaps(broker=b, rack=r),
                         packer=packer, lanes=lanes, seed=seed)


def _plan_fields(plan, wv) -> dict:
    return {"plan": plan.to_dict(), "score": plan.score,
            "makespan": plan.makespan, "peaks": (plan.peak_broker,
                                                 plan.peak_rack,
                                                 plan.peak_cross_rack),
            "verify": wv.verify_caps(plan)}


@pytest.mark.parametrize("packer,lanes", PACKERS)
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_pack_waves_matches_reference(pair, packer, lanes):
    """Waves (moves in emission order, per-wave broker and rack loads,
    cross-rack units), caps with ``raised``, the score and the scored
    packer's winner lane equal the reference's; every wave is within
    its caps."""
    got = {n: _plan_fields(_pack(n, pair, packer, lanes), PKG[n][1])
           for n in PKG}
    assert got["port"] == got["jax"]
    assert got["port"]["verify"] is True
    plan = got["port"]["plan"]
    assert plan["packer"] == packer and plan["waves"]
    if pair == "seeded1":
        assert plan["caps"]["raised"] is True
    if pair == "decommission":
        assert got["port"]["makespan"] >= 2


def test_packer_env_and_moves_match_reference(monkeypatch):
    """``KAO_ROLLOUT_PACKER`` picks the packer when none is given (as
    ``pack_waves`` reads it in the reference), a bad packer name raises
    the same error, and ``moves_of`` gives the same move list."""
    monkeypatch.setenv("KAO_ROLLOUT_PACKER", "scored")
    got = {n: _pack(n, "seeded0", None, 3).to_dict() for n in PKG}
    assert got["port"] == got["jax"]
    assert got["port"]["packer"] == "scored"
    errs = []
    for n in PKG:
        with pytest.raises(ValueError) as ei:
            _pack(n, "seeded0", "fancy", 3)
        errs.append(str(ei.value))
    assert errs[1] == errs[0]
    cur, tgt, _ = PAIRS["seeded2"]
    mv = {n: [m.to_dict() for m in PKG[n][1].moves_of(
        PKG[n][0].Assignment.from_dict(cur),
        PKG[n][0].Assignment.from_dict(tgt))] for n in PKG}
    assert mv["port"] == mv["jax"] and mv["port"]


def test_emit_waves_cli_matches_reference_and_golden(tmp_path, capsys):
    """``--emit-waves`` through both CLIs in process, on the golden pair
    audited with ``--evaluate`` (caps 1 and 4): the same exit code and
    report, and wave files byte-equal to each other and to
    ``tests/golden/waves/``; then a scored packing of a seeded pair,
    byte-equal across the packages."""
    cur, tgt, _ = PAIRS["golden"]
    (tmp_path / "cur.json").write_text(json.dumps(cur))
    (tmp_path / "tgt.json").write_text(json.dumps(tgt))
    golden = {p.name: p.read_bytes() for p in GOLDEN.glob("wave-*.json")}
    got = []
    for name, main in (("jax", jmain), ("port", tmain)):
        d = tmp_path / f"golden-{name}"
        rc = main(["-i", str(tmp_path / "cur.json"), "--broker-list", "0-3",
                   "--topology", "even-odd", "--evaluate",
                   str(tmp_path / "tgt.json"), "--emit-waves", str(d),
                   "--wave-broker-cap", "1", "--wave-rack-cap", "4"])
        rep = json.loads(capsys.readouterr().out)
        rep["waves"].pop("dir")
        files = {p.name: p.read_bytes() for p in d.iterdir()}
        got.append((rc, rep, files))
    assert got[1] == got[0]
    assert got[1][2] == golden and len(golden) == 2
    # a plan over the current partitions only (an audit compares the
    # same partition set)
    cur, tgt, topo = PAIRS["seeded0"]
    tgt = {"version": 1, "partitions": [
        q for q in tgt["partitions"] if q["topic"] != "grown"]
        + [cur["partitions"][59]]}
    (tmp_path / "scur.json").write_text(json.dumps(cur))
    (tmp_path / "stgt.json").write_text(json.dumps(tgt))
    (tmp_path / "topo.json").write_text(json.dumps(topo))
    got = []
    for name, main in (("jax", jmain), ("port", tmain)):
        d = tmp_path / f"scored-{name}"
        rc = main(["-i", str(tmp_path / "scur.json"), "--broker-list",
                   "0-13", "--topology", str(tmp_path / "topo.json"),
                   "--evaluate", str(tmp_path / "stgt.json"),
                   "--emit-waves", str(d), "--wave-packer", "scored",
                   "--wave-broker-cap", "2"])
        out = capsys.readouterr()
        assert rc in (0, 3), out.err
        got.append((rc, {p.name: p.read_bytes() for p in d.iterdir()}))
    assert got[1] == got[0] and len(got[1][1]) >= 2


# -- the rollout state machine through both managers ----------------------


def _bootstrap(epoch=1, B=4, P=8):
    return {"type": "bootstrap", "epoch": epoch,
            "assignment": _assign(P=P, B=B), "brokers": list(range(B)),
            "topology": "even-odd"}


def _stub_solve_fn(state, prev_plan, budget):
    """A deterministic rebalancer (the reference tests' stub): each
    partition round-robin over the eligible brokers."""
    elig = sorted(state.brokers)
    parts = []
    for p in state.assignment.partitions:
        rf = len(p.replicas) or 2
        parts.append({"topic": p.topic, "partition": p.partition,
                      "replicas": [elig[(p.partition + i) % len(elig)]
                                   for i in range(rf)]})
    return ({"version": 1, "partitions": parts},
            {"feasible": True, "replica_moves": 1})


DRAIN = {"type": "broker_drain", "epoch": 2, "brokers": [3]}
# each sequence: ("event", payload) to the registry, ("cmd", command,
# payload) to the manager, ("restart",) a new registry and manager over
# the same plan store, ("get",) the rollout view
SEQUENCES = {
    "canary_fail": [
        ("event", _bootstrap()), ("event", DRAIN),
        ("cmd", "start", {"epoch": 1}), ("cmd", "advance", {"epoch": 2}),
        ("cmd", "advance", {"epoch": 3}),
        ("cmd", "advance", {"epoch": 3, "canary_ok": False}),
        ("cmd", "advance", {"epoch": 4, "canary_ok": True}),
    ],
    "stale_epoch": [
        ("event", _bootstrap()), ("event", DRAIN),
        ("cmd", "start", {"epoch": 5}), ("cmd", "advance", {"epoch": 6}),
        ("cmd", "advance", {"epoch": 6, "canary_ok": True}),
        ("cmd", "advance", {"epoch": 7, "canary_ok": True}),
        ("cmd", "start", {"epoch": 8}), ("cmd", "advance", {}),
    ],
    "pause_to_done": [
        ("event", _bootstrap(P=12)), ("event", DRAIN),
        ("cmd", "start", {"epoch": 1, "broker_cap": 1}),
        ("cmd", "advance", {"epoch": 2}), ("cmd", "pause", {"epoch": 3}),
        ("cmd", "pause", {"epoch": 4}), ("cmd", "advance", {"epoch": 5}),
        ("cmd", "advance", {"epoch": 6, "canary_ok": True}),
        *[("cmd", "advance", {"epoch": e}) for e in range(7, 20)],
        ("cmd", "start", {"epoch": 20}),
    ],
    "rollback": [
        ("event", _bootstrap(P=12)), ("event", DRAIN),
        ("cmd", "start", {"epoch": 1}), ("cmd", "advance", {"epoch": 2}),
        ("cmd", "advance", {"epoch": 3, "canary_ok": True}),
        ("cmd", "rollback", {"epoch": 4}),
        ("cmd", "rollback", {"epoch": 5}),
    ],
    "restart_same_wave": [
        ("event", _bootstrap(P=12)), ("event", DRAIN),
        ("cmd", "start", {"epoch": 1}), ("cmd", "advance", {"epoch": 2}),
        ("cmd", "advance", {"epoch": 3, "canary_ok": True}),
        ("restart",), ("get",), ("cmd", "advance", {"epoch": 3}),
        ("cmd", "advance", {"epoch": 4}),
    ],
    "rebootstrap_voids": [
        ("event", _bootstrap()), ("event", DRAIN),
        ("cmd", "start", {"epoch": 1}), ("cmd", "advance", {"epoch": 2}),
        ("event", _bootstrap(epoch=3)),
        ("cmd", "advance", {"epoch": 3, "canary_ok": True}),
        ("event", {"type": "broker_drain", "epoch": 4, "brokers": [3]}),
        ("cmd", "start", {"epoch": 3}),
    ],
}


def _scrub(obj):
    """Drop trace IDs, the rollout-root links that carry them, and the
    solve reports' durations (``*wall_clock_s``, ``*build_s``)."""
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items()
                if k not in ("trace_id", "rollout_root")
                and not k.endswith(("wall_clock_s", "build_s"))}
    if isinstance(obj, (list, tuple)):
        return [_scrub(v) for v in obj]
    return obj


def _drive(name: str, steps: list, root: Path) -> list:
    _cl, _wv, rexec, wman, wstore = PKG[name]
    store = wstore.PlanStore(root / name)

    def fresh():
        reg = wman.WatchRegistry(_stub_solve_fn, store, window_s=0.0)
        return reg, rexec.RolloutManager(reg, store, broker_cap=2,
                                         rack_cap=8)

    reg, mgr = fresh()
    out = []
    for step in steps:
        try:
            if step[0] == "event":
                res = reg.handle_event("c", json.loads(json.dumps(step[1])))
                res = {k: res.get(k) for k in ("status", "epoch",
                                               "plan_epoch")}
            elif step[0] == "restart":
                reg, mgr = fresh()
                res = None
            elif step[0] == "get":
                res = mgr.get("c")
            else:
                res = mgr.command("c", step[1], dict(step[2]))
            out.append(("ok", _scrub(res)))
        except Exception as e:  # the outcome under test
            out.append(("err", type(e).__name__, str(e)))
        info = reg.get_cluster("c")
        out.append(("truth", info and info["assignment"],
                    _scrub(mgr.snapshot())))
    rec = store.load_rollout("c")
    out.append(("record", _scrub(rec)))
    return out


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_state_machine_matches_reference(seq, tmp_path):
    """The same command sequence through both packages' watch registry
    and rollout manager: each command's view or error (class and
    message), the ground truth and the counters after each step, and
    the durable record at the end are equal."""
    got = {n: _drive(n, SEQUENCES[seq], tmp_path) for n in PKG}
    assert got["port"] == got["jax"]
    outcomes = [s for s in got["port"] if s[0] in ("ok", "err")]
    errs = {s[1] for s in outcomes if s[0] == "err"}
    want = {"canary_fail": {"RolloutError", "RolloutConflict"},
            "stale_epoch": {"RolloutFenced", "RolloutConflict",
                            "RolloutError"},
            "pause_to_done": {"RolloutConflict"},
            "rollback": {"RolloutConflict"},
            "restart_same_wave": {"RolloutFenced"},
            "rebootstrap_voids": {"RolloutConflict"}}[seq]
    assert errs == want, outcomes
    if seq == "rollback":
        # the assignment after the rollback is the one after start's
        # rewind, bit for bit
        truths = [s[1] for s in got["port"] if s[0] == "truth"]
        assert truths[5] == truths[2] and truths[4] != truths[2]
    if seq == "pause_to_done":
        views = [s[1] for s in outcomes if s[0] == "ok" and s[1]
                 and "status" in s[1] and "waves" in s[1]]
        assert "done" in {v["status"] for v in views}


# -- one HTTP round on each package's service -----------------------------


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    root = tmp_path_factory.mktemp("rollout-http")
    saved = []
    urls = {}
    for name, mod, kw in (("jax", jserve, {}),
                          ("port", serve, {"device": "cpu"})):
        saved.append((mod, dict(mod.WATCH), dict(mod.ROLLOUT)))
        mod.WATCH.update(dir=str(root / name), registry=None, window_s=0.0)
        mod.ROLLOUT.update(manager=None, broker_cap=1, rack_cap=8)
        srv = mod.make_server(port=0, **kw)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        urls[name] = (srv, f"http://127.0.0.1:{srv.server_address[1]}")
    yield {n: u for n, (_s, u) in urls.items()}
    for srv, _u in urls.values():
        srv.shutdown()
        srv.server_close()
    for mod, watch, rollout in saved:
        mod.WATCH.clear()
        mod.WATCH.update(watch, registry=None)
        mod.ROLLOUT.clear()
        mod.ROLLOUT.update(rollout, manager=None)
    serve.SERVE["device"] = "cuda"


def _http(url, method, path, payload=None):
    req = urllib.request.Request(
        url + path, method=method,
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _rollout_families(text: str) -> dict:
    return {ln.split()[0]: float(ln.split()[1]) for ln in text.splitlines()
            if ln.startswith("kao_rollout_")}


# the HTTP round: (method, path, body); the demo-sized cluster solves
# through the exact MILP on the watch path
HTTP_ROUND = [
    ("GET", "/clusters/prod/rollout", None),
    ("POST", "/clusters/prod/events", _bootstrap(B=4, P=8)),
    ("POST", "/clusters/prod/events", DRAIN),
    ("GET", "/clusters/prod/rollout", None),
    ("POST", "/clusters/prod/rollout/start", {"epoch": 1}),
    ("GET", "/clusters/prod/rollout", None),
    ("POST", "/clusters/prod/rollout/start", {"epoch": 2}),
    ("POST", "/clusters/prod/rollout/advance", {"epoch": 2}),
    ("POST", "/clusters/prod/rollout/advance",
     {"epoch": 2, "canary_ok": True}),
    ("POST", "/clusters/prod/rollout/advance", {"epoch": 3}),
    ("POST", "/clusters/prod/rollout/advance",
     {"epoch": 3, "canary_ok": True}),
    ("POST", "/clusters/prod/rollout/pause", {"epoch": 4}),
    ("POST", "/clusters/prod/rollout/rollback", {"epoch": 5}),
    ("GET", "/clusters/prod", None),
    ("POST", "/clusters/ghost/rollout/start", {"epoch": 1}),
    ("POST", "/clusters/ghost/rollout/advance", {"epoch": 1}),
    ("POST", "/clusters/prod/rollout/start", {"epoch": -1}),
    ("POST", "/clusters/prod/rollout/start",
     {"epoch": 9, "broker_cap": "abc"}),
    ("POST", "/clusters/rollout/events", _bootstrap()),
    ("GET", "/clusters/rollout", None),
    ("GET", "/clusters/rollout/rollout", None),
]


def test_http_rollout_round_matches_reference(services):
    """One HTTP round on each service: the ``kao_rollout_*`` families
    declared at zero before the first rollout; start, the canary, a
    stale epoch (409 ``stale_rollout_epoch`` with
    ``current_rollout_epoch``), advance, pause, rollback to the
    pre-rollout assignment, the 404/409/400 mapping, a cluster named
    ``rollout`` still readable; then the ``/healthz`` ``rollout``
    section and the counters. Status codes and bodies are equal (trace
    IDs excluded)."""
    got = {}
    for name, url in services.items():
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            zero = _rollout_families(r.read().decode())
        rows = [_http(url, m, p, b) for m, p, b in HTTP_ROUND]
        _st, hz = _http(url, "GET", "/healthz")
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            after = _rollout_families(r.read().decode())
        got[name] = (zero, _scrub(rows), hz["rollout"], after)
    assert got["port"] == got["jax"]
    zero, rows, hz_rollout, after = got["port"]
    assert len(zero) == 10 and set(zero.values()) == {0.0}
    codes = [st for st, _b in rows]
    assert codes == [404, 200, 200, 404, 200, 200, 409, 200, 409, 400,
                     200, 200, 200, 200, 404, 409, 400, 400, 200, 200,
                     404], codes
    stale = rows[8][1]
    assert stale["reason"] == "stale_rollout_epoch"
    assert stale["current_rollout_epoch"] == 2
    assert rows[12][1]["status"] == "rolled_back"
    assert rows[13][1]["cluster_id"] == "prod"
    assert rows[19][1]["cluster_id"] == "rollout"
    assert hz_rollout["started_total"] == 1
    assert after["kao_rollout_fenced_total"] == 1.0
    assert after["kao_rollout_rollbacks_total"] == 1.0
