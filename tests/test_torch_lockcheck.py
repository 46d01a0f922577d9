"""PyTorch port: the runtime lock sanitizer (``analysis/lsan.py``) against
the JAX package's.

- the reference's sanitizer scenarios (an inversion, record-only mode,
  the hold budget, RLock re-entry, the Condition protocol, the proxy's
  overhead) run on both packages' ``lsan`` and give the same violation
  kinds and sites;
- ``install()`` in a fresh process wraps the port's locks (the chain
  engine's ``_CAPTURE_LOCK`` among them) and not the JAX package's;
- armed in a child process, the port serves two concurrent demo
  ``/submit`` requests and runs a chain-engine solve beside a sweep solve
  on the CPU, each plan equal to the plan the solve gives alone, and
  records no violation, as the reference's session gate demands.
"""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from kafka_assignment_optimizer_tpu.analysis import lsan as jlsan
from kafka_assignment_optimizer_tpu_torch.analysis import lsan

REPO = Path(__file__).resolve().parent.parent


def _inversion(mod):
    a, b = mod.wrap(site="pair.a"), mod.wrap(site="pair.b")
    with mod.scope() as sc:
        with a:
            with b:
                pass
        with pytest.raises(mod.LockOrderInversion) as ei:
            with b:
                with a:
                    pass
        assert "pair.a" in str(ei.value) and "pair.b" in str(ei.value)
    # a tripped acquisition must not leak the inner lock
    assert not a._inner.locked() and not b._inner.locked()
    return sc.violations


def _record_only(mod):
    a, b = mod.wrap(site="ro.a"), mod.wrap(site="ro.b")
    with mod.scope() as sc:
        with a:
            with b:
                pass
        with b:
            with a:  # recorded, not raised
                pass
    return sc.violations


def _hold_budget(mod):
    old = mod._HOLD_BUDGET[0]
    mod._HOLD_BUDGET[0] = 0.01
    try:
        lock = mod.wrap(site="hold.x")
        with mod.scope() as sc:
            with lock:
                time.sleep(0.05)
    finally:
        mod._HOLD_BUDGET[0] = old
    return sc.violations


def _rlock_reentry(mod):
    r = mod.wrap(threading.RLock(), site="re.r", reentrant=True)
    inner = mod.wrap(site="re.inner")
    with mod.scope() as sc:
        with r:
            with r:  # re-entry: no self-edge, no double hold window
                with inner:
                    pass
    return sc.violations


def _condition(mod):
    cv = threading.Condition(mod.wrap(site="cv.lock"))
    hits = []

    def waiter():
        with cv:
            while not hits:
                cv.wait(timeout=2.0)

    with mod.scope() as sc:
        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        with cv:
            hits.append(1)
            cv.notify_all()
        t.join(timeout=5.0)
        assert not t.is_alive()
    return sc.violations


SCENARIOS = {"inversion": (_inversion, ["inversion"]),
             "record_only": (_record_only, ["inversion"]),
             "hold_budget": (_hold_budget, ["hold_budget"]),
             "rlock_reentry": (_rlock_reentry, []),
             "condition": (_condition, [])}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_gives_the_reference_violations(name, monkeypatch):
    if name == "record_only":
        monkeypatch.setenv("KAO_LSAN_RAISE", "0")
    run, kinds = SCENARIOS[name]
    got = [(v.kind, v.site_a, v.site_b) for v in run(lsan)]
    ref = [(v.kind, v.site_a, v.site_b) for v in run(jlsan)]
    assert got == ref
    assert [k for k, _a, _b in got] == kinds
    # deliberate trips stay out of the session ledger
    assert all(v.site_a not in ("pair.a", "ro.a", "hold.x")
               for v in lsan.violations())


def test_hold_statistics_count_and_time_the_holds():
    a, b = lsan.wrap(site="stat.a"), lsan.wrap(site="stat.b")
    with lsan.scope():
        pass  # a private ledger is untouched by the session's holds
    for _ in range(3):
        with a:
            with b:
                time.sleep(0.002)
    rows = lsan.holds()
    assert rows["stat.a"]["acquisitions"] == 3
    assert rows["stat.b"]["max_hold_s"] >= 0.002
    assert rows["stat.a"]["max_hold_at"].startswith(__name__)
    assert ("stat.a", "stat.b") in lsan.edges()


def test_overhead_smoke():
    """The reference's bound: 50k uncontended round trips through the
    proxy (the port's also counts each hold) in under 2 s."""
    lock = lsan.wrap(site="perf.x")
    n = 50_000
    t0 = time.monotonic()
    for _ in range(n):
        with lock:
            pass
    elapsed = time.monotonic() - t0
    assert elapsed < 2.0, f"{n} wrapped round-trips took {elapsed:.2f}s"


def _child(code: str, timeout: int = 240) -> dict:
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_install_wraps_the_port_locks_only():
    out = _child(
        "import json, threading\n"
        "from kafka_assignment_optimizer_tpu_torch.analysis import lsan\n"
        "lsan.install()\n"
        "raw = threading.Lock()  # __main__ is outside the package\n"
        "from kafka_assignment_optimizer_tpu_torch.fleet import health\n"
        "from kafka_assignment_optimizer_tpu_torch.solvers.tpu import "
        "anneal\n"
        "from kafka_assignment_optimizer_tpu.fleet import health as jh\n"
        "t = health.FleetTracker([], fetch=lambda u: {})\n"
        "j = jh.FleetTracker([], fetch=lambda u: {})\n"
        "t.poll_once(); t.snapshot()\n"
        "print(json.dumps({'raw': type(raw).__name__,\n"
        "  'port': type(t._lock).__name__, 'jax': type(j._lock).__name__,\n"
        "  'capture': type(anneal._CAPTURE_LOCK).__name__,\n"
        "  'site': anneal._CAPTURE_LOCK._site,\n"
        "  'violations': len(lsan.violations())}))\n")
    assert out["raw"] != "_LsanLock" and out["jax"] != "_LsanLock"
    assert out["port"] == out["capture"] == "_LsanLock"
    assert out["site"].startswith(
        "kafka_assignment_optimizer_tpu_torch.solvers.tpu.anneal:")
    assert out["violations"] == 0


# armed before any port module binds its locks; then two concurrent demo
# /submit requests, and a chain solve beside a sweep solve on the CPU
ARMED_CPU = r"""
import json, threading, urllib.request
from kafka_assignment_optimizer_tpu_torch.analysis import lsan
lsan.install()
import numpy as np
from kafka_assignment_optimizer_tpu_torch import serve
from kafka_assignment_optimizer_tpu_torch.models.cluster import (
    Assignment, PartitionAssignment, Topology, demo_assignment)
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance)
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine
from kafka_assignment_optimizer_tpu_torch.utils import gen

srv = serve.make_server(port=0, device="cpu")
threading.Thread(target=srv.serve_forever, daemon=True).start()
url = f"http://127.0.0.1:{srv.server_address[1]}/submit"
body = json.dumps({"assignment": demo_assignment().to_dict(),
                   "brokers": "0-18", "topology": "even-odd"}).encode()
codes, moves = [], []

def post():
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        codes.append(r.status)
        moves.append(json.loads(r.read())["report"]["replica_moves"])

ths = [threading.Thread(target=post) for _ in range(2)]
for t in ths: t.start()
for t in ths: t.join(timeout=180)
srv.shutdown(); srv.server_close()

rng = np.random.default_rng(0)
parts = [PartitionAssignment("t", p, [int(b) for b in rng.choice(
    12, size=2, replace=False)]) for p in range(40)]
chain = (Assignment(partitions=parts), list(range(10)),
         Topology(rack_of={b: f"r{b % 2}" for b in range(12)}))
s = gen.adversarial(n_brokers=24, n_racks=4, n_topics_low=3,
                    n_topics_high=3, parts_per_topic=10)
cases = {"chain": chain, "sweep": (s.current, s.broker_list, s.topology)}
kw = {"chain": dict(engine="chain", batch=8, rounds=2, steps_per_round=16),
      "sweep": dict(engine="sweep", batch=4, sweeps=16, portfolio=False)}

def solve(name):
    return engine.solve_tpu(build_instance(*cases[name]), seed=0,
                            device="cpu", **kw[name])

alone = {n: solve(n) for n in kw}
got, errs = {}, []

def run(name):
    try:
        got[name] = solve(name)
    except BaseException as e:
        errs.append(repr(e))

ths = [threading.Thread(target=run, args=(n,)) for n in kw]
for t in ths: t.start()
for t in ths: t.join(timeout=300)
print(json.dumps({
    "codes": codes, "moves": moves, "errors": errs,
    "engines": {n: got[n].stats["engine"] for n in got},
    "equal": {n: bool(np.array_equal(got[n].a, alone[n].a)) for n in got},
    "violations": [v.detail for v in lsan.violations()],
    "holds": lsan.holds(), "edges": len(lsan.edges())}))
"""


def test_armed_port_serves_and_solves_beside_itself_without_violation():
    out = _child(ARMED_CPU)
    assert out["codes"] == [200, 200] and out["moves"] == [1, 1]
    assert out["errors"] == []
    assert out["engines"] == {"chain": "chain", "sweep": "sweep"}
    assert out["equal"] == {"chain": True, "sweep": True}
    assert out["violations"] == []
    # the sanitizer saw the service's and the engine's locks at work
    assert sum(r["acquisitions"] for r in out["holds"].values()) > 0
    assert any(".serve:" in site for site in out["holds"])
