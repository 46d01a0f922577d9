"""PyTorch port: ``kao-check`` over the port (``analysis/``) against the
JAX package's.

- group (a), the language-general rules (KAO100, KAO106, KAO107, KAO109,
  KAO111, KAO112, KAO114, KAO116-KAO119): the reference's own positive
  and negative fixtures through both packages' ``lint_source`` give the
  same findings, rule, line and message;
- group (b), the JAX-idiom rules translated to PyTorch's (KAO101-KAO105,
  KAO108, KAO110, KAO113 with the C8 case, KAO115): a positive and a
  negative fixture each, and the CLI exits 1 on every positive one;
- suppressions, the baseline ratchet, SARIF and the CLI's flags, guards
  and exit codes equal to the reference's on the same inputs;
- ``kao-check --device cpu`` exits 0 on the port's tree with its
  baseline, and without a card the default ``--device cuda`` refuses;
- the runtime contracts pass on the real steppers on the CPU, and finds
  each seeded violation: a float64 op, an ``.item()`` in a step, two
  state tensors on one storage, a wrong output shape.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from kafka_assignment_optimizer_tpu.analysis import __main__ as jcli
from kafka_assignment_optimizer_tpu.analysis import baseline as jbaseline
from kafka_assignment_optimizer_tpu.analysis import findings as jfindings
from kafka_assignment_optimizer_tpu.analysis import sarif as jsarif
from kafka_assignment_optimizer_tpu.analysis.rules_ast import (
    lint_source as jlint_source,
)
from kafka_assignment_optimizer_tpu_torch.analysis import (
    RULES,
    baseline,
    contracts,
    findings,
    lint_source,
    sarif,
)
from kafka_assignment_optimizer_tpu_torch.analysis import __main__ as cli

REPO = Path(__file__).resolve().parent.parent


def _lint(fn, snippet: str, rel: str):
    return fn(textwrap.dedent(snippet), "fixture.py", rel=rel)


def _rules(found):
    return [f.rule for f in found]


def _triples(found):
    return [(f.rule, f.line, f.message) for f in found]


# ------------------------------------------------ group (a): parity
# the reference's fixtures (tests/test_analysis.py, tests/test_lockcheck.py)

POS_106 = """
    def handle(req):
        print("served", req)
"""

NEG_106_LOG = """
    from .obs import log as _olog

    def handle(req):
        _olog.info("served", req=req)
"""

POS_107 = """
    def render(n):
        lines = []
        lines.append(f"kao_new_counter_total {n}")
        return lines
"""

NEG_107 = """
    def render(n):
        lines = []
        lines.append("# HELP kao_new_counter_total new counter")
        lines.append("# TYPE kao_new_counter_total counter")
        lines.append(f"kao_new_counter_total {n}")
        return lines
"""

NEG_107_PROSE = """
    NAME = "kao_current_span"  # a contextvar name, not a metric sample
"""

POS_109 = """
    def weight_upper_bound(inst):
        total = 0
        for p in range(inst.num_parts):
            total += int(inst.rf[p])
        return total
"""

POS_109_SPLIT = """
    def certify(inst):
        P = inst.num_parts
        acc = []
        for p in range(P):
            acc.append(p)
        return acc
"""

NEG_109_VECTORIZED = """
    import numpy as np

    def weight_upper_bound(inst):
        return int(inst.rf[: inst.num_parts].sum())
"""

POS_111_REQUEST = """
    import http.client

    def proxy(url, body):
        conn = http.client.HTTPConnection(url)
        conn.request("POST", "/submit", body=body)
        return conn.getresponse().read()
"""

POS_111_URLOPEN = """
    import urllib.request

    def fanout(url):
        with urllib.request.urlopen(url + "/clusters") as r:
            return r.read()
"""

NEG_111_INJECTED = """
    import http.client
    from .obs import trace as _otrace

    def proxy(url, body):
        hdrs = {"traceparent": _otrace.inject()}
        conn = http.client.HTTPConnection(url)
        conn.request("POST", "/submit", body=body, headers=hdrs)
        return conn.getresponse().read()
"""

NEG_111_HEADER_PARAM = """
    import http.client

    def proxy_once(url, body, headers=None):
        # propagation is the CALLER's contract: headers thread through
        conn = http.client.HTTPConnection(url)
        conn.request("POST", "/submit", body=body,
                     headers=headers or {})
        return conn.getresponse().read()
"""

POS_112 = """
    import numpy as np

    def stitch(inst, plans):
        out = np.full((inst.num_parts, 3), -1)
        for p in range(inst.num_parts):
            out[p] = plans[p]
        return out
"""

NEG_112_GROUP_LOOP = """
    import numpy as np

    def split(inst, n_groups):
        subs = []
        for g in range(n_groups):  # groups, not partitions: fine
            subs.append(g)
        return subs
"""

POS_114 = """
    import time

    def run_chunk(dispatch, state, log):
        t0 = time.perf_counter()
        out = dispatch(state)
        dt = time.perf_counter() - t0
        log.info("chunk", seconds=dt)  # the ledger never sees this
        return out
"""

NEG_114_FUNNEL = """
    import time

    def run_chunk(dispatch, state, _flight):
        t0 = time.perf_counter()
        out = dispatch(state)
        dt = time.perf_counter() - t0
        _flight.note_window("dispatch", dt)
        return out
"""

NEG_114_RESULT_FIELD = """
    import time

    def run_chunk(dispatch, state, r):
        t0 = time.perf_counter()
        out = dispatch(state)
        r.device_s += time.perf_counter() - t0  # lands on the record
        return out, time.perf_counter() - t0  # returned: caller funnels
"""

NEG_114_CHAIN = """
    import time

    def run_chunk(dispatch, state, overlap_ok, sp):
        t0 = time.perf_counter()
        out = dispatch(state)
        dt = time.perf_counter() - t0
        overlap = dt if overlap_ok else 0.0  # taint follows the chain
        chunk_attrs(sp, overlap)
        return out
"""

NEG_114_HEADROOM = """
    import time

    def run_chunk(dispatch, state, deadline):
        if deadline - time.perf_counter() < 0.1:  # remaining budget,
            return None                           # not elapsed wall
        return dispatch(state)
"""

NEG_114_NO_DISPATCH_SITE = """
    import time

    def tick(log):
        t0 = time.perf_counter()
        work()
        dt = time.perf_counter() - t0
        log.info("tick", seconds=dt)
"""

SEEDED_UNGUARDED = """
    import threading

    class Counter:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0

        def bump(self):
            with self._lock:
                self.n += 1

        def race(self):
            self.n += 1  # the seeded race
"""

GUARDS_COMMENT = """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()  # kao: guards(n)
            self.n = 0

        def race(self):
            self.n = 5
"""

LOCKED_SUFFIX = """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0

        def bump(self):
            with self._lock:
                self._bump_locked()

        def _bump_locked(self):
            self.n += 1
"""

MAIN_EXEMPT = """
    import threading

    _LOCK = threading.Lock()
    CFG = {}

    def handler():
        with _LOCK:
            CFG["x"] = 1

    def main():
        CFG["boot"] = True
"""

BLOCKING_UNDER_LOCK = """
    import threading
    import urllib.request

    class C:
        def __init__(self):
            self._lock = threading.Lock()

        def fetch(self):
            with self._lock:
                urllib.request.urlopen("http://x")
"""

BLOCKING_OUTSIDE = """
    import threading
    import urllib.request

    class C:
        def __init__(self):
            self._lock = threading.Lock()

        def fetch(self):
            with self._lock:
                pass
            urllib.request.urlopen("http://x")
"""

CONDITION_WAIT = """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._cv = threading.Condition(self._lock)

        def drain(self):
            with self._cv:
                self._cv.wait(timeout=1.0)
"""

SEEDED_INVERSION = """
    import threading

    class Pair:
        def __init__(self):
            self.a = threading.Lock()
            self.b = threading.Lock()

        def fwd(self):
            with self.a:
                with self.b:
                    pass

        def rev(self):
            with self.b:
                with self.a:
                    pass
"""

ORPHAN_THREAD = """
    import threading

    def spawn():
        threading.Thread(target=print).start()
"""

DAEMON_THREAD = """
    import threading

    def spawn():
        threading.Thread(target=print, daemon=True).start()
"""

SUP_JUSTIFIED = 'def f(x):\n    print(x)  # kao: disable=KAO106 -- CLI UX\n'
SUP_NAKED = 'def f(x):\n    print(x)  # kao: disable=KAO106\n'
SUP_ABOVE = "def f(x):\n    # kao: disable=KAO106 -- UX\n    print(x)\n"
SUP_LEAK = ("def f(x):\n    print(x)  # kao: disable=KAO106 -- UX\n"
            "    print(x)\n")
SUP_FILE = ("# kao: disable-file=KAO106 -- generated\n"
            "def f(x):\n    print(x)\n")

ENGINE = "solvers/tpu/engine.py"
# (name, snippet, rel, the rules it must produce — the parity is not
# vacuous: each positive case holds its rule in both packages)
PARITY = [
    ("106_pos", POS_106, "solvers/tpu/fixture.py", {"KAO106"}),
    ("106_neg_log", NEG_106_LOG, "solvers/tpu/fixture.py", set()),
    ("106_log_module", "def emit(line):\n    print(line)\n", "obs/log.py",
     set()),
    ("107_pos", POS_107, "solvers/tpu/fixture.py", {"KAO107"}),
    ("107_neg", NEG_107, "solvers/tpu/fixture.py", set()),
    ("107_prose", NEG_107_PROSE, "solvers/tpu/fixture.py", set()),
    ("109_bounds", POS_109, "models/bounds.py", {"KAO109"}),
    ("109_reseat", POS_109, "models/reseat.py", {"KAO109"}),
    ("109_split", POS_109_SPLIT, "models/bounds.py", {"KAO109"}),
    ("109_vectorized", NEG_109_VECTORIZED, "models/bounds.py", set()),
    ("109_out_of_scope", POS_109, ENGINE, set()),
    ("109_suppressed", POS_109.replace(
        "for p in range(inst.num_parts):",
        "for p in range(inst.num_parts):  "
        "# kao: disable=KAO109 -- cold fallback, never on the hot path"),
     "models/bounds.py", set()),
    ("111_request", POS_111_REQUEST, "fleet/router.py", {"KAO111"}),
    ("111_urlopen", POS_111_URLOPEN, "serve.py", {"KAO111"}),
    ("111_injected", NEG_111_INJECTED, "fleet/router.py", set()),
    ("111_header_param", NEG_111_HEADER_PARAM, "fleet/router.py", set()),
    ("111_out_of_scope", POS_111_REQUEST, ENGINE, set()),
    ("112_split", POS_112, "decompose/split.py", {"KAO112"}),
    ("112_stitch", POS_112, "decompose/stitch.py", {"KAO112"}),
    ("112_name_bound", POS_109_SPLIT, "decompose/split.py", {"KAO112"}),
    ("112_group_loop", NEG_112_GROUP_LOOP, "decompose/split.py", set()),
    ("112_out_of_scope", POS_112, "decompose/__init__.py", set()),
    ("114_engine", POS_114, ENGINE, {"KAO114"}),
    ("114_mesh", POS_114, "parallel/mesh.py", {"KAO114"}),
    ("114_out_of_scope", POS_114, "obs/flight.py", set()),
    ("114_funnel", NEG_114_FUNNEL, ENGINE, set()),
    ("114_result_field", NEG_114_RESULT_FIELD, ENGINE, set()),
    ("114_chain", NEG_114_CHAIN, ENGINE, set()),
    ("114_headroom", NEG_114_HEADROOM, ENGINE, set()),
    ("114_no_dispatch_site", NEG_114_NO_DISPATCH_SITE, ENGINE, set()),
    ("116_unguarded", SEEDED_UNGUARDED, "obs/fixture.py", {"KAO116"}),
    ("116_guards_comment", GUARDS_COMMENT, "obs/fixture.py", {"KAO116"}),
    ("116_locked_suffix", LOCKED_SUFFIX, "obs/fixture.py", set()),
    ("116_main_exempt", MAIN_EXEMPT, "obs/fixture.py", set()),
    ("117_blocking", BLOCKING_UNDER_LOCK, "obs/fixture.py", {"KAO117"}),
    ("117_outside", BLOCKING_OUTSIDE, "obs/fixture.py", set()),
    ("117_condition_wait", CONDITION_WAIT, "obs/fixture.py", set()),
    ("118_inversion", SEEDED_INVERSION, "obs/fixture.py", {"KAO118"}),
    ("119_orphan", ORPHAN_THREAD, "serve.py", {"KAO119"}),
    ("119_daemon", DAEMON_THREAD, "serve.py", set()),
    ("119_out_of_scope", ORPHAN_THREAD, "solvers/tpu/sweep.py", set()),
    ("100_justified", SUP_JUSTIFIED, "solvers/tpu/fixture.py", set()),
    ("100_naked", SUP_NAKED, "solvers/tpu/fixture.py",
     {"KAO100", "KAO106"}),
    ("100_above", SUP_ABOVE, "solvers/tpu/fixture.py", set()),
    ("100_trailing_leak", SUP_LEAK, "solvers/tpu/fixture.py", {"KAO106"}),
    ("100_file_level", SUP_FILE, "solvers/tpu/fixture.py", set()),
    ("100_unparsable", "def f(:\n", "solvers/tpu/fixture.py", {"KAO100"}),
]


@pytest.mark.parametrize("snippet,rel,want",
                         [c[1:] for c in PARITY], ids=[c[0] for c in PARITY])
def test_group_a_findings_equal_the_reference(snippet, rel, want):
    ref = _lint(jlint_source, snippet, rel)
    got = _lint(lint_source, snippet, rel)
    assert _triples(got) == _triples(ref)
    assert set(_rules(got)) == want


# ------------------------------------- group (b): the rules in torch idiom

POS_101 = """
    from .sweep import make_sweep_stepper_fn

    def run(m, state, temps):
        step = make_sweep_stepper_fn(8)
        out = step(m, state, temps)
        return out, state[0]  # consumed: its successor is out[0]
"""

POS_101_CHAINED = """
    from .sweep import make_lane_stepper_fn

    def run(m, state, temps):
        out = make_lane_stepper_fn(8)(m, state, temps)
        return out, state
"""

NEG_101 = """
    from .sweep import make_sweep_stepper_fn

    def run(m, state, temps):
        step = make_sweep_stepper_fn(8)
        state, best_a, best_k, curve = step(m, state, temps)
        return state[0]  # the RETURNED state
"""

POS_102 = """
    import torch

    def init(seed, n):
        tile = seed.expand(n, 4, 4)
        return (tile, torch.zeros(n), tile)  # two tensors, one storage
"""

POS_102_INPLACE = """
    def bump(best, n):
        rows = best.expand(n, 4)
        rows.add_(1)  # lands on every row's one element
        return rows
"""

POS_102_SETITEM = """
    import torch

    def pin(x, n):
        v = torch.broadcast_to(x, (n, 4))
        v[0] = 1
"""

NEG_102 = """
    import torch

    def init(seed, n):
        tile = seed.expand(n, 4, 4)
        return (tile.clone(), torch.zeros(n), tile.clone())
"""

NEG_102_FUNCTIONAL = """
    def score(a, n):
        x = a.expand(n, 4)
        return (x > 0) & (x + x < 9)  # read-only: no state tensor
"""

POS_103 = """
    import torch

    def ladder(n):
        return torch.zeros(n, dtype=torch.float64)
"""

POS_103_DOUBLE = """
    def ladder(t):
        return t.double() * 0.5
"""

POS_103_NUMPY = """
    import numpy as np
    import torch

    def ladder(dev):
        return torch.as_tensor(np.array([2.0, 1.0, 0.5]), device=dev)
"""

NEG_103 = """
    import numpy as np
    import torch

    def ladder(dev):
        t = torch.as_tensor(np.array([2.0, 1.0], dtype=np.float32))
        return t.to(dev, torch.float32), torch.tensor([0.5], device=dev)
"""

POS_104 = """
    from .. import prng

    def draw(n):
        key = prng.PRNGKey(0)
        a = prng.bits(key, (n,))
        b = prng.randint(key, (n,), 0, 4)  # the same stream
        return a, b
"""

NEG_104 = """
    from .. import prng

    def draw(n):
        key = prng.PRNGKey(0)
        ka, kb = prng.split(key)
        return prng.bits(ka, (n,)), prng.randint(kb, (n,), 0, 4)
"""

POS_105 = """
    import torch

    def make_sweep_solver_fn(n):
        def solve(m, a, temps):
            if torch.any(a > 0):  # the host waits for the device
                a = a - 1
            return a
        return solve
"""

POS_105_BOOL = """
    def make_round_runner(steps):
        def run_round(m, st, best_k, k):
            done = bool((best_k >= k).any())
            return st, done
        return run_round
"""

NEG_105 = """
    import torch

    def make_sweep_solver_fn(n):
        def solve(m, a, temps, axis_name=None):
            if axis_name is None and a.shape[0] > 2:  # host metadata
                a = torch.where(a > 0, a - 1, a)  # on the device
            return a
        return solve

    def host_report(a):
        if torch.any(a > 0):  # after the step, on the host: fine
            return 1
"""

POS_108 = """
    from ..resilience import chaos

    def make_sweep_stepper_fn(n):
        def solve(m, state, temps):
            chaos.raise_if("nan_chunk")
            return state
        return solve
"""

POS_108_CAPTURE = """
    import torch
    from ..resilience import chaos

    def _body(st):
        chaos.raise_if("kernel_fault")  # fires at capture, never on replay
        return st + 1

    def capture(st):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = _body(st)
        return g, out
"""

NEG_108 = """
    from ..resilience import chaos

    def dispatch(step, st):
        chaos.raise_if("nan_chunk")  # host side, at the dispatch site
        return step(st)
"""

POS_110 = """
    def make_lane_stepper_fn(n_chains, lam):
        def step(m, a, temp):
            return a * lam  # config captured: the step serves one config
        return step
"""

NEG_110 = """
    def make_lane_stepper_fn(n_chains):
        def step(m, a, temp):
            return a * m.lam + temp * m.temp_scale  # config as data
        return step
"""

POS_113 = """
    def _sweeps(state, temps):
        return state[1].max().item()  # a host read in the chunk step

    def make_sweep_stepper_fn(n):
        def solve(m, state, temps):
            return _sweeps(state, temps)
        return solve
"""

POS_113_CAPTURE = """
    import torch

    def capture(st):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            host = st.sum().cpu()  # an error under capture
        return g, host
"""

NEG_113 = """
    def make_sweep_stepper_fn(n):
        def solve(m, state, temps):
            return state
        return solve

    def report(state):
        return state[1].max().item()  # after the chunk, on the host
"""

POS_113_C8 = """
    import torch

    def phase_time(dev):
        torch.cuda.synchronize()  # every stream of the card
        return 1
"""

NEG_113_C8_LOCKED = """
    import torch
    from . import anneal

    def capture(dev):
        with anneal._CAPTURE_LOCK:
            torch.cuda.synchronize()  # no capture can be in progress
"""

NEG_113_C8_STREAM = """
    import torch

    def phase_time(dev):
        torch.cuda.current_stream(dev).synchronize()  # this thread's
        return 1
"""

POS_115_MODULE = """
    import torch

    N_CARDS = torch.cuda.device_count()  # frozen at import
"""

POS_115_DEFAULT = """
    import torch

    def make_mesh(dev=torch.device("cuda", 0)):
        return dev
"""

POS_115_CLOSURE = """
    import torch

    def make_dispatch():
        n = torch.cuda.device_count()

        def dispatch(state):
            return shard(state, n)  # the closure pins the snapshot

        return dispatch
"""

POS_115_NO_DEVICE = """
    import torch

    def fill(n):
        return torch.zeros(n, dtype=torch.int32)  # the default device
"""

NEG_115 = """
    import torch

    def make_mesh(n=None, dev=None):
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        return cards[:n], torch.zeros(2, dtype=torch.int32, device=dev)
"""

SOLVERS = "solvers/tpu/fixture.py"
MESH = "parallel/mesh.py"
# (rule, name, snippet, rel, flagged)
GROUP_B = [
    ("KAO101", "pos", POS_101, SOLVERS, True),
    ("KAO101", "pos_chained", POS_101_CHAINED, SOLVERS, True),
    ("KAO101", "neg", NEG_101, SOLVERS, False),
    ("KAO102", "pos", POS_102, SOLVERS, True),
    ("KAO102", "pos_inplace", POS_102_INPLACE, SOLVERS, True),
    ("KAO102", "pos_setitem", POS_102_SETITEM, SOLVERS, True),
    ("KAO102", "neg", NEG_102, SOLVERS, False),
    ("KAO102", "neg_functional", NEG_102_FUNCTIONAL, SOLVERS, False),
    ("KAO102", "neg_host_module", POS_102, "models/bounds.py", False),
    ("KAO103", "pos", POS_103, SOLVERS, True),
    ("KAO103", "pos_double", POS_103_DOUBLE, SOLVERS, True),
    ("KAO103", "pos_numpy", POS_103_NUMPY, SOLVERS, True),
    ("KAO103", "neg", NEG_103, SOLVERS, False),
    ("KAO103", "neg_host_module", POS_103, "models/bounds.py", False),
    ("KAO104", "pos", POS_104, SOLVERS, True),
    ("KAO104", "neg", NEG_104, SOLVERS, False),
    ("KAO105", "pos", POS_105, SOLVERS, True),
    ("KAO105", "pos_bool", POS_105_BOOL, SOLVERS, True),
    ("KAO105", "neg", NEG_105, SOLVERS, False),
    ("KAO108", "pos", POS_108, SOLVERS, True),
    ("KAO108", "pos_capture", POS_108_CAPTURE, SOLVERS, True),
    ("KAO108", "neg", NEG_108, SOLVERS, False),
    ("KAO110", "pos", POS_110, SOLVERS, True),
    ("KAO110", "neg", NEG_110, SOLVERS, False),
    ("KAO113", "pos", POS_113, SOLVERS, True),
    ("KAO113", "pos_capture", POS_113_CAPTURE, "obs/prof.py", True),
    ("KAO113", "neg", NEG_113, SOLVERS, False),
    ("KAO113", "pos_c8", POS_113_C8, "solvers/tpu/engine.py", True),
    ("KAO113", "pos_c8_serve", POS_113_C8, "serve.py", True),
    ("KAO113", "neg_c8_locked", NEG_113_C8_LOCKED, "solvers/tpu/anneal.py",
     False),
    ("KAO113", "neg_c8_stream", NEG_113_C8_STREAM, "solvers/tpu/engine.py",
     False),
    ("KAO113", "neg_c8_out_of_scope", POS_113_C8, "obs/prof.py", False),
    ("KAO115", "pos_module", POS_115_MODULE, MESH, True),
    ("KAO115", "pos_default", POS_115_DEFAULT, MESH, True),
    ("KAO115", "pos_closure", POS_115_CLOSURE, MESH, True),
    ("KAO115", "pos_no_device", POS_115_NO_DEVICE, MESH, True),
    ("KAO115", "neg", NEG_115, MESH, False),
    ("KAO115", "neg_out_of_scope", POS_115_NO_DEVICE, SOLVERS, False),
]


@pytest.mark.parametrize("rule,snippet,rel,flagged",
                         [(c[0], *c[2:]) for c in GROUP_B],
                         ids=[f"{c[0]}_{c[1]}" for c in GROUP_B])
def test_group_b_rule(rule, snippet, rel, flagged):
    got = _rules(_lint(lint_source, snippet, rel))
    if flagged:
        # the positive fixture trips exactly its own rule, and a
        # justified suppression on each flagged line silences it
        assert set(got) == {rule}, got
        found = _lint(lint_source, snippet, rel)
        lines = textwrap.dedent(snippet).split("\n")
        for ln in {f.line for f in found}:
            lines[ln - 1] += f"  # kao: disable={rule} -- fixture"
        assert _rules(lint_source("\n".join(lines), "fixture.py",
                                  rel=rel)) == []
    else:
        assert got == [], got


POSITIVES = [(c[0], c[2], c[3]) for c in GROUP_B if c[4] and c[1] == "pos"]


@pytest.mark.parametrize("rule,snippet,rel", POSITIVES,
                         ids=[p[0] for p in POSITIVES])
def test_cli_exits_one_on_each_group_b_rule(rule, snippet, rel, tmp_path,
                                            capsys):
    bad = tmp_path / rel
    bad.parent.mkdir(parents=True)
    bad.write_text(textwrap.dedent(snippet))
    assert cli.main([str(bad)]) == 1
    assert f" {rule} " in capsys.readouterr().out


def test_c8_finds_the_device_wide_syncs_the_port_had():
    """The two device-wide syncs ``ops/bench_kernel.py`` timed with are
    the C8 shape; the stream-level waits that replaced them are not."""
    old = """
        import torch

        def timed_ms(fn):
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            torch.cuda.synchronize()
            return t0.elapsed_time(t1)
    """
    found = _lint(lint_source, old, "ops/bench_kernel.py")
    assert [(f.rule, f.line) for f in found] == [("KAO113", 5),
                                                 ("KAO113", 11)]
    text = (REPO / "kafka_assignment_optimizer_tpu_torch/ops/"
            "bench_kernel.py").read_text()
    assert lint_source(text, "bench_kernel.py",
                       rel="ops/bench_kernel.py") == []


# ------------------------------------------- shared plumbing, reference's

SUPPRESSION_TEXTS = [SUP_JUSTIFIED, SUP_NAKED, SUP_ABOVE, SUP_LEAK, SUP_FILE,
                     "x = 1  # kao: disable=KAO106,KAO117 -- two rules\n"]


@pytest.mark.parametrize("text", SUPPRESSION_TEXTS)
def test_suppressions_parse_as_the_reference(text):
    ref, got = jfindings.parse_suppressions(text), \
        findings.parse_suppressions(text)
    assert (got.by_line, got.whole_file, got.unjustified) == (
        ref.by_line, ref.whole_file, ref.unjustified)


def _pair(rule, path, line, msg):
    return (jfindings.Finding(rule, path, line, msg),
            findings.Finding(rule, path, line, msg))


def test_baseline_compare_and_sarif_equal_the_reference(tmp_path):
    cur = [_pair("KAO116", "a.py", 10, "m1"),
           _pair("KAO117", "a.py", 20, "m2"),
           _pair("KAO116", "a.py", 30, "m1")]
    entries = [
        {"rule": "KAO116", "path": "a.py", "line": 99, "message": "m1"},
        {"rule": "KAO118", "path": "b.py", "line": 5, "message": "gone"},
    ]
    ref = jbaseline.compare([j for j, _ in cur], entries)
    got = baseline.compare([t for _, t in cur], entries)
    for part in ("known", "new"):
        assert [f.__dict__ for f in getattr(got, part)] == [
            f.__dict__ for f in getattr(ref, part)]
    assert got.stale == ref.stale and got.clean == ref.clean
    # the file round trip writes the reference's bytes
    baseline.save(str(tmp_path / "t.json"), [t for _, t in cur])
    jbaseline.save(str(tmp_path / "j.json"), [j for j, _ in cur])
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert baseline.load(str(tmp_path / "t.json")) == \
        jbaseline.load(str(tmp_path / "j.json"))
    # SARIF: the same document but for the titles of translated rules
    sj = jsarif.render([j for j, _ in cur], {0})
    st = sarif.render([t for _, t in cur], {0})
    assert st["runs"][0]["results"] == sj["runs"][0]["results"]
    rj = {r["id"]: r for r in sj["runs"][0]["tool"]["driver"]["rules"]}
    rt = {r["id"]: r for r in st["runs"][0]["tool"]["driver"]["rules"]}
    assert rt.keys() == rj.keys()
    assert {k: rt[k] for k in GROUP_A} == {k: rj[k] for k in GROUP_A}
    assert {**st, "runs": None} == {**sj, "runs": None}


GROUP_A = ("KAO100", "KAO106", "KAO107", "KAO109", "KAO111", "KAO112",
           "KAO114", "KAO116", "KAO117", "KAO118", "KAO119")


def _exit(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


GUARDS = [["--contracts-only", "--no-contracts"], ["--rule", "KAO999"],
          ["--contracts-only", "some/path"], ["--update-baseline"],
          ["--format", "xml"]]


@pytest.mark.parametrize("argv", GUARDS, ids=[" ".join(a) for a in GUARDS])
def test_cli_guards_exit_two_as_the_reference(argv, capsys):
    rc_j, _, err_j = _exit(jcli.main, argv, capsys)
    rc_t, _, err_t = _exit(cli.main, argv, capsys)
    assert rc_t == rc_j == 2
    assert err_t.splitlines()[-1] == err_j.splitlines()[-1]


def test_list_rules_ids_equal_the_reference(capsys):
    rc_j, out_j, _ = _exit(jcli.main, ["--list-rules"], capsys)
    rc_t, out_t, _ = _exit(cli.main, ["--list-rules"], capsys)
    ids = [line.split()[0] for line in out_t.splitlines()]
    assert rc_t == rc_j == 0
    assert ids == [line.split()[0] for line in out_j.splitlines()]
    assert ids == sorted(RULES)
    # the language-general rules keep their titles
    assert {k: RULES[k] for k in GROUP_A} == {
        k: jfindings.RULES[k] for k in GROUP_A}


@pytest.mark.parametrize("fmt", ["text", "json", "sarif"])
def test_formats_and_ratchet_equal_the_reference(fmt, tmp_path, capsys):
    """The same seeded file through both CLIs: the exit codes of the
    ratchet's round trip (fail, accept, tolerate, stale, shrink) and the
    output of each format equal the reference's."""
    bad = tmp_path / "seeded.py"
    outs = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        bad.write_text(textwrap.dedent(SEEDED_UNGUARDED))
        base = tmp_path / f"{name}.json"
        flow = [_exit(main, [str(bad), "--format", fmt], capsys)]
        flow.append(_exit(main, [str(bad), "--baseline", str(base),
                                 "--update-baseline"], capsys))
        flow.append(_exit(main, [str(bad), "--baseline", str(base),
                                 "--format", fmt], capsys))
        bad.write_text(textwrap.dedent(SEEDED_UNGUARDED).replace(
            "self.n += 1  # the seeded race",
            "with self._lock:\n            self.n += 1"))
        flow.append(_exit(main, [str(bad), "--baseline", str(base)],
                          capsys))
        flow.append(_exit(main, [str(bad), "--baseline", str(base),
                                 "--update-baseline"], capsys))
        outs[name] = [(rc, out.replace(str(base), "BASE"))
                      for rc, out, _err in flow]
    # the one deliberate difference: a lock outside the package renders
    # with its own path, where the reference's climbs out of its root
    jrel = os.path.relpath(bad, os.path.dirname(os.path.dirname(
        jcli.__file__))).replace(os.sep, "/")
    outs["jax"] = [(rc, o.replace(jrel + "::", f"{bad}::"))
                   for rc, o in outs["jax"]]
    assert [rc for rc, _ in outs["port"]] == [1, 0, 0, 1, 0]
    if fmt == "sarif":
        for (_, t), (_, j) in zip(outs["port"][:3:2], outs["jax"][:3:2]):
            assert json.loads(t)["runs"][0]["results"] == \
                json.loads(j)["runs"][0]["results"]
        outs = {k: [(rc, "") if i in (0, 2) else (rc, o)
                    for i, (rc, o) in enumerate(v)]
                for k, v in outs.items()}
    assert outs["port"] == outs["jax"]


def test_kao_check_on_the_port_tree_exits_zero():
    """The gate: the port's tree is clean under its own analyzer, lint
    and runtime contracts on the CPU, against its committed baseline,
    which holds no finding; a fixture violation exits 1."""
    base = REPO / "analysis_baseline_torch.json"
    assert json.loads(base.read_text())["findings"] == []
    r = subprocess.run(
        [sys.executable, "-m", "kafka_assignment_optimizer_tpu_torch.analysis",
         "--device", "cpu", "--baseline", str(base)],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s)" in r.stdout and "0 stale" in r.stdout


def test_kao_check_subprocess_exits_one_on_a_violation(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(x):\n    print(x)\n")
    r = subprocess.run(
        [sys.executable, "-m", "kafka_assignment_optimizer_tpu_torch.analysis",
         "--device", "cpu", str(bad)],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "KAO106" in r.stdout


def test_default_device_refuses_without_a_card(capsys, monkeypatch):
    """``--device`` defaults to the card: with none, the contracts refuse
    (exit 2, no findings printed) instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _exit(cli.main, ["--contracts-only"], capsys)
    assert rc == 2 and "no CUDA device" in err and out == ""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        contracts.run_contracts()


def test_paths_are_relative_to_the_port_root(tmp_path):
    from kafka_assignment_optimizer_tpu_torch.analysis import (
        _rel,
        package_root,
    )

    root = package_root()
    assert Path(root).name == "kafka_assignment_optimizer_tpu_torch"
    assert _rel(str(Path(root) / "ops" / "kernels.py"), root) == \
        "ops/kernels.py"
    outside = str(tmp_path / "x.py")
    assert _rel(outside, root) == outside


# -------------------------------------------------------- runtime contracts

@pytest.fixture(scope="module")
def report():
    return contracts.run_contracts(device="cpu")


def test_contracts_pass_on_the_real_steppers(report):
    assert report.ok, [f.render() for f in report.findings]
    assert report.checks_run >= 16 and report.ops > 1000
    assert set(report.launches) == {"sweep stepper", "lane stepper",
                                    "group stepper", "lane group stepper",
                                    "chain round"}
    # the CPU runs the plain versions: no kernel launches
    assert all(n == 0 for v in report.launches.values() for n in v.values())


@pytest.fixture(scope="module")
def demo_step():
    """The sweep stepper's inputs at the demo bucket on the CPU, one
    sweep: ``(stepper, m, state, temps, want)``."""
    from kafka_assignment_optimizer_tpu_torch import prng
    from kafka_assignment_optimizer_tpu_torch.parallel import mesh as pm
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import (
        arrays,
        bucket,
        sweep,
    )
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu.seed import (
        greedy_seed,
    )

    inst = contracts._demo_instance()
    P, R = bucket.bucket_shape(inst)
    m = arrays.from_instance(inst, "cpu", num_parts=P, max_rf=R)
    seed = torch.from_numpy(arrays.pad_candidate(greedy_seed(inst), m))
    state = pm.init_sweep_state(m, seed, prng.PRNGKey(0), 2)
    temps = np.asarray([1.0], np.float32)
    want = {"best_a": (P, R), "best_k": (), "curve": (1,)}
    return sweep.make_sweep_stepper_fn(2), m, state, temps, want


def _seeded(demo_step, stepper=None, state=None):
    step, m, st, temps, want = demo_step
    found: list = []
    contracts.check_stepper("seeded", stepper or step, m, state or st,
                            temps, want, found)
    return found


def test_contracts_clean_on_the_unseeded_stepper(demo_step):
    assert _seeded(demo_step) == []


def test_contracts_find_a_float64_op(demo_step):
    step = demo_step[0]

    def seeded(m, state, temps):
        torch.full((2,), 0.5, dtype=torch.float64)
        return step(m, state, temps)

    found = _seeded(demo_step, seeded)
    assert _rules(found) == ["KAO201"] and "float64" in found[0].message


def test_contracts_find_an_item_in_a_step(demo_step):
    step = demo_step[0]

    def seeded(m, state, temps):
        if state[1].max().item() < 0:  # a host sync mid-step
            pass
        return step(m, state, temps)

    found = _seeded(demo_step, seeded)
    assert _rules(found) == ["KAO201"]
    assert "aten._local_scalar_dense" in found[0].message


def test_contracts_find_two_state_tensors_on_one_storage(demo_step):
    pop, k, mv, _best, key = demo_step[2]
    aliased = (pop, k, mv, pop, key)  # the snapshot IS the population
    found = _seeded(demo_step, state=aliased)
    assert set(_rules(found)) == {"KAO202"}
    assert any("tensors 0 and 3 overlap" in f.message for f in found)
    # a broadcast view (zero stride) is the same class of bug
    view = (pop[:1].expand_as(pop), k, mv, pop.clone(), key)
    assert any("zero stride" in f.message
               for f in _seeded(demo_step, state=view))


def test_contracts_find_a_wrong_output_shape(demo_step):
    step = demo_step[0]

    def seeded(m, state, temps):
        st, best_a, best_k, curve = step(m, state, temps)
        return st, best_a[None], best_k, curve

    found = _seeded(demo_step, seeded)
    assert _rules(found) == ["KAO202"] and "best_a shape" in found[0].message


def test_model_scalars_are_carried_not_read_from_the_device():
    """The KAO201 census's one host read of the chunk step on the card
    was ``lane_scalars()`` of a model the step derived (the one-lane
    stack): every constructor now carries the host scalars over, equal to
    what reading the tensors gives."""
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import arrays

    inst = contracts._demo_instance()
    m = arrays.from_instance(inst, "cpu", num_parts=32, max_rf=2)
    ms = [arrays.with_config(m, c) for c in arrays.portfolio_configs(4)]
    st = arrays.stack_models(ms)
    derived = [m, *ms, st, arrays.lane_model(st, 2),
               arrays.lane_range(st, 1, 3), arrays.shard_models(st, 2),
               arrays.stack_models([m])]
    for d in derived:
        carried = d.__dict__.pop("_host_scalars")
        assert d.lane_scalars() == carried


def test_contracts_find_an_arity_regression(demo_step):
    step = demo_step[0]
    found = _seeded(demo_step, lambda m, s, t: step(m, s, t)[:3])
    assert _rules(found) == ["KAO202"]
    assert "expected (state, best_a, best_k, curve)" in found[0].message
