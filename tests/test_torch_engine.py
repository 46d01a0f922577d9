"""PyTorch port: the engine end to end on the CPU — ``optimize`` on the
golden demo and on seeded random clusters, the CLI, the engine's schedule
and defaults against the reference's, the reference's decisions (the
constructor race, certify-first selection, the deadline, the chain
engine) case for case with plan and stats equal, the keywords the port
refuses, the device rules (the card unless the caller asks for the CPU;
never a silent fallback), and the import boundary: the port and
``chip_smoke.py`` never import JAX or the JAX package."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kafka_assignment_optimizer_tpu import build_instance as jax_build
from kafka_assignment_optimizer_tpu import optimize as jax_optimize
from kafka_assignment_optimizer_tpu.solvers.tpu import engine as jengine
from kafka_assignment_optimizer_tpu.utils import gen as jgen
from kafka_assignment_optimizer_tpu_torch import optimize, prng
from kafka_assignment_optimizer_tpu_torch.cli import main as cli_main
from kafka_assignment_optimizer_tpu_torch.models.cluster import (
    Assignment,
    Topology,
    demo_assignment,
)
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.parallel.mesh import (
    init_sweep_state,
)
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import arrays, engine
from kafka_assignment_optimizer_tpu_torch.solvers.tpu.seed import greedy_seed
from kafka_assignment_optimizer_tpu_torch.utils import gen

from tests.test_tpu_engine import random_cluster

REPO = Path(__file__).resolve().parent.parent


def port_cluster(current, brokers, topo):
    """A reference-package cluster as the port's own model objects."""
    return (Assignment.from_json(current.to_json()), brokers,
            Topology(rack_of=dict(topo.rack_of)))


# the reference's mesh of one device, the sequential ladder; the port
# accepts these values (they name what it does)
REF_KW = dict(n_devices=1, portfolio=False, pipeline=False, megachunk=1)
FIELDS = ("engine", "construct_path", "rounds_run", "proved_optimal",
          "final_cert", "moves", "feasible", "timed_out", "early_stopped",
          "degradations", "warm_started")


def solve_both(case, prewarm_bounds=False, **kw):
    """The same instance through both packages' ``solve_tpu`` (the port
    on the CPU), with the same keywords. ``prewarm_bounds`` memoizes the
    exact move bound and the tier-0 weight bound on both instances first,
    so a bounds check never depends on when the prefetch thread ends."""
    current, brokers, topo = case
    inst_j = jax_build(current, brokers, topo)
    inst_t = build_instance(*port_cluster(current, brokers, topo))
    if prewarm_bounds:
        for inst in (inst_j, inst_t):
            inst.move_lower_bound_exact()
            inst.weight_upper_bound()
    rj = jengine.solve_tpu(inst_j, **REF_KW, **kw)
    rt = engine.solve_tpu(inst_t, device="cpu", **REF_KW, **kw)
    return rj, rt


def assert_same(rj, rt):
    np.testing.assert_array_equal(rt.a, rj.a)
    assert rt.objective == rj.objective
    assert rt.optimal == rj.optimal
    for f in FIELDS:
        assert rt.stats.get(f) == rj.stats.get(f), (
            f, rt.stats.get(f), rj.stats.get(f))


def small_adversarial():
    """A 60-partition slice of the adversarial family: slack caps and no
    symmetry, so with knobs set no constructor worker races."""
    return jgen.adversarial(n_brokers=24, n_racks=4, n_topics_low=3,
                            n_topics_high=3, parts_per_topic=10)


def test_demo_golden(demo):
    current, brokers, topo = port_cluster(*demo)
    res = optimize(current, brokers, topo, solver="tpu", device="cpu")
    rep = res.report()
    assert rep["feasible"], rep
    # the exact-MILP race certifies the demo on the host: no device
    assert rep["solver_engine"] == "construct"
    assert rep["solver_construct_path"] == "milp"
    assert rep["solver_platform"] == "host"
    assert rep["solver_rounds_run"] == 0
    assert rep["proven_optimal"] is True
    assert res.replica_moves == 1
    assert res.solve.objective == res.instance.max_weight()


def test_demo_matches_reference(demo):
    rj, rt = solve_both(demo)
    assert_same(rj, rt)
    assert rt.stats["engine"] == "construct"
    assert rt.stats["construct_path"] == "milp"
    assert rt.optimal and rt.stats["moves"] == 1 and rt.objective == 49


def test_lp_constructor_matches_reference(rng):
    """The LP constructor certifies at once where the caps bind."""
    rj, rt = solve_both(random_cluster(rng, n_brokers=14, n_parts=60, rf=3,
                                       n_racks=3, drop=1))
    assert_same(rj, rt)
    assert rt.stats["engine"] == "construct"
    assert rt.stats["construct_path"] == "lp"
    assert rt.stats["rounds_run"] == 0 and rt.optimal
    assert rt.stats["moves"] == 50 and rt.objective == 290


def test_adversarial_reseat_race_matches_reference():
    """Greedy + exact reseat certifies the 10,000-partition adversarial
    scenario on the host: no ladder, no device."""
    s = jgen.adversarial()
    rj, rt = solve_both((s.current, s.broker_list, s.topology))
    assert_same(rj, rt)
    assert rt.stats["engine"] == "construct"
    assert rt.stats["construct_path"] == "reseat"
    assert rt.stats["platform"] == "host" and rt.optimal
    assert rt.stats["moves"] == 117 and rt.objective == 59_802


def test_chain_engine_matches_reference(rng):
    """Below 512 partitions off the card the chain engine runs (32 chains
    x 24 rounds x 256 steps); an uncertified MILP plan seeds it, final
    selection polishes and reseats."""
    rj, rt = solve_both(random_cluster(rng, n_brokers=12, n_parts=40, rf=2,
                                       n_racks=2, drop=2))
    assert_same(rj, rt)
    assert rt.stats["engine"] == "chain" and rt.stats["rounds_run"] == 24
    assert rt.stats["final_cert"] == "weight_below_ub"
    assert rt.stats["moves"] == 19 and rt.objective == 153


def test_deadline_matches_reference(demo):
    """A deadline cuts the sweep ladder into 8-sweep chunks and stops it
    at the first chunk boundary past the deadline; final selection then
    has no budget left. The boundary certificate is turned off on both
    (``cert_min_savings_s``): whether the reference tries it depends on
    how long its first chunk took to compile."""
    rj, rt = solve_both(demo, prewarm_bounds=True, engine="sweep",
                        time_limit_s=0.001, cert_min_savings_s=1e9)
    assert_same(rj, rt)
    assert rt.stats["rounds_run"] == 8 and rt.stats["timed_out"]
    assert rt.stats["final_cert"] == "budget_spent"
    assert rt.optimal and rt.stats["moves"] == 1


def test_pinned_annealer_matches_reference(monkeypatch):
    """With the reseat racer off, slack caps and knobs set, no worker
    races: the sweep ladder runs and certify-first selection decides
    (here: moves above the exact bound, so polish and reseat), equal to
    the reference. The boundary certificate is off on both."""
    monkeypatch.setattr(jengine, "_RESEAT_RACE", False)
    monkeypatch.setattr(engine, "_RESEAT_RACE", False)
    s = small_adversarial()
    rj, rt = solve_both((s.current, s.broker_list, s.topology),
                        prewarm_bounds=True, engine="sweep", sweeps=32,
                        batch=4, cert_min_savings_s=1e9)
    assert_same(rj, rt)
    assert rt.stats["engine"] == "sweep" and rt.stats["rounds_run"] == 32
    assert rt.stats["feasible"]
    assert rt.stats["final_cert"] == "moves_above_lb"


def test_boundary_certificate_matches_reference(demo):
    """At ``cert_min_savings_s=0`` the certificate is tried at every chunk
    boundary (bounds memoized first): the demo's ladder certifies after
    its first chunk and stops there, as the reference's does."""
    rj, rt = solve_both(demo, prewarm_bounds=True, engine="sweep",
                        sweeps=64, batch=4, cert_min_savings_s=0.0)
    assert_same(rj, rt)
    assert rt.stats["early_stopped"] and rt.stats["rounds_run"] == 32
    assert rt.optimal and "final_cert" not in rt.stats


def test_sweep_to_chain_retry_keeps_the_better_plan(demo, monkeypatch):
    """A defaulted sweep that ends infeasible below 512 partitions (on the
    card the sweep is the default at every size) retries the chain
    engine on what is left of the budget and keeps the better plan. The
    first solve is stood in by an infeasible sweep result; the chain
    engine's defaults are cut to 4 chains x 2 rounds, and the boundary
    certificate is off so both rounds run."""
    current, brokers, topo = port_cluster(*demo)
    inst = build_instance(current, brokers, topo)
    real_raced, real_defaults = engine._solve_raced, engine._defaults
    calls = []

    def raced(inst, dev, seed, batch, rounds, sweeps, steps, t_hi, t_lo,
              eng, *rest):
        calls.append(eng)
        if eng is None:
            return engine.SolveResult(
                a=inst.a0.copy(), solver="tpu", objective=0,
                stats={"feasible": False, "engine": "sweep",
                       "violations": 3, "moves": 0})
        return real_raced(inst, dev, seed, batch, rounds, sweeps, steps,
                          t_hi, t_lo, eng, *rest)

    def defaults(inst, platform, eng):
        d = real_defaults(inst, platform, eng)
        return dict(d, batch=4, rounds=2) if d["engine"] == "chain" else d

    monkeypatch.setattr(engine, "_solve_raced", raced)
    monkeypatch.setattr(engine, "_defaults", defaults)
    res = engine.solve_tpu(inst, device="cpu", time_limit_s=600.0,
                           cert_min_savings_s=1e9)
    assert calls == [None, "chain"]
    assert res.stats["engine"] == "chain" and res.stats["feasible"]
    assert res.stats["engine_fallback"] == (
        "chain after infeasible defaulted sweep")
    assert res.stats["rounds_run"] == 2 and res.stats["moves"] == 1
    assert res.stats["time_limit_s"] <= 600.0


def test_unported_keywords_raise(demo):
    """A keyword of the reference's solver asks for a path the port does
    not have: it raises instead of being ignored; values naming what the
    port does pass. (``n_devices`` is ported: two shards equal the
    reference's two devices here, and ``tests/test_torch_mesh.py`` holds
    the mesh to the reference.) (``portfolio`` is ported: its values are held to the
    reference's in ``tests/test_torch_portfolio.py``; ``decompose`` and
    ``warm_start`` in ``tests/test_torch_decompose.py`` and
    ``tests/test_torch_watch.py``; ``pipeline``, ``megachunk`` and
    ``checkpoint`` in ``tests/test_torch_pipeline.py``,
    ``tests/test_torch_megachunk.py`` and
    ``tests/test_torch_checkpoint.py``; ``profile_dir`` in
    ``tests/test_torch_measure.py``.)"""
    current, brokers, topo = port_cluster(*demo)
    inst = build_instance(current, brokers, topo)
    # n_devices above 1 is ported: two chain shards on the CPU give the
    # reference's two-device plan and stats
    kw = dict(precompile=True, engine="sweep", sweeps=8, batch=4,
              portfolio=False, n_devices=2)
    want = jengine.solve_tpu(jax_build(*demo), **kw)
    got = engine.solve_tpu(inst, device="cpu", **kw)
    np.testing.assert_array_equal(got.a, want.a)
    for f in ("devices", "chains_per_device", "rounds_run", "moves",
              "score_curve", "final_cert"):
        assert got.stats[f] == want.stats[f], f
    assert got.stats["devices"] == 2 and got.stats["chains_per_device"] == 2
    # precompile (the service's warm-up) is ported: no constructor race,
    # so the demo's device path runs instead of the exact MILP's
    # certificate, as in the reference
    res = engine.solve_tpu(inst, device="cpu", precompile=True,
                           engine="sweep", sweeps=8, batch=2)
    assert res.stats["engine"] == "sweep" and res.stats["rounds_run"] == 8
    with pytest.raises(TypeError):
        engine.solve_tpu(inst, device="cpu", no_such_keyword=1)
    res = engine.solve_tpu(inst, device="cpu", portfolio=False,
                           pipeline=False, megachunk=1, n_devices=1,
                           decompose=False)
    assert res.optimal and res.stats["moves"] == 1


def test_auto_resolves_like_reference(demo):
    """``"auto"`` is the exact MILP on the demo in both packages, with
    the same plan, proof and reported weight bound."""
    current, brokers, topo = demo
    ref = jax_optimize(current, brokers, topo, solver="auto").report()
    got = optimize(*port_cluster(current, brokers, topo), solver="auto",
                   device="cpu").report()
    assert got["solver"] == ref["solver"] == "milp"
    assert got["proven_optimal"] is True
    assert got["replica_moves"] == ref["replica_moves"] == 1
    assert got["objective_upper_bound"] == ref["objective_upper_bound"]


@pytest.mark.parametrize("case", [
    dict(n_brokers=14, n_parts=60, rf=3, n_racks=3, drop=1),
    dict(n_brokers=12, n_parts=40, rf=2, n_racks=2, drop=2),
])
def test_random_cluster_feasible(case, rng):
    current, brokers, topo = port_cluster(*random_cluster(rng, **case))
    res = optimize(current, brokers, topo, solver="tpu", device="cpu",
                   engine="sweep", sweeps=32)
    rep = res.report()
    assert rep["feasible"], rep["violations"]
    assert res.replica_moves >= rep["solver_moves_lb"]
    assert res.replica_moves <= rep["solver_seed_moves"] or (
        res.solve.objective >= res.instance.preservation_weight(
            res.instance.a0))


def test_schedule_and_initial_state_match_reference(rng):
    current, brokers, topo = random_cluster(rng, 10, 30, 3, 3, drop=1)
    inst_j = jax_build(current, brokers, topo)
    inst_t = build_instance(*port_cluster(current, brokers, topo))
    for eng, rounds, limit in [("sweep", 64, None), ("sweep", 128, None),
                               ("sweep", 100, None), ("sweep", 64, 1.0),
                               ("chain", 24, None), ("chain", 24, 1.0),
                               ("chain", 30, 2.0)]:
        ref = jengine._build_chunks(inst_j, eng, rounds, 2.0, 0.02, limit)
        got = engine._build_chunks(inst_t, eng, rounds, 2.0, 0.02, limit)
        assert len(ref) == len(got)
        for x, y in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(x), y)
    # the card takes the reference's TPU choices
    for eng in (None, "sweep", "chain"):
        assert engine._defaults(inst_t, "gpu", eng) == jengine._defaults(
            inst_j, "tpu", eng)
        assert engine._defaults(inst_t, "cpu", eng) == jengine._defaults(
            inst_j, "cpu", eng)
    assert engine._defaults(inst_t, "cpu", None)["engine"] == "chain"
    m = arrays.from_instance(inst_t, "cpu")
    seed_np = greedy_seed(inst_t)
    seed = torch.from_numpy(seed_np)
    a, bk, bmv, ba, key = init_sweep_state(m, seed, prng.PRNGKey(3), 4)
    assert a.data_ptr() != ba.data_ptr()
    assert torch.equal(a, ba) and a.shape == (4, *inst_t.a0.shape)
    np.testing.assert_array_equal(
        key, np.asarray(jax.random.split(jax.random.PRNGKey(3), 1)[0]))
    assert (bmv == inst_t.move_count(seed_np)).all()
    assert (bk == inst_t.preservation_weight(seed_np)).all()  # feasible


def test_entry_points_need_the_card_unless_asked(demo, monkeypatch):
    current, brokers, topo = port_cluster(*demo)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimize(current, brokers, topo, solver="tpu")
    with pytest.raises(ValueError, match="unsupported device"):
        engine.resolve_device("mps")
    with pytest.raises(ValueError, match="unknown tpu engine"):
        optimize(current, brokers, topo, solver="tpu", device="cpu",
                 engine="anneal")


def test_cli_demo(tmp_path, capsys, monkeypatch):
    src = tmp_path / "current.json"
    src.write_text(demo_assignment().to_json())
    rc = cli_main(["-i", str(src), "--broker-list", "0-18", "--topology",
                   "even-odd", "--device", "cpu", "--report"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    plan = json.loads(out.out)
    assert len(plan["partitions"]) == 10
    rep = json.loads(out.err)
    assert rep["replica_moves"] == 1 and rep["feasible"]
    assert rep["solver"] == "milp" and rep["proven_optimal"]
    rc = cli_main(["-i", str(src), "--broker-list", "0-18", "--topology",
                   "even-odd", "--device", "cpu", "--solver", "tpu",
                   "--engine", "sweep", "--sweeps", "8", "--time-limit",
                   "60", "--report"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    rep = json.loads(out.err)
    assert rep["solver_engine"] == "sweep" and rep["solver_rounds_run"] == 8
    assert rep["replica_moves"] == 1 and rep["feasible"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli_main(["-i", str(src), "--broker-list", "0-18",
                     "--solver", "tpu"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def _cli_report(main, argv, capsys) -> tuple[int, dict | None, str]:
    """``(exit code, --report JSON, stderr)`` of one CLI run: the report
    is the JSON object after the structured log lines on stderr."""
    rc = main(argv)
    err = capsys.readouterr().err
    start = err.find("\n{") + 1 if not err.startswith("{") else 0
    rep = json.loads(err[start:]) if "{" in err else None
    return rc, rep, err


def test_cli_decompose_and_chaos_match_reference(tmp_path, capsys,
                                                 monkeypatch):
    """``--decompose`` on a smoke ``ultra_jumbo`` input and ``--chaos
    nan_chunk`` on the demo give the reference CLI's report (engine,
    moves, weight, degraded, degradations); a malformed ``--chaos`` spec
    exits 2 with ``error:`` in both. The reference's ``tpu`` solver runs
    on its mesh of one device, as in every parity test here."""
    import functools

    from kafka_assignment_optimizer_tpu.cli import main as jcli_main
    from kafka_assignment_optimizer_tpu.resilience import chaos as jchaos
    from kafka_assignment_optimizer_tpu.solvers import base as jbase
    from kafka_assignment_optimizer_tpu_torch.resilience import chaos

    jbase._load_all()
    monkeypatch.setitem(jbase._REGISTRY, "tpu", functools.partial(
        jengine.solve_tpu, n_devices=1, pipeline=False, megachunk=1))

    s = jgen.ultra_jumbo(n_az=3, racks_per_az=4, partitions=120, seed=0)
    src, topo = tmp_path / "uj.json", tmp_path / "uj_topo.json"
    src.write_text(s.current.to_json())
    topo.write_text(json.dumps(s.topology.to_dict()))
    demo_src = tmp_path / "demo.json"
    demo_src.write_text(demo_assignment().to_json())
    runs = {
        "decompose": ["-i", str(src), "--broker-list",
                      ",".join(map(str, s.broker_list)), "--topology",
                      str(topo), "--solver", "tpu", "--sweeps", "2",
                      "--decompose", "--report"],
        "chaos": ["-i", str(demo_src), "--broker-list", "0-18",
                  "--topology", "even-odd", "--solver", "tpu", "--engine",
                  "sweep", "--sweeps", "16", "--chaos", "nan_chunk",
                  "--report"],
    }
    keys = ("solver_engine", "replica_moves", "objective_weight",
            "solver_degraded", "degradations", "feasible")
    try:
        for name, argv in runs.items():
            rc_j, ref, _ = _cli_report(jcli_main, argv, capsys)
            rc_t, got, err = _cli_report(cli_main, argv + ["--device", "cpu"],
                                         capsys)
            assert rc_t == rc_j == 0, err
            assert {k: got.get(k) for k in keys} == {
                k: ref.get(k) for k in keys}, name
        assert got["solver_engine"] == "host_fallback"
        assert got["degradations"] == ["anneal_to_construct"]
    finally:
        jchaos.disarm()
        chaos.disarm()
    bad = runs["chaos"][:-3] + ["--chaos", "nan_chunc:1"]
    for main in (jcli_main, cli_main):
        rc, _rep, err = _cli_report(main, bad, capsys)
        assert rc == 2 and "error: bad --chaos spec" in err
    assert not chaos.armed() and not jchaos.armed()


def test_port_never_imports_jax():
    """Importing the port, solving on the CPU through every backend (the
    exact host solvers, the race, the sweep engine's portfolio lanes and
    the chain engine), a batch through ``optimize_batch``, a decomposed
    solve (``KAO_DECOMPOSE=1``), ``optimize_delta`` with its warm start, a
    pipelined megachunk solve writing a checkpoint (``utils.checkpoint``
    imported), a chaos-armed solve's host fallback, the measurement plane
    (its modules imported, a profiled solve), ``kao-check``'s lint and
    runtime contracts (``analysis`` and ``analysis.lsan`` imported), and
    importing and running chip_smoke.py without a card load neither JAX
    nor the JAX package."""
    code = (
        "import sys\n"
        "import torch\n"
        "import kafka_assignment_optimizer_tpu_torch as k\n"
        "from kafka_assignment_optimizer_tpu_torch.utils import gen\n"
        "s = gen.demo()\n"
        "def solve(**kw):\n"
        "    r = k.optimize(s.current, s.broker_list, s.topology, **kw)\n"
        "    assert r.report()['feasible'], kw\n"
        "    return r.solve.stats\n"
        "for name in ('milp', 'native', 'lp_solve', 'auto'):\n"
        "    solve(solver=name)\n"
        "assert solve(solver='tpu', device='cpu')['engine'] == 'construct'\n"
        "assert solve(solver='tpu', device='cpu', engine='sweep', "
        "sweeps=8)['engine'] == 'sweep'\n"
        "assert solve(solver='tpu', device='cpu', engine='chain', "
        "batch=4, rounds=2)['engine'] == 'chain'\n"
        "st = solve(solver='tpu', device='cpu', engine='sweep', sweeps=8, "
        "batch=2)\n"
        "assert st['portfolio']['width'] == 8, st\n"
        "inst = k.build_instance(s.current, s.broker_list, s.topology)\n"
        "out = k.optimize_batch([s.current] * 2, [inst] * 2, device='cpu', "
        "engine='sweep', sweeps=8, batch=2)\n"
        "assert all(r.report()['feasible'] for r in out)\n"
        "import os\n"
        "os.environ['KAO_DECOMPOSE'] = '1'\n"
        "u = gen.ultra_jumbo(n_az=3, racks_per_az=4, partitions=120)\n"
        "r = k.optimize(u.current, u.broker_list, u.topology, solver='tpu', "
        "device='cpu', sweeps=2)\n"
        "assert r.solve.stats['engine'] == 'decomposed', r.solve.stats\n"
        "d = k.optimize_delta(s.current, s.broker_list, s.topology, "
        "prev_plan=s.current, solver='tpu', device='cpu')\n"
        "assert d.solve.stats['warm_started'], d.solve.stats\n"
        "del os.environ['KAO_DECOMPOSE']\n"
        "import tempfile\n"
        "ck = tempfile.mkdtemp() + '/ck.npz'\n"
        "st = solve(solver='tpu', device='cpu', engine='sweep', sweeps=16, "
        "time_limit_s=60, megachunk=2, checkpoint=ck)\n"
        "assert st['megachunk']['k'] == 2 and st['pipeline'], st\n"
        "from kafka_assignment_optimizer_tpu_torch.utils import checkpoint\n"
        "assert checkpoint.load(ck, k.build_instance(s.current, "
        "s.broker_list, s.topology)) is not None\n"
        "from kafka_assignment_optimizer_tpu_torch.resilience import chaos\n"
        "chaos.arm('nan_chunk')\n"
        "st = solve(solver='tpu', device='cpu', engine='sweep', sweeps=8)\n"
        "assert st['degradations'] == ['anneal_to_construct'], st\n"
        "from kafka_assignment_optimizer_tpu_torch.obs import (chrome, "
        "drift, prof, regress, sampler, slo, trace_cli)\n"
        "from kafka_assignment_optimizer_tpu_torch.ops import bench_kernel\n"
        "solve(solver='tpu', device='cpu', engine='sweep', sweeps=8, "
        "profile_dir=tempfile.mkdtemp())\n"
        "assert prof.snapshot()['executables']\n"
        "from kafka_assignment_optimizer_tpu_torch.analysis import (lint_paths, "
        "lsan)\n"
        "from kafka_assignment_optimizer_tpu_torch.analysis.contracts import "
        "run_contracts\n"
        "assert lint_paths() == []\n"
        "assert run_contracts(device='cpu').ok\n"
        "import chip_smoke\n"
        "torch.cuda.is_available = lambda: False\n"
        "assert chip_smoke.main() != 0\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'kafka_assignment_optimizer_tpu'"
        " or n.startswith('kafka_assignment_optimizer_tpu.')]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-800:]


def test_chip_smoke_refuses_without_the_card(monkeypatch, capsys):
    """chip_smoke.py imports nothing but the standard library, torch,
    numpy and the port (at any depth, lazy imports included), and exits
    non-zero without printing a result when there is no card."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = {al.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for al in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert roots - set(sys.stdlib_module_names) == {
        "torch", "numpy", "kafka_assignment_optimizer_tpu_torch"}
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok": true' not in capsys.readouterr().out
