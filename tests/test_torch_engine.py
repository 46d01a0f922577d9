"""PyTorch port: the slice end to end on the CPU — ``optimize`` on the
golden demo and on seeded random clusters, the CLI, the engine's schedule
against the reference's, the device rules (the card unless the caller
asks for the CPU; never a silent fallback), and the import boundary: the
port and ``chip_smoke.py`` never import JAX or the JAX package."""

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
from kafka_assignment_optimizer_tpu.solvers.tpu import engine as jengine
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

from tests.test_tpu_engine import random_cluster

REPO = Path(__file__).resolve().parent.parent


def port_cluster(current, brokers, topo):
    """A reference-package cluster as the port's own model objects."""
    return (Assignment.from_json(current.to_json()), brokers,
            Topology(rack_of=dict(topo.rack_of)))


def test_demo_golden(demo):
    current, brokers, topo = port_cluster(*demo)
    res = optimize(current, brokers, topo, solver="tpu", device="cpu")
    rep = res.report()
    assert rep["feasible"], rep
    assert rep["solver_engine"] == "sweep"
    assert rep["solver_platform"] == "cpu"
    assert res.replica_moves == 1
    assert res.solve.objective == res.instance.max_weight()


@pytest.mark.parametrize("case", [
    dict(n_brokers=14, n_parts=60, rf=3, n_racks=3, drop=1),
    dict(n_brokers=12, n_parts=40, rf=2, n_racks=2, drop=2),
])
def test_random_cluster_feasible(case, rng):
    current, brokers, topo = port_cluster(*random_cluster(rng, **case))
    res = optimize(current, brokers, topo, device="cpu", sweeps=32)
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
    for rounds in (64, 128, 100):
        ref = jengine._build_chunks(inst_j, "sweep", rounds, 2.0, 0.02, None)
        got = engine._build_chunks(inst_t, rounds, 2.0, 0.02)
        assert len(ref) == len(got)
        for x, y in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(x), y)
    assert engine._defaults("gpu", None) == {
        "engine": "sweep", "batch": 8, "rounds": 128}
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
        optimize(current, brokers, topo)
    with pytest.raises(ValueError, match="unsupported device"):
        engine.resolve_device("mps")
    with pytest.raises(ValueError, match="'sweep' engine only"):
        optimize(current, brokers, topo, device="cpu", engine="chain")


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
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli_main(["-i", str(src), "--broker-list", "0-18"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_port_never_imports_jax():
    """Importing the port, solving on the CPU, and importing and running
    chip_smoke.py without a card load neither JAX nor the JAX package."""
    code = (
        "import sys\n"
        "import torch\n"
        "import kafka_assignment_optimizer_tpu_torch as k\n"
        "from kafka_assignment_optimizer_tpu_torch.utils import gen\n"
        "s = gen.demo()\n"
        "r = k.optimize(s.current, s.broker_list, s.topology, "
        "device='cpu', sweeps=8)\n"
        "assert r.report()['feasible']\n"
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
