"""PyTorch port: the multi-process solve mesh (``parallel.distributed``).

Mirrors the reference's ``tests/test_distributed.py``: a launch with no
cluster environment is a single-host no-op, idempotent; an explicit but
malformed configuration raises; the CLI has ``--distributed`` and the
service has none. Past the reference (whose JAX build refuses
multi-process collectives on the CPU), the port runs them: the probe's
two-process gloo ``all_reduce`` succeeds, and two CPU processes over
gloo, each holding one chain shard, give the plan of one process with
``n_devices=2``, which is the JAX package's two-device plan; two CLI
processes with ``--distributed`` agree. Every child process has a
timeout: a hung rendezvous fails the test.
"""

import inspect
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

from kafka_assignment_optimizer_tpu import build_instance as jax_build
from kafka_assignment_optimizer_tpu.solvers.tpu import engine as jengine
from kafka_assignment_optimizer_tpu.utils import gen as jgen
from kafka_assignment_optimizer_tpu_torch.parallel import distributed as dist
from kafka_assignment_optimizer_tpu_torch.parallel.mesh import make_mesh
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine
from kafka_assignment_optimizer_tpu_torch.utils import gen

REPO = Path(__file__).resolve().parent.parent
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
        "LOCAL_WORLD_SIZE", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
        "JAX_PROCESS_ID")
# the two-shard solve: the adversarial case of the mesh tests, the
# races off (precompile) so every run anneals the same ladder
CASE = dict(n_brokers=32, n_topics_low=3, n_topics_high=3,
            parts_per_topic=10, seed=7)
KW = dict(precompile=True, engine="sweep", sweeps=16, batch=8,
          portfolio=False, seed=0)
TIMEOUT_S = 240

# one process of a group: join it from the launcher's environment, solve
# the case on its shard, print the plan and what it ran on
_CHILD = r"""
import json, sys
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance)
from kafka_assignment_optimizer_tpu_torch.parallel import distributed as dist
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine
from kafka_assignment_optimizer_tpu_torch.utils import gen
case, kw = json.loads(sys.argv[1]), json.loads(sys.argv[2])
rank, world = dist.init_distributed(device="cpu")
s = gen.adversarial(**case)
inst = build_instance(s.current, s.broker_list, s.topology)
res = engine.solve_tpu(inst, device="cpu", **kw)
print(json.dumps({"rank": rank, "world": world, "a": res.a.tolist(),
                  "stats": {k: res.stats[k] for k in (
                      "devices", "chains_per_device", "mesh", "moves",
                      "score_curve")},
                  "backend": dist.backend()}))
dist.shutdown_distributed()
"""

# an armed fused group called directly on a two-shard mesh: K=4 chunks
# of 8 sweeps from the current assignment, a chain qualifying once its
# best key is 2 above the start's (after the second chunk), so the group
# exits early; exec'd by the test and by each group process
_MEGA_RUN = r"""
import numpy as np
import torch
from kafka_assignment_optimizer_tpu_torch import prng
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance)
from kafka_assignment_optimizer_tpu_torch.parallel import mesh as pm
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import arrays
from kafka_assignment_optimizer_tpu_torch.utils import gen


def mega_run(case, mesh):
    s = gen.adversarial(**case)
    inst = build_instance(s.current, s.broker_list, s.topology)
    m = arrays.from_instance(inst, "cpu")
    seed = m.a0.clone()
    key = prng.PRNGKey(3)
    k0 = int(pm.init_sweep_state(m, seed, key, 4)[1][0])
    temps = arrays.geometric_temps(2.0, 0.02, 32).reshape(4, 8)
    st = pm.init_sweep_state(m, seed, key, 4, mesh)
    out = pm.solve_megachunk(m, 4, temps, st, cert_k=k0 + 2,
                             cert_mv=10 ** 6, mesh=mesh)
    return {name: np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                             else x).tolist()
            for name, x in zip(("top_a", "top_k", "cert_a", "cert_ok",
                                "cert_mv", "curves", "execd"), out[1:])}
"""

_MEGA_CHILD = r"""
import json, sys
from kafka_assignment_optimizer_tpu_torch.parallel import distributed as dist
from kafka_assignment_optimizer_tpu_torch.parallel import mesh as pm
src, case = sys.argv[1], json.loads(sys.argv[2])
ns = {}
exec(src, ns)
dist.init_distributed(device="cpu")
print(json.dumps(ns["mega_run"](case, pm.make_mesh(2, device="cpu"))))
dist.shutdown_distributed()
"""


@pytest.fixture
def no_cluster_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _group_env(port: int, rank: int) -> dict:
    """A group process's environment: the launcher's variables, and one
    intra-op thread (two processes, each with a thread a core, would
    oversubscribe the CPU while they wait on each other)."""
    env = {k: v for k, v in os.environ.items() if k not in _ENV}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2", RANK=str(rank), OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def _run_group(argv_of) -> list[tuple[int, str, str]]:
    """Two processes of one gloo group, each ``argv_of(rank)``; their
    ``(returncode, stdout, stderr)``. A child still running at the
    timeout is killed and the test fails."""
    port = _free_port()
    procs = [subprocess.Popen(argv_of(r), env=_group_env(port, r),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=str(REPO))
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                pytest.fail(f"a group process hung past {TIMEOUT_S} s: "
                            f"{err[-800:]}")
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, _out, err in outs:
        assert rc == 0, f"a group process failed rc={rc}: {err[-1500:]}"
    return outs


def test_single_host_is_noop(no_cluster_env):
    """No cluster environment: a logged no-op returning (0, 1), and
    again (idempotent); the mesh is this process's alone."""
    assert dist.init_distributed(device="cpu") == (0, 1)
    assert dist.init_distributed() == (0, 1)
    assert dist.process_count() == 1 and dist.backend() is None
    assert make_mesh(2, device="cpu").processes == 1


def test_explicit_misconfig_raises(no_cluster_env, monkeypatch):
    """A configuration given explicitly but malformed raises: N workers
    silently solving alone is worse than an error."""
    with pytest.raises(ValueError):
        dist.init_distributed(coordinator_address="nonsense:0",
                              num_processes=2, process_id=0)
    with pytest.raises(ValueError):
        dist.init_distributed(coordinator_address="127.0.0.1:29500",
                              num_processes=2, process_id=5)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "nonsense:0")
    with pytest.raises(ValueError):
        dist.init_distributed()
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError):
        dist.init_distributed()
    monkeypatch.delenv("WORLD_SIZE")
    assert dist.init_distributed() == (0, 1)


def test_cli_flag_exists_and_serve_has_none():
    """``--distributed`` exists on the CLI; the service has no such flag
    (independent request streams cannot drive matching collectives)."""
    from kafka_assignment_optimizer_tpu_torch import serve
    from kafka_assignment_optimizer_tpu_torch.cli import build_parser

    args = build_parser().parse_args(["--broker-list", "0-2",
                                      "--distributed"])
    assert args.distributed
    assert not build_parser().parse_args(["--broker-list", "0-2"]
                                         ).distributed
    assert "--distributed" not in inspect.getsource(serve)


def test_probe_runs_a_two_process_collective():
    """The probe forms a real two-process gloo group and all_reduces one
    int32 (1 + 2 = 3); the verdict is memoized."""
    ok, finding = dist.probe_multiprocess_cpu(timeout_s=TIMEOUT_S,
                                              refresh=True)
    assert ok, finding
    assert "3" in finding
    assert dist.probe_multiprocess_cpu() == (ok, finding)


def test_two_gloo_processes_equal_two_shards_and_reference():
    """Two CPU processes over gloo, one chain shard each: both give the
    plan of one process at ``n_devices=2``, which is the JAX package's
    two-device plan; the migration's values and the shards' winners
    crossed the processes as ``all_reduce`` calls."""
    outs = _run_group(lambda r: [sys.executable, "-c", _CHILD,
                                 json.dumps(CASE), json.dumps(KW)])
    got = [json.loads(out.strip().splitlines()[-1]) for _rc, out, _e in outs]
    assert [g["rank"] for g in got] == [0, 1]
    assert all(g["world"] == 2 and g["backend"] == "gloo" for g in got)
    assert got[0]["a"] == got[1]["a"]
    meshes = [g["stats"].pop("mesh") for g in got]
    assert got[0]["stats"] == got[1]["stats"]
    st = got[0]["stats"]
    assert st["devices"] == 2 and st["chains_per_device"] == 4
    # each process sees its own position and the other's as remote
    assert meshes == [{"axes": {"chains": 2, "lanes": 1},
                       "devices": devs, "processes": 2}
                      for devs in (["cpu", "remote"], ["remote", "cpu"])]

    s = gen.adversarial(**CASE)
    from kafka_assignment_optimizer_tpu_torch.models.instance import (
        build_instance,
    )

    one = engine.solve_tpu(build_instance(s.current, s.broker_list,
                                          s.topology),
                           device="cpu", n_devices=2, **KW)
    np.testing.assert_array_equal(np.asarray(got[0]["a"]), one.a)
    assert st["score_curve"] == one.stats["score_curve"]
    sj = jgen.adversarial(**CASE)
    want = jengine.solve_tpu(jax_build(sj.current, sj.broker_list,
                                       sj.topology), n_devices=2, **KW)
    np.testing.assert_array_equal(one.a, want.a)
    assert one.stats["moves"] == want.stats["moves"]


def test_two_cli_processes_agree():
    """``--distributed`` through the CLI: two processes with the same
    input both exit 0 with the same plan, solved on a two-shard mesh
    spanning both."""
    with tempfile.TemporaryDirectory() as td:
        inp = os.path.join(td, "current.json")
        s = gen.adversarial(**CASE)
        Path(inp).write_text(s.current.to_json())
        brokers = ",".join(str(b) for b in s.broker_list)

        def argv(_rank):
            return [sys.executable, "-m",
                    "kafka_assignment_optimizer_tpu_torch", "--input", inp,
                    "--broker-list", brokers,
                    "--solver", "tpu", "--engine", "sweep", "--sweeps", "16",
                    "--batch", "8", "--device", "cpu", "--distributed",
                    "--report"]

        outs = _run_group(argv)
    plans = [json.loads(out) for _rc, out, _e in outs]
    assert plans[0] == plans[1]
    reps = [json.loads(err[err.index("{"):]) for _rc, _o, err in outs]
    assert all(r["solver_devices"] == 2 for r in reps)


def test_armed_megachunk_over_blocks_and_processes():
    """An armed fused group called directly (``solve_megachunk`` with the
    certificate's thresholds) on two shards: one block on one device,
    a block a device over two devices (the state a tuple of blocks),
    and two gloo processes of one shard each (the group's exit flag an
    ``all_reduce`` of a tensor on the block's device) exit after the
    same chunk with the same outputs."""
    ns = {}
    exec(_MEGA_RUN, ns)
    one = ns["mega_run"](CASE, make_mesh(2, device="cpu"))
    assert one["execd"][0] == [True, True, False, False]
    assert ns["mega_run"](CASE, make_mesh(device=["cpu", "cpu:0"])) == one
    outs = _run_group(lambda r: [sys.executable, "-c", _MEGA_CHILD,
                                 _MEGA_RUN, json.dumps(CASE)])
    for _rc, out, _err in outs:
        assert json.loads(out.strip().splitlines()[-1]) == one
