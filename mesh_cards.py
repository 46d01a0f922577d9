"""The solve mesh across every visible card, held to the CPU.

Usage::

    python3 mesh_cards.py          # on a host with two cards or more
    python3 mesh_cards.py --cpu    # rehearsal on the CPU, four shards

On ``cuda`` the port's default (``n_devices=None``) spreads a solve over
every visible card: one block of chain shards a card, enqueued in turn
from one host thread, the migration's few values copied between the
cards; under ``--distributed``, one process a card over NCCL. This
script drives that path and holds every run to the CPU's run at the same
number of shards (``device="cpu", n_devices=C``, which the tier-1 tests
hold to the JAX package's virtual devices):

1. one process, the pinned adversarial solo (``batch=8, rounds=16``,
   portfolio off) at ``n_devices=None``: plan, moves and curve equal to
   the CPU's; its launches one a stage a card;
2. one process, a batch of 4 adversarial instances under the
   chains-only split and a lane split (``KAO_MESH_SHARDING``): every
   lane's plan equal to the CPU's;
3. one process a card under ``init_distributed`` (NCCL when each owns a
   card), each solving step 1's solo on its own shard: every plan equal
   to step 1's.

Prints the card's name and power limit, each run's wall and launches,
and ``MESH_CARDS_OK`` last; exits 1 on any mismatch.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

SOLO = dict(seed=0, engine="sweep", batch=8, rounds=16, portfolio=False,
            cert_min_savings_s=float("inf"))
BATCH = dict(seeds=0, engine="sweep", batch=8, rounds=16)
TIMEOUT_S = 150

# one process of the group: join it from the launcher's environment,
# solve the pinned solo on this process's shard, print the plan
_CHILD = r"""
import json, sys, time
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance)
from kafka_assignment_optimizer_tpu_torch.ops import kernels
from kafka_assignment_optimizer_tpu_torch.parallel import distributed as dist
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine
from kafka_assignment_optimizer_tpu_torch.utils import gen
def stage(what):
    print("stage:", what, file=sys.stderr, flush=True)


device, kw = sys.argv[1], json.loads(sys.argv[2])
rank, world = dist.init_distributed(device=device)
stage(f"joined as {rank} of {world} ({dist.backend()})")
s = gen.adversarial()
inst = build_instance(s.current, s.broker_list, s.topology)
if device == "cuda":
    kernels.build_all()
kernels.reset_counts()
stage("solving")
t0 = time.perf_counter()
res = engine.solve_tpu(inst, device=device, **kw)
stage("solved")
print(json.dumps({
    "rank": rank, "world": world, "backend": dist.backend(),
    "a": res.a.tolist(), "mesh": res.stats["mesh"],
    "wall": time.perf_counter() - t0, "anneal_s": res.stats["anneal_s"],
    "launches": {k.name: k.launches for k in kernels.KERNELS}}))
dist.shutdown_distributed()
"""


def fail(msg: str) -> None:
    print(f"mesh_cards: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def main() -> int:
    import numpy as np
    import torch

    from kafka_assignment_optimizer_tpu_torch.models.instance import (
        build_instance,
    )
    from kafka_assignment_optimizer_tpu_torch.ops import kernels
    from kafka_assignment_optimizer_tpu_torch.parallel import mesh as pm
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import (
        engine,
        sweep,
    )
    from kafka_assignment_optimizer_tpu_torch.utils import gen

    on_cpu = "--cpu" in sys.argv[1:]
    if on_cpu:
        device, n = "cpu", 4
        # four positions the mesh keeps apart on the CPU: a block each
        where = ["cpu", "cpu:0"] * 2
        power = "cpu"
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
            print("mesh_cards: needs two cards or more", file=sys.stderr)
            return 1
        device, n, where = "cuda", torch.cuda.device_count(), "cuda"
        power = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().replace("\n", "; ")
        print(power)
        t = time.perf_counter()
        kernels.build_all()
        print(f"build: {time.perf_counter() - t:.3f} s")

    def counted(fn):
        kernels.reset_counts()
        if not on_cpu:
            for i in range(n):
                torch.cuda.synchronize(i)
        t0 = time.perf_counter()
        out = fn()
        if not on_cpu:
            for i in range(n):
                torch.cuda.synchronize(i)
        return (out, time.perf_counter() - t0,
                {k.name: k.launches for k in kernels.KERNELS})

    scen = gen.adversarial()
    inst = build_instance(scen.current, scen.broker_list, scen.topology)

    # 1. the solo over every card, against the CPU's n shards
    cpu = engine.solve_tpu(inst, device="cpu", n_devices=n, **SOLO)
    for run in (1, 2):
        res, wall, counts = counted(lambda: engine.solve_tpu(
            inst, device=where, **SOLO))
        st = res.stats
        if not np.array_equal(res.a, cpu.a):
            fail("solo: the plan differs from the CPU's")
        for f in ("moves", "score_curve", "rounds_run", "devices",
                  "chains_per_device"):
            if st[f] != cpu.stats[f]:
                fail(f"solo: {f} {st[f]}, the CPU's {cpu.stats[f]}")
        blocks = len(set(st["mesh"]["devices"]))
        if not on_cpu:
            per = sweep.stage_counts(st["rounds_run"] // st["dispatches"])
            expect = {k: v * st["dispatches"] * blocks
                      for k, v in per.items()}
            # the seed a block, final selection and verification
            expect["B1 score"] += blocks + 2
            if counts != expect:
                fail(f"solo: launches {counts}, expected {expect}")
        print(f"solo {run} (adversarial, {n} shards x "
              f"{st['chains_per_device']} chains x 16 sweeps on "
              f"{st['mesh']['devices']}): plan equal to the CPU's, "
              f"{st['moves']} moves, wall {wall:.3f} s, anneal_s "
              f"{st['anneal_s']}, launches {json.dumps(counts)} ({power})")

    # 2. a batch of 4 under the chains-only split and a lane split
    insts4 = [build_instance(x.current, x.broker_list, x.topology)
              for x in (gen.adversarial(seed=i) for i in range(4))]
    want = engine.solve_tpu_batch(insts4, n_devices=n, device="cpu",
                                  **BATCH)
    saved = os.environ.get(pm.MESH_ENV)
    try:
        for spec in (f"{n}x1", f"{n // 2}x2"):
            os.environ[pm.MESH_ENV] = spec
            out, wall, counts = counted(lambda: engine.solve_tpu_batch(
                insts4, device=where, **BATCH))
            for i, (g, w) in enumerate(zip(out, want)):
                if not np.array_equal(g.a, w.a):
                    fail(f"batch {spec}: lane {i} differs from the CPU's")
            axes = out[0].stats["mesh"]["axes"]
            if f"{axes['chains']}x{axes['lanes']}" != spec:
                fail(f"batch {spec}: ran on {axes}")
            print(f"batch {spec} (4 adversarial instances, {n} shards): "
                  f"every plan equal to the CPU's, wall {wall:.3f} s, "
                  f"anneal_s {out[0].stats['anneal_s']}, launches "
                  f"{json.dumps(counts)} ({power})")
    finally:
        if saved is None:
            os.environ.pop(pm.MESH_ENV, None)
        else:
            os.environ[pm.MESH_ENV] = saved

    # 3. one process a card (a shard each), the plan of step 1; each
    # process's output goes to a file, and on a failure or a hang every
    # process's last lines are printed (the one that failed first is
    # often not the one found hanging)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    procs, logs = [], []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        try:
            for rank in range(n):
                env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(port), WORLD_SIZE=str(n),
                           RANK=str(rank), LOCAL_RANK=str(rank),
                           LOCAL_WORLD_SIZE=str(n))
                if on_cpu:
                    env["OMP_NUM_THREADS"] = "1"
                out = open(os.path.join(td, f"{rank}.out"), "w+")
                err = open(os.path.join(td, f"{rank}.err"), "w+")
                logs.append((out, err))
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _CHILD, device,
                     json.dumps(SOLO)], cwd=root, env=env, stdout=out,
                    stderr=err))
            deadline = time.monotonic() + TIMEOUT_S
            while (any(p.poll() is None for p in procs)
                   and time.monotonic() < deadline):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    if any(p.returncode != 0 for p in procs):
        for rank, (p, (_out, err)) in enumerate(zip(procs, texts)):
            print(f"--- rank {rank}: rc {p.returncode}\n{err[-1500:]}",
                  file=sys.stderr)
        fail(f"processes: rcs {[p.returncode for p in procs]} (a negative "
             f"rc: killed at the {TIMEOUT_S} s limit or by the failure of "
             "another)")
    got = [json.loads(out.strip().splitlines()[-1]) for out, _e in texts]
    for g in got:
        if g["world"] != n or not np.array_equal(np.asarray(g["a"]), cpu.a):
            fail(f"processes: rank {g['rank']} (world {g['world']}) "
                 "differs from the one-process plan")
    print(f"{n} processes ({got[0]['backend']}, one shard each): every "
          f"plan equal to the one-process plan; solve walls "
          f"{[round(g['wall'], 3) for g in got]} s, anneal_s "
          f"{[g['anneal_s'] for g in got]}, launches a process "
          f"{json.dumps(got[0]['launches'])}; "
          f"{time.perf_counter() - t0:.3f} s with the processes' start "
          f"({power})")
    print("MESH_CARDS_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
