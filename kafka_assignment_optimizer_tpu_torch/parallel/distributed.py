"""The multi-process form of the solve mesh, over ``torch.distributed``.

Counterpart of ``kafka_assignment_optimizer_tpu.parallel.distributed``.
After :func:`init_distributed` the solve mesh (``parallel.mesh.make_mesh``)
spans every process's shards: each process anneals its own shards, and
the migration's few values cross processes as ``all_reduce`` (MAX, MIN,
SUM) of small int32 tensors; a shard's outputs reach every process the
same way (each process writes its blocks into a zero tensor of the
global shape, summed), so every process selects the same plan.

Execution model: every process runs the SAME program on the same input
(the CLI's ``--distributed`` under a launcher), as the reference's
multi-controller SPMD. The service has no such flag: independent request
streams cannot drive matching collectives.

Configuration, in this order: the arguments; the launcher's
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` (``torchrun``,
``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` when it sets them); the reference's
``JAX_COORDINATOR_ADDRESS`` (``host:port``)/``JAX_NUM_PROCESSES``/
``JAX_PROCESS_ID``. A launch with none of them is a single-host launch: a
logged no-op returning ``(0, 1)``. A configuration given explicitly but
malformed (no port, a rank outside the world) raises: N workers silently
solving alone is worse than an error.

The backend is chosen explicitly and reported (:func:`backend`): NCCL
when the solve runs on the card and every process of the host owns a
card of its own, gloo otherwise (the CPU, or several processes sharing a
card, whose migration values are staged through host memory).
"""

from __future__ import annotations

import os
import threading
from datetime import timedelta

from ..obs import log as _olog

_LOCK = threading.Lock()
# the process group this module started: backend, rank, world, the
# local card index
_STATE: dict = {"backend": None, "rank": 0, "world": 1, "local": 0}
_TIMEOUT_S = 300.0


def _env_config():
    """``(address, world, rank)`` from the launcher's environment or the
    reference's, each None when unset."""
    env = os.environ
    if env.get("MASTER_ADDR") or env.get("WORLD_SIZE"):
        addr = None
        if env.get("MASTER_ADDR"):
            addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '')}"
        return (addr, env.get("WORLD_SIZE"), env.get("RANK"))
    return (env.get("JAX_COORDINATOR_ADDRESS"), env.get("JAX_NUM_PROCESSES"),
            env.get("JAX_PROCESS_ID"))


def _parse_address(addr: str) -> tuple[str, int]:
    host, sep, port = str(addr).rpartition(":")
    if not sep or not host or not port.isdigit() or not 0 < int(port) < 65536:
        raise ValueError(f"malformed coordinator address {addr!r}; expected "
                         "host:port")
    return host, int(port)


def _choose_backend(device: str, world: int) -> str:
    """NCCL when the solve runs on the card and each process of the host
    has a card of its own, else gloo. The host's processes are
    ``LOCAL_WORLD_SIZE`` (``torchrun`` sets it); without it the whole
    world is taken for one host, so a launch over several hosts that
    leaves it unset runs gloo."""
    import torch

    if str(device).split(":")[0] != "cuda" or not torch.cuda.is_available():
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device: str = "cuda") -> tuple[int, int]:
    """Join (or start) the process group; idempotent. Returns
    ``(process_index, process_count)``. ``device`` is the solve device
    (``"cuda"`` unless the caller solves on the CPU): it decides the
    backend."""
    import torch.distributed as dist

    with _LOCK:
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        e_addr, e_world, e_rank = _env_config()
        explicit = any(v is not None for v in (coordinator_address,
                                               num_processes, process_id))
        addr = coordinator_address or e_addr
        world = num_processes if num_processes is not None else e_world
        rank = process_id if process_id is not None else e_rank
        if not explicit and addr is None and world is None and rank is None:
            _olog.warn("distributed_single_host",
                       reason="no cluster environment detected")
            return 0, 1
        if addr is None or world is None or rank is None:
            raise ValueError(
                "a distributed launch needs the coordinator address, the "
                f"process count and this process's id (got {addr!r}, "
                f"{world!r}, {rank!r})")
        host, port = _parse_address(addr)
        try:
            world, rank = int(world), int(rank)
        except (TypeError, ValueError) as e:
            raise ValueError(f"malformed process count or id: {e}") from e
        if world < 1 or not 0 <= rank < world:
            raise ValueError(f"process id {rank} outside a world of {world}")
        if not dist.is_available():
            raise RuntimeError("this PyTorch build has no torch.distributed")
        backend = _choose_backend(device, world)
        local = int(os.environ.get("LOCAL_RANK", rank))
        if backend == "nccl":
            import torch

            # the process's own card is its current one: the solve's
            # default device and NCCL's communicator
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"tcp://{host}:{port}", world_size=world,
            rank=rank, timeout=timedelta(seconds=_TIMEOUT_S))
        _STATE.update(backend=backend, rank=rank, world=world, local=local)
        _olog.info("distributed_init", backend=backend, rank=rank,
                   world=world)
        return rank, world


def shutdown_distributed() -> None:
    """Leave the process group this module started (no-op without one)."""
    import torch.distributed as dist

    with _LOCK:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        _STATE.update(backend=None, rank=0, world=1, local=0)


def process_index() -> int:
    return _STATE["rank"] if _STATE["backend"] else 0


def process_count() -> int:
    return _STATE["world"] if _STATE["backend"] else 1


def backend() -> str | None:
    """The process group's backend (``"nccl"``/``"gloo"``), None alone."""
    return _STATE["backend"]


def local_card() -> int:
    """The index of the card this process owns among the visible ones
    (its local rank, wrapped by the card count)."""
    import torch

    n = max(1, torch.cuda.device_count())
    return _STATE["local"] % n


_OPS = {"max": "MAX", "min": "MIN", "sum": "SUM"}


def all_reduce(t, op: str):
    """``t`` reduced over every process (``op`` max, min or sum) as a new
    tensor on ``t``'s device. Under gloo a card tensor is staged through
    host memory; under NCCL it is reduced on the card."""
    import torch.distributed as dist

    rop = getattr(dist.ReduceOp, _OPS[op])
    if _STATE["backend"] == "gloo" and t.device.type != "cpu":
        h = t.cpu()
        dist.all_reduce(h, op=rop)
        return h.to(t.device)
    out = t.clone()
    dist.all_reduce(out, op=rop)
    return out


# the probe's child: a real two-process gloo group on the CPU and ONE
# all_reduce, the operation the sharded solve's migration runs
_PROBE_CHILD = r"""
import sys
from datetime import timedelta
import torch
import torch.distributed as dist
addr, rank = sys.argv[1], int(sys.argv[2])
dist.init_process_group("gloo", init_method="tcp://" + addr, world_size=2,
                        rank=rank, timeout=timedelta(seconds=60))
t = torch.tensor([rank + 1], dtype=torch.int32)
dist.all_reduce(t)
assert int(t) == 3, int(t)
dist.destroy_process_group()
print("PROBE_OK", int(t))
"""

_PROBE_MEMO: tuple[bool, str] | None = None


def probe_multiprocess_cpu(timeout_s: float = 120.0,
                           refresh: bool = False) -> tuple[bool, str]:
    """Can this build run a two-process collective on the CPU? Returns
    ``(supported, finding)``: the collective's result on success, the
    failing child's own error otherwise. Two child processes form a gloo
    group on a free local port and all_reduce one int32; the verdict is
    memoized for the process (``/healthz`` reads the memo, never
    probes)."""
    global _PROBE_MEMO
    if _PROBE_MEMO is not None and not refresh:
        return _PROBE_MEMO
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    addr = f"127.0.0.1:{port}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PROBE_CHILD, addr, str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err = (err or "") + f"\n[probe timeout {timeout_s}s]"
            outs.append((p.returncode, out or "", err or ""))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ok = all(rc == 0 and "PROBE_OK" in out for rc, out, _ in outs)
    if ok:
        finding = "2-process gloo all_reduce verified: " + "; ".join(
            out.strip().splitlines()[-1] for _, out, _ in outs)
    else:
        rc, _, err = next((o for o in outs if o[0] != 0), outs[0])
        tail = [ln for ln in err.strip().splitlines() if ln][-1:]
        finding = f"probe rc={rc}: {tail[0] if tail else 'no stderr'}"[:300]
    _PROBE_MEMO = (ok, finding)
    _olog.log("distributed_probe", supported=ok, finding=finding)
    return _PROBE_MEMO
