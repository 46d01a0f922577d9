"""The solve mesh: chain shards over devices, the per-bucket (chains x
lanes) sharding search, the initial sweep state, the lanes, the fused
megachunk groups and the asynchronous device-to-host fetch.

Counterpart of ``kafka_assignment_optimizer_tpu.parallel.mesh``. A mesh
(:class:`Mesh`, :func:`make_mesh`) is a ``(dc, dl)`` grid of devices,
row-major; a solve on it holds C = dc * dl logical chain shards, each
with its own RNG key (``prng.split(key, C)``, lanes split per lane then
transposed, as the reference draws them) and ``chains_per_device``
chains. The state's leading axis is the shard axis, the reference's
global layout: ``[C, N, ...]`` for one model, ``[C, L, N, ...]`` for L
lanes. Grid position ``(ic, il)`` hosts shards ``ic*dl`` to ``ic*dl +
dl - 1`` of lane block ``il`` (L / dl lanes), as the reference's
``P('chains', 'lanes')`` places them; whatever the split, the shards are
the same C, so every split replays one trajectory.

Shards that share a device ride the lane axis of one launch of each
kernel (C * L lanes, ``arrays.shard_models``); shards on different cards
launch once a card (:class:`Block`; :class:`Layout` is the steppers'
view of the state). At every snapshot the shards of a lane exchange
their best chain (``sweep._migrate_blocks``): the global
best key, the fewest moves among the tied chains, the owner the lowest
shard index, its chain and histogram rows cloned over each shard's worst
chain. Those few values stay on the device (copies between cards, no
host sync); across processes (``parallel.distributed``) they are
``all_reduce`` calls.

``n_devices`` follows the reference: on ``cuda`` None takes every
visible card and k the first k, cut to the count as ``jax.devices()[:n]``
cuts; a card named with its index, and the CPU, host all ``n_devices``
shards themselves (on the CPU these are what the reference's virtual CPU
devices are to its tests); an explicit device list may repeat a card.
Under a process group the mesh spans every process's shards.

The (chains x lanes) split is chosen, never hand-written:
:func:`choose_sharding` reads an evidence table fed by timed candidate
dispatches (:func:`run_sharding_search`) and production batches, takes
the default chains-only split until a challenger and the default both
have ``MESH_MIN_SOLVES`` observations and the challenger is faster, and
always takes the default under a process group.
``KAO_MESH_SHARDING=auto|off|<dc>x<dl>`` forces or disables it.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import prng
from ..ops.score_cuda import score, score_lanes
from ..solvers.tpu.arrays import (
    ModelArrays,
    lane_range,
    model_on,
    shard_models,
)

AXIS = "chains"
AXIS_LANES = "lanes"
_IMAX = int(np.iinfo(np.int32).max)
_IMIN = int(np.iinfo(np.int32).min)


class Mesh:
    """A solve mesh: ``dc x dl`` grid positions, row-major, each a device
    (None for a position another process holds), and the process that
    owns each. It holds C = ``size`` logical chain shards."""

    def __init__(self, devices, dc: int, dl: int, owners=None,
                 rank: int = 0):
        if len(devices) != dc * dl:
            raise ValueError(f"{len(devices)} devices for a {dc}x{dl} mesh")
        self.devices = tuple(None if d is None else torch.device(d)
                             for d in devices)
        self.dc, self.dl = int(dc), int(dl)
        self.owners = (tuple(owners) if owners is not None
                       else (rank,) * len(devices))
        self.rank = rank
        self._blocks: dict = {}

    @property
    def size(self) -> int:
        """The logical chain shards C (= the grid positions)."""
        return self.dc * self.dl

    @property
    def processes(self) -> int:
        return len(set(self.owners))

    @property
    def multi(self) -> bool:
        """The mesh spans several processes."""
        return self.processes > 1

    def blocks(self, lanes: int) -> list:
        """This process's share of a solve of ``lanes`` lanes, as
        :class:`Block` s: one block when every local position is on one
        device (one launch of each kernel for all its shards and lanes),
        else one a position. Raises ValueError when the lane axis size
        does not divide ``lanes``."""
        if lanes % self.dl:
            raise ValueError(f"lane count {lanes} not divisible by lane "
                             f"axis size {self.dl}")
        if lanes not in self._blocks:
            lw = lanes // self.dl
            blks = [Block(self.devices[p], (p // self.dl) * self.dl,
                          (p // self.dl + 1) * self.dl, (p % self.dl) * lw,
                          (p % self.dl + 1) * lw)
                    for p in range(self.size) if self.owners[p] == self.rank]
            if len({b.device for b in blks}) == 1:
                c0, c1 = min(b.c0 for b in blks), max(b.c1 for b in blks)
                l0, l1 = min(b.l0 for b in blks), max(b.l1 for b in blks)
                if (c1 - c0) * (l1 - l0) == sum(
                        (b.c1 - b.c0) * (b.l1 - b.l0) for b in blks):
                    blks = [Block(blks[0].device, c0, c1, l0, l1)]
            self._blocks[lanes] = blks
        return self._blocks[lanes]

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` reduced over the mesh's processes (``op`` max/min/sum)."""
        from .distributed import all_reduce

        return all_reduce(t, op)

    def __repr__(self) -> str:
        return (f"Mesh({self.dc}x{self.dl}, devices="
                f"{[str(d) for d in self.devices]}, processes="
                f"{self.processes})")


def _positions(n_devices, device) -> tuple[list, list, int]:
    """``(devices, owners, rank)`` of a mesh's positions (see the module
    docstring for the rules)."""
    from . import distributed as _dist

    if isinstance(device, (list, tuple)):
        devs = [torch.device(d) for d in device]
        if n_devices is not None:
            devs = devs[:int(n_devices)]
        return devs, [0] * len(devs), 0
    dev = torch.device("cuda" if device is None else device)
    world, rank = _dist.process_count(), _dist.process_index()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to solve on the CPU")
    if world > 1:
        if n_devices is not None and int(n_devices) % world:
            raise ValueError(f"n_devices={n_devices} does not split over "
                             f"{world} processes")
        per = 1 if n_devices is None else int(n_devices) // world
        own = (torch.device("cuda", _dist.local_card())
               if dev.type == "cuda" else dev)
        devs = [own if r == rank else None
                for r in range(world) for _ in range(per)]
        return devs, [r for r in range(world) for _ in range(per)], rank
    if dev.type == "cuda" and dev.index is None:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        devs = cards if n_devices is None else cards[:int(n_devices)]
    else:
        devs = [dev] * (1 if n_devices is None else int(n_devices))
    return devs, [0] * len(devs), 0


def make_mesh(n_devices: int | None = None, lane_devices: int = 1, *,
              device=None) -> Mesh:
    """Build the solve mesh: ``lane_devices`` (dl) positions on the lane
    axis, the rest on the chain axis (``dc * dl`` = the positions).
    ``device`` is the solve device (default the card) or an explicit
    list of devices, one a position (a card may repeat); ``n_devices``
    cuts the positions (see the module docstring). The default ``dl =
    1`` is the chains-only split."""
    devs, owners, rank = _positions(n_devices, device)
    n = len(devs)
    if n < 1:
        raise ValueError("a mesh needs at least one device")
    dl = max(1, int(lane_devices))
    if n % dl:
        raise ValueError(f"lane_devices={dl} does not divide device count "
                         f"{n}")
    mesh = Mesh(devs, n // dl, dl, owners=owners, rank=rank)
    with _MESH_LOCK:
        _MESH_STATE["axes"] = {AXIS: mesh.dc, AXIS_LANES: mesh.dl}
        _MESH_STATE["devices"] = [str(d) if d is not None else "remote"
                                  for d in mesh.devices]
        _MESH_STATE["processes"] = mesh.processes
    return mesh


def mesh_spec(mesh: Mesh) -> tuple[int, int]:
    """The ``(dc, dl)`` axis split of a solve mesh."""
    return mesh.dc, mesh.dl


# ---------------------------------------------------------------------------
# The layout of a solve's state on the mesh: its blocks, the reductions
# of the migration over them, and the steppers' view of the state
# (``sweep``, ``anneal``).

class Block(NamedTuple):
    """A stepper's share of a solve mesh: global chain shards ``c0`` to
    ``c1 - 1`` of lanes ``l0`` to ``l1 - 1`` on ``device`` (None: the
    state's own device). Its state is ``(c1 - c0) * (l1 - l0)`` flat lanes
    in shard order (lane ``c * (l1 - l0) + l`` is shard ``c0 + c``, lane
    ``l0 + l``), one launch of each kernel for all of them."""

    device: object
    c0: int
    c1: int
    l0: int
    l1: int


class Cross:
    """The migration's reductions over the blocks of a mesh: a per-lane
    value of each block (``[lanes of the block, ...]``) combined over
    every block that holds the lane, on this process's cards (copies to
    the first block's device and back, stream-ordered, no host sync) and
    across processes (``mesh.all_reduce``). Trivial (the values as they
    are) when one block holds the whole mesh."""

    _FILL = {"max": _IMIN, "min": _IMAX, "sum": 0}

    def __init__(self, blocks, lanes: int, mesh=None, whole: bool = True):
        self.blocks, self.lanes, self.mesh = blocks, lanes, mesh
        self.trivial = whole

    def __call__(self, vals: list, op: str) -> list:
        if self.trivial:
            return vals
        dev0 = vals[0].device
        g = torch.full((self.lanes, *vals[0].shape[1:]), self._FILL[op],
                       dtype=vals[0].dtype, device=dev0)
        for b, v in zip(self.blocks, vals):
            seg, v = g[b.l0:b.l1], v.to(dev0)
            g[b.l0:b.l1] = (torch.maximum(seg, v) if op == "max"
                            else torch.minimum(seg, v) if op == "min"
                            else seg + v)
        if self.mesh is not None and self.mesh.multi:
            g = self.mesh.all_reduce(g, op)
        return [g[b.l0:b.l1].to(v.device) for b, v in zip(self.blocks, vals)]


TRIVIAL = Cross(None, 0)


def owner_rows(blocks, red, own, first_rows, pick, leaves):
    """The migrant of each lane: the owner is the lowest global shard
    index whose ``own`` flag ``[C, L]`` holds (a reduction over every
    shard), its source chain the ``first_rows`` pick of ``pick [C, L,
    N]`` within that shard. ``leaves`` (a list of ``[C*L, N, ...]``
    tensors a block) are read at that chain, packed as one int32 row a
    lane and combined over the blocks (a masked sum: the owner's block
    alone contributes; one block is a selection). Returns ``(rows,
    sizes)``, ``rows`` one ``[L, W]`` tensor a block, ``sizes`` each
    leaf's width in it."""
    owners = red([torch.where(ow, torch.arange(
        b.c0, b.c1, device=ow.device)[:, None], _IMAX).amin(0)
        for b, ow in zip(blocks, own)], "min")
    rows = []
    for b, pk, lv, o in zip(blocks, pick, leaves, owners):
        C, L, N = pk.shape
        oc = (o - b.c0).clamp(0, C - 1)
        li = torch.arange(L, device=pk.device)
        src = first_rows(pk[oc, li])
        chain = (oc * L + li) * N + src
        row = torch.cat([x.reshape(C * L * N, -1)[chain] for x in lv], 1)
        if not red.trivial:
            mine = (o >= b.c0) & (o < b.c1)
            row = torch.where(mine[:, None], row, 0)
        rows.append(row)
    sizes = [int(np.prod(x.shape[2:])) for x in leaves[0]]
    return red(rows, "sum"), sizes


def put_rows(x, fi, val):
    """``x`` (``[C*L, N, ...]``) with the flat chains ``fi`` (rows of its
    ``[C*L*N, ...]`` view) set to the rows of ``val``, in a fresh
    tensor."""
    flat = x.reshape(-1, *x.shape[2:])
    return flat.index_copy(0, fi, val.reshape(-1, *x.shape[2:])).view(
        x.shape)


def _flat_keys(keys):
    """A block's keys as rows ``[lanes, 2]``: host keys as a private
    ``uint32`` copy, device keys as a view (never written in place)."""
    if isinstance(keys, torch.Tensor):
        return keys.reshape(-1, 2)
    return np.array(keys, np.uint32).reshape(-1, 2)


class Layout:
    """How a stepper's state lies on a solve mesh: ``split`` turns the
    state into one flat block a :class:`Block` (leaves ``[C*L, N, ...]``,
    keys ``[C*L, 2]``, host or device keys, :func:`_flat_keys`), ``join``
    turns the blocks
    back, ``gather`` assembles one per-block output ``[C*L, ...]`` into
    the global one, ``models`` gives each block its model of ``C*L``
    lanes on its device.

    Without a mesh the state is the one-shard layout (leaves ``[L, N,
    ...]``, or ``[N, ...]`` for a single model, ``solo``). On a mesh
    whose one block holds every shard (one process, one device) the
    leaves are the reference's global ``[C, L, N, ...]`` (``[C, N, ...]``
    solo) and the outputs ``[C, L, ...]`` (``[C, ...]``); over several
    blocks each leaf is a tuple of the blocks' ``[C_b, L_b, N, ...]``
    tensors, and the outputs are gathered on the first block's device
    (summed over the processes of a process group)."""

    def __init__(self, mesh, lanes: int, solo: bool):
        self.mesh, self.L, self.solo = mesh, lanes, solo
        if mesh is None:
            self.blocks = [Block(None, 0, 1, 0, lanes)]
            self.C, self.whole = 1, True
        else:
            self.blocks = mesh.blocks(lanes)
            self.C = mesh.size
            self.whole = not mesh.multi and len(self.blocks) == 1
        self.red = Cross(self.blocks, lanes, mesh, self.whole)

    def split(self, state) -> list:
        a, best_k, best_mv, best_a, keys = state
        if self.mesh is None:
            leaves = (a, best_k, best_mv, best_a)
            if self.solo:
                leaves = tuple(x[None] for x in leaves)
            return [[*leaves, _flat_keys(keys)]]
        per = [(a, best_k, best_mv, best_a, keys)] if self.whole else list(
            zip(a, best_k, best_mv, best_a, keys))
        # the leading axes [C_b] (solo) or [C_b, L_b] flatten to lanes
        n = 1 if self.solo else 2
        return [[x.reshape(-1, *x.shape[n:]) for x in leaves[:4]]
                + [_flat_keys(leaves[4])]
                for leaves in per]

    def _unflat(self, b: Block, x):
        C, L = b.c1 - b.c0, b.l1 - b.l0
        return (x.reshape(C, *x.shape[1:]) if self.solo
                else x.reshape(C, L, *x.shape[1:]))

    def join(self, blocks) -> tuple:
        if self.mesh is None:
            a, bk, bm, ba, keys = blocks[0]
            if self.solo:
                return a[0], bk[0], bm[0], ba[0], keys[0]
            return a, bk, bm, ba, keys
        per = []
        for b, st in zip(self.blocks, blocks):
            C, L = b.c1 - b.c0, b.l1 - b.l0
            keys = st[4].reshape((C, 2) if self.solo else (C, L, 2))
            per.append(tuple(self._unflat(b, x) for x in st[:4]) + (keys,))
        if self.whole:
            return per[0]
        return tuple(tuple(x) for x in zip(*per))

    def gather(self, xs: list):
        """One output a block (``[C_b*L_b, ...]``) as the global output
        (see the class)."""
        if self.mesh is None:
            return xs[0][0] if self.solo else xs[0]
        if self.whole:
            return self._unflat(self.blocks[0], xs[0])
        x0 = xs[0]
        boolean = x0.dtype == torch.bool
        dt = torch.int32 if boolean else x0.dtype
        g = torch.zeros((self.C, self.L, *x0.shape[1:]), dtype=dt,
                        device=x0.device)
        for b, x in zip(self.blocks, xs):
            g[b.c0:b.c1, b.l0:b.l1] = x.reshape(
                b.c1 - b.c0, b.l1 - b.l0, *x.shape[1:]).to(g.device, dt)
        if self.mesh.multi:
            g = self.mesh.all_reduce(g, "sum")
        if boolean:
            g = g > 0
        return g[:, 0] if self.solo else g

    def models(self, m: ModelArrays) -> list:
        """Each block's model: its lanes of the stacked model ``m`` on its
        device, repeated over its shards (``arrays.shard_models``)."""
        if self.mesh is None:
            return [m]
        out = []
        for b in self.blocks:
            mb = model_on(m, b.device)
            if (b.l0, b.l1) != (0, self.L):
                mb = lane_range(mb, b.l0, b.l1)
            out.append(shard_models(mb, b.c1 - b.c0))
        return out

    def any(self, flags: list) -> list:
        """Whether any block's flag (a device bool scalar a block) holds,
        on every block and process alike: one device bool scalar a block,
        combined on the first block's device (copies between cards, no
        host read) and across processes (``mesh.all_reduce``)."""
        if self.whole:
            return flags
        dev0 = flags[0].device
        hit = torch.stack([f.to(dev0) for f in flags]).any()
        if self.mesh is not None and self.mesh.multi:
            hit = self.mesh.all_reduce(
                hit.to(torch.int32).reshape(1), "max")[0] > 0
        return [hit.to(f.device) for f in flags]


# ---------------------------------------------------------------------------
# The per-bucket sharding search: candidate splits are timed through the
# real ``solve_lanes`` path and the winner persists in an evidence table
# keyed by bucket; the chooser never guesses.

MESH_ENV = "KAO_MESH_SHARDING"
# evidence quorum: a spec competes only after this many timed solves
MESH_MIN_SOLVES = 2

_MESH_LOCK = threading.Lock()
# the last-built mesh's axis sizes (healthz/metrics) and running counters
_MESH_STATE: dict = {"axes": {AXIS: 1, AXIS_LANES: 1}, "devices": [],
                     "processes": 1}
_MESH_COUNTERS = {"search_evals": 0, "reshard_bytes": 0}
# bucket key -> spec "dcxdl" -> {"solves", "device_s", "lanes"}
_SHARD_EVIDENCE: dict[tuple, dict[str, dict]] = {}


def _spec_str(spec: tuple[int, int]) -> str:
    return f"{spec[0]}x{spec[1]}"


def parse_mesh_sharding(val: str | None = None):
    """Parse ``KAO_MESH_SHARDING`` (or an explicit ``val``):
    ``("auto", None)`` | ``("off", None)`` | ``("spec", (dc, dl))`` |
    ``("invalid", None)``. An invalid value takes the default split (a
    typo never fails a solve); the snapshot shows the raw value."""
    if val is None:
        val = os.environ.get(MESH_ENV, "auto")
    v = str(val).strip().lower()
    if v in ("", "auto"):
        return ("auto", None)
    if v in ("off", "0", "none", "false"):
        return ("off", None)
    m = re.fullmatch(r"(\d+)x(\d+)", v)
    if m and int(m.group(1)) > 0 and int(m.group(2)) > 0:
        return ("spec", (int(m.group(1)), int(m.group(2))))
    return ("invalid", None)


def candidate_shardings(n_dev: int, lanes: int) -> list[tuple[int, int]]:
    """Every ``(dc, dl)`` with ``dc * dl == n_dev`` and ``dl`` dividing
    the lane count; the default chains-only split first."""
    out = []
    for dl in range(1, max(1, int(n_dev)) + 1):
        if n_dev % dl or dl > lanes or lanes % dl:
            continue
        out.append((n_dev // dl, dl))
    return out


def note_sharding_evidence(bucket_key: tuple, spec: tuple[int, int], *,
                           lanes: int, solves: int,
                           device_s: float) -> None:
    """File one observation for (bucket, spec): ``solves`` lane dispatches
    taking ``device_s`` seconds at width ``lanes``. Production dispatches
    and search evaluations both land here."""
    if solves <= 0 or device_s <= 0:
        return
    with _MESH_LOCK:
        rows = _SHARD_EVIDENCE.setdefault(tuple(bucket_key), {})
        row = rows.setdefault(_spec_str(spec),
                              {"solves": 0, "device_s": 0.0,
                               "lanes": int(lanes)})
        row["solves"] += int(solves)
        row["device_s"] += float(device_s)
        row["lanes"] = int(lanes)


def choose_sharding(bucket_key: tuple | None, n_dev: int, lanes: int, *,
                    multi: bool = False) -> tuple[int, int]:
    """The (dc, dl) split of one dispatch site. Precedence: an explicit
    ``KAO_MESH_SHARDING=<dc>x<dl>`` that fits the bucket (else the
    default), ``off`` -> default, else the evidence table: the spec with
    the best lane-solve throughput among those with ``MESH_MIN_SOLVES``
    observations, the default until a challenger qualifies AND beats a
    qualified default. A process group (``multi``) always takes the
    default: evidence is per process, and diverging choices would fork
    the program across processes."""
    default = (max(1, int(n_dev)), 1)
    mode, spec = parse_mesh_sharding()
    if mode in ("off", "invalid"):
        return default
    if mode == "spec":
        dc, dl = spec
        if dc * dl == n_dev and lanes % dl == 0 and dl <= lanes:
            return (dc, dl)
        return default
    if multi or n_dev <= 1 or lanes <= 1 or bucket_key is None:
        return default
    valid = set(candidate_shardings(n_dev, lanes))
    with _MESH_LOCK:
        rows = dict(_SHARD_EVIDENCE.get(tuple(bucket_key), {}))
    best, best_rate = default, -1.0
    for name, row in rows.items():
        if row["solves"] < MESH_MIN_SOLVES or row["device_s"] <= 0:
            continue
        try:
            dc, dl = (int(x) for x in name.split("x"))
        except ValueError:
            continue
        if (dc, dl) not in valid:
            continue
        rate = row["solves"] * row["lanes"] / row["device_s"]
        if rate > best_rate or (rate == best_rate and (dc, dl) == default):
            best, best_rate = (dc, dl), rate
    if best != default and best_rate > 0:
        d_row = rows.get(_spec_str(default))
        if d_row is None or d_row["solves"] < MESH_MIN_SOLVES:
            return default
        d_rate = d_row["solves"] * d_row["lanes"] / d_row["device_s"]
        if d_rate >= best_rate:
            return default
    return best


def make_solve_mesh(n_devices: int | None = None, *,
                    lanes: int | None = None,
                    bucket_key: tuple | None = None,
                    engine: str = "sweep", multi: bool = False,
                    device=None) -> Mesh:
    """The engine's mesh for one dispatch site: a multi-lane sweep
    dispatch over several devices gets the split :func:`choose_sharding`
    picks; single-model sites, the chain engine, one-position meshes and
    meshes whose every position is on one device get the chains-only
    split."""
    mesh = make_mesh(n_devices, device=device)
    n = mesh.size
    # every position on one device: each split is the same one block
    # (Mesh.blocks), the same launches on the same state, so there is
    # nothing to choose, and neither the evidence nor KAO_MESH_SHARDING
    # is read
    if (lanes is None or lanes <= 1 or engine != "sweep" or n <= 1
            or len(set(mesh.devices)) == 1):
        return mesh
    _dc, dl = choose_sharding(bucket_key, n, lanes, multi=multi)
    return mesh if dl == 1 else make_mesh(n_devices, lane_devices=dl,
                                          device=device)


def _state_blocks(state, mesh: Mesh, lanes: int) -> list:
    """A sweep state's leaves grouped by the mesh's blocks."""
    blocks = mesh.blocks(lanes)
    leaves = state[:4]
    if len(blocks) == 1 and not isinstance(leaves[0], tuple):
        return [(blocks[0], leaves)]
    return list(zip(blocks, zip(*leaves)))


def note_reshard(state, mesh: Mesh, lanes: int = 1) -> None:
    """Count the bytes of a carried state that arrive at a dispatch off
    the device of the mesh block that runs them (the copy the dispatch
    then makes): zero on every chunk boundary of a solve, whose state
    stays where its block runs; surfaced as
    ``kao_mesh_reshard_bytes_total``."""
    def where(d):
        # a device without an index is the current one ("cuda" is the
        # current card, "cpu" is "cpu:0")
        if d.index is not None:
            return d.type, d.index
        return d.type, (torch.cuda.current_device() if d.type == "cuda"
                        else 0)

    bad = 0
    for b, leaves in _state_blocks(state, mesh, lanes):
        for x in leaves:
            if isinstance(x, torch.Tensor) and where(x.device) != where(
                    b.device):
                bad += x.numel() * x.element_size()
    if bad:
        with _MESH_LOCK:
            _MESH_COUNTERS["reshard_bytes"] += bad


def mesh_counters() -> dict:
    with _MESH_LOCK:
        return dict(_MESH_COUNTERS)


def mesh_snapshot() -> dict:
    """The /healthz evidence: the last-built mesh's axis sizes, devices
    and processes, the env override mode, the running counters, and the
    per-bucket evidence table with each bucket's current choice."""
    mode, spec = parse_mesh_sharding()
    with _MESH_LOCK:
        axes = dict(_MESH_STATE.get("axes") or {})
        devices = list(_MESH_STATE.get("devices") or [])
        counters = dict(_MESH_COUNTERS)
        table = {k: {s: dict(row) for s, row in rows.items()}
                 for k, rows in _SHARD_EVIDENCE.items()}
    n_dev = axes.get(AXIS, 1) * axes.get(AXIS_LANES, 1)
    buckets = {}
    for k, rows in sorted(table.items()):
        lanes = max((row["lanes"] for row in rows.values()), default=1)
        buckets["x".join(str(x) for x in k)] = {
            "chosen": _spec_str(choose_sharding(k, n_dev, lanes)),
            "evidence": rows,
        }
    return {
        "axes": axes,
        "devices": devices,
        "sharding_mode": mode,
        "sharding_env": os.environ.get(MESH_ENV, ""),
        "forced_spec": _spec_str(spec) if spec else None,
        "min_solves": MESH_MIN_SOLVES,
        "counters": counters,
        "buckets": buckets,
    }


def reset_mesh_adapt() -> None:
    """Drop the sharding evidence and the counters."""
    with _MESH_LOCK:
        _SHARD_EVIDENCE.clear()
        for k in _MESH_COUNTERS:
            _MESH_COUNTERS[k] = 0


# which raw lane counts each lane-padded bucket has served: (brokers,
# racks, part-bucket, rf-bucket) -> lane buckets, lane counts, dispatches
_LANE_SERVED: dict[tuple, dict] = {}
_LANE_SERVED_LOCK = threading.Lock()


def note_lane_serve(bucket_key: tuple, lanes: int,
                    lane_bucket: int) -> None:
    """Record one lane dispatch: ``bucket_key`` is (brokers, racks,
    part-bucket, rf-bucket); ``lanes`` the raw width, ``lane_bucket`` the
    padded width dispatched."""
    with _LANE_SERVED_LOCK:
        row = _LANE_SERVED.setdefault(
            tuple(bucket_key),
            {"lane_buckets": set(), "served_lane_counts": set(),
             "dispatches": 0},
        )
        row["lane_buckets"].add(int(lane_bucket))
        row["served_lane_counts"].add(int(lanes))
        row["dispatches"] += 1


def lane_serve_report() -> dict:
    """``{'BxKxPxR': {lane_buckets, served_lane_counts, dispatches}}``."""
    with _LANE_SERVED_LOCK:
        rows = {k: dict(v) for k, v in _LANE_SERVED.items()}
    return {
        "x".join(str(x) for x in k): {
            "lane_buckets": sorted(v["lane_buckets"]),
            "served_lane_counts": sorted(v["served_lane_counts"]),
            "dispatches": v["dispatches"],
        }
        for k, v in sorted(rows.items())
    }


def _pack(mesh: Mesh, per_block: list) -> tuple:
    """Per-block state tuples as the state: each leaf one tensor when one
    block holds the whole mesh, else a tuple of the blocks' leaves."""
    if len(per_block) == 1 and not mesh.multi:
        return per_block[0]
    return tuple(tuple(x) for x in zip(*per_block))


def init_sweep_state(m: ModelArrays, a_seed: torch.Tensor, key,
                     n_chains: int, mesh: Mesh | None = None):
    """Initial sweep state: every chain starts at the seed, and every
    per-chain best snapshot starts AT the seed, so the engine never
    returns a plan that ranks below it. The population and snapshot
    leaves are two independent buffers (never two views of one
    broadcast): the stepper may later hand either to a kernel that
    writes its output beside it. The seed is scored, and its moves
    counted, by B1 (its plain version on the CPU), once a block.

    Without ``mesh``: one shard, leaves ``[N, ...]``, the key the first
    of ``split(key, 1)``. On a mesh: C shards, leaves ``[C, N, ...]``,
    shard c's key ``split(key, C)[c]`` (the reference's layout)."""
    from ..solvers.tpu.sweep import out_key

    if mesh is None:
        a = a_seed.to(torch.int32)[None]
        out, _c, _l, _r = score(m, a)
        k0, mv0 = out_key(out)[0], out[0, 5]
        pop = a.repeat(n_chains, 1, 1)
        return (pop, k0.repeat(n_chains), mv0.repeat(n_chains), pop.clone(),
                prng.split(key, 1)[0])
    keys = prng.split(key, mesh.size)
    per = []
    for b in mesh.blocks(1):
        C = b.c1 - b.c0
        mb = model_on(m, b.device)
        a = a_seed.to(b.device, torch.int32)[None]
        out, _c, _l, _r = score(mb, a)
        k0, mv0 = out_key(out)[0], out[0, 5]
        pop = a[None].repeat(C, n_chains, 1, 1)
        per.append((pop, k0.repeat(C, n_chains), mv0.repeat(C, n_chains),
                    pop.clone(), keys[b.c0:b.c1].copy()))
    return _pack(mesh, per)


def init_lane_state(m_stack: ModelArrays, lane_seeds, keys, n_chains: int,
                    mesh: Mesh | None = None):
    """Initial sweep state of L lanes: lane l's slice is exactly what
    :func:`init_sweep_state` builds for lane l's model, seed
    ``lane_seeds[l]`` and key ``keys[l]`` (``a [L, N, P, R]``, ranks
    ``[L, N]``, keys ``uint32[L, 2]``; on a mesh ``[C, L, ...]`` with
    shard c of lane l keyed ``split(keys[l], C)[c]``, each lane's key
    split over the shards then transposed, as the reference draws them).
    The seeds are scored, and their moves counted, by one B1 launch a
    block for every lane."""
    from ..solvers.tpu.sweep import best_key

    seeds_np = np.asarray(lane_seeds, np.int32)
    L = seeds_np.shape[0]
    keys = np.asarray(keys, np.uint32).reshape(L, 2)
    blocks = ([Block(m_stack.device, 0, 1, 0, L)] if mesh is None
              else mesh.blocks(L))
    # [C, L, 2]: each lane's key split over the shards, transposed
    shard_keys = np.stack([prng.split(k, 1 if mesh is None else mesh.size)
                           for k in keys], 1)
    per = []
    for b in blocks:
        C = b.c1 - b.c0
        mb = model_on(m_stack, b.device)
        if (b.l0, b.l1) != (0, L):
            mb = lane_range(mb, b.l0, b.l1)
        seeds = torch.tensor(seeds_np[b.l0:b.l1], device=b.device)
        out, _c, _l, _r = score_lanes(mb, seeds[:, None])
        k0 = best_key(out[:, 0, 0], out[:, 0, 1:5].sum(-1, dtype=torch.int32))
        mv0 = out[:, 0, 5]
        pop = seeds[None, :, None].repeat(C, 1, n_chains, 1, 1)
        per.append((pop, k0[None, :, None].repeat(C, 1, n_chains),
                    mv0[None, :, None].repeat(C, 1, n_chains), pop.clone(),
                    shard_keys[b.c0:b.c1, b.l0:b.l1].copy()))
    if mesh is None:
        return tuple(x[0] for x in per[0])
    return _pack(mesh, per)


def solve_lanes(m_stack: ModelArrays, n_chains: int, temps, state=None,
                lane_seeds=None, keys=None, engine: str = "sweep",
                steps_per_round: int = 1, scorer: str = "torch",
                mesh: Mesh | None = None):
    """Run L same-bucket lanes (the stacked model ``m_stack``) through one
    schedule chunk. Sweep engine: pass ``state`` from
    :func:`init_lane_state` (or a previous chunk), or ``lane_seeds [L, P,
    R]`` and ``keys [L, 2]`` to build it; returns ``(state', best_a [L,
    P, R], best_k [L], curve [L, sweeps])`` through the lane stepper (one
    launch of each kernel for every lane). Chain engine (no kernel in
    either package): pass ``lane_seeds`` and ``keys``; every lane's
    chains run as one chain axis (``anneal.make_lane_solver_fn``), each
    lane on its model with its own key, as the reference's ``vmap`` does
    per lane; returns ``(best_a, best_k, curve)`` with the same lane
    axes. On a ``mesh`` every output gains the leading shard axis ``[C,
    ...]`` (each shard's winners), as the reference's sharded dispatch
    returns them."""
    if engine == "sweep":
        from ..solvers.tpu.sweep import make_lane_stepper_fn

        if state is None:
            if lane_seeds is None or keys is None:
                raise ValueError(
                    "sweep lanes need state= or (lane_seeds=, keys=)")
            state = init_lane_state(m_stack, lane_seeds, keys, n_chains,
                                    mesh)
        elif mesh is not None:
            note_reshard(state, mesh, m_stack.num_lanes)
        return make_lane_stepper_fn(n_chains, scorer=scorer, mesh=mesh)(
            m_stack, state, temps)
    from ..solvers.tpu.anneal import make_lane_solver_fn

    seeds = torch.tensor(np.asarray(lane_seeds, np.int32),
                         device=m_stack.device)
    return make_lane_solver_fn(n_chains, steps_per_round, mesh)(
        m_stack, seeds, keys, temps)


def _mega_args(temps_stack, active, cert_k, cert_mv) -> tuple:
    """A fused group's runtime arguments: every step active and the
    never-firing certificate sentinels (a disarmed group) unless the
    caller passes its own."""
    from ..solvers.tpu.sweep import MEGA_DISARMED_KEY, MEGA_DISARMED_MOVES

    temps_stack = np.asarray(temps_stack, np.float32)
    if active is None:
        active = np.ones(temps_stack.shape[0], bool)
    return (temps_stack, np.asarray(active, bool),
            MEGA_DISARMED_KEY if cert_k is None else int(cert_k),
            MEGA_DISARMED_MOVES if cert_mv is None else int(cert_mv))


def solve_megachunk(m: ModelArrays, n_chains: int, temps_stack, state, *,
                    active=None, cert_k=None, cert_mv=None,
                    scorer: str = "torch", mesh: Mesh | None = None):
    """One fused group over K chunk steps: ``temps_stack [K, c]`` (a
    short tail pads ``temps_stack`` and clears ``active``), ``state`` from
    :func:`init_sweep_state` or any prior chunk or group. Returns
    ``(state', top_a [P, R], top_k, cert_a [P, R], cert_ok, cert_mv,
    curves [K, c], execd [K])`` (``sweep.make_mega_stepper_fn``; on a
    ``mesh`` each ``[C, ...]``). Omitting the certificate arguments runs
    the group disarmed. On a card with every shard on it the group runs
    as replays of its bucket's CUDA graph (``sweep.make_mega_stepper_fn``)."""
    from ..solvers.tpu.sweep import make_mega_stepper_fn

    return make_mega_stepper_fn(n_chains, scorer=scorer, mesh=mesh)(
        m, state, *_mega_args(temps_stack, active, cert_k, cert_mv))


def solve_lanes_megachunk(m_stack: ModelArrays, n_chains: int, temps_stack,
                          state, *, active=None, cert_k=None, cert_mv=None,
                          scorer: str = "torch", mesh: Mesh | None = None):
    """:func:`solve_megachunk` over the L lanes of ``m_stack`` (every
    kernel one launch for all lanes a step): ``curves [L, K, c]``,
    ``execd [L, K]`` (``[C, L, ...]`` on a ``mesh``). Batch callers
    leave the certificate arguments at their disarmed defaults
    (independent instances never share an exit); the portfolio arms
    them, so the first lane to qualify stops every lane."""
    from ..solvers.tpu.sweep import make_mega_lane_stepper_fn

    if mesh is not None:
        note_reshard(state, mesh, m_stack.num_lanes)
    return make_mega_lane_stepper_fn(n_chains, scorer=scorer, mesh=mesh)(
        m_stack, state, *_mega_args(temps_stack, active, cert_k, cert_mv))


def solve_on_mesh(m: ModelArrays, a_seed: torch.Tensor, key, mesh: Mesh,
                  chains_per_device: int, rounds: int,
                  steps_per_round: int, t_hi: float = 2.5,
                  t_lo: float = 0.05, engine: str = "chain", temps=None,
                  scorer: str = "torch", state=None):
    """Run the annealer over ``mesh``; returns each shard's winners
    ``(best_a [C, P, R], best_k [C], curve [C, rounds])``. ``temps`` (a
    schedule segment) overrides ``geometric_temps(t_hi, t_lo, rounds)``.
    The sweep engine is stateful: pass ``state`` (from
    :func:`init_sweep_state` or a previous chunk) and the return is
    ``(state', best_a, best_k, curve)``; without one the seed is expanded
    into a fresh state first. The chain engine's shard keys are
    ``split(key, C)``."""
    from ..solvers.tpu.arrays import geometric_temps

    if temps is None:
        temps = geometric_temps(t_hi, t_lo, rounds)
    if engine == "sweep":
        from ..solvers.tpu.sweep import make_sweep_stepper_fn

        if state is None:
            state = init_sweep_state(m, a_seed, key, chains_per_device, mesh)
        return make_sweep_stepper_fn(chains_per_device, scorer=scorer,
                                     mesh=mesh)(m, state, temps)
    from ..solvers.tpu.anneal import make_solver_fn

    return make_solver_fn(chains_per_device, steps_per_round, mesh)(
        m, a_seed, key, temps)


def _wait(t: torch.Tensor) -> None:
    """Wait for the current stream of ``t``'s device (never a device-wide
    sync: another thread may be capturing a CUDA graph)."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


def run_sharding_search(m_stack: ModelArrays, lane_seeds, keys, temps, *,
                        n_devices: int | None, chains_per_device: int,
                        bucket_key: tuple, scorer: str = "torch",
                        repeats: int = 1, check_parity: bool = True,
                        device=None) -> list[dict]:
    """Time every candidate (dc x dl) split of this bucket through the
    real :func:`solve_lanes` path, file the observations in the evidence
    table, and return one row a candidate (``spec``, ``warm_s``,
    ``lanes_per_s``, ``parity_vs_default``). Each candidate's first run
    is excluded from the timing; each timed repeat starts from a fresh
    state. With ``check_parity`` every split's winners (``best_a`` and
    ``best_k`` of every shard) are held to the default split's and a
    mismatch raises: the parity contract as a runtime check. Production
    solves only read the table."""
    lane_seeds = np.asarray(lane_seeds, np.int32)
    lanes = int(lane_seeds.shape[0])
    n = make_mesh(n_devices, device=device).size
    results = []
    base = None
    for dc, dl in candidate_shardings(n, lanes):
        mesh = make_mesh(n_devices, lane_devices=dl, device=device)
        device_s = warm_s = 0.0
        n_timed = 0
        for r in range(int(repeats) + 1):
            state = init_lane_state(m_stack, lane_seeds, keys,
                                    chains_per_device, mesh)
            t0 = time.perf_counter()
            _st, best_a, best_k, _curve = solve_lanes(
                m_stack, chains_per_device, temps, state=state,
                scorer=scorer, mesh=mesh)
            _wait(best_k)
            dt = time.perf_counter() - t0
            if r > 0:
                device_s += dt
                warm_s = dt if n_timed == 0 else min(warm_s, dt)
                n_timed += 1
        got = (best_a.cpu().numpy(), best_k.cpu().numpy())
        parity = None
        if check_parity:
            if base is None:
                base, parity = got, True
            else:
                parity = all(np.array_equal(x, y) for x, y in zip(base, got))
                if not parity:
                    raise AssertionError(
                        f"sharding {dc}x{dl} diverged from the default "
                        "split's winners")
        note_sharding_evidence(bucket_key, (dc, dl), lanes=lanes,
                               solves=max(n_timed, 1), device_s=device_s)
        with _MESH_LOCK:
            _MESH_COUNTERS["search_evals"] += 1
        results.append({"spec": _spec_str((dc, dl)), "warm_s": warm_s,
                        "lanes_per_s": lanes / warm_s if warm_s > 0 else 0.0,
                        "parity_vs_default": parity})
    return results


def best_of(best_a, best_k, curve=None):
    """The host's argmax over the shards' winners (first index among
    ties): ``(best_a [P, R] numpy, best_k int)``. Kept for API parity
    with the reference's ``best_of``: the engine's final selection
    rescores its own candidate pool and does not call it."""
    ba = np.asarray(best_a.cpu() if isinstance(best_a, torch.Tensor)
                    else best_a)
    bk = np.asarray(best_k.cpu() if isinstance(best_k, torch.Tensor)
                    else best_k)
    top = int(np.argmax(bk))
    return ba[top], int(bk[top])


class _AsyncFetch:
    """An in-flight device-to-host copy of a tensor or a tuple of tensors
    (:func:`fetch_global_async`). On the card each tensor is copied with
    ``non_blocking=True`` into pinned host memory on the current stream,
    and an event is recorded after the copies: it completes once every
    launch enqueued before the fetch has finished, so :meth:`wait` also
    retires the work that produced the tensors. On the CPU the copy is
    made at once. :meth:`get` returns numpy, idempotently."""

    __slots__ = ("_host", "_event", "_tuple")

    def __init__(self, x):
        self._tuple = isinstance(x, (tuple, list))
        xs = tuple(x) if self._tuple else (x,)
        self._event = None
        if any(t.device.type == "cuda" for t in xs):
            self._host = []
            for t in xs:
                dst = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                                  pin_memory=True)
                dst.copy_(t, non_blocking=True)
                self._host.append(dst)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = [t.detach().clone() for t in xs]

    def wait(self) -> None:
        """Block until the copy (and all work enqueued before it) is
        done."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None

    def get(self):
        self.wait()
        out = tuple(h.numpy() for h in self._host)
        return out if self._tuple else out[0]


def fetch_global_async(x) -> _AsyncFetch:
    """Start the device-to-host copy of ``x`` (a tensor or a tuple of
    tensors) without waiting: the ladder starts each chunk's copies right
    after enqueueing the chunk, ahead of the next chunk's launches, so
    the copies are not queued behind them."""
    return _AsyncFetch(x)
