"""The one-device subset of the reference's ``parallel.mesh``: the initial
sweep state, the lanes, the fused megachunk groups and the asynchronous
device-to-host fetch.

The reference tiles the population over a device mesh; this package runs
one device, which is the reference's mesh of one: one shard holding all
chains, its RNG key the first of ``split(key, 1)``. Its lane leaves lose
the device axis: the reference's ``a [1, L, N, P, R]`` is ``a [L, N, P,
R]`` here.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import prng
from ..ops.score_cuda import score, score_lanes
from ..solvers.tpu.arrays import ModelArrays, lane_model
from ..solvers.tpu.sweep import best_key, out_key

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


def init_sweep_state(m: ModelArrays, a_seed: torch.Tensor, key,
                     n_chains: int):
    """Initial sweep state: every chain starts at the seed, and every
    per-chain best snapshot starts AT the seed, so the engine never
    returns a plan that ranks below it. The population and snapshot
    leaves are two independent buffers (never two views of one
    broadcast): the stepper may later hand either to a kernel that
    writes its output beside it. The seed is scored, and its moves
    counted, by B1 (its plain version on the CPU)."""
    a = a_seed.to(torch.int32)[None]
    out, _c, _l, _r = score(m, a)
    k0, mv0 = out_key(out)[0], out[0, 5]
    pop = a.repeat(n_chains, 1, 1)
    return (
        pop,
        k0.repeat(n_chains),
        mv0.repeat(n_chains),
        pop.clone(),
        prng.split(key, 1)[0],
    )


def init_lane_state(m_stack: ModelArrays, lane_seeds, keys, n_chains: int):
    """Initial sweep state of L lanes: lane l's slice is exactly what
    :func:`init_sweep_state` builds for lane l's model, seed
    ``lane_seeds[l]`` and key ``keys[l]`` (``a [L, N, P, R]``, ranks
    ``[L, N]``, keys ``uint32[L, 2]``). The seeds are scored, and their
    moves counted, by one B1 launch for every lane."""
    seeds = torch.tensor(np.asarray(lane_seeds, np.int32),
                         device=m_stack.device)
    L = seeds.shape[0]
    out, _c, _l, _r = score_lanes(m_stack, seeds[:, None])
    k0 = best_key(out[:, 0, 0], out[:, 0, 1:5].sum(-1, dtype=torch.int32))
    mv0 = out[:, 0, 5]
    pop = seeds[:, None].repeat(1, n_chains, 1, 1)
    keys = np.asarray(keys, np.uint32).reshape(L, 2)
    return (
        pop,
        k0[:, None].repeat(1, n_chains),
        mv0[:, None].repeat(1, n_chains),
        pop.clone(),
        np.stack([prng.split(k, 1)[0] for k in keys]),
    )


def solve_lanes(m_stack: ModelArrays, n_chains: int, temps, state=None,
                lane_seeds=None, keys=None, engine: str = "sweep",
                steps_per_round: int = 1, scorer: str = "torch"):
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
    axes."""
    if engine == "sweep":
        from ..solvers.tpu.sweep import make_lane_stepper_fn

        if state is None:
            if lane_seeds is None or keys is None:
                raise ValueError(
                    "sweep lanes need state= or (lane_seeds=, keys=)")
            state = init_lane_state(m_stack, lane_seeds, keys, n_chains)
        return make_lane_stepper_fn(n_chains, scorer=scorer)(
            m_stack, state, temps)
    from ..solvers.tpu.anneal import make_lane_solver_fn

    seeds = torch.tensor(np.asarray(lane_seeds, np.int32),
                         device=m_stack.device)
    return make_lane_solver_fn(n_chains, steps_per_round)(
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
                    scorer: str = "torch"):
    """One fused group over K chunk steps: ``temps_stack [K, c]`` (a
    short tail pads ``temps_stack`` and clears ``active``), ``state`` from
    :func:`init_sweep_state` or any prior chunk or group. Returns
    ``(state', top_a [P, R], top_k, cert_a [P, R], cert_ok, cert_mv,
    curves [K, c], execd [K])``
    (``sweep.make_mega_stepper_fn``). Omitting the certificate arguments
    runs the group disarmed."""
    from ..solvers.tpu.sweep import make_mega_stepper_fn

    return make_mega_stepper_fn(n_chains, scorer=scorer)(
        m, state, *_mega_args(temps_stack, active, cert_k, cert_mv))


def solve_lanes_megachunk(m_stack: ModelArrays, n_chains: int, temps_stack,
                          state, *, active=None, cert_k=None, cert_mv=None,
                          scorer: str = "torch"):
    """:func:`solve_megachunk` over the L lanes of ``m_stack`` (every
    kernel one launch for all lanes a step): ``curves [L, K, c]``,
    ``execd [L, K]``. Batch callers leave the certificate arguments at
    their disarmed defaults (independent instances never share an exit);
    the portfolio arms them, so the first lane to qualify stops every
    lane."""
    from ..solvers.tpu.sweep import make_mega_lane_stepper_fn

    return make_mega_lane_stepper_fn(n_chains, scorer=scorer)(
        m_stack, state, *_mega_args(temps_stack, active, cert_k, cert_mv))


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
                dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
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
