"""The exchange sweep on the card: B4+B5+B6 (the exchange proposals, their
thinning maps, the keep test, the apply and the leader-histogram update)
in one cooperative launch, with its plain PyTorch version.

Replaces ``kafka_assignment_optimizer_tpu/ops/propose_pallas.py:424``
(``_exchange_kernel``) and ``kafka_assignment_optimizer_tpu/ops/
thin_pallas.py:247`` (``_exch_maps_kernel``) and ``:277``
(``_exch_finish_kernel``): one launch draws the random words and each
chain's pairing phase (threefry in registers), evaluates both halves of
every pair, accepts, max-accumulates the maps, and behind a grid-wide
barrier keeps, applies and updates ``lcnt``; see ``csrc/exchange.cu``.
Its plain version is ``sweep._exchange_sweep_delta``: the proposal
``sweep.exchange_propose``, then ``sweep.exch_finish``.

The draws of the sweep key that precede the words (the stride and the
keys of the words and of the phases, :func:`host_keys`) are made in the
kernel's first phase, on the card, from the lane's key in device memory
(its temperature, band and penalty scale are read there too). The lane
forms (:func:`exchange_step_lanes`,
:func:`exchange_sweep_lanes`) sweep the L lanes of a stacked model in one
launch, each with its own key and temperature. Each wrapper launches the
kernel for CUDA tensors and runs the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import prng
from ..solvers.tpu.arrays import ModelArrays, lane_model
from ..solvers.tpu.sweep import (
    _exchange_sweep_delta,
    _pair_stride,
    exch_finish,
    exchange_lanes_delta,
    exchange_propose,
)
from . import kernels
from .kernels import check


def host_keys(key, P: int):
    """The draws of one exchange proposal's host key, as
    ``propose_exchange`` makes them: ``(kbits, d, k_hi, k_lo)``, the key
    of the words ``bits [N, P, 4]``, the stride, and the two keys of the
    phases' ``randint``. The kernel draws the same words on the card
    (``kernels.exchange_host_keys`` runs its C code on the host)."""
    kd, kbits = prng.split(key)
    d, kph = _pair_stride(kd, P)
    k_hi, k_lo = prng.split(kph)
    return kbits, d, k_hi, k_lo


def _plain_sweep(m: ModelArrays, a, lcnt, key, temp: float):
    """The plain versions of one exchange sweep with what it leaves
    behind: ``(a_new, lcnt', records, m_out, m_in)``."""
    p, m_out, m_in = exchange_propose(m, a, lcnt, key, temp)
    rec = (p.s, p.b_other, p.tok_out, p.tok_in, p.prio)
    a2, d_lcnt = exch_finish(a, *rec, m_out, m_in)
    return a2, lcnt + d_lcnt, rec, m_out, m_in


def exchange_sweep_cuda(m: ModelArrays, a, lcnt, key, temp: float):
    """One exchange sweep, with what it leaves behind: ``(a_new, lcnt',
    (s, b_other, tok_out, tok_in, prio), m_out, m_in)``, the records
    [N, P] and the maps [N, B+1] of its proposal. The fused kernel for
    CUDA tensors (one launch; every output lies in memory the kernel
    fills, allocated uninitialized), the plain versions
    (``sweep.exchange_propose``, then ``sweep.exch_finish``) for CPU
    tensors. ``key`` is the sweep's host ``uint32[2]`` key, ``temp`` the
    sweep temperature as a float32 value (or a device key and scalar)."""
    if a.device.type == "cpu":
        return _plain_sweep(m, a, lcnt, key, temp)
    from .site_cuda import _one

    a2, l2, rec, m_out, m_in = _launch(m, a[None], lcnt[None],
                                       *_one(key, temp, a.device))
    return (a2[0], l2[0], tuple(x[0] for x in rec), m_out[0], m_in[0])


def exchange_sweep_lanes(m: ModelArrays, a, lcnt, keys, temps):
    """:func:`exchange_sweep_cuda` for every lane of the stacked model
    ``m`` (``a [L, N, P, R]``, ``lcnt [L, N, B+1]``, lane l with
    ``keys[l]`` and ``temps[l]``): every output gains the lane axis. One
    launch on CUDA tensors, the plain versions lane by lane on CPU
    tensors."""
    if a.device.type == "cpu":
        outs = [_plain_sweep(lane_model(m, lane), a[lane], lcnt[lane],
                             keys[lane], temps[lane])
                for lane in range(a.shape[0])]
        a2, l2, rec, m_out, m_in = zip(*outs)
        return (torch.stack(a2), torch.stack(l2),
                tuple(torch.stack(x) for x in zip(*rec)),
                torch.stack(m_out), torch.stack(m_in))
    return _launch(m, a, lcnt, *kernels.lane_values(keys, temps, a.shape[0],
                                                    a.device))


def exchange_step_cuda(m: ModelArrays, a, cnt, lcnt, rcnt, key,
                       temp: float):
    """One exchange sweep with the carried leader histogram updated:
    ``(a_new, cnt, lcnt', rcnt)``. On the card one device activity, the
    fused launch, and no host sync. For CPU tensors the plain version,
    ``sweep._exchange_sweep_delta``."""
    if a.device.type == "cpu":
        return _exchange_sweep_delta(m, a, cnt, lcnt, rcnt, key, temp)
    if a.shape[1] < 2:
        return a, cnt, lcnt, rcnt
    a2, lcnt2, _rec, _m_out, _m_in = exchange_sweep_cuda(m, a, lcnt, key,
                                                         temp)
    return a2, cnt, lcnt2, rcnt


def exchange_step_lanes(m: ModelArrays, a, cnt, lcnt, rcnt, keys, temps):
    """:func:`exchange_step_cuda` for every lane of the stacked model
    ``m`` (state ``[L, N, ...]``, lane l with ``keys[l]`` and
    ``temps[l]``): one launch on CUDA tensors, the plain version
    (``sweep.exchange_lanes_delta``) on CPU tensors."""
    if a.device.type == "cpu":
        return exchange_lanes_delta(m, a, cnt, lcnt, rcnt, keys, temps)
    if a.shape[2] < 2:
        return a, cnt, lcnt, rcnt
    a2, lcnt2, _rec, _m_out, _m_in = _launch(
        m, a, lcnt, *kernels.lane_values(keys, temps, a.shape[0], a.device))
    return a2, cnt, lcnt2, rcnt


@kernels.in_lane_groups
def _launch(m: ModelArrays, a, lcnt, keys, temps):
    """One launch of the fused exchange sweep on ``a [L, N, P, R]`` with
    the lanes' device keys ``[L, 2]`` and temperatures ``[L]`` (a single
    model is one lane; above ``kernels.MAX_LANES`` lanes, one launch a
    group of lanes)."""
    tabs = kernels.model_tabs(m)
    L, N = a.shape[:2]
    kernels.lane_count(m, L)
    P, R = m.a0.shape[-2:]
    B1 = m.num_brokers + 1
    dev = m.a0.device
    check("a", a, torch.int32, (L, N, P, R), dev)
    check("lcnt", lcnt, torch.int32, (L, N, B1), dev)
    a_new = torch.empty_like(a)
    lcnt_new = torch.empty_like(lcnt)
    # the records, the maps, the phases and the lanes' draws (11 words a
    # lane: csrc/exchange.cu's ExchLane)
    scratch = torch.empty(L * (5 * N * P + 2 * N * B1 + N + 11),
                          dtype=torch.int32, device=dev)
    kernels.EXCHANGE(
        ctypes.byref(tabs), keys.data_ptr(), temps.data_ptr(), L, N, P, R,
        B1,
        a.data_ptr(), lcnt.data_ptr(), a_new.data_ptr(),
        lcnt_new.data_ptr(), scratch.data_ptr(),
    )
    rec = scratch[:5 * L * N * P].view(L, 5, N, P)
    maps = scratch[5 * L * N * P:5 * L * N * P + 2 * L * N * B1].view(
        torch.float32).view(L, 2, N, B1)
    s, b_other, tok_out, tok_in, prio = rec.unbind(1)
    return (a_new, lcnt_new,
            (s, b_other, tok_out, tok_in, prio.view(torch.float32)),
            maps[:, 0], maps[:, 1])
