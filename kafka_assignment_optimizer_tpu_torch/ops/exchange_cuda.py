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

Each wrapper launches the kernel for CUDA tensors and runs the plain
version for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import prng
from ..solvers.tpu.arrays import ModelArrays
from ..solvers.tpu.sweep import (
    _exchange_sweep_delta,
    _pair_stride,
    exch_finish,
    exchange_propose,
)
from . import kernels
from .kernels import check, check_model


def _words(key) -> tuple[int, int]:
    return tuple(int(w) for w in np.asarray(key, np.uint32).reshape(2))


def host_keys(key, P: int):
    """The host draws of one exchange proposal, as ``propose_exchange``
    makes them: ``(kbits, d, k_hi, k_lo)``, the key of the words ``bits
    [N, P, 4]``, the stride, and the two keys of the phases'
    ``randint``."""
    kd, kbits = prng.split(key)
    d, kph = _pair_stride(kd, P)
    k_hi, k_lo = prng.split(kph)
    return kbits, d, k_hi, k_lo


def exchange_sweep_cuda(m: ModelArrays, a, lcnt, key, temp: float):
    """One exchange sweep, with what it leaves behind: ``(a_new, lcnt',
    (s, b_other, tok_out, tok_in, prio), m_out, m_in)``, the records
    [N, P] and the maps [N, B+1] of its proposal. The fused kernel for
    CUDA tensors (one launch; every output lies in memory the kernel
    fills, allocated uninitialized), the plain versions
    (``sweep.exchange_propose``, then ``sweep.exch_finish``) for CPU
    tensors. ``key`` is the sweep's host ``uint32[2]`` key, ``temp`` the
    sweep temperature as a float32 value."""
    if a.device.type == "cpu":
        p, m_out, m_in = exchange_propose(m, a, lcnt, key, temp)
        rec = (p.s, p.b_other, p.tok_out, p.tok_in, p.prio)
        a2, d_lcnt = exch_finish(a, *rec, m_out, m_in)
        return a2, lcnt + d_lcnt, rec, m_out, m_in
    check_model(m)
    N = a.shape[0]
    P, R = m.a0.shape
    B1 = m.num_brokers + 1
    dev = m.a0.device
    check("a", a, torch.int32, (N, P, R), dev)
    check("lcnt", lcnt, torch.int32, (N, B1), dev)
    kbits, d, k_hi, k_lo = host_keys(key, P)
    a_new = torch.empty_like(a)
    lcnt_new = torch.empty_like(lcnt)
    scratch = torch.empty(5 * N * P + 2 * N * B1 + N, dtype=torch.int32,
                          device=dev)
    _blo, _bhi, llo, lhi = m.bands()
    kernels.EXCHANGE(
        a.data_ptr(), m.rf.data_ptr(), m.slot_valid.data_ptr(),
        m.part_rack_hi.data_ptr(), m.w_lead.data_ptr(), m.w_foll.data_ptr(),
        m.rack_of.data_ptr(), lcnt.data_ptr(), *_words(kbits),
        *_words(k_hi), *_words(k_lo), temp, m.lam_host(), d, llo, lhi, N,
        P, R, B1, a_new.data_ptr(), lcnt_new.data_ptr(), scratch.data_ptr(),
    )
    rec = scratch[:5 * N * P].view(5, N, P)
    maps = scratch[5 * N * P:-N].view(torch.float32).view(2, N, B1)
    s, b_other, tok_out, tok_in, prio = rec.unbind(0)
    return (a_new, lcnt_new,
            (s, b_other, tok_out, tok_in, prio.view(torch.float32)),
            maps[0], maps[1])


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
