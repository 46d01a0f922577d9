"""The exchange sweep on the card: B4+B5 (one exchange proposal with its
thinning maps) and B6 (keep, apply, leader-histogram delta), with their
plain PyTorch versions.

B4+B5 replaces ``kafka_assignment_optimizer_tpu/ops/propose_pallas.py:424``
(``_exchange_kernel``) and ``kafka_assignment_optimizer_tpu/ops/
thin_pallas.py:247`` (``_exch_maps_kernel``): one launch draws the random
words and each chain's pairing phase (threefry in registers), evaluates
both halves of every pair, accepts, and max-accumulates the maps; see
``csrc/exchange.cu``. Its plain version is ``sweep.exchange_propose``.

B6 replaces ``thin_pallas.py:277`` (``_exch_finish_kernel``); see
``csrc/thin.cu``. Its plain version is ``sweep.exch_finish``.

Each wrapper launches its kernel for CUDA tensors and runs its plain
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
    exch_finish as exch_finish_plain,
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


def exchange_propose_cuda(m: ModelArrays, a, lcnt, key, temp: float):
    """One exchange proposal and its maps: ``((s, b_other, tok_out,
    tok_in, prio), m_out, m_in)``, the records B6 reads, each [N, P],
    and the maps [N, B+1]. The fused kernel for CUDA tensors (one zero
    fill of the maps and one launch), the plain version
    (``sweep.exchange_propose``) for CPU tensors. ``key`` is the sweep's
    host ``uint32[2]`` key, ``temp`` the sweep temperature as a float32
    value."""
    if a.device.type == "cpu":
        p, m_out, m_in = exchange_propose(m, a, lcnt, key, temp)
        return (p.s, p.b_other, p.tok_out, p.tok_in, p.prio), m_out, m_in
    check_model(m)
    N = a.shape[0]
    P, R = m.a0.shape
    B1 = m.num_brokers + 1
    dev = m.a0.device
    check("a", a, torch.int32, (N, P, R), dev)
    check("lcnt", lcnt, torch.int32, (N, B1), dev)
    maps = torch.zeros(2, N, B1, dtype=torch.float32, device=dev)
    kbits, d, k_hi, k_lo = host_keys(key, P)
    rec = torch.empty(5, N, P, dtype=torch.int32, device=dev)
    _blo, _bhi, llo, lhi = m.bands()
    kernels.EXCHANGE(
        a.data_ptr(), m.rf.data_ptr(), m.slot_valid.data_ptr(),
        m.part_rack_hi.data_ptr(), m.w_lead.data_ptr(), m.w_foll.data_ptr(),
        m.rack_of.data_ptr(), lcnt.data_ptr(), *_words(kbits),
        *_words(k_hi), *_words(k_lo), temp, m.lam_host(), d, llo, lhi, N,
        P, R, B1, rec.data_ptr(), maps.data_ptr(),
    )
    s, b_other, tok_out, tok_in, prio = rec.unbind(0)
    return ((s, b_other, tok_out, tok_in, prio.view(torch.float32)),
            maps[0], maps[1])


def exch_finish_cuda(a, s_own, b_other, tok_out, tok_in, prio, m_out,
                     m_in):
    """B6: ``(a_new, d_lcnt)`` of one exchange sweep."""
    if a.device.type == "cpu":
        return exch_finish_plain(a, s_own, b_other, tok_out, tok_in, prio,
                                 m_out, m_in)
    N, P, R = a.shape
    B1 = m_out.shape[1]
    dev = a.device
    check("a", a, torch.int32, (N, P, R), dev)
    for name, t in (("s_own", s_own), ("b_other", b_other),
                    ("tok_out", tok_out), ("tok_in", tok_in)):
        check(name, t, torch.int32, (N, P), dev)
    check("prio", prio, torch.float32, (N, P), dev)
    check("m_out", m_out, torch.float32, (N, B1), dev)
    check("m_in", m_in, torch.float32, (N, B1), dev)
    d_lcnt = torch.zeros(N, B1, dtype=torch.int32, device=dev)
    a_new = torch.empty_like(a)
    kernels.EXCH_FINISH(
        a.data_ptr(), s_own.data_ptr(), b_other.data_ptr(),
        tok_out.data_ptr(), tok_in.data_ptr(), prio.data_ptr(),
        m_out.data_ptr(), m_in.data_ptr(), N, P, R, B1, a_new.data_ptr(),
        d_lcnt.data_ptr(),
    )
    return a_new, d_lcnt


def exchange_step_cuda(m: ModelArrays, a, cnt, lcnt, rcnt, key,
                       temp: float):
    """One exchange sweep with the carried leader histogram updated:
    ``(a_new, cnt, lcnt', rcnt)``. On the card: the maps' zero fill, the
    fused proposal, B6's zero fill and launch, and the ``lcnt`` add, with
    no host sync. For CPU tensors the plain version,
    ``sweep._exchange_sweep_delta``."""
    if a.device.type == "cpu":
        return _exchange_sweep_delta(m, a, cnt, lcnt, rcnt, key, temp)
    if a.shape[1] < 2:
        return a, cnt, lcnt, rcnt
    rec, m_out, m_in = exchange_propose_cuda(m, a, lcnt, key, temp)
    a2, d_lcnt = exch_finish_cuda(a, *rec, m_out, m_in)
    return a2, cnt, lcnt + d_lcnt, rcnt
