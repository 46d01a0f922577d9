"""B5 (exchange maps) and B6 (exchange finish): the CUDA kernels and their
plain PyTorch versions, and the kernel-path exchange sweep that chains
them with B4.

B5 replaces ``kafka_assignment_optimizer_tpu/ops/thin_pallas.py:247``
(``_exch_maps_kernel``); B6 ``thin_pallas.py:277``
(``_exch_finish_kernel``). Both are bound on the card by bytes (one
record and one row per thread); see ``csrc/thin.cu``. Each wrapper
launches its kernel for CUDA tensors and runs its plain version for CPU
tensors.
"""

from __future__ import annotations

import torch

from ..solvers.tpu.arrays import ModelArrays
from ..solvers.tpu.sweep import (
    exch_finish as exch_finish_plain,
    exch_maps as exch_maps_plain,
    propose_exchange,
)
from . import kernels
from .kernels import check
from .propose_cuda import exchange_halves_cuda


def exch_maps_cuda(tok_out, tok_in, prio, width: int):
    """B5: the per-chain max-priority maps ``(m_out, m_in) [N, width]``."""
    if prio.device.type == "cpu":
        return exch_maps_plain(tok_out, tok_in, prio, width)
    N, P = prio.shape
    dev = prio.device
    check("tok_out", tok_out, torch.int32, (N, P), dev)
    check("tok_in", tok_in, torch.int32, (N, P), dev)
    check("prio", prio, torch.float32, (N, P), dev)
    m_out = torch.zeros(N, width, dtype=torch.float32, device=dev)
    m_in = torch.zeros(N, width, dtype=torch.float32, device=dev)
    kernels.EXCH_MAPS(tok_out.data_ptr(), tok_in.data_ptr(), prio.data_ptr(),
                      N, P, width, m_out.data_ptr(), m_in.data_ptr())
    return m_out, m_in


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
    a_new = torch.empty_like(a)
    d_lcnt = torch.zeros(N, B1, dtype=torch.int32, device=dev)
    kernels.EXCH_FINISH(
        a.data_ptr(), s_own.data_ptr(), b_other.data_ptr(),
        tok_out.data_ptr(), tok_in.data_ptr(), prio.data_ptr(),
        m_out.data_ptr(), m_in.data_ptr(), N, P, R, B1, a_new.data_ptr(),
        d_lcnt.data_ptr(),
    )
    return a_new, d_lcnt


def exchange_step_cuda(m: ModelArrays, a, cnt, lcnt, rcnt, key,
                       temp: float):
    """One exchange sweep: the pairing and the combination of the halves
    stay in ``sweep.propose_exchange``, the halves run in B4, the maps
    in B5 and the keep/apply/delta in B6 — the kernel path of
    ``sweep._exchange_sweep_delta``."""
    if a.shape[1] < 2:
        return a, cnt, lcnt, rcnt
    p = propose_exchange(m, a, key, temp, halves=exchange_halves_cuda,
                         lcnt=lcnt)
    m_out, m_in = exch_maps_cuda(p.tok_out, p.tok_in, p.prio,
                                 m.num_brokers + 1)
    a2, d_lcnt = exch_finish_cuda(a, p.s, p.b_other, p.tok_out, p.tok_in,
                                  p.prio, m_out, m_in)
    return a2, cnt, lcnt + d_lcnt, rcnt
