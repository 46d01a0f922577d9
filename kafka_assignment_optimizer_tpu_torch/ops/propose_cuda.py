"""B2 (site proposals) and B4 (exchange half-deltas): the CUDA kernels and
their plain PyTorch versions.

B2 replaces ``kafka_assignment_optimizer_tpu/ops/propose_pallas.py:66``
(``_propose_kernel``): one site proposal per (chain, partition), with the
per-chain thinning priority maps. B4 replaces
``kafka_assignment_optimizer_tpu/ops/propose_pallas.py:424``
(``_exchange_kernel``): the per-partition half of a pair-exchange delta.

Both are bound on the card by bytes and gather latency (one thread per
(chain, partition), a few table lookups each); see ``csrc/propose.cu``.
Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors.
"""

from __future__ import annotations

import torch

from ..solvers.tpu.arrays import ModelArrays
from ..solvers.tpu.sweep import (
    SiteProposals,
    _carried,
    exchange_halves as exchange_halves_plain,
    propose_site,
    site_maps,
)
from . import kernels
from .kernels import check


def propose_site_plain(m: ModelArrays, a, bits, temp: float, cnt, lcnt,
                       rcnt):
    """The plain version of B2: ``(SiteProposals, m_out, m_in)``."""
    p = propose_site(m, a, bits, temp, hists=_carried(cnt, lcnt, rcnt))
    return (p, *site_maps(m, p))


def _check_model(m: ModelArrays, P: int, R: int, dev) -> None:
    B1 = m.num_brokers + 1
    K1 = m.rack_lo.shape[0]
    if R > 16:
        raise ValueError(f"the kernels take at most 16 replica slots, got {R}")
    check("a0", m.a0, torch.int32, (P, R), dev)
    check("rf", m.rf, torch.int32, (P,), dev)
    check("slot_valid", m.slot_valid, torch.bool, (P, R), dev)
    check("part_rack_hi", m.part_rack_hi, torch.int32, (P,), dev)
    check("w_lead", m.w_lead, torch.int32, (P, B1), dev)
    check("w_foll", m.w_foll, torch.int32, (P, B1), dev)
    check("rack_of", m.rack_of, torch.int32, (B1,), dev)
    check("rack_lo", m.rack_lo, torch.int32, (K1,), dev)
    check("rack_hi", m.rack_hi, torch.int32, (K1,), dev)


def propose_site_cuda(m: ModelArrays, a, bits, temp: float, cnt, lcnt,
                      rcnt):
    """B2: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. ``bits [N, P, 8]`` int64 (uint32 values), ``temp`` the
    sweep temperature as a float32 value."""
    if a.device.type == "cpu":
        return propose_site_plain(m, a, bits, temp, cnt, lcnt, rcnt)
    N, P, R = a.shape
    B1 = m.num_brokers + 1
    K1 = m.rack_lo.shape[0]
    dev = a.device
    check("a", a, torch.int32, (N, P, R), dev)
    check("bits", bits, torch.int64, (N, P, 8), dev)
    check("cnt", cnt, torch.int32, (N, B1), dev)
    check("lcnt", lcnt, torch.int32, (N, B1), dev)
    check("rcnt", rcnt, torch.int32, (N, K1), dev)
    _check_model(m, P, R, dev)
    rec = [torch.empty(N, P, dtype=torch.int32, device=dev) for _ in range(5)]
    prio = torch.empty(N, P, dtype=torch.float32, device=dev)
    m_out = torch.zeros(N, B1, dtype=torch.float32, device=dev)
    m_in = torch.zeros(N, B1, dtype=torch.float32, device=dev)
    blo, bhi, llo, lhi = m.bands()
    kernels.PROPOSE(
        a.data_ptr(), m.a0.data_ptr(), m.rf.data_ptr(),
        m.slot_valid.data_ptr(), m.part_rack_hi.data_ptr(),
        m.w_lead.data_ptr(), m.w_foll.data_ptr(), m.rack_of.data_ptr(),
        m.rack_lo.data_ptr(), m.rack_hi.data_ptr(), bits.data_ptr(),
        cnt.data_ptr(), lcnt.data_ptr(), rcnt.data_ptr(),
        blo, bhi, llo, lhi, temp, m.lam_host(), N, P, R, B1, K1,
        *(r.data_ptr() for r in rec), prio.data_ptr(), m_out.data_ptr(),
        m_in.data_ptr(),
    )
    is_lsw, s, b_new, b_lead, b_at_s = rec
    p = SiteProposals(is_lsw=is_lsw.bool(), s=s, b_new=b_new, b_lead=b_lead,
                      b_at_s=b_at_s, prio=prio)
    return p, m_out, m_in


def exchange_halves_cuda(m: ModelArrays, a, lcnt, s_own, lead_other,
                         b_other, b_own=None):
    """B4: the CUDA kernel for CUDA tensors, the plain version
    (``sweep.exchange_halves``) for CPU tensors. ``b_own`` is accepted
    for interface parity; the kernel rebuilds it from the row."""
    if a.device.type == "cpu":
        return exchange_halves_plain(m, a, lcnt, s_own, lead_other,
                                     b_other, b_own=b_own)
    N, P, R = a.shape
    B1 = m.num_brokers + 1
    dev = a.device
    s_own = s_own.to(torch.int32).contiguous()
    lead_other = lead_other.to(torch.int32).contiguous()
    b_other = b_other.contiguous()
    check("a", a, torch.int32, (N, P, R), dev)
    check("lcnt", lcnt, torch.int32, (N, B1), dev)
    check("s_own", s_own, torch.int32, (N, P), dev)
    check("lead_other", lead_other, torch.int32, (N, P), dev)
    check("b_other", b_other, torch.int32, (N, P), dev)
    _check_model(m, P, R, dev)
    out = [torch.empty(N, P, dtype=torch.int32, device=dev) for _ in range(5)]
    _blo, _bhi, llo, lhi = m.bands()
    kernels.EXCHANGE(
        a.data_ptr(), m.slot_valid.data_ptr(), m.part_rack_hi.data_ptr(),
        m.w_lead.data_ptr(), m.w_foll.data_ptr(), m.rack_of.data_ptr(),
        lcnt.data_ptr(), s_own.data_ptr(), lead_other.data_ptr(),
        b_other.data_ptr(), llo, lhi, N, P, R, B1,
        *(o.data_ptr() for o in out),
    )
    b_own, dw, ddiv, dlcnt, legal = out
    return b_own, dw, ddiv, dlcnt, legal > 0
