"""B4 (exchange half-deltas): the CUDA kernel and its plain PyTorch
version.

B4 replaces ``kafka_assignment_optimizer_tpu/ops/propose_pallas.py:424``
(``_exchange_kernel``): the per-partition half of a pair-exchange delta.
It is bound on the card by bytes and gather latency (one thread per
(chain, partition), a few table lookups each); see ``csrc/propose.cu``.
The wrapper launches the kernel for CUDA tensors and runs the plain
version for CPU tensors.
"""

from __future__ import annotations

import torch

from ..solvers.tpu.arrays import ModelArrays
from ..solvers.tpu.sweep import exchange_halves as exchange_halves_plain
from . import kernels
from .kernels import check, check_model


def exchange_halves_cuda(m: ModelArrays, a, lcnt, s_own, lead_other,
                         b_other, b_own=None):
    """B4: the CUDA kernel for CUDA tensors, the plain version
    (``sweep.exchange_halves``) for CPU tensors. ``b_own`` is accepted
    for interface parity; the kernel rebuilds it from the row."""
    if a.device.type == "cpu":
        return exchange_halves_plain(m, a, lcnt, s_own, lead_other,
                                     b_other, b_own=b_own)
    check_model(m)
    N = a.shape[0]
    P, R = m.a0.shape
    B1 = m.num_brokers + 1
    dev = m.a0.device
    s_own = s_own.to(torch.int32).contiguous()
    lead_other = lead_other.to(torch.int32).contiguous()
    b_other = b_other.contiguous()
    check("a", a, torch.int32, (N, P, R), dev)
    check("lcnt", lcnt, torch.int32, (N, B1), dev)
    check("s_own", s_own, torch.int32, (N, P), dev)
    check("lead_other", lead_other, torch.int32, (N, P), dev)
    check("b_other", b_other, torch.int32, (N, P), dev)
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
