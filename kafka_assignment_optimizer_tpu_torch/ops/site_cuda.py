"""B2+B3 (one site sweep): the fused CUDA kernel and its plain PyTorch
version.

Replaces ``kafka_assignment_optimizer_tpu/ops/propose_pallas.py:66``
(``_propose_kernel``) and ``kafka_assignment_optimizer_tpu/ops/
thin_pallas.py:59`` (``_site_finish_kernel``), chained in the JAX package
as ``thin_pallas.site_step_pallas``. One launch draws the sweep's random
words (threefry in registers), proposes, accepts, thins, applies and
updates the carried histograms, one thread-block cluster per chain; see
``csrc/site.cu``. The plain version is ``sweep._site_sweep_delta``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solvers.tpu.arrays import ModelArrays
from ..solvers.tpu.sweep import _site_sweep_delta
from . import kernels
from .kernels import check, check_model

CLUSTER = 8  # CTAs per chain: KAO_SITE_CLUSTER in csrc/site.cu
SMEM_LIMIT = 232_448  # bytes of shared memory one CTA can use on Hopper


def smem_bytes(B1: int, K1: int) -> int:
    """Shared memory of one CTA: its share of the chain's two priority
    maps and three histogram deltas (token t lives in CTA t % CLUSTER)."""
    return 4 * (4 * -(-B1 // CLUSTER) + -(-K1 // CLUSTER))


def site_step_cuda(m: ModelArrays, a, cnt, lcnt, rcnt, key, temp: float):
    """One site sweep with the carried histograms updated: ``(a_new,
    cnt', lcnt', rcnt')``. The fused kernel for CUDA tensors (one launch,
    no other device work, no host sync), the plain version for CPU
    tensors. ``key`` is the sweep's host ``uint32[2]`` key, ``temp`` the
    sweep temperature as a float32 value."""
    if a.device.type == "cpu":
        return _site_sweep_delta(m, a, cnt, lcnt, rcnt, key, temp)
    check_model(m)
    N = a.shape[0]
    P, R = m.a0.shape
    B1 = m.num_brokers + 1
    K1 = m.rack_lo.shape[0]
    dev = m.a0.device
    check("a", a, torch.int32, (N, P, R), dev)
    check("cnt", cnt, torch.int32, (N, B1), dev)
    check("lcnt", lcnt, torch.int32, (N, B1), dev)
    check("rcnt", rcnt, torch.int32, (N, K1), dev)
    if smem_bytes(B1, K1) > SMEM_LIMIT:
        raise ValueError(
            f"site sweep: {B1} brokers and {K1} racks need "
            f"{smem_bytes(B1, K1)} bytes of shared memory per CTA; the "
            f"card offers {SMEM_LIMIT}"
        )
    k0, k1 = (int(w) for w in np.asarray(key, np.uint32).reshape(2))
    a_new = torch.empty_like(a)
    cnt2 = torch.empty_like(cnt)
    lcnt2 = torch.empty_like(lcnt)
    rcnt2 = torch.empty_like(rcnt)
    rec = torch.empty(N, P, 4, dtype=torch.int32, device=dev)  # scratch
    blo, bhi, llo, lhi = m.bands()
    kernels.SITE(
        a.data_ptr(), m.a0.data_ptr(), m.rf.data_ptr(),
        m.slot_valid.data_ptr(), m.part_rack_hi.data_ptr(),
        m.w_lead.data_ptr(), m.w_foll.data_ptr(), m.rack_of.data_ptr(),
        m.rack_lo.data_ptr(), m.rack_hi.data_ptr(), cnt.data_ptr(),
        lcnt.data_ptr(), rcnt.data_ptr(), k0, k1, temp, m.lam_host(),
        blo, bhi, llo, lhi, N, P, R, B1, K1, a_new.data_ptr(),
        cnt2.data_ptr(), lcnt2.data_ptr(), rcnt2.data_ptr(), rec.data_ptr(),
    )
    return a_new, cnt2, lcnt2, rcnt2
