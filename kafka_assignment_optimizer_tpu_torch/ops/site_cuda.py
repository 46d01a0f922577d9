"""B2+B3 (one site sweep): the fused CUDA kernel and its plain PyTorch
version.

Replaces ``kafka_assignment_optimizer_tpu/ops/propose_pallas.py:66``
(``_propose_kernel``) and ``kafka_assignment_optimizer_tpu/ops/
thin_pallas.py:59`` (``_site_finish_kernel``), chained in the JAX package
as ``thin_pallas.site_step_pallas``. One launch draws the sweep's random
words (threefry in registers), proposes, accepts, thins, applies and
updates the carried histograms, one thread-block cluster per chain; see
``csrc/site.cu``. The plain version is ``sweep._site_sweep_delta``.

:func:`site_step_lanes` is the lane form (the reference reaches the
kernels under ``jax.vmap`` for its lanes): one launch sweeps the L lanes
of a stacked model, each with its own key and temperature (read from
device memory, as its bands and penalty scale are); its plain
version is ``sweep.site_lanes_delta``, the plain sweep lane by lane.
"""

from __future__ import annotations

import ctypes

import torch

from ..solvers.tpu.arrays import ModelArrays
from ..solvers.tpu.sweep import _site_sweep_delta, site_lanes_delta
from . import kernels
from .kernels import check

CLUSTER = 8  # CTAs per chain: KAO_SITE_CLUSTER in csrc/site.cu
SMEM_LIMIT = 232_448  # bytes of shared memory one CTA can use on Hopper


def smem_bytes(B1: int, K1: int) -> int:
    """Shared memory of one CTA: its share of the chain's two priority
    maps and three histogram deltas (token t lives in CTA t % CLUSTER)."""
    return 4 * (4 * -(-B1 // CLUSTER) + -(-K1 // CLUSTER))


def site_step_cuda(m: ModelArrays, a, cnt, lcnt, rcnt, key, temp):
    """One site sweep with the carried histograms updated: ``(a_new,
    cnt', lcnt', rcnt')``. The fused kernel for CUDA tensors (one launch,
    no host sync), the plain version for CPU tensors. ``key`` is the
    sweep's key (host ``uint32[2]`` or a device key), ``temp`` the sweep
    temperature as a float32 value or device scalar."""
    if a.device.type == "cpu":
        return _site_sweep_delta(m, a, cnt, lcnt, rcnt, key, temp)
    keys, temps = _one(key, temp, a.device)
    return tuple(x[0] for x in _launch(m, a[None], cnt[None], lcnt[None],
                                       rcnt[None], keys, temps))


def _one(key, temp, device) -> tuple:
    """One lane's key and temperature as the lane form takes them."""
    if isinstance(key, torch.Tensor):
        key = key.reshape(1, 2)
    else:
        key = [key]
    temp = temp.reshape(1) if isinstance(temp, torch.Tensor) else [temp]
    return kernels.lane_values(key, temp, 1, device)


def site_step_lanes(m: ModelArrays, a, cnt, lcnt, rcnt, keys, temps):
    """One site sweep of every lane of the stacked model ``m``: ``a [L,
    N, P, R]`` and the carried histograms ``[L, N, ...]``, lane l with
    its key ``keys[l]`` and float32 temperature ``temps[l]`` (device
    tensors ``[L, 2]`` and ``[L]``, or host keys and floats). One launch
    for every lane on CUDA tensors, the plain version on CPU tensors."""
    if a.device.type == "cpu":
        return site_lanes_delta(m, a, cnt, lcnt, rcnt, keys, temps)
    keys, temps = kernels.lane_values(keys, temps, a.shape[0], a.device)
    return _launch(m, a, cnt, lcnt, rcnt, keys, temps)


@kernels.in_lane_groups
def _launch(m: ModelArrays, a, cnt, lcnt, rcnt, keys, temps):
    """One launch of the fused site sweep on ``a [L, N, P, R]`` with the
    lanes' device keys ``[L, 2]`` and temperatures ``[L]`` (a single model
    is one lane; above ``kernels.MAX_LANES`` lanes, one launch a group of
    lanes)."""
    tabs = kernels.model_tabs(m)
    L, N = a.shape[:2]
    kernels.lane_count(m, L)
    P, R = m.a0.shape[-2:]
    B1 = m.num_brokers + 1
    K1 = m.rack_lo.shape[-1]
    dev = m.a0.device
    check("a", a, torch.int32, (L, N, P, R), dev)
    check("cnt", cnt, torch.int32, (L, N, B1), dev)
    check("lcnt", lcnt, torch.int32, (L, N, B1), dev)
    check("rcnt", rcnt, torch.int32, (L, N, K1), dev)
    if smem_bytes(B1, K1) > SMEM_LIMIT:
        raise ValueError(
            f"site sweep: {B1} brokers and {K1} racks need "
            f"{smem_bytes(B1, K1)} bytes of shared memory per CTA; the "
            f"card offers {SMEM_LIMIT}"
        )
    a_new = torch.empty_like(a)
    cnt2 = torch.empty_like(cnt)
    lcnt2 = torch.empty_like(lcnt)
    rcnt2 = torch.empty_like(rcnt)
    rec = torch.empty(L, N, P, 4, dtype=torch.int32, device=dev)  # scratch
    kernels.SITE(
        ctypes.byref(tabs), keys.data_ptr(), temps.data_ptr(), L, N, P, R,
        B1, K1,
        a.data_ptr(), cnt.data_ptr(), lcnt.data_ptr(), rcnt.data_ptr(),
        a_new.data_ptr(), cnt2.data_ptr(), lcnt2.data_ptr(),
        rcnt2.data_ptr(), rec.data_ptr(),
    )
    return a_new, cnt2, lcnt2, rcnt2
