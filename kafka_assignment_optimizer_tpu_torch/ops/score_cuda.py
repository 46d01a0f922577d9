"""B1: exact chain scoring and histograms — the CUDA kernel and its plain
PyTorch version.

Replaces ``kafka_assignment_optimizer_tpu/ops/score_pallas.py:55``
(``_score_kernel``, reached through ``score_batch_pallas``). The sweep
runs it at every chunk entry and every snapshot resync, and the engine
at seed scoring and final selection and verification.

On the card the cost is bytes: one read of ``a[N, P, R]`` plus the
gathered weights of each valid slot; see ``csrc/score.cu`` for the
design (one cooperative launch, any broker count). :func:`score`
launches the kernel for a CUDA tensor and runs :func:`score_plain` for a
CPU tensor; both return ``(out [N, 8], cnt [N, B+1], lcnt [N, B+1], rcnt
[N, K+1])`` with ``out[:, :6] = (weight, pen_broker, pen_leader,
pen_rack, pen_part_rack, moves)`` and zeros after. The TPU kernel leaves
column 5 zero; the reference computes the moves beside it in XLA
(``ops/score.py::moves_batch``), and the port folds that count into B1.

:func:`score_lanes` is the lane form (the reference reaches B1 under
``jax.vmap`` for its lanes): one launch scores ``a [L, N, P, R]``, each
lane against its own model of a stacked model
(``arrays.stack_models``); its plain version, :func:`score_lanes_plain`,
is :func:`score_plain` lane by lane.
"""

from __future__ import annotations

import ctypes

import torch

from ..solvers.tpu.arrays import ModelArrays, band_pen, lane_model
from . import kernels
from .kernels import check


def _count(idx: torch.Tensor, width: int) -> torch.Tensor:
    """Per-chain histogram of ``idx [N, ...]`` over ``width`` buckets."""
    idx = idx.reshape(idx.shape[0], -1)
    out = torch.zeros(idx.shape[0], width, dtype=torch.int32,
                      device=idx.device)
    return out.scatter_add_(
        1, idx.long(), torch.ones(idx.shape, dtype=torch.int32,
                                  device=idx.device))


def histograms(m: ModelArrays, a: torch.Tensor):
    """Exact per-chain histograms. a: [N, P, R] -> (flat, racks, cnt
    [N, B+1], lcnt [N, B+1], rcnt [N, K+1])."""
    B = m.num_brokers
    K1 = m.rack_lo.shape[0]
    flat = torch.where(m.slot_valid[None], a, B)
    cnt = _count(flat, B + 1)
    lcnt = _count(flat[:, :, 0], B + 1)
    racks = m.rack_of[flat.long()]
    rcnt = _count(racks, K1)
    return flat, racks, cnt, lcnt, rcnt


def div_overflow(m: ModelArrays, racks: torch.Tensor) -> torch.Tensor:
    """Rack-diversity penalty: a slot overflows when its same-rack rank
    among the earlier slots of its partition reaches the cap. [N]."""
    R = racks.shape[-1]
    same = racks[..., :, None] == racks[..., None, :]  # [N, P, R, R]
    iota = torch.arange(R, device=racks.device)
    tri = (iota[:, None] > iota[None, :])[None, None]
    rank = (same & tri).sum(-1, dtype=torch.int32)
    over = m.slot_valid[None] & (rank >= m.part_rack_hi[None, :, None])
    return over.sum((1, 2), dtype=torch.int32)


def weight(m: ModelArrays, a: torch.Tensor) -> torch.Tensor:
    """Exact preservation weight per chain. [N] int32."""
    N, P, R = a.shape
    rows = torch.arange(P, device=a.device)[None, :]
    wl = m.w_lead[rows, a[:, :, 0].long()]
    w = torch.where(m.slot_valid[None, :, 0], wl, 0).sum(1, dtype=torch.int32)
    if R > 1:
        wf = m.w_foll[rows[..., None], a[:, :, 1:].long()]
        w = w + torch.where(m.slot_valid[None, :, 1:], wf, 0).sum(
            (1, 2), dtype=torch.int32)
    return w


def moves(m: ModelArrays, a: torch.Tensor) -> torch.Tensor:
    """Replica-move count vs the current assignment per chain: valid
    slots holding a broker with no leader weight for the partition were
    not assigned before. [N] int32."""
    rows = torch.arange(a.shape[1], device=a.device)[None, :, None]
    member = m.w_lead[rows, a.long()] > 0
    return (~member & m.slot_valid[None]).sum((1, 2), dtype=torch.int32)


def score_plain(m: ModelArrays, a: torch.Tensor):
    """The plain version of B1: ``(out [N, 8], cnt, lcnt, rcnt)``."""
    flat, racks, cnt, lcnt, rcnt = histograms(m, a)
    B, K = m.num_brokers, m.num_racks

    def band(x, lo, hi):
        return band_pen(x, lo, hi).sum(1, dtype=torch.int32)

    out = torch.zeros(a.shape[0], 8, dtype=torch.int32, device=a.device)
    out[:, 0] = weight(m, a)
    out[:, 1] = band(cnt[:, :B], m.broker_band[0], m.broker_band[1])
    out[:, 2] = band(lcnt[:, :B], m.leader_band[0], m.leader_band[1])
    out[:, 3] = band(rcnt[:, :K], m.rack_lo[None, :K], m.rack_hi[None, :K])
    out[:, 4] = div_overflow(m, racks)
    out[:, 5] = moves(m, a)
    return out, cnt, lcnt, rcnt


def score(m: ModelArrays, a: torch.Tensor):
    """B1 on ``a [N, P, R]``: the CUDA kernel for a CUDA tensor (one
    launch, outputs in one uninitialized buffer that the kernel fills),
    the plain version for a CPU tensor."""
    if a.device.type == "cpu":
        return score_plain(m, a)
    return tuple(x[0] for x in _launch(m, a[None]))


def score_lanes_plain(m: ModelArrays, a: torch.Tensor):
    """The plain version of B1's lane form: :func:`score_plain` on each
    lane of the stacked model ``m`` and its chains ``a[l]``, stacked."""
    outs = [score_plain(lane_model(m, lane), a[lane])
            for lane in range(a.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def score_lanes(m: ModelArrays, a: torch.Tensor):
    """B1 on the chains ``a [L, N, P, R]`` of the L lanes of the stacked
    model ``m``: ``(out [L, N, 8], cnt [L, N, B+1], lcnt [L, N, B+1],
    rcnt [L, N, K+1])``. One launch for every lane on a CUDA tensor, the
    plain version on a CPU tensor."""
    if a.device.type == "cpu":
        return score_lanes_plain(m, a)
    return _launch(m, a)


@kernels.in_lane_groups
def _launch(m: ModelArrays, a: torch.Tensor):
    """One launch of B1 on ``a [L, N, P, R]`` (a single model is one
    lane; above ``kernels.MAX_LANES`` lanes, one launch a group of
    lanes)."""
    tabs = kernels.model_tabs(m)
    L, N = a.shape[:2]
    kernels.lane_count(m, L)
    P, R = m.a0.shape[-2:]
    B1 = m.num_brokers + 1
    K1 = m.rack_lo.shape[-1]
    check("a", a, torch.int32, (L, N, P, R), m.a0.device)
    buf = torch.empty(L * N * (8 + 2 * B1 + K1), dtype=torch.int32,
                      device=a.device)
    out, cnt, lcnt, rcnt = (
        x.view(L, N, -1)
        for x in buf.split((8 * L * N, B1 * L * N, B1 * L * N, K1 * L * N)))
    kernels.SCORE(
        ctypes.byref(tabs), L, N, P, R, B1, K1,
        a.data_ptr(), out.data_ptr(), cnt.data_ptr(), lcnt.data_ptr(),
        rcnt.data_ptr(),
    )
    return out, cnt, lcnt, rcnt


def _scores_of(out, cnt, lcnt, rcnt):
    pen = out[:, 1:5].sum(1, dtype=torch.int32)
    return out[:, 0], pen, cnt, lcnt, rcnt


def full_scores(m: ModelArrays, a: torch.Tensor):
    """(weight [N], penalty [N], cnt, lcnt, rcnt) — exact, from scratch,
    in plain PyTorch."""
    return _scores_of(*score_plain(m, a))


def chain_scores(m: ModelArrays, a: torch.Tensor):
    """(weight [N], penalty [N]) — exact, from scratch."""
    w, pen, _cnt, _lcnt, _rcnt = full_scores(m, a)
    return w, pen
