"""Exact steepest-descent polish: one-move local optimality.

Counterpart of ``kafka_assignment_optimizer_tpu.solvers.tpu.polish``. It
evaluates the score delta of EVERY legal single move — all ``(partition,
slot, new_broker)`` replacements plus all in-partition leader swaps — as
one dense ``[P, R, B]`` tensor computation, applies the single best
improving move, and repeats until no move improves (or ``max_moves``).
Ties between equal scores prefer fewer replica moves; ties between equal
keys pick the first index, as the reference's ``argmax`` does.

The loop reads one scalar per move on the host (whether the best move
improves); the reference runs it as a device ``while_loop``.
"""

from __future__ import annotations

import torch

from .arrays import LAMBDA, SCALE_W, ModelArrays, band_pen
from .sweep import first_argmax

_NEG = -(1 << 30)  # mask value for illegal moves


def _counts(m: ModelArrays, a: torch.Tensor):
    """Full histograms for one candidate ``a [P, R]``, plus the
    per-(partition, rack) table the delta pass needs."""
    P, R = m.a0.shape
    B = m.num_brokers
    K1 = m.rack_lo.shape[0]
    dev = a.device
    flat = torch.where(m.slot_valid, a, B)
    ones = torch.ones(P * R, dtype=torch.int32, device=dev)
    cnt = torch.zeros(B + 1, dtype=torch.int32, device=dev).scatter_add_(
        0, flat.reshape(-1).long(), ones)
    lcnt = torch.zeros(B + 1, dtype=torch.int32, device=dev).scatter_add_(
        0, flat[:, 0].long(), ones[:P])
    racks = m.rack_of[flat.long()]  # [P, R]
    rcnt = torch.zeros(K1, dtype=torch.int32, device=dev).scatter_add_(
        0, racks.reshape(-1).long(), ones)
    pr = torch.zeros(P, K1, dtype=torch.int32, device=dev).scatter_add_(
        1, racks.long(), torch.ones_like(racks))
    return flat, cnt, lcnt, rcnt, pr


def _replace_deltas(m: ModelArrays, flat, cnt, lcnt, rcnt, pr):
    """Score delta of ``a[p, s] <- b`` for every (p, s, b). [P, R, B]."""
    P, R = flat.shape
    B = m.num_brokers
    dev = flat.device
    fl = flat.long()
    blo, bhi = m.broker_band[0], m.broker_band[1]
    llo, lhi = m.leader_band[0], m.leader_band[1]
    is_lead = (torch.arange(R, device=dev) == 0)[None, :]  # [1, R]

    w_in = torch.where(is_lead[:, :, None], m.w_lead[:, None, :B],
                       m.w_foll[:, None, :B])
    w_out = torch.where(is_lead, m.w_lead.gather(1, fl),
                        m.w_foll.gather(1, fl))
    dw = w_in - w_out[:, :, None]  # [P, R, B]

    d_bout = band_pen(cnt[fl] - 1, blo, bhi) - band_pen(cnt[fl], blo, bhi)
    d_bin = band_pen(cnt[:B] + 1, blo, bhi) - band_pen(cnt[:B], blo, bhi)
    dpen = d_bout[:, :, None] + d_bin[None, None, :]

    d_lout = band_pen(lcnt[fl] - 1, llo, lhi) - band_pen(lcnt[fl], llo, lhi)
    d_lin = band_pen(lcnt[:B] + 1, llo, lhi) - band_pen(lcnt[:B], llo, lhi)
    dpen = dpen + torch.where(
        is_lead[:, :, None], d_lout[:, :, None] + d_lin[None, None, :], 0)

    r_old = m.rack_of[fl].long()  # [P, R]
    rb = m.rack_of[:B].long()  # [B]
    same_rack = rb[None, None, :] == r_old[:, :, None]
    d_rout = (band_pen(rcnt[r_old] - 1, m.rack_lo[r_old], m.rack_hi[r_old])
              - band_pen(rcnt[r_old], m.rack_lo[r_old], m.rack_hi[r_old]))
    d_rin = (band_pen(rcnt[rb] + 1, m.rack_lo[rb], m.rack_hi[rb])
             - band_pen(rcnt[rb], m.rack_lo[rb], m.rack_hi[rb]))
    cap = m.part_rack_hi[:, None]  # [P, 1]
    pr_old = pr.gather(1, r_old)
    g_out = (torch.clamp_min(pr_old - 1 - cap, 0)
             - torch.clamp_min(pr_old - cap, 0))
    pr_b = pr[:, rb]  # [P, B]
    g_in = torch.clamp_min(pr_b + 1 - cap, 0) - torch.clamp_min(pr_b - cap, 0)
    dpen = dpen + torch.where(
        same_rack, 0,
        (d_rout + g_out)[:, :, None] + d_rin[None, None, :]
        + g_in[:, None, :])

    delta = SCALE_W * dw - LAMBDA * dpen

    iota_b = torch.arange(B, device=dev)
    in_row = (flat[:, :, None] == iota_b[None, None, :]).any(1)  # [P, B]
    legal = m.slot_valid[:, :, None] & ~in_row[:, None, :]
    return torch.where(legal, delta, _NEG)


def _lswap_deltas(m: ModelArrays, flat, lcnt):
    """Score delta of promoting slot s (>= 1) to leader. [P, R]."""
    llo, lhi = m.leader_band[0], m.leader_band[1]
    fl = flat.long()
    bl = fl[:, :1]  # current leader [P, 1]
    wl = m.w_lead.gather(1, fl)
    wf = m.w_foll.gather(1, fl)
    dw = (wl + m.w_foll.gather(1, bl)) - (m.w_lead.gather(1, bl) + wf)
    dpen = (
        band_pen(lcnt[bl] - 1, llo, lhi) - band_pen(lcnt[bl], llo, lhi)
        + band_pen(lcnt[fl] + 1, llo, lhi) - band_pen(lcnt[fl], llo, lhi)
    )
    delta = SCALE_W * dw - LAMBDA * dpen
    legal = m.slot_valid & (
        torch.arange(flat.shape[1], device=flat.device)[None, :] >= 1)
    return torch.where(legal, delta, _NEG)


def polish(m: ModelArrays, a: torch.Tensor,
           max_moves: int = 4096) -> torch.Tensor:
    """Apply best-improvement moves until 1-move local optimality (or
    the ``max_moves`` cap). Exact int32 arithmetic; never writes into
    ``a``."""
    P, R = m.a0.shape
    B = m.num_brokers
    a = a.to(torch.int32).clone()
    member = (m.w_lead[:, :B] > 0).to(torch.int32)  # [P, B]
    for _ in range(max_moves):
        flat, cnt, lcnt, rcnt, pr = _counts(m, a)
        d_rep = _replace_deltas(m, flat, cnt, lcnt, rcnt, pr)
        d_lsw = _lswap_deltas(m, flat, lcnt)
        # fewest-moves tie-break: scale the exact delta by 4 and add the
        # move-count gain in the low bits (the _NEG mask is not scaled)
        gain_out = (m.w_lead.gather(1, flat.long()) != 0).to(
            torch.int32)[:, :, None]
        d_rep = torch.where(d_rep == _NEG, _NEG,
                            d_rep * 4 + (member[:, None, :] - gain_out))
        d_lsw = torch.where(d_lsw == _NEG, _NEG, d_lsw * 4)

        best_rep = d_rep.max()
        best_lsw = d_lsw.max()
        best = torch.maximum(best_rep, best_lsw)
        if int(best) <= 0:
            break
        if bool(best_rep >= best_lsw):
            idx = int(first_argmax(d_rep.reshape(-1)))
            p1, s1, b1 = idx // (R * B), (idx // B) % R, idx % B
            a[p1, s1] = b1
        else:
            idx = int(first_argmax(d_lsw.reshape(-1)))
            p2, s2 = idx // R, idx % R
            lead, foll = a[p2, 0].clone(), a[p2, s2].clone()
            a[p2, 0] = foll
            a[p2, s2] = lead
    return a
