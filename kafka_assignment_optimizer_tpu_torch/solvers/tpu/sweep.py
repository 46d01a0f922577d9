"""Sweep-parallel annealing: the large-instance engine.

Counterpart of ``kafka_assignment_optimizer_tpu.solvers.tpu.sweep``. Every
sweep proposes ONE move for EVERY partition of every chain ([N, P]
proposals), evaluates all proposal deltas against the sweep-start
histograms, Metropolis-accepts per partition, then conflict-thins the
accepted set so at most one move touches any broker's in/out counts
(random-priority max maps), and applies the survivors.

Histograms are delta-accumulated: the stepper carries exact per-chain
(cnt, lcnt, rcnt) and updates them from the kept moves; a from-scratch
resync runs at every snapshot and at every chunk entry. Sweeps cycle
through three moves: single-site proposals on even sweeps, the
count-invariant pair exchange on odd sweeps, and every ``COMPOUND_EVERY``
sweeps the atomic compound 2-move exchange in the exchange slot.

Every function here is the plain PyTorch formulation, written to
reproduce the reference's integer and float32 arithmetic exactly: with
the random bits of ``prng`` the port replays the reference trajectory
bit for bit. The ``"cuda"`` scorer bundle swaps the hot stages for the
hand-written kernels of ``ops`` (B1, the fused site sweep B2+B3, the
fused exchange proposal B4+B5 and B6), which reproduce these functions
exactly on the card.

The lane form (:func:`make_lane_stepper_fn`) runs L lanes (one model
each, the models stacked by ``arrays.stack_models``) through one stepper:
the three kernels take every lane in one launch, and each lane's
trajectory is the one the single-model stepper runs on that lane's model
and key (the reference's ``jax.vmap`` of its stepper). The compound sweep
and the snapshot's bookkeeping have no kernel in either package; they run
lane by lane.

On a solve mesh (``parallel.mesh``) the stepper runs C chain shards of
every lane: shards on one device as ``C * L`` lanes of one launch of each
kernel (``parallel.mesh.Block``, ``arrays.shard_models``), and at every
snapshot the best migration over the shards of each lane
(:func:`_migrate_blocks`, the reference's ``pmax``/``pmin``/``psum`` over
its mesh axis as tensor selections on the device, ``all_reduce`` across
processes); one shard is the reference's one-device mesh.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ... import prng
from ...ops.score_cuda import _count, chain_scores, histograms, score_plain
from ...parallel.mesh import TRIVIAL, Block, Layout, owner_rows, put_rows
from .arrays import (
    SCALE_W,
    ModelArrays,
    band_pen,
    lane_model,
    stack_models,
    u01,
)

P_LSWAP = 0.15  # leadership-only proposals (zero replica movement)
P_RESTORE = 0.5  # replace proposals that re-propose the original broker

# every COMPOUND_EVERY-th sweep the exchange slot runs the compound
# 2-move exchange; the cadence divides the snapshot cadence (8) and the
# chunk parity, so chunked schedules replay the uncut ladder
COMPOUND_EVERY = 4

_EPS = float(np.float32(1e-6))  # thinning-priority floor, float32-exact
_IMAX = int(np.iinfo(np.int32).max)
_IMIN = int(np.iinfo(np.int32).min)


def _temp_div(temp: float, device) -> torch.Tensor:
    """``max(temp, 1e-6)`` in float32 as a device tensor. Dividing by a
    device tensor (never a host scalar, which PyTorch's CUDA division
    turns into a reciprocal multiply) keeps the division IEEE-exact."""
    t = max(np.float32(temp), np.float32(1e-6))
    return torch.full((), float(t), dtype=torch.float32, device=device)


def _metropolis(legal, delta, u, temp: float):
    return legal & ((delta >= 0) | (u < torch.exp(
        delta / _temp_div(temp, delta.device))))


def _lookup(hist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``hist[n, idx[n, p]]`` for per-chain tables ``hist [N, W]``."""
    return hist.gather(1, idx.long())


def _max_map(tok: torch.Tensor, prio: torch.Tensor, width: int):
    """Per-chain max priority over the proposals with each token."""
    out = torch.zeros(prio.shape[0], width, dtype=torch.float32,
                      device=prio.device)
    return out.scatter_reduce(1, tok.long(), prio, "amax")


def first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the FIRST minimum of a 1-D tensor (``torch.argmin`` makes
    no promise among ties on the card). A 0-d int64 tensor."""
    idx = torch.arange(x.shape[0], device=x.device)
    return torch.where(x == x.min(), idx, x.shape[0]).min()


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the FIRST maximum of a 1-D tensor."""
    idx = torch.arange(x.shape[0], device=x.device)
    return torch.where(x == x.max(), idx, x.shape[0]).min()


def best_key(w: torch.Tensor, pen: torch.Tensor) -> torch.Tensor:
    return torch.where(pen == 0, w, -pen - 1)


def out_key(out: torch.Tensor) -> torch.Tensor:
    """:func:`best_key` of B1's ``out [N, 8]``."""
    return best_key(out[:, 0], out[:, 1:5].sum(1, dtype=torch.int32))


class SiteProposals(NamedTuple):
    """One proposed move per (chain, partition). Replace (``is_lsw``
    false): slot ``s`` <- ``b_new``, outgoing broker ``b_at_s``. Leader
    swap (``is_lsw`` true): slot 0 <- ``b_at_s``, slot ``s`` <-
    ``b_lead``. ``prio`` > 0 iff Metropolis-accepted."""

    is_lsw: torch.Tensor  # [N, P] bool
    s: torch.Tensor       # [N, P] int32 target slot
    b_new: torch.Tensor   # [N, P] int32 incoming broker (replace)
    b_lead: torch.Tensor  # [N, P] int32 current leader (slot 0)
    b_at_s: torch.Tensor  # [N, P] int32 current occupant of slot s
    prio: torch.Tensor    # [N, P] float32, 0 where rejected


def _rand_idx(u: torch.Tensor, hi) -> torch.Tensor:
    """Uniform int in [0, hi) from u ~ U[0,1): the float32 product
    truncated to int32, clamped to hi - 1 (as the reference)."""
    if isinstance(hi, int):
        return torch.clamp_max((u * float(hi)).to(torch.int32), hi - 1)
    return torch.minimum((u * hi.to(torch.float32)).to(torch.int32), hi - 1)


def _rows(P: int, device) -> torch.Tensor:
    return torch.arange(P, device=device)[None, :]


def propose_site(m: ModelArrays, a: torch.Tensor, bits: torch.Tensor,
                 temp: float, hists=histograms) -> SiteProposals:
    """One single-site proposal per (chain, partition) from ``bits [N, P,
    8]``: the move, its exact score delta against the sweep-start
    histograms, the Metropolis accept and the thinning priority."""
    N, P, R = a.shape
    B = m.num_brokers
    dev = a.device
    flat, racks, cnt, lcnt, rcnt = hists(m, a)
    rf = m.rf[None, :]
    rows = _rows(P, dev)

    u_slot = u01(bits[..., 0])
    s_rep = _rand_idx(u_slot, rf)
    s_lsw = 1 + _rand_idx(u_slot, torch.clamp_min(rf - 1, 1))
    is_lsw = (u01(bits[..., 1]) < P_LSWAP) & (rf > 1)
    s = torch.where(is_lsw, s_lsw, s_rep)

    b_lead = a[:, :, 0].contiguous()
    # an empty (padded) row draws s = -1: the reference's gather wraps a
    # negative index to the last slot
    s_idx = torch.where(s < 0, s + R, s)
    b_at_s = a.gather(2, s_idx.long()[..., None])[..., 0]
    b_old = torch.where(is_lsw, b_lead, b_at_s)
    b_foll = b_at_s

    b_uni = _rand_idx(u01(bits[..., 2]), B)
    s_orig = _rand_idx(u01(bits[..., 3]), R)
    b_orig = m.a0[rows, s_orig.long()]
    b_new = torch.where((u01(bits[..., 4]) < P_RESTORE) & (b_orig < B),
                        b_orig, b_uni)

    def wl(b):
        return m.w_lead[rows, b.long()]

    def wf(b):
        return m.w_foll[rows, b.long()]

    # ---- deltas (replace: a[p, s] <- b_new) --------------------------
    lead_slot = s == 0
    dw_rep = torch.where(lead_slot, wl(b_new) - wl(b_old),
                         wf(b_new) - wf(b_old))
    blo, bhi = m.broker_band[0], m.broker_band[1]
    llo, lhi = m.leader_band[0], m.leader_band[1]
    cnt_old = _lookup(cnt, b_old)
    cnt_new = _lookup(cnt, b_new)
    d_cnt = (
        band_pen(cnt_old - 1, blo, bhi) - band_pen(cnt_old, blo, bhi)
        + band_pen(cnt_new + 1, blo, bhi) - band_pen(cnt_new, blo, bhi)
    )
    lcnt_old = _lookup(lcnt, b_old)
    lcnt_new = _lookup(lcnt, b_new)
    d_lcnt_rep = torch.where(
        lead_slot,
        band_pen(lcnt_old - 1, llo, lhi) - band_pen(lcnt_old, llo, lhi)
        + band_pen(lcnt_new + 1, llo, lhi) - band_pen(lcnt_new, llo, lhi),
        0,
    )
    r_old = m.rack_of[b_old.long()]
    r_new = m.rack_of[b_new.long()]
    rc_old = _lookup(rcnt, r_old)
    rc_new = _lookup(rcnt, r_new)
    lo_o, hi_o = m.rack_lo[r_old.long()], m.rack_hi[r_old.long()]
    lo_n, hi_n = m.rack_lo[r_new.long()], m.rack_hi[r_new.long()]
    d_rcnt = (
        band_pen(rc_old - 1, lo_o, hi_o) - band_pen(rc_old, lo_o, hi_o)
        + band_pen(rc_new + 1, lo_n, hi_n) - band_pen(rc_new, lo_n, hi_n)
    )
    c_old = (racks == r_old[:, :, None]).sum(-1, dtype=torch.int32)
    c_new = (racks == r_new[:, :, None]).sum(-1, dtype=torch.int32)
    cap = m.part_rack_hi[None, :]

    def g(c):
        return torch.clamp_min(c - cap, 0)

    d_div = g(c_old - 1) - g(c_old) + g(c_new + 1) - g(c_new)
    dpen_rep = d_cnt + d_lcnt_rep + torch.where(r_old != r_new,
                                                d_rcnt + d_div, 0)
    in_row = ((flat == b_new[:, :, None]) & m.slot_valid[None]).any(-1)

    # ---- deltas (leader swap: promote slot s) -------------------------
    dw_lsw = wl(b_foll) + wf(b_lead) - wl(b_lead) - wf(b_foll)
    lc_l = _lookup(lcnt, b_lead)
    lc_f = _lookup(lcnt, b_foll)
    dpen_lsw = (
        band_pen(lc_l - 1, llo, lhi) - band_pen(lc_l, llo, lhi)
        + band_pen(lc_f + 1, llo, lhi) - band_pen(lc_f, llo, lhi)
    )

    dw = torch.where(is_lsw, dw_lsw, dw_rep)
    dpen = torch.where(is_lsw, dpen_lsw, dpen_rep)
    # rf > 0: bucket-padded rows must never be accepted
    legal = torch.where(is_lsw, rf > 1, ~in_row) & (rf > 0)
    delta = (SCALE_W * dw).to(torch.float32) - m.lam * dpen.to(
        torch.float32)
    accept = _metropolis(legal, delta, u01(bits[..., 5]), temp)
    prio = torch.where(accept, u01(bits[..., 6]) + _EPS, 0.0)
    return SiteProposals(is_lsw=is_lsw, s=s, b_new=b_new, b_lead=b_lead,
                         b_at_s=b_at_s, prio=prio)


def _site_tokens(p: SiteProposals):
    """(tok_out, tok_in): a replace moves a replica unit (out=b_at_s,
    in=b_new); a leader swap moves a leadership unit (out=b_lead,
    in=b_at_s)."""
    tok_out = torch.where(p.is_lsw, p.b_lead, p.b_at_s)
    tok_in = torch.where(p.is_lsw, p.b_at_s, p.b_new)
    return tok_out, tok_in


def site_maps(m: ModelArrays, p: SiteProposals):
    """The conflict-thinning priority maps (m_out, m_in) [N, B+1]."""
    tok_out, tok_in = _site_tokens(p)
    B1 = m.num_brokers + 1
    return _max_map(tok_out, p.prio, B1), _max_map(tok_in, p.prio, B1)


def _thin_keep(m: ModelArrays, p: SiteProposals, m_out, m_in):
    """Keep an accepted proposal only if it owns the priority maps of
    BOTH brokers whose counts it moves."""
    tok_out, tok_in = _site_tokens(p)
    return (p.prio > 0) & (p.prio == _lookup(m_out, tok_out)) & (
        p.prio == _lookup(m_in, tok_in))


def _apply_site(a: torch.Tensor, p: SiteProposals,
                keep: torch.Tensor) -> torch.Tensor:
    """Apply the kept proposals (one move max per partition)."""
    r_iota = torch.arange(a.shape[2], device=a.device)[None, None, :]
    s3 = p.s[:, :, None]
    rep_val = torch.where(r_iota == s3, p.b_new[:, :, None], a)
    lsw_val = torch.where(
        r_iota == 0, p.b_at_s[:, :, None],
        torch.where(r_iota == s3, p.b_lead[:, :, None], a),
    )
    new_a = torch.where(p.is_lsw[:, :, None], lsw_val, rep_val)
    return torch.where(keep[:, :, None], new_a, a)


def _hist_delta(tok_out: torch.Tensor, tok_in: torch.Tensor,
                width: int) -> torch.Tensor:
    """+1 at ``tok_in``, -1 at ``tok_out``, per chain: [N, width] int32.
    Pairs routed to one bucket cancel exactly."""
    out = torch.zeros(tok_in.shape[0], width, dtype=torch.int32,
                      device=tok_in.device)
    one = torch.ones(tok_in.shape, dtype=torch.int32, device=tok_in.device)
    out.scatter_add_(1, tok_in.long(), one)
    out.scatter_add_(1, tok_out.long(), -one)
    return out


def _site_hist_deltas(m: ModelArrays, p: SiteProposals, keep):
    """Exact (d_cnt, d_lcnt, d_rcnt) of one applied site sweep. Not-kept
    pairs route both tokens to the null broker B (null rack K), where
    they cancel; the ``rf > 0`` guard drops empty partitions."""
    B = m.num_brokers
    K1 = m.rack_lo.shape[0]
    live = m.rf[None, :] > 0
    rep = keep & ~p.is_lsw & live
    out_b = torch.where(rep, p.b_at_s, B)
    in_b = torch.where(rep, p.b_new, B)
    d_cnt = _hist_delta(out_b, in_b, B + 1)
    d_rcnt = _hist_delta(m.rack_of[out_b.long()], m.rack_of[in_b.long()],
                         K1)
    lead_mv = keep & (p.is_lsw | (p.s == 0)) & live
    tok_out, tok_in = _site_tokens(p)
    d_lcnt = _hist_delta(torch.where(lead_mv, tok_out, B),
                         torch.where(lead_mv, tok_in, B), B + 1)
    return d_cnt, d_lcnt, d_rcnt


def site_finish(m: ModelArrays, a: torch.Tensor, p: SiteProposals,
                m_out, m_in):
    """Thin, apply and delta-count one site sweep: ``(a_new, d_cnt,
    d_lcnt, d_rcnt)``."""
    keep = _thin_keep(m, p, m_out, m_in)
    return (_apply_site(a, p, keep), *_site_hist_deltas(m, p, keep))


def thin_apply(m: ModelArrays, a: torch.Tensor,
               p: SiteProposals) -> torch.Tensor:
    """Conflict-thin accepted proposals and apply the winners."""
    return _apply_site(a, p, _thin_keep(m, p, *site_maps(m, p)))


def _carried(cnt, lcnt, rcnt):
    """A ``hists`` function that serves carried histograms."""
    def hists(m: ModelArrays, a: torch.Tensor):
        flat = torch.where(m.slot_valid[None], a, m.num_brokers)
        return flat, m.rack_of[flat.long()], cnt, lcnt, rcnt

    return hists


def _site_sweep_delta(m: ModelArrays, a: torch.Tensor, cnt, lcnt, rcnt,
                      key, temp: float):
    """One site sweep against CARRIED histograms, updating the carry
    from the kept moves (bit-identical to the from-scratch form). The
    plain version of the fused site-sweep kernel (B2+B3)."""
    N, P = a.shape[:2]
    bits = prng.bits(key, (N, P, 8), a.device)
    p = propose_site(m, a, bits, temp, hists=_carried(cnt, lcnt, rcnt))
    a2, d_cnt, d_lcnt, d_rcnt = site_finish(m, a, p, *site_maps(m, p))
    return a2, cnt + d_cnt, lcnt + d_lcnt, rcnt + d_rcnt


def sweep_once(m: ModelArrays, a: torch.Tensor, key, temp: float):
    """One site sweep from scratch: propose everywhere -> accept ->
    thin -> apply."""
    N, P = a.shape[:2]
    bits = prng.bits(key, (N, P, 8), a.device)
    return thin_apply(m, a, propose_site(m, a, bits, temp))


class ExchangeProposals(NamedTuple):
    """One proposed pair exchange per (chain, partition), partition-
    aligned: partition p offers its slot-``s`` occupant ``b_own`` and
    receives its partner's ``b_other``. Both halves of a pair carry the
    same ``prio``."""

    s: torch.Tensor        # [N, P] int32 own slot
    b_own: torch.Tensor    # [N, P] int32 outgoing broker
    b_other: torch.Tensor  # [N, P] int32 incoming broker
    tok_out: torch.Tensor  # [N, P] int32 leadership token out (B = none)
    tok_in: torch.Tensor   # [N, P] int32 leadership token in (B = none)
    prio: torch.Tensor     # [N, P] float32, 0 where rejected


def _pair_stride(key, P: int):
    """The host half of the pairing: the stride ``d`` (a shift amount,
    drawn on the host) and the key of the per-chain phases,
    ``randint(kph, (N, 1), 0, 2 * d)``."""
    kd, kph = prng.split(key)
    return int(prng.randint(kd, (), 1, max(P // 2, 2))), kph


def _pair_partners(key, N: int, P: int, device):
    """Involution pairing by random stride ``d`` (shared by all chains)
    with a per-chain random phase: alternating d-blocks pair p with p+d
    (lower blocks) or p-d (upper blocks). ``d`` is drawn on the host; the
    phases on the device. Returns (d, is_lower [N, P], pair_valid [N,
    P])."""
    d, kph = _pair_stride(key, P)
    phase = prng.randint(kph, (N, 1), 0, 2 * d, device=device)
    p_idx = torch.arange(P, device=device)[None, :]
    is_lower = ((p_idx + phase) // d) % 2 == 0
    partner = torch.where(is_lower, p_idx + d, p_idx - d)
    pair_valid = (partner >= 0) & (partner < P)
    return d, is_lower, pair_valid


def _partner_view(x: torch.Tensor, d: int, is_lower: torch.Tensor):
    """x[n, partner(p), ...] for partner = p ± d — two rolls + select.
    Out-of-range partners wrap; callers mask with ``pair_valid``."""
    up = torch.roll(x, -d, dims=1)    # x[p + d]
    down = torch.roll(x, d, dims=1)   # x[p - d]
    sel = is_lower
    while sel.dim() < x.dim():
        sel = sel[..., None]
    return torch.where(sel, up, down)


def _slot_value(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """a[n, p, s[n, p]], 0 where s is outside [0, R)."""
    r_iota = torch.arange(a.shape[2], device=a.device)[None, None, :]
    return torch.where(r_iota == s[:, :, None], a, 0).sum(
        -1, dtype=torch.int32)


def exchange_halves(m: ModelArrays, a, lcnt, s_own, lead_other, b_other,
                    b_own=None):
    """Per-partition half of a pair-exchange delta, from the OWN row only
    (plus the pair-level leader-count term, identical on both sides).
    The plain form of B4's half, which the fused exchange kernel
    evaluates for both sides of a pair. Returns (b_own, dw_own,
    ddiv_own, dlcnt_pair, legal_own)."""
    N, P, R = a.shape
    B = m.num_brokers
    rows = _rows(P, a.device)
    if b_own is None:
        b_own = _slot_value(a, s_own)

    lead_own = s_own == 0
    dw_own = torch.where(
        lead_own,
        m.w_lead[rows, b_other.long()] - m.w_lead[rows, b_own.long()],
        m.w_foll[rows, b_other.long()] - m.w_foll[rows, b_own.long()],
    )
    llo, lhi = m.leader_band[0], m.leader_band[1]
    xor = lead_own != lead_other
    lo_c = _lookup(lcnt, torch.where(lead_own, b_own, b_other))
    li_c = _lookup(lcnt, torch.where(lead_own, b_other, b_own))
    dlcnt = torch.where(
        xor,
        band_pen(lo_c - 1, llo, lhi) - band_pen(lo_c, llo, lhi)
        + band_pen(li_c + 1, llo, lhi) - band_pen(li_c, llo, lhi),
        0,
    )
    flat = torch.where(m.slot_valid[None], a, B)
    racks = m.rack_of[flat.long()]
    r_out = m.rack_of[b_own.long()]
    r_in = m.rack_of[b_other.long()]
    c_out = (racks == r_out[:, :, None]).sum(-1, dtype=torch.int32)
    c_in = (racks == r_in[:, :, None]).sum(-1, dtype=torch.int32)
    cap = m.part_rack_hi[None, :]

    def g(c):
        return torch.clamp_min(c - cap, 0)

    ddiv_own = torch.where(
        r_out != r_in, g(c_out - 1) - g(c_out) + g(c_in + 1) - g(c_in), 0)
    in_row = ((flat == b_other[:, :, None]) & m.slot_valid[None]).any(-1)
    return b_own, dw_own, ddiv_own, dlcnt, ~in_row


def propose_exchange(m: ModelArrays, a, key, temp: float, halves=None,
                     lcnt=None) -> ExchangeProposals:
    """One pair-exchange proposal per (chain, partition). The key drives
    the stride pairing and ``bits [N, P, 4]`` (slot-lower, slot-upper,
    metropolis, prio); the pair's shared draws are the LOWER side's
    bits, so both halves reach identical decisions. ``halves`` computes
    the per-partition half-deltas (:func:`exchange_halves` by default)."""
    N, P, R = a.shape
    B = m.num_brokers
    dev = a.device
    if lcnt is None:
        lcnt = _count(torch.where(m.rf[None, :] > 0, a[:, :, 0], B), B + 1)

    kd, kbits = prng.split(key)
    bits = prng.bits(kbits, (N, P, 4), dev)
    d, is_lower, pair_valid = _pair_partners(kd, N, P, dev)

    bits_low = torch.where(is_lower[..., None], bits,
                           _partner_view(bits, d, is_lower))
    u0 = u01(bits_low[..., 0])
    u1 = u01(bits_low[..., 1])
    rf_own = m.rf[None, :].expand(N, P)
    rf_other = torch.where(is_lower, torch.roll(m.rf, -d)[None, :],
                           torch.roll(m.rf, d)[None, :])
    s_own = _rand_idx(torch.where(is_lower, u0, u1), rf_own)
    s_other = _rand_idx(torch.where(is_lower, u1, u0), rf_other)
    lead_other = s_other == 0

    b_probe = _slot_value(a, s_own)
    b_other = _partner_view(b_probe, d, is_lower)
    b_own, dw_own, ddiv_own, dlcnt, legal_own = (halves or exchange_halves)(
        m, a, lcnt, s_own, lead_other, b_other, b_own=b_probe)

    packed = torch.stack([dw_own, ddiv_own, legal_own.to(torch.int32)], -1)
    other = _partner_view(packed, d, is_lower)
    dw = dw_own + other[..., 0]
    ddiv = ddiv_own + other[..., 1]
    # both sides must be live partitions (padded rows have no slot)
    pair_live = (rf_own > 0) & (rf_other > 0)
    legal = legal_own & (other[..., 2] > 0) & pair_valid & pair_live
    delta = (SCALE_W * dw).to(torch.float32) - m.lam * (dlcnt + ddiv).to(
        torch.float32)
    accept = _metropolis(legal, delta, u01(bits_low[..., 2]), temp)
    prio = torch.where(accept, u01(bits_low[..., 3]) + _EPS, 0.0)

    lead_own = s_own == 0
    hot = (prio > 0) & (lead_own != lead_other)  # only leadership conflicts
    tok_out = torch.where(hot, torch.where(lead_own, b_own, b_other), B)
    tok_in = torch.where(hot, torch.where(lead_own, b_other, b_own), B)
    return ExchangeProposals(s=s_own, b_own=b_own, b_other=b_other,
                             tok_out=tok_out, tok_in=tok_in, prio=prio)


def exch_maps(tok_out, tok_in, prio, width: int):
    """Per-chain max-priority maps over the leadership tokens."""
    return _max_map(tok_out, prio, width), _max_map(tok_in, prio, width)


def exchange_propose(m: ModelArrays, a, lcnt, key, temp: float):
    """One exchange proposal against the carried leader histograms and
    its thinning maps: ``(ExchangeProposals, m_out, m_in)``. The plain
    version of the fused exchange kernel (B4+B5)."""
    p = propose_exchange(m, a, key, temp, lcnt=lcnt)
    return (p, *exch_maps(p.tok_out, p.tok_in, p.prio, m.num_brokers + 1))


def exch_finish(a, s_own, b_other, tok_out, tok_in, prio, m_out, m_in):
    """Keep test (token B bypasses its map), apply (own slot <- incoming
    broker) and the exact leader-count delta (the slot-0 diff of the
    applied population): ``(a_new, d_lcnt)``. The plain version of B6."""
    B = m_out.shape[1] - 1
    keep = (prio > 0) & (
        (tok_out == B) | (prio == _lookup(m_out, tok_out))) & (
        (tok_in == B) | (prio == _lookup(m_in, tok_in)))
    r_iota = torch.arange(a.shape[2], device=a.device)[None, None, :]
    write = keep[:, :, None] & (r_iota == s_own[:, :, None])
    a2 = torch.where(write, b_other[:, :, None], a)
    return a2, _hist_delta(a[:, :, 0], a2[:, :, 0], B + 1)


def exchange_thin_apply(m: ModelArrays, a, p: ExchangeProposals):
    """Thin leadership-moving exchanges to one kept unit per broker per
    direction, then apply. Returns ``(a_new, d_lcnt)``."""
    maps = exch_maps(p.tok_out, p.tok_in, p.prio, m.num_brokers + 1)
    return exch_finish(a, p.s, p.b_other, p.tok_out, p.tok_in, p.prio,
                       *maps)


def exchange_sweep(m: ModelArrays, a, key, temp: float):
    """From-scratch pair-exchange sweep (the count-invariant move)."""
    if a.shape[1] < 2:
        return a
    return exchange_thin_apply(m, a, propose_exchange(m, a, key, temp))[0]


def _exchange_sweep_delta(m: ModelArrays, a, cnt, lcnt, rcnt, key,
                          temp: float):
    """Exchange sweep against the carried leader histograms. Replica and
    rack totals are exchange-invariant; only leadership units move. The
    plain version of the cuda bundle's exchange step (B4+B5, then B6)."""
    if a.shape[1] < 2:
        return a, cnt, lcnt, rcnt
    p, m_out, m_in = exchange_propose(m, a, lcnt, key, temp)
    a2, d_lcnt = exch_finish(a, p.s, p.b_other, p.tok_out, p.tok_in, p.prio,
                             m_out, m_in)
    return a2, cnt, lcnt + d_lcnt, rcnt


class CompoundProposals(NamedTuple):
    """One half of a compound 2-move exchange per (chain, partition):
    partition p replaces its slot-``s`` occupant ``b_out`` with a fresh
    ``b_in``, and its paired partition does the same, atomically."""

    s: torch.Tensor        # [N, P] int32 own slot
    b_out: torch.Tensor    # [N, P] int32 outgoing broker
    b_in: torch.Tensor     # [N, P] int32 incoming broker
    lead_mv: torch.Tensor  # [N, P] bool own slot is the leader slot
    prio: torch.Tensor     # [N, P] float32, 0 where rejected


def _pair_pen_delta(hist, outs, ins, lo_of, hi_of):
    """Exact band-penalty delta of a pair's unit moves applied ATOMICALLY:
    per token, the net count change of its bin across all four moves,
    priced once per distinct bin (first-occurrence masking)."""
    toks = list(outs) + list(ins)
    signs = [-1] * len(outs) + [1] * len(ins)
    total = torch.zeros_like(toks[0])
    for j, tj in enumerate(toks):
        net = torch.zeros_like(tj)
        for sk, tk in zip(signs, toks):
            net = net + sk * (tk == tj).to(torch.int32)
        first = torch.ones(tj.shape, dtype=torch.bool, device=tj.device)
        for tk in toks[:j]:
            first = first & (tk != tj)
        c = _lookup(hist, tj)
        lo, hi = lo_of(tj), hi_of(tj)
        d = band_pen(c + net, lo, hi) - band_pen(c, lo, hi)
        total = total + torch.where(first, d, 0)
    return total


def propose_compound(m: ModelArrays, a, key, temp: float, cnt, lcnt,
                     rcnt):
    """One compound 2-move exchange per (chain, partition): the pair
    proposes TWO single-site replaces (each side a fresh restore-biased
    draw), scored as ONE atomic move against the carried histograms with
    the cross terms priced exactly. Returns ``(proposals, d,
    is_lower)``."""
    N, P, R = a.shape
    B = m.num_brokers
    dev = a.device
    rows = _rows(P, dev)
    kd, kbits = prng.split(key)
    bits = prng.bits(kbits, (N, P, 7), dev)
    d, is_lower, pair_valid = _pair_partners(kd, N, P, dev)

    bits_low = torch.where(is_lower[..., None], bits,
                           _partner_view(bits, d, is_lower))
    u0 = u01(bits_low[..., 0])
    u1 = u01(bits_low[..., 1])
    rf_own = m.rf[None, :].expand(N, P)
    rf_other = torch.where(is_lower, torch.roll(m.rf, -d)[None, :],
                           torch.roll(m.rf, d)[None, :])
    s_own = _rand_idx(torch.where(is_lower, u0, u1), rf_own)
    b_out = _slot_value(a, s_own)

    b_uni = _rand_idx(u01(bits[..., 2]), B)
    s_orig = _rand_idx(u01(bits[..., 3]), R)
    b_orig = m.a0[rows, s_orig.long()]
    b_in = torch.where((u01(bits[..., 4]) < P_RESTORE) & (b_orig < B),
                       b_orig, b_uni)

    lead_own = s_own == 0
    dw_own = torch.where(
        lead_own,
        m.w_lead[rows, b_in.long()] - m.w_lead[rows, b_out.long()],
        m.w_foll[rows, b_in.long()] - m.w_foll[rows, b_out.long()],
    )
    flat = torch.where(m.slot_valid[None], a, B)
    racks = m.rack_of[flat.long()]
    r_out = m.rack_of[b_out.long()]
    r_in = m.rack_of[b_in.long()]
    c_out = (racks == r_out[:, :, None]).sum(-1, dtype=torch.int32)
    c_in = (racks == r_in[:, :, None]).sum(-1, dtype=torch.int32)
    cap = m.part_rack_hi[None, :]

    def g(c):
        return torch.clamp_min(c - cap, 0)

    ddiv_own = torch.where(
        r_out != r_in, g(c_out - 1) - g(c_out) + g(c_in + 1) - g(c_in), 0)
    in_row = ((flat == b_in[:, :, None]) & m.slot_valid[None]).any(-1)
    legal_own = ~in_row

    packed = torch.stack(
        [b_out, b_in, lead_own.to(torch.int32), dw_own, ddiv_own,
         legal_own.to(torch.int32)], -1)
    oth = _partner_view(packed, d, is_lower)
    b_out_o, b_in_o = oth[..., 0], oth[..., 1]
    lead_o = oth[..., 2] > 0

    def canon(own, other):
        return (torch.where(is_lower, own, other),
                torch.where(is_lower, other, own))

    o_lo, o_up = canon(b_out, b_out_o)
    i_lo, i_up = canon(b_in, b_in_o)
    blo, bhi = m.broker_band[0], m.broker_band[1]
    d_cnt = _pair_pen_delta(cnt, [o_lo, o_up], [i_lo, i_up],
                            lambda t: blo, lambda t: bhi)

    def rack(t):
        return m.rack_of[t.long()]

    d_rcnt = _pair_pen_delta(
        rcnt, [rack(o_lo), rack(o_up)], [rack(i_lo), rack(i_up)],
        lambda t: m.rack_lo[t.long()], lambda t: m.rack_hi[t.long()])
    led_lo, led_up = canon(lead_own, lead_o)
    llo, lhi = m.leader_band[0], m.leader_band[1]
    d_lcnt = _pair_pen_delta(
        lcnt,
        [torch.where(led_lo, o_lo, B), torch.where(led_up, o_up, B)],
        [torch.where(led_lo, i_lo, B), torch.where(led_up, i_up, B)],
        lambda t: llo, lambda t: lhi)

    dw = dw_own + oth[..., 3]
    dpen = d_cnt + d_rcnt + d_lcnt + ddiv_own + oth[..., 4]
    pair_live = (rf_own > 0) & (rf_other > 0)
    legal = legal_own & (oth[..., 5] > 0) & pair_valid & pair_live
    legal = legal & (m.comp_enable > 0.5)
    delta = (SCALE_W * dw).to(torch.float32) - m.lam * dpen.to(
        torch.float32)
    accept = _metropolis(legal, delta, u01(bits_low[..., 5]), temp)
    prio = torch.where(accept, u01(bits_low[..., 6]) + _EPS, 0.0)
    return (
        CompoundProposals(s=s_own, b_out=b_out, b_in=b_in,
                          lead_mv=lead_own, prio=prio),
        d, is_lower,
    )


def _compound_sweep_delta(m: ModelArrays, a, cnt, lcnt, rcnt, key,
                          temp: float):
    """One compound sweep against the carried histograms: propose
    (pair-atomic), thin (a half must own both of its maps AND its
    partner half must win its own), apply, and delta-update the carry."""
    N, P = a.shape[:2]
    if P < 2:
        return a, cnt, lcnt, rcnt
    B = m.num_brokers
    prop, d, is_lower = propose_compound(m, a, key, temp, cnt, lcnt, rcnt)
    m_out = _max_map(prop.b_out, prop.prio, B + 1)
    m_in = _max_map(prop.b_in, prop.prio, B + 1)
    win_own = (prop.prio > 0) & (prop.prio == _lookup(m_out, prop.b_out)) & (
        prop.prio == _lookup(m_in, prop.b_in))
    keep = win_own & _partner_view(win_own, d, is_lower)

    r_iota = torch.arange(a.shape[2], device=a.device)[None, None, :]
    write = keep[:, :, None] & (r_iota == prop.s[:, :, None])
    a2 = torch.where(write, prop.b_in[:, :, None], a)

    out_b = torch.where(keep, prop.b_out, B)
    in_b = torch.where(keep, prop.b_in, B)
    cnt = cnt + _hist_delta(out_b, in_b, B + 1)
    rcnt = rcnt + _hist_delta(m.rack_of[out_b.long()],
                              m.rack_of[in_b.long()], m.rack_lo.shape[0])
    lead = keep & prop.lead_mv
    lcnt = lcnt + _hist_delta(torch.where(lead, prop.b_out, B),
                              torch.where(lead, prop.b_in, B), B + 1)
    return a2, cnt, lcnt, rcnt


def compound_sweep(m: ModelArrays, a, key, temp: float):
    """From-scratch compound sweep (tests and reference loops)."""
    _flat, _racks, cnt, lcnt, rcnt = histograms(m, a)
    return _compound_sweep_delta(m, a, cnt, lcnt, rcnt, key, temp)[0]


def _per_lane(step):
    """The lane form of a sweep stage ``step(m, a, cnt, lcnt, rcnt, key,
    temp)``: the stage on each lane of the stacked model ``m`` with that
    lane's state rows, key ``keys[l]`` and temperature ``temps[l]``,
    stacked."""
    def run(m: ModelArrays, a, cnt, lcnt, rcnt, keys, temps):
        outs = [step(lane_model(m, lane), a[lane], cnt[lane], lcnt[lane],
                     rcnt[lane], keys[lane], temps[lane])
                for lane in range(a.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))

    return run


# the plain versions of the lane kernels' sweeps, and the compound sweep
# (no kernel in either package), lane by lane
site_lanes_delta = _per_lane(_site_sweep_delta)
exchange_lanes_delta = _per_lane(_exchange_sweep_delta)
compound_lanes_delta = _per_lane(_compound_sweep_delta)


def _on_card(fn):
    """Guard a kernel-bundle stage: its tensors must lie on the card."""
    def run(m: ModelArrays, a: torch.Tensor, *args):
        if a.device.type != "cuda":
            raise ValueError(
                "the 'cuda' scorer runs on the card; got tensors on "
                f"{a.device} (use scorer='torch' off the card)"
            )
        return fn(m, a, *args)

    return run


class LaneBundle(NamedTuple):
    """The sweep engine's stages, resolved per scorer; every stage takes
    a stacked model and ``[L, ...]`` state (a single model runs as one
    lane, :func:`_one_lane`).

    - ``full(m, a) -> (out [L, N, 8], cnt, lcnt, rcnt)`` — B1
    - ``site_step / exch_step / comp_step(m, a, cnt, lcnt, rcnt, keys,
      temps) -> (a, cnt, lcnt, rcnt)``
    """

    full: Callable
    site_step: Callable
    exch_step: Callable
    comp_step: Callable


def _make_lane_scorer(scorer: str) -> LaneBundle:
    """``"torch"``: the plain PyTorch formulation (this module), lane by
    lane. ``"cuda"``: the hand-written kernels (``ops``), one launch of
    each for every lane: B1 for the scores, moves and histograms, the
    fused site sweep (B2+B3) and the fused exchange sweep (B4+B5+B6); the
    compound sweep has no kernel and runs lane by lane in both. Both yield
    bit-identical trajectories."""
    from ...ops.score_cuda import score_lanes, score_lanes_plain

    if scorer == "torch":
        return LaneBundle(score_lanes_plain, site_lanes_delta,
                          exchange_lanes_delta, compound_lanes_delta)
    if scorer != "cuda":
        raise ValueError(f"unknown scorer {scorer!r}; expected 'torch' or "
                         "'cuda'")
    from ...ops.exchange_cuda import exchange_step_lanes
    from ...ops.site_cuda import site_step_lanes

    return LaneBundle(_on_card(score_lanes), _on_card(site_step_lanes),
                      _on_card(exchange_step_lanes),
                      _on_card(compound_lanes_delta))


def first_argmin_rows(x: torch.Tensor) -> torch.Tensor:
    """:func:`first_argmin` of every row of a 2-D tensor: ``[rows]``."""
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    low = x.min(1, keepdim=True).values
    return torch.where(x == low, idx, x.shape[1]).min(1).values


def first_argmax_rows(x: torch.Tensor) -> torch.Tensor:
    """:func:`first_argmax` of every row of a 2-D tensor: ``[rows]``."""
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    high = x.max(1, keepdim=True).values
    return torch.where(x == high, idx, x.shape[1]).min(1).values


def _migrate_blocks(blocks, rows, red):
    """The snapshot-boundary best migration over the chain shards of a
    mesh, each lane on its own: locate the lane's best current chain
    (highest key over every shard, then the fewest moves among the
    key-tied chains, the owner the lowest shard index holding one, the
    first such chain within it), clone it with its histogram rows over
    each shard's worst chain (lowest key, first index), and harvest the
    clone into that chain's best snapshot at once. ``rows`` holds one
    ``[a, cnt, lcnt, rcnt, k, mv, best_k, best_mv, best_a]`` a block,
    each flat ``[C*L, N, ...]``; returns ``(a, cnt, lcnt, rcnt, best_k,
    best_mv, best_a)`` a block, in fresh tensors. One shard reduces to
    the reference's one-device mesh."""
    kl, mvt, local = [], [], []
    for b, r in zip(blocks, rows):
        C, L = b.c1 - b.c0, b.l1 - b.l0
        kl.append(r[4].view(C, L, -1))
        local.append(kl[-1].amax(2))
    gbest = red([x.amax(0) for x in local], "max")
    for k, g, r in zip(kl, gbest, rows):
        mvt.append(torch.where(k == g[None, :, None], r[5].view_as(k),
                               _IMAX))
    local_mv = [x.amin(2) for x in mvt]
    gmv = red([x.amin(0) for x in local_mv], "min")
    own = [(lb == g) & (lm == gm)
           for lb, g, lm, gm in zip(local, gbest, local_mv, gmv)]
    g_rows, sizes = owner_rows(blocks, red, own, first_argmin_rows, mvt,
                                [r[:4] for r in rows])
    out = []
    for b, r, k, g, gm, gr in zip(blocks, rows, kl, gbest, gmv, g_rows):
        C, L, N = k.shape
        a, cnt, lcnt, rcnt, _k, _mv, best_k, best_mv, best_a = r
        fi = torch.arange(C * L, device=k.device) * N + first_argmin_rows(
            k.reshape(C * L, N))
        ga, gc, gl, grk = (x.repeat(C, 1) for x in gr.split(sizes, 1))
        G, GM = g.repeat(C), gm.repeat(C)
        bk, bm = best_k.reshape(-1)[fi], best_mv.reshape(-1)[fi]
        take = (G > bk) | ((G == bk) & (GM < bm))
        ba = best_a.reshape(C * L * N, -1)
        out.append((
            put_rows(a, fi, ga), put_rows(cnt, fi, gc),
            put_rows(lcnt, fi, gl), put_rows(rcnt, fi, grk),
            best_k.reshape(-1).index_copy(0, fi, torch.maximum(bk, G))
            .view(best_k.shape),
            best_mv.reshape(-1).index_copy(0, fi, torch.where(take, GM, bm))
            .view(best_mv.shape),
            ba.index_copy(0, fi, torch.where(take[:, None], ga, ba[fi]))
            .view(best_a.shape)))
    return out


def _migrate(a, cnt, lcnt, rcnt, k, mv, best_k, best_mv, best_a):
    """The snapshot-boundary best migration of the reference's one-device
    mesh (:func:`_migrate_blocks` of one shard of one lane): leaves
    ``[N, ...]``."""
    out = _migrate_blocks(
        [Block(None, 0, 1, 0, 1)],
        [[x[None] for x in (a, cnt, lcnt, rcnt, k, mv, best_k, best_mv,
                            best_a)]], TRIVIAL)[0]
    return tuple(x[0] for x in out)


def _snapshot_blocks(sc: LaneBundle, models, state, hist, blocks, red):
    """The stepper's snapshot of every block: an exact rescore through
    bundle ``sc`` (one B1 a block; its histograms overwrite the carried
    ones, its ``out[..., 5]`` is the move count), each chain's best kept
    (fewest moves breaks key ties), then the best migration over the
    mesh (:func:`_migrate_blocks`). ``state`` (``[a, best_k, best_mv,
    best_a, keys]`` a block) and ``hist`` (``[cnt, lcnt, rcnt]`` a
    block) are updated in place."""
    rows = []
    for m, st in zip(models, state):
        out, cnt, lcnt, rcnt = sc.full(m, st[0])
        k = best_key(out[..., 0], out[..., 1:5].sum(-1, dtype=torch.int32))
        mv = out[..., 5]
        improved = (k > st[1]) | ((k == st[1]) & (mv < st[2]))
        st[2] = torch.where(improved, mv, st[2])
        st[1] = torch.where(improved, k, st[1])
        st[3] = torch.where(improved[..., None, None], st[0], st[3])
        rows.append([st[0], cnt, lcnt, rcnt, k, mv, st[1], st[2], st[3]])
    for st, h, new in zip(state, hist, _migrate_blocks(blocks, rows, red)):
        st[0], h[0], h[1], h[2], st[1], st[2], st[3] = new


def snapshot_step(sc: LaneBundle, m: ModelArrays, a, best_k, best_mv,
                  best_a):
    """The stepper's snapshot of every lane of the stacked model ``m`` on
    one shard (:func:`_snapshot_blocks`): returns ``(a, cnt, lcnt, rcnt,
    best_k, best_mv, best_a)``, every leaf ``[L, ...]``."""
    st = [a, best_k, best_mv, best_a, None]
    hist = [None, None, None]
    _snapshot_blocks(sc, [m], [st], [hist],
                     [Block(None, 0, 1, 0, a.shape[0])], TRIVIAL)
    return st[0], *hist, st[1], st[2], st[3]


def sweep_kind(i: int) -> str:
    """The kind of sweep ``i`` of a stepper run: ``"compound"`` every
    ``COMPOUND_EVERY``-th sweep, else ``"exchange"`` on odd sweeps and
    ``"site"`` on even ones."""
    if i % COMPOUND_EVERY == COMPOUND_EVERY - 1:
        return "compound"
    return "exchange" if i % 2 == 1 else "site"


def is_snapshot(i: int, sweeps: int, snapshot_every: int) -> bool:
    """Whether sweep ``i`` of a run of ``sweeps`` ends with a snapshot:
    every ``snapshot_every`` sweeps and at the last one."""
    return i % snapshot_every == snapshot_every - 1 or i == sweeps - 1


def stage_counts(sweeps: int, snapshot_every: int = 8) -> dict:
    """The kernel stages one stepper run of ``sweeps`` sweeps calls, by
    kernel name (``ops.kernels``): B1 at entry and at every snapshot, the
    site and exchange sweeps by :func:`sweep_kind`; the compound sweep has
    no kernel. On the card each call is one launch for up to
    ``kernels.MAX_LANES`` lanes (an exchange stage of fewer than two
    chains launches nothing)."""
    kinds = [sweep_kind(i) for i in range(sweeps)]
    return {
        "B1 score": 1 + sum(is_snapshot(i, sweeps, snapshot_every)
                            for i in range(sweeps)),
        "B2+B3 site sweep": kinds.count("site"),
        "B4+B5+B6 exchange sweep": kinds.count("exchange"),
    }


def _sweeps(sc: LaneBundle, lay: Layout, models, state, temps,
            snapshot_every: int) -> list:
    """One stepper run of ``len(temps)`` sweeps over the blocks' state
    (updated in place): the chunk-entry rescore, each sweep one launch of
    its kernel a block, each snapshot one B1 a block and the migration
    over the mesh. Returns each block's curve ``[C_b*L_b, sweeps]``."""
    # kao: disable=KAO113 -- host data: the temperature ladder is a numpy array
    temps = np.asarray(temps, np.float32)
    sweeps = temps.shape[0]
    # kao: disable=KAO113 -- host data: lane_scalars() are host floats, cached per model
    scales = [np.asarray(m.lane_scalars()[2], np.float32) for m in models]
    hist = [list(sc.full(m, st[0])[1:]) for m, st in zip(models, state)]
    curves = [[] for _ in state]
    for i in range(sweeps):
        step = {"compound": sc.comp_step, "exchange": sc.exch_step,
                "site": sc.site_step}[sweep_kind(i)]
        for m, st, h, sc_b in zip(models, state, hist, scales):
            keys = st[4]
            subs = []
            for j in range(keys.shape[0]):
                keys[j], sub = prng.split(keys[j])
                subs.append(sub)
            lane_temps = [float(temps[i] * s) for s in sc_b]
            st[0], h[0], h[1], h[2] = step(m, st[0], h[0], h[1], h[2], subs,
                                           lane_temps)
        if is_snapshot(i, sweeps, snapshot_every):
            _snapshot_blocks(sc, models, state, hist, lay.blocks, lay.red)
        for st, c in zip(state, curves):
            c.append(st[1].max(1).values)
    return [torch.stack(c, 1) if c
            else torch.zeros(st[0].shape[0], 0, dtype=torch.int32,
                             device=st[0].device)
            for st, c in zip(state, curves)]


def _tops(state) -> tuple:
    """Each block's winner a flat lane: the best snapshot with the
    highest key, fewest moves among ties, first index: ``(top_a, top_k)``
    lists."""
    tas, tks = [], []
    for st in state:
        best_k, best_mv, best_a = st[1], st[2], st[3]
        tied = best_k == best_k.max(1, keepdim=True).values
        top = first_argmin_rows(torch.where(tied, best_mv, _IMAX))
        lanes = torch.arange(best_k.shape[0], device=best_k.device)
        tas.append(best_a[lanes, top])
        tks.append(best_k[lanes, top])
    return tas, tks


def make_lane_stepper_fn(n_chains: int, snapshot_every: int = 8,
                         scorer: str = "torch", mesh=None):
    """The sweep engine's stepper over L lanes: ``(m_stack, state,
    temps) -> (state', best_a [L, P, R], best_k [L], curve [L, sweeps])``
    with state = (a [L, N, P, R], best_k [L, N], best_mv [L, N], best_a
    [L, N, P, R], keys ``uint32[L, 2]`` on the host).

    Lane l's trajectory is the single-model stepper's on lane l's model
    and key, bit for bit (the reference's ``jax.vmap`` of its stepper):
    the cadences are lane-invariant, each lane draws its own sweep keys
    and scales the shared ladder by its own ``temp_scale`` in float32.
    Every kernel stage is one launch for all lanes; the compound sweep
    and the snapshot's bookkeeping run lane by lane.

    On a solve mesh (``mesh``, ``parallel.mesh.make_mesh``) the state is
    C chain shards of every lane (:class:`Layout`: ``[C, L, N, ...]``,
    keys ``[C, L, 2]``) and the outputs ``[C, L, ...]``, each shard's
    winners, as the reference's sharded stepper returns them. Shards on
    one device ride the lane axis of one launch (C*L lanes); the
    snapshot's migration runs over every shard of a lane. Neither the
    state tensors passed in nor their views are written in place."""
    sc = _make_lane_scorer(scorer)

    def solve(m: ModelArrays, state, temps):
        lay = Layout(mesh, m.num_lanes, solo=False)
        blocks = lay.split(state)
        curves = _sweeps(sc, lay, lay.models(m), blocks, temps,
                         snapshot_every)
        tas, tks = _tops(blocks)
        return (lay.join(blocks), lay.gather(tas), lay.gather(tks),
                lay.gather(curves))

    return solve


def _one_lane(m: ModelArrays) -> ModelArrays:
    """``m`` as a stacked model of one lane (cached on ``m``)."""
    one = m.__dict__.get("_one_lane")
    if one is None:
        one = stack_models([m])
        object.__setattr__(m, "_one_lane", one)
    return one


def make_sweep_stepper_fn(n_chains: int, snapshot_every: int = 8,
                          scorer: str = "torch", mesh=None):
    """The state-carrying core of the sweep engine: ``(m, state, temps)
    -> (state', best_a [P, R], best_key, curve [sweeps])`` with state =
    (a [N, P, R], best_k [N], best_mv [N], best_a [N, P, R], key): the
    lane stepper (:func:`make_lane_stepper_fn`) on one lane.

    The reference's ``lax.scan`` becomes a Python loop with the same
    cadences: exchange on odd sweeps, compound every ``COMPOUND_EVERY``,
    an exact snapshot every ``snapshot_every`` sweeps and at the last
    one, with fewest moves breaking key ties, followed by the best
    migration the reference runs on its device mesh (its ``axis_name``
    path). On a solve mesh (``mesh``) every leaf gains the shard axis
    (``[C, N, ...]``, keys ``[C, 2]``) and the outputs are each shard's
    (``[C, P, R]``, ``[C]``, ``[C, sweeps]``). The full state (the RNG
    keys included) threads through chunk boundaries, so a run cut into
    chunks whose length is a multiple of ``snapshot_every`` replays the
    uncut run exactly. Neither the state tensors passed in nor their
    views are written in place."""
    sc = _make_lane_scorer(scorer)

    def solve(m: ModelArrays, state, temps):
        lay = Layout(mesh, 1, solo=True)
        blocks = lay.split(state)
        curves = _sweeps(sc, lay, lay.models(_one_lane(m)), blocks, temps,
                         snapshot_every)
        tas, tks = _tops(blocks)
        return (lay.join(blocks), lay.gather(tas), lay.gather(tks),
                lay.gather(curves))

    return solve


def make_sweep_solver_fn(n_chains: int, snapshot_every: int = 8,
                         scorer: str = "torch"):
    """``(m, a_seed [P, R], key, temps) -> (best_a, best_key, curve)``:
    the seed broadcast to ``n_chains`` independent chains, then one
    stepper run."""
    stepper = make_sweep_stepper_fn(n_chains, snapshot_every, scorer)
    from ...ops.score_cuda import score, score_plain

    full = _on_card(score) if scorer == "cuda" else score_plain

    def solve(m: ModelArrays, a_seed: torch.Tensor, key, temps):
        P, R = a_seed.shape
        a = a_seed.to(torch.int32)[None].repeat(n_chains, 1, 1)
        out, _c, _l, _r = full(m, a)
        state = (a, out_key(out), out[:, 5], a.clone(), key)
        _, top_a, top_k, curve = stepper(m, state, temps)
        return top_a, top_k, curve

    return solve


# the never-firing early-exit thresholds of a disarmed fused group: a
# chain qualifies when ``best_k >= cert_k and best_mv <= cert_mv``, and
# no key reaches int32 max and no move count is negative
MEGA_DISARMED_KEY = _IMAX
MEGA_DISARMED_MOVES = -1


def _mega(sc: LaneBundle, lay: Layout, m: ModelArrays, state, temps,
          active, cert_k, cert_mv, snapshot_every: int) -> tuple:
    """A fused group over the blocks of ``lay`` (see
    :func:`make_mega_lane_stepper_fn`)."""
    # kao: disable=KAO113 -- host data: the group's temperature ladders are a numpy array
    temps = np.asarray(temps, np.float32)
    # kao: disable=KAO113 -- host data: the group's active mask is a numpy array
    active = np.asarray(active, bool)
    K, c = temps.shape
    cert_k, cert_mv = int(cert_k), int(cert_mv)
    armed = (cert_k, cert_mv) != (MEGA_DISARMED_KEY, MEGA_DISARMED_MOVES)
    models = lay.models(m)
    blocks = lay.split(state)
    done = False
    curves, execd = [[] for _ in blocks], []
    for j in range(K):
        run = bool(active[j]) and not done
        if run:
            for c_b, cv in zip(curves, _sweeps(sc, lay, models, blocks,
                                               temps[j], snapshot_every)):
                c_b.append(cv)
            if armed:
                # one qualifying chain in any lane of any shard stops the
                # group (the reference's pmax over its shard and lane
                # axes): one host read a block
                done = lay.any([((st[1] >= cert_k) & (st[2] <= cert_mv))
                                .any() for st in blocks])
        else:
            for c_b, st in zip(curves, blocks):
                c_b.append(torch.zeros(st[1].shape[0], c,
                                       dtype=st[1].dtype,
                                       device=st[1].device))
        execd.append(run)
    tas, tks = _tops(blocks)
    cas, oks, cms = [], [], []
    for st in blocks:
        best_k, best_mv, best_a = st[1], st[2], st[3]
        lanes = torch.arange(best_k.shape[0], device=best_k.device)
        qual = (best_k >= cert_k) & (best_mv <= cert_mv)
        ok = qual.any(1)
        cidx = first_argmin_rows(torch.where(qual, best_mv, _IMAX))
        cas.append(best_a[lanes, cidx])
        oks.append(ok)
        cms.append(torch.where(ok, best_mv[lanes, cidx], _IMAX))
    lead = (lay.L,) if lay.mesh is None else (lay.C, lay.L)
    if lay.solo:
        lead = lead[:-1]
    return (lay.join(blocks), lay.gather(tas), lay.gather(tks),
            lay.gather(cas), lay.gather(oks), lay.gather(cms),
            lay.gather([torch.stack(cb, 1) for cb in curves]),
            # kao: disable=KAO113 -- host data: execd is a list of Python bools
            np.broadcast_to(np.asarray(execd, bool), (*lead, K)).copy())


def make_mega_lane_stepper_fn(n_chains: int, snapshot_every: int = 8,
                              scorer: str = "torch", mesh=None):
    """K consecutive chunk steps as one fused group over L lanes (the
    reference's ``make_mega_lane_stepper_fn``): ``(m_stack, state, temps
    [K, c], active [K] bool, cert_k, cert_mv) -> (state', top_a [L, P,
    R], top_k [L], cert_a [L, P, R], cert_ok [L], cert_mv_out [L], curves
    [L, K, c], execd [L, K])``; on a solve mesh (``mesh``) every output
    gains the leading shard axis ``[C, ...]``, as the state does
    (:func:`make_lane_stepper_fn`).

    Each executed step is the UNCHANGED :func:`make_lane_stepper_fn` run
    on the carried state, so a group replays the chunked ladder bit for
    bit. A step runs when ``active`` holds (a short tail clears the
    padding steps) and no chain has qualified yet; a skipped step leaves
    every state leaf alone, the host-side keys included, and emits a
    zero curve. After each executed step of an ARMED group, a chain
    qualifies when ``best_k >= cert_k and best_mv <= cert_mv`` (the
    boundary certificate's device-side precheck); one qualifying chain in
    any lane of any shard sets the group's shared ``done`` flag (the
    reference's ``pmax`` over its shard and lane axes) and the remaining
    steps are skipped.

    The keys live on the host, so a skip is a host decision, not a
    device-side select: a DISARMED group (the sentinels
    ``MEGA_DISARMED_KEY``/``MEGA_DISARMED_MOVES``) skips exactly where
    ``active`` is clear, which the host already knows, and reads nothing
    from the device; an ARMED group reads its one-element ``done`` flag
    after each executed step (one small device-to-host copy a block,
    which waits for that step: the only host read inside a group).
    ``execd`` is therefore host data (numpy). ``cert_a`` is each lane's
    qualifying snapshot with the fewest moves (``cert_mv_out`` its
    moves, int32 max when none qualifies)."""
    sc = _make_lane_scorer(scorer)

    def solve(m: ModelArrays, state, temps, active, cert_k, cert_mv):
        return _mega(sc, Layout(mesh, m.num_lanes, solo=False), m, state,
                     temps, active, cert_k, cert_mv, snapshot_every)

    return solve


def make_mega_stepper_fn(n_chains: int, snapshot_every: int = 8,
                         scorer: str = "torch", mesh=None):
    """:func:`make_mega_lane_stepper_fn` on one model: ``(m, state,
    temps [K, c], active [K], cert_k, cert_mv) -> (state', top_a [P, R],
    top_k, cert_a [P, R], cert_ok, cert_mv_out, curves [K, c], execd
    [K])`` with the single-model sweep state of
    :func:`make_sweep_stepper_fn` (on a mesh, each output ``[C, ...]``)."""
    sc = _make_lane_scorer(scorer)

    def solve(m: ModelArrays, state, temps, active, cert_k, cert_mv):
        return _mega(sc, Layout(mesh, 1, solo=True), _one_lane(m), state,
                     temps, active, cert_k, cert_mv, snapshot_every)

    return solve
