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

A fused group of K chunk steps (:func:`make_mega_lane_stepper_fn`, the
reference's megachunk scan) draws nothing on the host: its keys are
device keys, split on the device a sweep at a time (``prng``), the
temperatures a device table, the exchange and compound strides device
scalars (the partner views index gathers), and its ``done`` flag lives
on the device, each step kept through ``torch.where``. On a card each
of its steps is one replay of its bucket's step graph: the CUDA graphs
of the step's pieces (the prologue, one a sweep, the epilogue), captured
once for the bucket and replayed in turn (:class:`_GroupGraph`, a
bounded cache of such graphs). The eager ladder
keeps host keys, and its kernels take the chunk's draws in one copy.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import fields
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
    lane_temps,
    stack_models,
    u01,
)

_MODEL_FIELDS = [f.name for f in fields(ModelArrays)]

P_LSWAP = 0.15  # leadership-only proposals (zero replica movement)
P_RESTORE = 0.5  # replace proposals that re-propose the original broker

# every COMPOUND_EVERY-th sweep the exchange slot runs the compound
# 2-move exchange; the cadence divides the snapshot cadence (8) and the
# chunk parity, so chunked schedules replay the uncut ladder
COMPOUND_EVERY = 4

_EPS = float(np.float32(1e-6))  # thinning-priority floor, float32-exact
_IMAX = int(np.iinfo(np.int32).max)
_IMIN = int(np.iinfo(np.int32).min)


def _temp_div(temp, device) -> torch.Tensor:
    """``max(temp, 1e-6)`` in float32 as a device tensor, from a host
    float or a float32 device scalar (a row of the chunk's temperature
    table). Dividing by a device tensor (never a host scalar, which
    PyTorch's CUDA division turns into a reciprocal multiply) keeps the
    division IEEE-exact."""
    if isinstance(temp, torch.Tensor):
        return torch.clamp_min(temp.to(torch.float32), 1e-6)
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
    """The stride of the pairing and the key of its per-chain phases,
    ``randint(kph, (N, 1), 0, 2 * d)``: ``d`` a host int for a host key,
    an int64 device scalar for a device key (drawn on the card, no host
    read)."""
    kd, kph = prng.split(key)
    d = prng.randint(kd, (), 1, max(P // 2, 2))
    if prng.is_device_key(key):
        return d.to(torch.int64), kph
    return int(d), kph


def _pair_partners(key, N: int, P: int, device):
    """Involution pairing by random stride ``d`` (shared by all chains)
    with a per-chain random phase: alternating d-blocks pair p with p+d
    (lower blocks) or p-d (upper blocks). The phases are drawn on the
    device, and ``d`` too for a device key. Returns (d, is_lower [N, P],
    pair_valid [N, P])."""
    d, kph = _pair_stride(key, P)
    phase = prng.randint(kph, (N, 1), 0, 2 * d, device=device)
    p_idx = torch.arange(P, device=device)[None, :]
    is_lower = ((p_idx + phase) // d) % 2 == 0
    partner = torch.where(is_lower, p_idx + d, p_idx - d)
    pair_valid = (partner >= 0) & (partner < P)
    return d, is_lower, pair_valid


def _partner_rows(P: int, d, device):
    """The rows ``(p + d) mod P`` and ``(p - d) mod P`` of every p, for a
    host or device stride ``d``: the reference's rolls by ``-d`` and
    ``d`` as index gathers, which give the same values."""
    p = torch.arange(P, device=device)
    return (p + d) % P, (p - d) % P


def _partner_view(x: torch.Tensor, d, is_lower: torch.Tensor):
    """x[n, partner(p), ...] for partner = p ± d — two row gathers and a
    select. Out-of-range partners wrap; callers mask with
    ``pair_valid``."""
    up_rows, down_rows = _partner_rows(x.shape[1], d, x.device)
    up = x.index_select(1, up_rows)      # x[p + d]
    down = x.index_select(1, down_rows)  # x[p - d]
    sel = is_lower
    while sel.dim() < x.dim():
        sel = sel[..., None]
    return torch.where(sel, up, down)


def _partner_rf(m: ModelArrays, d, is_lower: torch.Tensor):
    """The partner's replication factor ``rf[p ± d]`` of every pair."""
    up_rows, down_rows = _partner_rows(m.rf.shape[-1], d, m.rf.device)
    return torch.where(is_lower, m.rf.index_select(0, up_rows)[None, :],
                       m.rf.index_select(0, down_rows)[None, :])


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
    rf_other = _partner_rf(m, d, is_lower)
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
    rf_other = _partner_rf(m, d, is_lower)
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
    - ``kernels``: the sweep kinds whose stage is a kernel, which reads
      its lanes' keys and temperatures from device memory (the eager
      ladder hands them the chunk's draws on the card, and the other
      stages the host's)
    """

    full: Callable
    site_step: Callable
    exch_step: Callable
    comp_step: Callable
    kernels: frozenset = frozenset()


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
                      _on_card(compound_lanes_delta),
                      frozenset(("site", "exchange")))


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


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``: on a card one copy from pinned memory
    that does not wait for the card (the chunk's draws ride the stream
    in order, as a launch's parameters did)."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _temp_table(temps, m: ModelArrays, device) -> torch.Tensor:
    """:func:`arrays.lane_temps` (the per-lane float32 temperature of
    every sweep, ``[..., c, lanes]``) as a table on ``device``."""
    return _to_device(torch.from_numpy(lane_temps(temps, m)), device)


def _upload_draws(subs, temps, device) -> tuple:
    """Host draws ``(subs uint32 [c, n, 2], temps float32 [c, n])`` on
    ``device`` in ONE copy (one int64 buffer: the keys' words, then the
    temperatures' bits): ``(subs int64 [c, n, 2], temps float32 [c,
    n])``, views of it."""
    c, n = temps.shape
    buf = np.zeros(2 * c * n + -(-c * n // 2), np.int64)
    buf[:2 * c * n] = subs.reshape(-1)
    buf[2 * c * n:].view(np.float32)[:c * n] = temps.reshape(-1)
    dev = _to_device(torch.from_numpy(buf), device)
    return (dev[:2 * c * n].view(c, n, 2),
            dev[2 * c * n:].view(torch.float32)[:c * n].view(c, n))


def _chunk_draws(sc: LaneBundle, models, state, temps) -> list:
    """The draws of one stepper run of ``len(temps)`` sweeps over each
    block: the sweep keys ``[sweeps, lanes, 2]`` (each lane's key split
    once a sweep, ``prng.split_chain``) and the temperatures ``[sweeps,
    lanes]``, as ``{"host": (subs, temps) or None, "device": (subs,
    temps) or None}``. Device keys (a fused ladder) split on the device
    and every stage takes device draws: nothing read by the host. Host
    keys (the eager ladder) split on the host, the plain stages take the
    host draws (and draw their strides on the host) and the bundle's
    kernels one copy of them on the card, made once a run. Each block's
    keys advance to the keys after the run."""
    out = []
    for m, st in zip(models, state):
        dev = st[0].device
        subs, st[4] = prng.split_chain(st[4], len(temps))
        if prng.is_device_key(subs):
            out.append({"host": None,
                        "device": (subs, _temp_table(temps, m, dev))})
            continue
        host = (subs, lane_temps(temps, m))
        out.append({"host": host, "device": (
            _upload_draws(*host, dev) if sc.kernels and dev.type == "cuda"
            else None)})
    return out


def _sweeps(sc: LaneBundle, lay: Layout, models, state, draws,
            snapshot_every: int) -> list:
    """One stepper run over the blocks' state (updated in place): the
    chunk-entry rescore, each sweep one launch of its kernel a block,
    each snapshot one B1 a block and the migration over the mesh. The
    per-sweep values come from ``draws`` (a block's sweep keys and
    temperatures, :func:`_chunk_draws`); with device draws only the run
    reads nothing from the host, and a CUDA graph can capture it.
    Returns each block's curve ``[C_b*L_b, sweeps]``."""
    sweeps = next(d for d in draws[0].values() if d is not None)[0].shape[0]
    hist = [list(sc.full(m, st[0])[1:]) for m, st in zip(models, state)]
    curves = [[] for _ in state]
    _sweep_range(sc, lay, models, state, hist, draws, range(sweeps), sweeps,
                 snapshot_every, curves)
    return [torch.stack(c, 1) if c
            else torch.zeros(st[0].shape[0], 0, dtype=torch.int32,
                             device=st[0].device)
            for st, c in zip(state, curves)]


def _sweep_range(sc: LaneBundle, lay: Layout, models, state, hist, draws,
                 idx, sweeps: int, snapshot_every: int, curves) -> None:
    """Sweeps ``idx`` of a stepper run of ``sweeps`` (:func:`_sweeps`)
    over the blocks' state and histograms ``hist`` (updated in place),
    each followed by its snapshot where the cadence puts one; appends
    each sweep's curve column ``[lanes]`` to ``curves``."""
    for i in idx:
        kind = sweep_kind(i)
        step = {"compound": sc.comp_step, "exchange": sc.exch_step,
                "site": sc.site_step}[kind]
        for m, st, h, dr in zip(models, state, hist, draws):
            subs, temps = (dr["device"] if dr["host"] is None
                           or (kind in sc.kernels and dr["device"])
                           else dr["host"])
            st[0], h[0], h[1], h[2] = step(m, st[0], h[0], h[1], h[2],
                                           subs[i], temps[i])
        if is_snapshot(i, sweeps, snapshot_every):
            _snapshot_blocks(sc, models, state, hist, lay.blocks, lay.red)
        for st, c in zip(state, curves):
            c.append(st[1].max(1).values)


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
        models = lay.models(m)
        curves = _sweeps(sc, lay, models, blocks,
                         _chunk_draws(sc, models, blocks, temps),
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
        models = lay.models(_one_lane(m))
        curves = _sweeps(sc, lay, models, blocks,
                         _chunk_draws(sc, models, blocks, temps),
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


# megachunk fusion: True here and False in ``anneal.SUPPORTS_MEGACHUNK``;
# the engine's width resolver reads the flag, as the reference's does
SUPPORTS_MEGACHUNK = True

# the never-firing early-exit thresholds of a disarmed fused group: a
# chain qualifies when ``best_k >= cert_k and best_mv <= cert_mv``, and
# no key reaches int32 max and no move count is negative
MEGA_DISARMED_KEY = _IMAX
MEGA_DISARMED_MOVES = -1


def _mega_step(sc: LaneBundle, lay: Layout, models, blocks, temps, done,
               cks, cms, armed: bool, snapshot_every: int) -> tuple:
    """One step of a fused group over the blocks (updated in place; their
    keys are device keys): the chunk stepper's sweeps with the
    temperatures ``temps[b]`` ``[c, lanes]`` and the keys split on the
    device, kept where ``run = ~done`` (every state leaf, the keys
    included, through ``torch.where``; a skipped step's curve is zeros).
    ARMED, ``done`` then takes in whether any chain of any block
    qualifies (``best_k >= cert_k and best_mv <= cert_mv``); disarmed it
    stays as it is. Every value lives on the device: no host read, so a
    CUDA graph can capture the step. Returns ``(curves, runs, done)``, a
    device tensor a block each."""
    c = temps[0].shape[0]
    runs = [~dn for dn in done]
    new = [list(st) for st in blocks]
    draws = []
    for st, tb in zip(new, temps):
        subs, st[4] = prng.split_chain(st[4], c)
        draws.append({"host": None, "device": (subs, tb)})
    cvs = _sweeps(sc, lay, models, new, draws, snapshot_every)
    curves = []
    for st, nw, run, cv in zip(blocks, new, runs, cvs):
        for x in range(5):
            st[x] = torch.where(run, nw[x], st[x])
        curves.append(torch.where(run, cv, 0))
    if armed:
        hits = lay.any([((st[1] >= ck) & (st[2] <= cm)).any()
                        for st, ck, cm in zip(blocks, cks, cms)])
        done = [dn | h for dn, h in zip(done, hits)]
    return curves, runs, done


def _mega_outs(blocks, cks, cms) -> tuple:
    """A fused group's outputs from its blocks' state: ``(top_a, top_k,
    cert_a, cert_ok, cert_mv_out)`` a block (lists)."""
    tas, tks = _tops(blocks)
    cas, oks, cmo = [], [], []
    for st, ck, cm in zip(blocks, cks, cms):
        best_k, best_mv, best_a = st[1], st[2], st[3]
        lanes = torch.arange(best_k.shape[0], device=best_k.device)
        qual = (best_k >= ck) & (best_mv <= cm)
        ok = qual.any(1)
        cidx = first_argmin_rows(torch.where(qual, best_mv, _IMAX))
        cas.append(best_a[lanes, cidx])
        oks.append(ok)
        cmo.append(torch.where(ok, best_mv[lanes, cidx], _IMAX))
    return tas, tks, cas, oks, cmo


def _skipped(st, c: int) -> tuple:
    """A step the host skips (``active`` false): a zero curve ``[lanes,
    c]`` and a false ``execd``, on the block's device."""
    dev = st[0].device
    return (torch.zeros(st[0].shape[0], c, dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))


def _mega_run(sc: LaneBundle, lay: Layout, models, blocks, tables, active,
              cks, cms, armed: bool, snapshot_every: int) -> tuple:
    """A fused group over the blocks, eagerly (updated in place): step j
    runs (:func:`_mega_step`) where the host's ``active[j]`` holds and
    the device's ``done`` does not, with the temperatures
    ``tables[b][j]``; an inactive step (a padded tail) launches nothing.
    Returns ``(top_a, top_k, cert_a, cert_ok, cert_mv_out, curves)`` a
    block (lists) and ``execd [K]``."""
    c = tables[0].shape[1]
    done = [torch.zeros((), dtype=torch.bool, device=st[0].device)
            for st in blocks]
    curves, execd = [[] for _ in blocks], []
    for j, act in enumerate(active):
        if not act:
            for st, cb in zip(blocks, curves):
                cb.append(_skipped(st, c)[0])
            execd.append(_skipped(blocks[0], c)[1])
            continue
        cvs, runs, done = _mega_step(sc, lay, models, blocks,
                                     [tb[j] for tb in tables], done, cks,
                                     cms, armed, snapshot_every)
        for cb, cv in zip(curves, cvs):
            cb.append(cv)
        execd.append(runs[0])
    return (*_mega_outs(blocks, cks, cms),
            [torch.stack(cb, 1) for cb in curves], torch.stack(execd))


# ---------------------------------------------------------------------------
# The group graph: one step of a fused group on one card captured as ONE
# CUDA graph, replayed once an active step of a group (the reference's group
# is one device-resident ``lax.scan``, one dispatch). One graph serves every
# width, model and state of a bucket: it reads them from static buffers
# (the state and ``done`` carried from replay to replay inside them), copied
# in before a group's first replay, and its outputs are copied out of its
# pool after each replay.

# the most graphs kept (least recently used first out): a group's static
# state is ~21 MB at the adversarial bucket and L=8, its model tables up to
# two [L, P, B+1] int32 weight tables (~84 MB each at L=8, lane stride 0
# for a portfolio)
GROUP_GRAPHS_MAX = 8
_GROUP_LOCK = threading.Lock()
_GROUP_GRAPHS: OrderedDict = OrderedDict()  # key -> [_GroupGraph, ...]
# the group graphs of this process: captures, replays (steps replayed,
# each its pieces' graphs), evictions
GROUP_STATS = {"captures": 0, "replays": 0, "evicted": 0}


def _static_like(t: torch.Tensor):
    """A static buffer shaped as a block model's table ``t`` (lane axis
    first): ``(view, base, shared)``; a table the lanes share (lane
    stride 0) keeps one lane's storage, expanded."""
    shared = t.dim() > 0 and t.stride(0) == 0
    base = torch.empty(t.shape[1:] if shared else t.shape, dtype=t.dtype,
                       device=t.device)
    return (base.unsqueeze(0).expand(t.shape) if shared else base), base, \
        shared


def _graph_key(scorer: str, lay: Layout, m: ModelArrays, st, c: int,
               snapshot_every: int) -> tuple:
    """A group graph's identity: the bucket (the state's and the tables'
    shapes), the lanes and shards, the chunk length, the cadence, the
    scorer, the card and which tables the lanes share; never the group's
    width, the model or the state's values."""
    return ("group", scorer, str(st[0].device), lay.solo, lay.C, lay.L,
            tuple(st[0].shape), c, snapshot_every,
            tuple((tuple(getattr(m, f).shape), getattr(m, f).stride(0) == 0)
                  for f in _MODEL_FIELDS))


class _GroupGraph:
    """One step of a fused group (:func:`_mega_step`, armed, one block on
    one card) captured as CUDA graphs over static buffers: the block's
    model tables, its state (the keys as device keys) and ``done``, the
    step's temperatures ``[c, lanes]`` and the certificate's thresholds,
    and the step's own working state, sweep keys, histograms and curve.
    The step is cut into pieces, each its own graph in one memory pool:
    the prologue (the keys' split and the chunk-entry rescore), one piece
    a sweep (with its snapshot where the cadence puts one) and the
    epilogue (the ``torch.where`` on ``run = ~done``, the exit test and
    the group's outputs), each writing what the next reads back into the
    static buffers. A capture holds the process's capture lock for one
    piece at a time, so another thread's capture or device-wide sync
    waits for one sweep's capture, not a step's.

    A group copies its values in, then replays the pieces once an active
    step (the step's temperatures copied in first; an inactive step
    replays nothing), and clones each step's curve and ``execd`` and the
    last step's state and outputs out of the pool before anything can
    overwrite them. One solve at a time holds an instance (``busy``,
    :func:`_group_graph`); the next group of an instance, on any stream,
    waits for the last one's copies (``event``). ``launches`` is what one
    step's replays launch of each kernel (``ops.kernels``), added to
    their counts at every step.

    Construction makes the buffers and runs the pieces once eagerly on a
    side stream (it builds the kernels, the model's launch tables and
    lane views and the allocator's blocks); :meth:`capture` records
    them."""

    def __init__(self, sc: LaneBundle, lay: Layout, m: ModelArrays, st,
                 temp, cert, snapshot_every: int):
        from ...ops import kernels

        dev = st[0].device
        tabs = {f: _static_like(getattr(m, f)) for f in _MODEL_FIELDS}
        self.m = ModelArrays(**{f: v[0] for f, v in tabs.items()})
        self._bases = {f: v[1:] for f, v in tabs.items()}
        self._copy_model(m)
        self.st = [x.clone() for x in st]
        self.new = [x.clone() for x in st]
        self.temp = temp.clone()
        self.cert = [x.clone() for x in cert]
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        c = temp.shape[0]
        self.busy = False
        self.event = None

        def prologue():
            subs, key = prng.split_chain(self.st[4], c)
            for dst, src in zip(self.new[:4], self.st[:4]):
                dst.copy_(src)
            self.new[4].copy_(key)
            hist = sc.full(self.m, self.new[0])[1:]
            if not hasattr(self, "subs"):  # the eager run sizes them
                self.subs = torch.empty_like(subs)
                self.hist = [torch.empty_like(h) for h in hist]
            self.subs.copy_(subs)
            for dst, src in zip(self.hist, hist):
                dst.copy_(src)

        def sweep(i):
            new, hist, cv = [list(self.new)], [list(self.hist)], [[]]
            _sweep_range(sc, lay, [self.m], new, hist,
                         [{"host": None, "device": (self.subs, self.temp)}],
                         (i,), c, snapshot_every, cv)
            for dst, src in zip([*self.new[:4], *self.hist],
                                [*new[0][:4], *hist[0]]):
                if src is not dst:
                    dst.copy_(src)
            self.curve[:, i].copy_(cv[0][0])

        def epilogue():
            run = ~self.done
            for x in range(5):
                self.st[x].copy_(torch.where(run, self.new[x], self.st[x]))
            ck, cm = self.cert
            hit = ((self.st[1] >= ck) & (self.st[2] <= cm)).any()
            self.done.copy_(self.done | hit)
            return (torch.where(run, self.curve, 0), run,
                    _mega_outs([self.st], [ck], [cm]))

        self.curve = torch.zeros(st[0].shape[0], c, dtype=torch.int32,
                                 device=dev)
        self._pieces = [prologue, *(lambda i=i: sweep(i) for i in range(c)),
                        epilogue]
        # its launches and the captures' are no solve's work
        with kernels.recording():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for piece in self._pieces:
                    piece()
            torch.cuda.current_stream(dev).wait_stream(side)

    def capture(self, lock) -> None:
        """Record the pieces on a stream of their own, each under
        ``lock`` (the capture lock). Not through ``torch.cuda.graph``,
        whose entry synchronizes the card and empties the allocator's and
        the pinned host memory's caches, each a wait for every stream's
        work (another thread's solve included) while the lock is held:
        the static buffers already hold the step's inputs and nothing
        runs during a capture."""
        from ...ops import kernels

        pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        with kernels.recording() as rec, \
                torch.cuda.stream(torch.cuda.Stream(self.st[0].device)):
            for piece in self._pieces:
                g = torch.cuda.CUDAGraph()
                with lock:
                    g.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                    try:
                        out = piece()
                    finally:
                        g.capture_end()
                self.graphs.append(g)
        self.curve_out, self.run, self.outs = out
        self.launches = dict(rec)
        del self._pieces  # their closures hold the instance

    def _copy_model(self, m: ModelArrays) -> None:
        for f, (base, shared) in self._bases.items():
            src = getattr(m, f)
            base.copy_(src[0] if shared else src)
        self._src = weakref.ref(m)

    def group(self, m: ModelArrays, st, table, active, cert) -> tuple:
        """One group on the current stream from block model ``m``, state
        ``st``, the temperature table ``table [K, c, lanes]``, the host's
        ``active [K]`` and ``cert`` (the thresholds, device scalars);
        returns ``(state, outputs)`` as :func:`_mega_run` leaves and
        returns them, in fresh tensors. The model is copied in only when
        it is not the one the buffers hold."""
        from ...ops import kernels

        cur = torch.cuda.current_stream(st[0].device)
        if self.event is not None:
            cur.wait_event(self.event)
        if self._src() is not m:
            self._copy_model(m)
        for dst, src in zip([*self.st, *self.cert], [*st, *cert]):
            dst.copy_(src)
        self.done.zero_()
        c = table.shape[1]
        curves, execd, steps = [], [], 0
        for j, act in enumerate(active):
            if not act:
                cv, ex = _skipped(self.st, c)
            else:
                self.temp.copy_(table[j])
                for g in self.graphs:
                    g.replay()
                kernels.add_launches(self.launches)
                steps += 1
                cv, ex = self.curve_out.clone(), self.run.clone()
            curves.append(cv)
            execd.append(ex)
        outs = (tuple([x.clone() for x in o] for o in self.outs) if steps
                else _mega_outs([self.st], [self.cert[0]], [self.cert[1]]))
        state = [x.clone() for x in self.st]
        self.event = torch.cuda.Event()
        self.event.record(cur)
        with _GROUP_LOCK:
            GROUP_STATS["replays"] += steps
        return state, (*outs, [torch.stack(curves, 1)], torch.stack(execd))


def _idle_graph(key):
    """An idle instance of ``key``'s graphs, checked out; None when there
    is none. Under ``_GROUP_LOCK``."""
    insts = _GROUP_GRAPHS.get(key)
    if insts:
        _GROUP_GRAPHS.move_to_end(key)
        for g in insts:
            if not g.busy:
                g.busy = True
                return g
    return None


def _evict() -> None:
    """Drop idle instances, least recently used first, down to
    ``GROUP_GRAPHS_MAX``, each after its last group's copies. Under
    ``_GROUP_LOCK``."""
    total = sum(len(v) for v in _GROUP_GRAPHS.values())
    for key in list(_GROUP_GRAPHS):
        insts = _GROUP_GRAPHS[key]
        for g in [g for g in insts if not g.busy]:
            if total <= GROUP_GRAPHS_MAX:
                return
            if g.event is not None:
                g.event.synchronize()
            insts.remove(g)
            total -= 1
            GROUP_STATS["evicted"] += 1
        if not insts:
            del _GROUP_GRAPHS[key]


def _group_graph(key, build) -> _GroupGraph:
    """Check out an instance of ``key``'s graph: an idle one, else one
    made now by ``build()`` (its buffers and eager warm-up step) and
    captured under the process's capture lock, unless an instance
    another thread captured meanwhile is idle by then (it is taken
    instead). A capture counts in ``anneal.GRAPH_CAPTURES``, the solve's
    compile time (the warm-up's too) and the recompile sentinel
    (``anneal._note_capture``)."""
    from .anneal import _CAPTURE_LOCK, _note_capture

    with _GROUP_LOCK:
        g = _idle_graph(key)
    if g is not None:
        return g
    t0 = time.perf_counter()
    g = build()
    with _GROUP_LOCK:
        other = _idle_graph(key)
    if other is not None:
        return other
    g.capture(_CAPTURE_LOCK)
    _note_capture(time.perf_counter() - t0, key)
    with _GROUP_LOCK:
        GROUP_STATS["captures"] += 1
        g.busy = True
        _GROUP_GRAPHS.setdefault(key, []).append(g)
        _GROUP_GRAPHS.move_to_end(key)
        _evict()
    return g


def group_graphs_snapshot() -> dict:
    """The group graphs held (instances, keys) and this process's
    captures, replays and evictions."""
    with _GROUP_LOCK:
        return {"graphs": sum(len(v) for v in _GROUP_GRAPHS.values()),
                "keys": len(_GROUP_GRAPHS), "max": GROUP_GRAPHS_MAX,
                **GROUP_STATS}


def clear_group_graphs() -> None:
    """Drop every idle group graph (tests; the next group captures)."""
    with _GROUP_LOCK:
        for key in list(_GROUP_GRAPHS):
            for g in _GROUP_GRAPHS[key]:
                if g.event is not None:
                    g.event.synchronize()
            _GROUP_GRAPHS[key] = [g for g in _GROUP_GRAPHS[key] if g.busy]
            if not _GROUP_GRAPHS[key]:
                del _GROUP_GRAPHS[key]


def _replay_group(sc: LaneBundle, scorer: str, lay: Layout, m: ModelArrays,
                  st, table, active, cert, snapshot_every: int) -> tuple:
    """One fused group of one block as replays of its bucket's step graph
    (captured at the bucket's first group): ``(state, outputs)`` as
    :func:`_mega_run` leaves and returns them for that block."""
    c = table.shape[1]
    g = _group_graph(_graph_key(scorer, lay, m, st, c, snapshot_every),
                     lambda: _GroupGraph(sc, lay, m, st, table[0], cert,
                                         snapshot_every))
    try:
        return g.group(m, st, table, active, cert)
    finally:
        with _GROUP_LOCK:
            g.busy = False


def _mega(sc: LaneBundle, scorer: str, lay: Layout, m: ModelArrays, state,
          temps, active, cert_k, cert_mv, snapshot_every: int,
          graph: bool | None) -> tuple:
    """A fused group over the blocks of ``lay`` (see
    :func:`make_mega_lane_stepper_fn`)."""
    models = lay.models(m)
    blocks = lay.split(state)
    host_keys = not prng.is_device_key(blocks[0][4])
    K = temps.shape[0]
    active = [bool(x) for x in active]  # host data: the schedule's steps
    armed = (int(cert_k), int(cert_mv)) != (MEGA_DISARMED_KEY,
                                            MEGA_DISARMED_MOVES)
    on_card = blocks[0][0].device.type == "cuda"
    if graph is None:
        graph = on_card and lay.whole
    if graph and not (on_card and lay.whole):
        raise ValueError("a group graph runs one block on one card")
    tables, certs = [], []
    for mb, st in zip(models, blocks):
        dev = st[0].device
        st[4] = prng.to_device_keys(st[4], dev)
        tables.append(_temp_table(temps, mb, dev))
        certs.append(list(_to_device(torch.tensor(
            [int(cert_k), int(cert_mv)], dtype=torch.int32), dev)))
    if graph:
        blocks[0], outs = _replay_group(sc, scorer, lay, models[0],
                                        blocks[0], tables[0], active,
                                        certs[0], snapshot_every)
    else:
        outs = _mega_run(sc, lay, models, blocks, tables, active,
                         [c[0] for c in certs], [c[1] for c in certs],
                         armed, snapshot_every)
    tas, tks, cas, oks, cms, curves, execd = outs
    if host_keys:
        for st in blocks:
            st[4] = prng.to_host_keys(st[4])
    lead = (lay.L,) if lay.mesh is None else (lay.C, lay.L)
    if lay.solo:
        lead = lead[:-1]
    return (lay.join(blocks), lay.gather(tas), lay.gather(tks),
            lay.gather(cas), lay.gather(oks), lay.gather(cms),
            lay.gather(curves), execd.expand(*lead, K).clone())


def make_mega_lane_stepper_fn(n_chains: int, snapshot_every: int = 8,
                              scorer: str = "torch", mesh=None,
                              graph: bool | None = None):
    """K consecutive chunk steps as one fused group over L lanes (the
    reference's ``make_mega_lane_stepper_fn``): ``(m_stack, state, temps
    [K, c], active [K] bool, cert_k, cert_mv) -> (state', top_a [L, P,
    R], top_k [L], cert_a [L, P, R], cert_ok [L], cert_mv_out [L], curves
    [L, K, c], execd [L, K])``; on a solve mesh (``mesh``) every output
    gains the leading shard axis ``[C, ...]``, as the state does
    (:func:`make_lane_stepper_fn`).

    Each step is the UNCHANGED chunk stepper's run on the carried state,
    so a group replays the chunked ladder bit for bit. As in the
    reference's scan, the group carries a ``done`` flag on the device: a
    step runs where ``active`` holds and ``done`` does not. ``active`` is
    the host's (a short tail clears its padding steps), so an inactive
    step launches nothing, as the reference's ``lax.cond`` skips it. The
    step after an exit (``done`` set) cannot be told from the host
    without a read: it runs, and its result is dropped through
    ``torch.where`` for every state leaf, the keys included (a zero
    curve), which is what the reference's ``lax.cond`` lowers to under
    ``vmap``; the reference's solo group, not vmapped, skips that work.
    After each step of an ARMED group a chain qualifies when ``best_k >=
    cert_k and best_mv <= cert_mv`` (the boundary certificate's
    device-side precheck); one qualifying chain in any lane of any shard
    sets ``done`` (the reference's ``pmax`` over its shard and lane
    axes). DISARMED groups pass the sentinels ``MEGA_DISARMED_KEY`` /
    ``MEGA_DISARMED_MOVES``, which never qualify, and test nothing.

    Nothing inside a group is read by the host: the keys split on the
    device (a host key state enters as device keys, and leaves as host
    keys, read once after the group; device keys stay on the device),
    the temperatures are a device table ``[K, c, lanes]`` and ``execd``
    is a device bool tensor. On a card, with every block on it (the
    default when ``graph`` is None), each active step is one replay of
    its bucket's step graph (the CUDA graphs of the step's pieces),
    captured once for its bucket
    (:class:`_GroupGraph`; one graph per bucket, lanes, shards, c,
    cadence and scorer, whatever the width, the model and the seed), the
    state and ``done`` carried on the card from replay to replay;
    ``graph=False`` runs the steps eagerly, and a group whose blocks
    span several cards runs its steps from the host, as the migration
    copies values between cards mid-group. ``cert_a`` is each
    lane's qualifying snapshot with the fewest moves (``cert_mv_out`` its
    moves, int32 max when none qualifies)."""
    sc = _make_lane_scorer(scorer)

    def solve(m: ModelArrays, state, temps, active, cert_k, cert_mv):
        return _mega(sc, scorer, Layout(mesh, m.num_lanes, solo=False), m,
                     state, temps, active, cert_k, cert_mv, snapshot_every,
                     graph)

    return solve


def make_mega_stepper_fn(n_chains: int, snapshot_every: int = 8,
                         scorer: str = "torch", mesh=None,
                         graph: bool | None = None):
    """:func:`make_mega_lane_stepper_fn` on one model: ``(m, state,
    temps [K, c], active [K], cert_k, cert_mv) -> (state', top_a [P, R],
    top_k, cert_a [P, R], cert_ok, cert_mv_out, curves [K, c], execd
    [K])`` with the single-model sweep state of
    :func:`make_sweep_stepper_fn` (on a mesh, each output ``[C, ...]``)."""
    sc = _make_lane_scorer(scorer)

    def solve(m: ModelArrays, state, temps, active, cert_k, cert_mv):
        return _mega(sc, scorer, Layout(mesh, 1, solo=True), _one_lane(m),
                     state, temps, active, cert_k, cert_mv, snapshot_every,
                     graph)

    return solve
