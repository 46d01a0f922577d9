"""Per-move Metropolis chains: the small-instance engine.

Counterpart of ``kafka_assignment_optimizer_tpu.solvers.tpu.anneal``. A
population of N candidate assignments ``A[N, P, R]`` runs N independent
Metropolis chains. Every step proposes one of three constraint-aware
moves per chain and prices it in O(RF) from the carried histograms:

- ``replace``  A[p, s] <- b_new (restores the slot's original broker with
  probability ``P_RESTORE``, else a uniform broker);
- ``lswap``    swap A[p, 0] <-> A[p, s] (leadership only);
- ``xswap``    swap A[p1, s1] <-> A[p2, s2] across partitions (broker and
  rack totals invariant).

The reference vmaps one chain's step and scans it; here one step runs over
the whole ``[N]`` chain axis with advanced indexing, so a step is a fixed
few hundred tensor operations whatever N is. The step runs on a stacked
model (:func:`make_lane_solver_fn`): L lanes' chains are one ``[L·N]``
chain axis, each chain reading its own lane's tables, bands, penalty
scale and temperature, the same per-chain arithmetic as L single-model
runs, in one step's operations; a single model is its one lane
(:func:`make_solver_fn`). On a solve mesh (``parallel.mesh``) each lane
runs C chain shards, a device's shards one chain axis, and every round
ends with the best migration over the shards of each lane
(:func:`_migrate_blocks`), outside the captured steps. The reference
computes this engine in XLA with no Pallas kernel, so it is plain
PyTorch on either device. On the card a round's step loop is captured as CUDA graphs
(``_StepGraphs``) and replayed, so the host launches one graph per
``_GRAPH_STEPS`` steps instead of each operation of each step. Every
operation reproduces the reference's int32 and float32 arithmetic: the
random words are the reference's (``prng``), taken as non-negative int64
so the uint32 modulus and masks stay exact; the Metropolis division is
by a float32 device tensor (``max(temp, 1e-6)``, never a host scalar);
ties pick the first index; and every write goes to a fresh tensor.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ... import prng
from ...analysis import sanitize as _sanitize
from ...obs import flight as _flight
from ...ops.score_cuda import score
from ...parallel.mesh import TRIVIAL, Block, Layout, owner_rows, put_rows
from .arrays import LAMBDA, SCALE_W, ModelArrays, u01
from .sweep import _one_lane, first_argmax_rows, first_argmin_rows

# no fused megachunk groups here (the engine's width resolver reads the
# flag; ``sweep.SUPPORTS_MEGACHUNK`` is True), as in the reference
SUPPORTS_MEGACHUNK = False

# move-type proposal mix (the reference's constants); the comparisons run
# in float32, so the thresholds are taken as float32 values
P_REPLACE = 0.45
P_LSWAP = 0.10  # remainder goes to xswap
P_RESTORE = 0.5
_T_REP = float(np.float32(P_REPLACE))
_T_LSW = float(np.float32(P_REPLACE + P_LSWAP))
_T_RESTORE = float(np.float32(P_RESTORE))
_TEMP_FLOOR = np.float32(1e-6)
# steps of every chain captured in one CUDA graph on the card
_GRAPH_STEPS = 32
_INT_FIELDS = ("a", "cnt", "lcnt", "rcnt", "pen", "w")


@dataclass(frozen=True)
class ChainState:
    """Annealing state of N chains (leading axis N)."""

    a: torch.Tensor  # [N, P, R] int32
    cnt: torch.Tensor  # [N, B+1] int32 replicas per broker
    lcnt: torch.Tensor  # [N, B+1] int32 leaders per broker
    rcnt: torch.Tensor  # [N, K+1] int32 replicas per rack
    pen: torch.Tensor  # [N] int32 total band + diversity violations
    w: torch.Tensor  # [N] int32 preservation weight
    key: torch.Tensor  # [N, 2] int64 (uint32 words), on the device


def chain_score(st: ChainState) -> torch.Tensor:
    return SCALE_W * st.w - LAMBDA * st.pen


def best_key(st: ChainState) -> torch.Tensor:
    """int32 ranking: any feasible chain (weight >= 0) beats any
    infeasible one (strictly negative, ranked by penalty)."""
    return torch.where(st.pen == 0, st.w, -st.pen - 1)


def init_chain(m: ModelArrays, a_seed: torch.Tensor,
               keys: torch.Tensor) -> ChainState:
    """Every chain at the seed, fully scored once (B1 on the card);
    ``keys`` int64 ``[N, 2]`` on the device, one a chain."""
    n = keys.shape[0]
    a = a_seed.to(torch.int32)[None]
    out, cnt, lcnt, rcnt = score(m, a)
    pen = out[:, 1:5].sum(1, dtype=torch.int32)
    return ChainState(
        a=a.repeat(n, 1, 1),
        cnt=cnt.repeat(n, 1),
        lcnt=lcnt.repeat(n, 1),
        rcnt=rcnt.repeat(n, 1),
        pen=pen.repeat(n),
        w=out[:, 0].repeat(n),
        key=keys,
    )


def _tables(m: ModelArrays) -> dict:
    """The model's tables as the step reads them, once per model: int64
    (the step computes in int64, exact for these int32 values, so it
    pays for no index conversions), the two weight tables stacked flat
    as ``w[role, p, b]`` (role 1 = leader). The stacked model's tables
    are flattened over the lane axis (a chain adds its lane's offset to
    each index, :func:`_lane_offsets`), its bands and penalty scales kept
    one a lane."""
    cached = m.__dict__.get("_chain_tables")
    if cached is None:
        R = m.max_rf
        cached = {
            "rf": m.rf.long().reshape(-1),
            "a0": m.a0.long().reshape(-1, R),
            "slot_valid": m.slot_valid.reshape(-1, R),
            "w": torch.stack([m.w_foll, m.w_lead], -3).reshape(-1).long(),
            "rack_of": m.rack_of.long().reshape(-1),
            "rack_lo": m.rack_lo.long().reshape(-1),
            "rack_hi": m.rack_hi.long().reshape(-1),
            "part_rack_hi": m.part_rack_hi.long().reshape(-1),
            "blo": m.broker_band[..., 0].long(),
            "bhi": m.broker_band[..., 1].long(),
            "llo": m.leader_band[..., 0].long(),
            "lhi": m.leader_band[..., 1].long(),
            "lam": m.lam.reshape(-1),
        }
        object.__setattr__(m, "_chain_tables", cached)
    return cached


def _lane_offsets(m: ModelArrays, t: dict, n_total: int) -> dict:
    """For a stacked model of L lanes and ``n_total = L·N`` chains (lane
    major): each chain's index offsets into the flattened tables (``p``:
    partition rows, ``b``: broker entries, ``k``: rack entries, ``w``:
    the weight table) and its lane's bands and penalty scale, cached per
    chain count."""
    L = m.num_lanes
    key = ("_lane_offsets", n_total)
    cached = t.get(key)
    if cached is None:
        P, B, K = m.num_parts, m.num_brokers, m.num_racks
        lane = torch.arange(n_total, device=m.device) // (n_total // L)
        cached = {
            "p": lane * P, "b": lane * (B + 1), "k": lane * (K + 1),
            "w": lane * (2 * P * (B + 1)),
            **{f: t[f][lane] for f in ("blo", "bhi", "llo", "lhi", "lam")},
        }
        t[key] = cached
    return cached


def _delta_band(c_from, c_to, lo, hi):
    """Penalty delta of moving one unit from bucket value c_from to c_to:
    ``band_pen(c_from - 1) - band_pen(c_from) + band_pen(c_to + 1) -
    band_pen(c_to)``, in its closed form for integers (one unit out of
    ``c`` changes the penalty by ``[c <= lo] - [c > hi]``, one unit in
    by ``[c >= hi] - [c < lo]``)."""
    return (((c_from <= lo).long() - (c_from > hi).long())
            + ((c_to >= hi).long() - (c_to < lo).long()))


def _anneal_step(m: ModelArrays, st: ChainState, temp_div: torch.Tensor,
                 row: torch.Tensor) -> ChainState:
    """One Metropolis step of every chain of the stacked model ``m``.
    ``row`` is ``[N, 8]`` int64 random words (one row of the round's
    presampled bits a chain); ``temp_div`` the float32 ``[N]``
    denominators ``max(temp, 1e-6)``. The
    state's tensors are int64 here (``make_round_runner`` converts at
    the round's ends); every value equals the reference's int32 one.

    The reference prices all three move types and selects; here the
    leader-histogram and weight deltas are priced once, on the
    (from, to) pair of the move type each chain drew — the same integer
    terms, so the same sums."""
    t = _tables(m)
    P, R = m.num_parts, m.max_rf
    B, K = m.num_brokers, m.num_racks
    PB1 = P * (B + 1)
    n = torch.arange(st.a.shape[0], device=st.a.device)
    off = _lane_offsets(m, t, st.a.shape[0])

    def at(name, idx, o):  # the chain's own lane's table entry
        return t[name][idx + off[o]]

    def at_rows(name, idx, o):  # the same for [N, W] index rows
        return t[name][idx + off[o][:, None]]

    blo, bhi, llo, lhi, lam = (off[f]
                               for f in ("blo", "bhi", "llo", "lhi", "lam"))

    def col(x, idx):  # x[n, idx[n]] for per-chain rows x [N, W]
        return x.gather(1, idx[:, None])[:, 0]

    p = row[:, 0] % P
    rfp = at("rf", p, "p")
    u_type = u01(row[:, 1])
    is_rep = u_type < _T_REP
    is_lsw = (u_type >= _T_REP) & (u_type < _T_LSW)
    is_xsw = ~(is_rep | is_lsw)

    # rfp == 0 only on bucket-padded rows: the clamp keeps the modulus
    # defined; the rfp > 0 guards below reject every move touching them
    s_raw = row[:, 2] & 0x3FFFFFFF
    s_rep = s_raw % torch.clamp_min(rfp, 1)
    s_lsw = 1 + s_raw % torch.clamp_min(rfp - 1, 1)
    s_lswc = torch.clamp_max(s_lsw, R - 1)  # a read clamps, as XLA's
    s1 = torch.where(is_lsw, s_lsw, s_rep)

    row1 = st.a[n, p]  # [N, R]
    valid1 = at("slot_valid", p, "p")
    b_old = col(row1, torch.clamp_max(s1, R - 1))
    b_uni = row[:, 3] % B
    b_orig = t["a0"][p + off["p"], (row[:, 7] & 0xFFFF) % R]
    b_new_rep = torch.where((u01(row[:, 7]) < _T_RESTORE) & (b_orig < B),
                            b_orig, b_uni)

    p2 = row[:, 4] % P
    rfp2 = at("rf", p2, "p")
    s2 = (row[:, 5] & 0x3FFFFFFF) % torch.clamp_min(rfp2, 1)
    row2 = st.a[n, p2]
    valid2 = at("slot_valid", p2, "p")
    b2 = col(row2, s2)

    bl = row1[:, 0]
    bf = col(row1, s_lswc)
    b_in = torch.where(is_rep, b_new_rep, torch.where(is_lsw, bf, b2))

    # --- validity -----------------------------------------------------
    in_p1 = ((row1 == b_in[:, None]) & valid1).any(1)
    in_p2 = ((row2 == b_old[:, None]) & valid2).any(1)
    live = rfp > 0
    valid = torch.where(
        is_rep, ~in_p1 & live,
        torch.where(is_lsw, rfp >= 2,
                    ~in_p1 & live & ~in_p2 & (rfp2 > 0) & (p != p2)))

    # --- weight delta: w[r1, p, x1] - w[r1, p, y1] + w[r2, q, x2]
    # - w[r2, q, y2]; replace: the second pair cancels; leader swap:
    # (lead, bf, bl) then (follow, bl, bf); exchange: (slot roles of
    # s1, b2, b_old) at p then (role of s2, b_old, b2) at p2
    lead1 = s1 == 0
    lead2 = s2 == 0
    role1 = torch.where(is_lsw, 1, lead1.long()) * PB1 + p * (B + 1)
    x1 = torch.where(is_rep, b_in, torch.where(is_lsw, bf, b2))
    y1 = torch.where(is_lsw, bl, b_old)
    q_off = torch.where(
        is_lsw, p * (B + 1),
        torch.where(is_xsw, lead2.long() * PB1 + p2 * (B + 1), 0))
    x2 = torch.where(is_lsw, bl, torch.where(is_xsw, b_old, 0))
    y2 = torch.where(is_lsw, bf, torch.where(is_xsw, b2, 0))
    role1, q_off = role1 + off["w"], q_off + off["w"]
    w = t["w"]
    dw = (w[role1 + x1] - w[role1 + y1]) + (w[q_off + x2] - w[q_off + y2])

    # --- penalty deltas ----------------------------------------------
    def f_cnt(b_from, b_to, counts, lo, hi):
        both_real = (b_from < B) & (b_to < B)
        d = _delta_band(col(counts, b_from), col(counts, b_to), lo, hi)
        return torch.where(both_real & (b_from != b_to), d, 0)

    d_cnt = f_cnt(b_old, b_in, st.cnt, blo, bhi)
    lead_xor = lead1 ^ lead2
    lsub = torch.where(lead_xor, torch.where(lead1, b_old, b2), B)
    ladd = torch.where(lead_xor, torch.where(lead1, b2, b_old), B)
    # the leader-histogram move of each type (B: none)
    l_from = torch.where(is_rep, torch.where(lead1, b_old, B),
                         torch.where(is_lsw, bl, lsub))
    l_to = torch.where(is_rep, torch.where(lead1, b_in, B),
                       torch.where(is_lsw, bf, ladd))
    d_lead = f_cnt(l_from, l_to, st.lcnt, llo, lhi)

    r_old, r_in = at("rack_of", b_old, "b"), at("rack_of", b_in, "b")
    c_old, c_in = col(st.rcnt, r_old), col(st.rcnt, r_in)
    d_rack = torch.where(
        r_old != r_in,
        ((c_old <= at("rack_lo", r_old, "k")).long()
         - (c_old > at("rack_hi", r_old, "k")).long())
        + ((c_in >= at("rack_hi", r_in, "k")).long()
           - (c_in < at("rack_lo", r_in, "k")).long()),
        0,
    )

    def div_delta(racks_row, cap, r_from, r_to):
        # max(c - cap, 0) changes by -[c_from > cap] one out, and by
        # [c_to >= cap] one in
        c_from = (racks_row == r_from[:, None]).sum(1)
        c_to = (racks_row == r_to[:, None]).sum(1)
        return torch.where(r_from != r_to,
                           (c_to >= cap).long() - (c_from > cap).long(), 0)

    racks1 = torch.where(valid1, at_rows("rack_of", row1, "b"), K)
    d_div1 = div_delta(racks1, at("part_rack_hi", p, "p"), r_old, r_in)
    racks2 = torch.where(valid2, at_rows("rack_of", row2, "b"), K)
    d_div2 = div_delta(racks2, at("part_rack_hi", p2, "p"),
                       at("rack_of", b2, "b"), r_old)

    dpen = d_lead + torch.where(is_rep, d_cnt + d_rack + d_div1,
                                torch.where(is_lsw, 0, d_div1 + d_div2))

    # --- accept (float32, full-precision exp) --------------------------
    delta = (SCALE_W * dw).to(torch.float32) - lam * dpen.to(torch.float32)
    accept = valid & ((delta >= 0)
                      | (u01(row[:, 6]) < torch.exp(delta / temp_div)))

    # --- apply: two single-element writes a chain, into fresh tensors;
    # a rejected move writes its slot's own value back
    i1 = torch.where(is_lsw, 0, s1)
    v1 = torch.where(is_lsw, bf, b_in)
    pw2 = torch.where(is_xsw, p2, p)
    i2 = torch.clamp_max(torch.where(is_lsw, s_lsw,
                                     torch.where(is_xsw, s2, s1)), R - 1)
    v2 = torch.where(is_lsw, bl, torch.where(is_xsw, b_old, b_in))
    a = st.a.index_put((n, p, i1), torch.where(accept, v1, st.a[n, p, i1]))
    a = a.index_put((n, pw2, i2), torch.where(accept, v2, a[n, pw2, i2]))

    acc = accept.long()
    upd_c = acc * is_rep.long()
    cnt = (st.cnt.index_put((n, b_old), -upd_c, accumulate=True)
           .index_put((n, b_in), upd_c, accumulate=True))
    rcnt = (st.rcnt.index_put((n, r_old), -upd_c, accumulate=True)
            .index_put((n, r_in), upd_c, accumulate=True))
    upd_l = acc * ((l_from < B) & (l_to < B)).long()
    lcnt = (st.lcnt.index_put((n, l_from), -upd_l, accumulate=True)
            .index_put((n, l_to), upd_l, accumulate=True))

    return ChainState(
        a=a, cnt=cnt, lcnt=lcnt, rcnt=rcnt,
        pen=st.pen + torch.where(accept, dpen, 0),
        w=st.w + torch.where(accept, dw, 0),
        key=st.key,
    )


def _cast(st: ChainState, dtype: torch.dtype, key=None) -> ChainState:
    """``st`` with its integer leaves as ``dtype`` (and ``key`` in place
    of its keys, when given)."""
    return ChainState(a=st.a.to(dtype), cnt=st.cnt.to(dtype),
                      lcnt=st.lcnt.to(dtype), rcnt=st.rcnt.to(dtype),
                      pen=st.pen.to(dtype), w=st.w.to(dtype),
                      key=st.key if key is None else key)


def _migrate_blocks(blocks, sts: list, ks: list, red) -> list:
    """The reference's round-end migration over the chain shards of a
    mesh, each lane on its own: the lane's best chain (highest key over
    every shard, the owner the lowest shard index holding it, the first
    such chain within it) cloned over each shard's worst chain (lowest
    key, first index), keys untouched. ``sts``/``ks`` hold each block's
    chains (``[C_b·L_b·N]``, shard-major flat lanes of N chains, as
    ``parallel.mesh.Block`` lays them) and their keys; one shard of one lane is
    the reference's one-device mesh."""
    kl = [k.view(b.c1 - b.c0, b.l1 - b.l0, -1) for b, k in zip(blocks, ks)]
    local = [x.amax(2) for x in kl]
    gbest = red([x.amax(0) for x in local], "max")
    own = [lb == g for lb, g in zip(local, gbest)]
    leaves = [[getattr(st, f).reshape(k.shape[0] * k.shape[1], k.shape[2],
                                      *getattr(st, f).shape[1:])
               for f in _INT_FIELDS] for st, k in zip(sts, kl)]
    rows, sizes = owner_rows(blocks, red, own, first_argmax_rows, kl,
                              leaves)
    out = []
    for st, k, lv, row in zip(sts, kl, leaves, rows):
        C, L, N = k.shape
        fi = torch.arange(C * L, device=k.device) * N + first_argmin_rows(
            k.reshape(C * L, N))
        vals = [x.repeat(C, 1) for x in row.split(sizes, 1)]
        out.append(ChainState(
            **{f: put_rows(x, fi, v).reshape(getattr(st, f).shape)
               for f, x, v in zip(_INT_FIELDS, lv, vals)},
            key=st.key))
    return out


def _migrate(st: ChainState, k: torch.Tensor, lanes: int) -> ChainState:
    """The reference's round-end migration on a mesh of one device, within
    each lane's block of chains (:func:`_migrate_blocks` of one shard):
    the best chain (first index among ties) cloned over the worst (first
    index), keys untouched."""
    return _migrate_blocks([Block(None, 0, 1, 0, lanes)], [st], [k],
                           TRIVIAL)[0]


# every round runner's number: the recompile sentinel's key names the
# runner whose cache captured a graph
_RUNNER_IDS = itertools.count()
# one capture at a time in the process: entering torch.cuda.graph
# synchronizes the whole device, which another thread's capture in
# progress forbids (the service solves in several threads)
_CAPTURE_LOCK = threading.Lock()
# CUDA-graph captures of this process: count and seconds
GRAPH_CAPTURES = {"captures": 0, "capture_s": 0.0}


def _note_capture(seconds: float, key) -> None:
    """One graph capture: the process count, the solve's compile time
    (obs.flight) and the recompile sentinel's evidence."""
    GRAPH_CAPTURES["captures"] += 1
    GRAPH_CAPTURES["capture_s"] += seconds
    _flight.note_compile(seconds)
    _sanitize.note_compile(key)


class _StepGraphs:
    """A round's step loop on the card as CUDA graphs: ``k`` steps of
    every chain captured once over static buffers (the int64 state, ``k``
    rows of words a chain, the Metropolis denominator) and replayed in
    place, plus one graph of the ``steps % k`` steps left. The same
    operations on the same values as the eager loop."""

    def __init__(self, m: ModelArrays, st: ChainState, steps: int):
        dev = st.a.device
        self.steps = steps
        self.k = min(steps, _GRAPH_STEPS)
        self.st = ChainState(
            **{f: getattr(st, f).to(torch.int64, copy=True)
               for f in _INT_FIELDS}, key=st.key)
        self.rows = torch.zeros((st.a.shape[0], self.k, 8),
                                dtype=torch.int64, device=dev)
        # the Metropolis denominator, one a chain
        self.temp = torch.ones(st.a.shape[0], dtype=torch.float32,
                               device=dev)
        # one eager step on a side stream before capture builds the
        # model's tables and the allocator's blocks; its output is dropped
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _anneal_step(m, self.st, self.temp, self.rows[:, 0])
        torch.cuda.current_stream(dev).wait_stream(side)
        self.full = self._capture(m, self.k, None)
        tail = steps % self.k
        self.tail = self._capture(m, tail, self.full.pool()) if tail else None

    def _capture(self, m: ModelArrays, k: int, pool):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=pool,
                              capture_error_mode="thread_local"):
            out = self.st
            for s in range(k):
                out = _anneal_step(m, out, self.temp, self.rows[:, s])
            for f in _INT_FIELDS:
                getattr(self.st, f).copy_(getattr(out, f))
        return g

    def run(self, st: ChainState, temp_div: torch.Tensor,
            bits: torch.Tensor) -> ChainState:
        """``steps`` steps from ``st`` with the round's ``bits [N, steps,
        8]``; the result is the static buffers (the caller copies)."""
        for f in _INT_FIELDS:
            getattr(self.st, f).copy_(getattr(st, f))
        self.temp.copy_(temp_div)
        s = 0
        while s + self.k <= self.steps:
            self.rows.copy_(bits[:, s:s + self.k])
            self.full.replay()
            s += self.k
        if self.tail is not None:
            self.rows[:, :self.steps - s].copy_(bits[:, s:])
            self.tail.replay()
        return self.st


def make_round_runner(steps_per_round: int, graph: bool | None = None):
    """``(m, state, best_k, best_a, temp) -> (state, best_k, best_a)``:
    ``steps_per_round`` steps of every chain and the feasible-best
    snapshot. The round's migration is the caller's: the solver runs it
    over its mesh after every round (:func:`_migrate_blocks`;
    :func:`_migrate` is its one-shard case). ``m`` is
    a stacked model, or a single model run as its one lane. The
    temperature is scaled by each lane's ``temp_scale`` in float32; each
    chain's key splits once and its ``[steps_per_round, 8]`` words are
    one ``bits`` draw of the sub-key, as the reference draws them. ``graph``
    (default: on a CUDA state) replays the step loop as CUDA graphs
    captured at the runner's first round; ``False`` launches each
    operation eagerly."""
    graphs = {}
    runner = next(_RUNNER_IDS)

    def run_round(m: ModelArrays, st: ChainState, best_k: torch.Tensor,
                  best_a: torch.Tensor, temp):
        if not m.num_lanes:
            m = _one_lane(m)
        temp_div = _temp_div(m, temp, st.a.shape[0], st.a.device)
        ks = prng.split_rows(st.key)
        bits = prng.bits_rows(ks[:, 1], (steps_per_round, 8))
        if st.a.is_cuda if graph is None else graph:
            gkey = (id(m), tuple(st.a.shape))
            if gkey not in graphs:
                t0 = time.perf_counter()
                with _CAPTURE_LOCK:
                    graphs[gkey] = _StepGraphs(m, st, steps_per_round)
                _note_capture(time.perf_counter() - t0,
                              ("chain_graph", runner, *gkey))
            st = graphs[gkey].run(st, temp_div, bits)
        else:
            st = _cast(st, torch.int64)
            for s in range(steps_per_round):
                st = _anneal_step(m, st, temp_div, bits[:, s])
        st = _cast(st, torch.int32, key=ks[:, 0])
        k = best_key(st)
        improved = k > best_k
        best_k = torch.where(improved, k, best_k)
        best_a = torch.where(improved[:, None, None], st.a, best_a)
        return st, best_k, best_a

    return run_round


def _temp_div(m: ModelArrays, temp, n_total: int, device) -> torch.Tensor:
    """The Metropolis denominators ``max(temp * temp_scale, 1e-6)`` in
    float32 of the stacked model's ``n_total`` chains, each chain its
    lane's ``temp_scale``."""
    per_lane = [float(max(np.float32(temp) * np.float32(x), _TEMP_FLOOR))
                for x in m.lane_scalars()[2]]
    return torch.tensor(per_lane, dtype=torch.float32,
                        device=device).repeat_interleave(
                            n_total // m.num_lanes)


def chain_keys(key, n_chains: int, device) -> torch.Tensor:
    """The chains' keys of the reference's mesh of one: the shard key is
    ``split(key, 1)[0]``, split again into one key a chain."""
    shard = prng.split(key, 1)[0]
    return torch.tensor(prng.split(shard, n_chains).astype(np.int64),
                        device=device)


def _solve(lay: Layout, run_round, n_chains: int, m: ModelArrays, seeds,
           keys, temps):
    """The whole anneal of the L lanes of ``m`` on the blocks of ``lay``:
    lane l's key splits into one key a shard of the mesh (``split(keys[l],
    C)``, the reference's), each into one a chain; every chain of shard c
    and lane l starts at ``seeds[l]``. Each round runs every block's
    chains (one round runner a block), then the migration over the mesh.
    Returns each block's ``(best_a, best_k, curve)`` gathered by
    ``lay``."""
    from .arrays import lane_model

    L = m.num_lanes
    keys = np.asarray(keys, np.uint32).reshape(L, 2)
    shard_keys = np.stack([prng.split(k, lay.C) for k in keys], 1)
    models = lay.models(m)
    sts, bks, bas = [], [], []
    for b, mb in zip(lay.blocks, models):
        Lb = b.l1 - b.l0
        parts = [init_chain(
            lane_model(mb, (c - b.c0) * Lb + (l - b.l0)),
            seeds[l].to(mb.device),
            torch.tensor(prng.split(shard_keys[c, l], n_chains)
                         .astype(np.int64), device=mb.device))
            for c in range(b.c0, b.c1) for l in range(b.l0, b.l1)]
        st = ChainState(**{f: torch.cat([getattr(x, f) for x in parts])
                           for f in (*_INT_FIELDS, "key")})
        sts.append(st)
        bks.append(best_key(st))
        bas.append(st.a.clone())
    curves = [[] for _ in sts]
    for temp in np.asarray(temps, np.float32):
        for i, mb in enumerate(models):
            sts[i], bks[i], bas[i] = run_round(mb, sts[i], bks[i], bas[i],
                                               temp)
        sts = _migrate_blocks(lay.blocks, sts, [best_key(st) for st in sts],
                              lay.red)
        for c, bk in zip(curves, bks):
            c.append(bk.reshape(-1, n_chains).max(1).values)
    tas, tks, cvs = [], [], []
    for st, bk, ba, c in zip(sts, bks, bas, curves):
        bk = bk.reshape(-1, n_chains)
        top = first_argmax_rows(bk)
        lanes = torch.arange(bk.shape[0], device=bk.device)
        tas.append(ba.reshape(bk.shape[0], n_chains, *ba.shape[1:])[
            lanes, top])
        tks.append(bk[lanes, top])
        cvs.append(torch.stack(c, 1) if c else torch.zeros(
            (bk.shape[0], 0), dtype=torch.int32, device=bk.device))
    return lay.gather(tas), lay.gather(tks), lay.gather(cvs)


def make_lane_solver_fn(n_chains: int, steps_per_round: int, mesh=None):
    """The whole anneal of L lanes at once: ``(m_stack, seeds [L, P, R],
    keys [L, 2], temps) -> (best_a [L, P, R], best_k [L], curve [L,
    rounds])``. Lane l's ``n_chains`` chains start at ``seeds[l]`` on
    ``lane_model(m_stack, l)`` with ``keys[l]`` and run as one block of
    the ``[L·n_chains]`` chain axis (each lane's migration and winner
    within its block), so each lane's result equals its one-lane run. On
    a solve mesh (``mesh``) each lane runs C chain shards (their chains
    one axis on each device, the migration over every shard of the
    lane) and every output gains the leading shard axis ``[C, ...]``:
    each shard's winner, as the reference's sharded solver returns
    them."""
    run_round = make_round_runner(steps_per_round)

    def solve(m: ModelArrays, seeds: torch.Tensor, keys, temps):
        return _solve(Layout(mesh, m.num_lanes, solo=False), run_round,
                      n_chains, m, seeds, keys, temps)

    return solve


def make_solver_fn(n_chains: int, steps_per_round: int, mesh=None):
    """The whole anneal of one model, the one-lane case of
    :func:`make_lane_solver_fn`: ``(m, a_seed [P, R], key, temps) ->
    (best_a [P, R], best_key, curve [rounds])`` (on a mesh, each
    ``[C, ...]``). Every chain starts at the seed and the seed is the
    first best snapshot, so the result never ranks below it. ``key`` is a
    host ``uint32[2]`` key (the per-chunk key of the engine's ladder)."""
    run_round = make_round_runner(steps_per_round)

    def solve(m: ModelArrays, a_seed: torch.Tensor, key, temps):
        return _solve(Layout(mesh, 1, solo=True), run_round, n_chains,
                      _one_lane(m), a_seed[None], [key], temps)

    return solve
