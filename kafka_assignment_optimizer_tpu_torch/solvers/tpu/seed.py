"""Greedy repair: turn the current assignment into a feasible-ish warm
start for the annealing engine.

The search engine's population is seeded *from the current assignment* so
the zero-move plan (or its nearest feasible neighbour) is in the basin from
step one — the representation-level equivalent of the reference objective's
"more weight to existing assignments" trick
(the upstream ``README.md:116-120``). Pure numpy, host-side; broker
selection is vectorized so a 256-broker / 10k-partition decommission seeds
in well under a second.

Repairs, in order:
1. fill null slots (removed brokers / RF increase);
2. spread partitions violating rack diversity (``README.md:178-180``);
3. drain brokers above the replica band ceiling / feed below the floor
   (``README.md:158-161``), and the same per rack (``README.md:173-176``);
4. rebalance leadership into the leader band via zero-move leader swaps
   (``README.md:163-166``).

Each unit repair moves one replica (or swaps one leader), choosing the
donor slot with the least preservation weight and the recipient broker
with the least load — keeping the seed near the move-count optimum the
exact backends find. Residual violations (rare, small) are the annealing
engine's job.

Two implementations share this module (docs/CONSTRUCTOR.md, the
swappable constructor interface in ``solvers.tpu.constructor``):

- ``_Repair`` — the ORIGINAL per-partition Python implementation, kept
  verbatim as the parity oracle and the operator's fallback rung
  (``KAO_CONSTRUCTOR=legacy``).
- ``_RepairVec`` — the vectorized default: no per-slot Python set
  bookkeeping (the legacy ``slots_of`` build alone walks P*R slots in
  Python — ~150k iterations at the 50k-partition jumbo), O(1)
  membership tests via a scatter-built count matrix, cached
  lexsort-ordered donor lists for the band-repair relocations, and the
  leader-chain BFS (phase 3) on flat numpy edge arrays instead of a
  per-partition adjacency-dict build per augmentation. Decisions are
  deliberately bit-identical to the legacy path — same donor order,
  same recipient lexsort, same BFS scan order — so the parity pin in
  ``tests/test_constructor_vec.py`` is plan-for-plan, not merely
  rank-for-rank.
"""

from __future__ import annotations

import numpy as np

from ...models.instance import ProblemInstance
from . import constructor as _constructor


class _Repair:
    """Legacy per-partition implementation — the parity oracle. Do not
    optimize in place; speedups belong in :class:`_RepairVec` so this
    path keeps witnessing the original semantics."""

    def __init__(self, inst: ProblemInstance):
        self.inst = inst
        B, K, P, R = inst.num_brokers, inst.num_racks, inst.num_parts, inst.max_rf
        self.B, self.K, self.P, self.R = B, K, P, R
        self.rf = inst.rf
        self.rack = inst.rack_of_broker  # [B+1]
        self.a = inst.a0.copy()
        valid = inst.slot_valid
        self.valid = valid
        flat = np.where(valid, self.a, B)
        self.cnt = np.bincount(flat.ravel(), minlength=B + 1)[:B].astype(np.int64)
        self.lcnt = np.bincount(
            np.where(self.rf > 0, self.a[:, 0], B), minlength=B + 1
        )[:B].astype(np.int64)
        self.rcnt = np.bincount(self.rack[flat].ravel(), minlength=K + 1)[
            :K
        ].astype(np.int64)
        self.prc = np.zeros((P, K), dtype=np.int64)
        rows = np.repeat(np.arange(P), R)
        rk = self.rack[flat].ravel()
        np.add.at(self.prc, (rows[rk < K], rk[rk < K]), 1)
        self._init_slots()

    def _init_slots(self) -> None:
        # replica slots per broker, for donor selection
        self.slots_of: list[set[tuple[int, int]]] = [
            set() for _ in range(self.B)
        ]
        for p in range(self.P):
            for s in range(int(self.rf[p])):
                b = int(self.a[p, s])
                if b < self.B:
                    self.slots_of[b].add((p, s))

    # -- primitives -----------------------------------------------------
    def weight(self, p: int, s: int, b: int) -> int:
        if b >= self.B:
            return 0
        w = self.inst.w_leader if s == 0 else self.inst.w_follower
        return int(w[p, b])

    def set_slot(self, p: int, s: int, b_new: int) -> None:
        b_old = int(self.a[p, s])
        self.last_set = (p, s, b_old, b_new)
        if b_old < self.B:
            self.cnt[b_old] -= 1
            self.rcnt[self.rack[b_old]] -= 1
            self.prc[p, self.rack[b_old]] -= 1
            if s == 0:
                self.lcnt[b_old] -= 1
            self.slots_of[b_old].discard((p, s))
        self.a[p, s] = b_new
        if b_new < self.B:
            self.cnt[b_new] += 1
            self.rcnt[self.rack[b_new]] += 1
            self.prc[p, self.rack[b_new]] += 1
            if s == 0:
                self.lcnt[b_new] += 1
            self.slots_of[b_new].add((p, s))

    def _note_swap(self, p: int, s: int, bl: int, bf: int) -> None:
        """Bookkeeping hook for a leader<->follower swap of partition
        ``p`` slots (0, s): brokers keep their partition membership, only
        the slot indices trade."""
        self.slots_of[bl].discard((p, 0))
        self.slots_of[bl].add((p, s))
        self.slots_of[bf].discard((p, s))
        self.slots_of[bf].add((p, 0))

    def choose_broker(self, p: int, allowed: np.ndarray) -> int:
        """Best recipient among `allowed` (bool mask [B]) for a replica of
        partition p: lexicographically avoid new violations, prefer
        under-floor brokers/racks, then least load, then lowest index."""
        inst, rack = self.inst, self.rack[: self.B]
        if not allowed.any():
            return -1
        div_bad = self.prc[p, rack] + 1 > inst.part_rack_hi[p]
        brk_bad = self.cnt + 1 > inst.broker_hi
        rck_bad = self.rcnt[rack] + 1 > inst.rack_hi[rack]
        brk_under = self.cnt < inst.broker_lo
        rck_under = self.rcnt[rack] < inst.rack_lo[rack]
        order = np.lexsort(
            (
                np.arange(self.B),
                self.cnt,
                ~rck_under,
                ~brk_under,
                rck_bad,
                brk_bad,
                div_bad,
                ~allowed,  # excluded brokers sort last
            )
        )
        best = int(order[0])
        return best if allowed[best] else -1

    def used_mask(self, p: int) -> np.ndarray:
        m = np.zeros(self.B, dtype=bool)
        for s in range(int(self.rf[p])):
            b = int(self.a[p, s])
            if b < self.B:
                m[b] = True
        return m

    # -- repair phases ---------------------------------------------------
    def fill_nulls(self) -> None:
        null_rows = np.flatnonzero(
            (np.where(self.inst.slot_valid, self.a, 0) >= self.B).any(1)
        )
        for p in null_rows:
            for s in range(int(self.rf[p])):
                if int(self.a[p, s]) < self.B:
                    continue
                b = self.choose_broker(p, ~self.used_mask(p))
                if b >= 0:
                    self.set_slot(p, int(s), b)

    def fix_diversity(self) -> None:
        inst, rack = self.inst, self.rack
        bad = np.flatnonzero((self.prc > inst.part_rack_hi[:, None]).any(1))
        for p in bad:
            for _ in range(self.R + 1):
                over = np.flatnonzero(self.prc[p] > inst.part_rack_hi[p])
                if over.size == 0:
                    break
                k = int(over[0])
                slots = [
                    s
                    for s in range(int(self.rf[p]))
                    if int(rack[self.a[p, s]]) == k
                ]
                s = min(slots, key=lambda s: (self.weight(p, s, int(self.a[p, s])), s))
                headroom = self.prc[p, rack[: self.B]] < inst.part_rack_hi[p]
                b = self.choose_broker(p, headroom & ~self.used_mask(p))
                if b < 0:
                    break
                self.set_slot(p, int(s), b)

    def relocate_one(self, src: int, dst_mask: np.ndarray) -> bool:
        """Move the least-weight replica off `src` to the best allowed
        broker. Tries donor slots cheapest-first, and keeps scanning past
        placements that would break per-partition rack diversity, taking
        one only as a last resort."""
        inst, rack = self.inst, self.rack[: self.B]
        slots = sorted(
            self.slots_of[src],
            key=lambda ps: (self.weight(ps[0], ps[1], src), ps),
        )
        fallback: tuple[int, int, int] | None = None
        for p, s in slots:
            b = self.choose_broker(p, dst_mask & ~self.used_mask(p))
            if b < 0:
                continue
            same_rack = rack[b] == rack[src]  # donor replica leaves that rack
            if self.prc[p, rack[b]] + 1 - same_rack <= inst.part_rack_hi[p]:
                self.set_slot(p, s, b)
                return True
            if fallback is None:
                fallback = (p, s, b)
        if fallback is not None:
            self.set_slot(*fallback)
            return True
        return False

    def fix_bands(self, max_repairs: int) -> None:
        inst, B, K = self.inst, self.B, self.K
        rack = self.rack[:B]
        prev = None  # the last relocation: (p, s, b_old, b_new)
        for it in range(max_repairs):
            over_b = np.flatnonzero(self.cnt > inst.broker_hi)
            under_b = np.flatnonzero(self.cnt < inst.broker_lo)
            over_k = np.flatnonzero(self.rcnt > inst.rack_hi)
            under_k = np.flatnonzero(self.rcnt < inst.rack_lo)
            if not (len(over_b) or len(under_b) or len(over_k) or len(under_k)):
                break
            if len(over_b):
                src = int(over_b[np.argmax(self.cnt[over_b])])
                dst = self.cnt < inst.broker_hi
            elif len(under_b):
                dst = self.cnt < inst.broker_lo
                donors = self.cnt > inst.broker_lo
                if not donors.any():
                    break
                src = int(np.argmax(np.where(donors, self.cnt, -1)))
            elif len(over_k):
                k = int(over_k[0])
                members = rack == k
                src = int(np.argmax(np.where(members, self.cnt, -1)))
                dst = (rack != k) & (self.cnt < inst.broker_hi)
            else:
                k = int(under_k[0])
                dst = (rack == k) & (self.cnt < inst.broker_hi)
                donors = (rack != k) & (self.cnt > inst.broker_lo)
                if not donors.any():
                    break
                src = int(np.argmax(np.where(donors, self.cnt, -1)))
            if not dst.any() or not self.relocate_one(src, dst):
                break  # stuck; the annealer takes it from here
            # a relocation that undoes the one before it returns the
            # repair to the state before that one; every step being a
            # function of that state, the loop then alternates between
            # the two states until max_repairs. Stop at the state the
            # last repair would leave: the current one when an even
            # number of repairs is left, else one more relocation (the
            # one before, again). Same result, without the ping-pong
            # (hundreds of thousands of relocations at 50k partitions)
            move = self.last_set
            if prev is not None and move == (prev[0], prev[1], prev[3],
                                              prev[2]):
                if (max_repairs - it - 1) % 2:
                    self.set_slot(prev[0], prev[1], prev[3])
                break
            prev = move

    def _batch_swaps(self, ordered_ps: np.ndarray, s_best: np.ndarray,
                     swap) -> int:
        """Apply the leader swaps for ``ordered_ps`` (best first) whose
        two brokers are untouched so far in this pass, so per-swap deltas
        computed against pass-start counts stay exact. Returns the last
        partition swapped (-1 if none, unreachable for a nonempty
        order)."""
        # the candidates' brokers, read up front: a swap changes only its
        # own partition's row, and each candidate is a distinct partition
        ps = np.asarray(ordered_ps, dtype=np.int64)
        sb = s_best[ps] + 1
        bl, bf = self.a[ps, 0], self.a[ps, sb]
        used = np.zeros(self.B + 1, dtype=bool)
        last, pos = -1, 0
        # each step takes the next candidate whose two brokers are both
        # untouched (one array scan a swap: at most B/2 swaps a pass)
        while pos < ps.size:
            ok = ~(used[bl[pos:]] | used[bf[pos:]])
            if not ok.any():
                break
            k = pos + int(np.argmax(ok))
            used[bl[k]] = used[bf[k]] = True
            swap(int(ps[k]), int(sb[k]))
            last, pos = int(ps[k]), k + 1
        return last

    def fix_leaders(self, max_repairs: int) -> None:
        inst, B = self.inst, self.B

        def swap(p: int, s: int) -> None:
            bl, bf = int(self.a[p, 0]), int(self.a[p, s])
            self.a[p, 0], self.a[p, s] = bf, bl
            self.lcnt[bl] -= 1
            self.lcnt[bf] += 1
            self._note_swap(p, s, bl, bf)

        # phase 1 — potential descent: repeatedly hand leadership of some
        # partition to its least-leading follower while that strictly
        # decreases sum(lcnt^2) (gain >= 2). Each swap drops the potential
        # by >= 2, so this terminates, and the balanced profile is its
        # global minimum — it walks straight through the multi-hop chains
        # the band-targeted phase below cannot see.
        if self.R > 1:
            foll = self.a[:, 1:]  # [P, R-1]
            foll_valid = (np.arange(1, self.R)[None, :] < self.rf[:, None]) & (
                foll < B
            )
            # batched descent: one swap per pass made the seed the jumbo
            # bottleneck (6.8 s of 11 at 50k partitions — thousands of
            # O(P*R) passes). Each pass now applies every gain>=2 swap
            # whose two brokers are untouched so far in the pass, so the
            # gains (computed against pass-start counts) stay exact and
            # the sum(lcnt^2) potential still strictly drops per swap.
            for _ in range(max_repairs):
                lead = self.a[:, 0]
                safe_lead = np.where(lead < B, lead, 0)
                l_of_lead = np.where(lead < B, self.lcnt[safe_lead], -1)
                f_cnt = np.where(foll_valid, self.lcnt[np.minimum(foll, B - 1)],
                                 np.iinfo(np.int64).max)
                s_best = np.argmin(f_cnt, axis=1)
                f_best = f_cnt[np.arange(self.P), s_best]
                gain = l_of_lead - np.where(f_best < np.iinfo(np.int64).max,
                                            f_best, np.iinfo(np.int64).max)
                cand = np.flatnonzero(gain >= 2)
                if cand.size == 0:
                    break
                cand = cand[np.argsort(-gain[cand], kind="stable")]
                self._batch_swaps(cand, s_best, swap)

        # phase 2 — band-violation descent with bounded neutral chaining:
        # vectorized over partitions, pick the leader<->follower swap with
        # the most negative band-violation delta; when only neutral swaps
        # exist (delta 0), take the one with the largest potential gain —
        # these walk the multi-hop chains (A->B then B->C) a strict descent
        # cannot, with a stall budget so cycles terminate.
        if self.R <= 1:
            return
        lo, hi = inst.leader_lo, inst.leader_hi
        foll = self.a[:, 1:]
        foll_valid = (np.arange(1, self.R)[None, :] < self.rf[:, None]) & (
            foll < B
        )

        def bv(c):
            return np.maximum(c - hi, 0) + np.maximum(lo - c, 0)

        stall = 0
        prev_p = -1  # neutral moves never revisit the partition just swapped
        for _ in range(max_repairs):
            if not (bv(self.lcnt) > 0).any():
                break
            lead = self.a[:, 0]
            safe_lead = np.where(lead < B, lead, 0)
            lc = self.lcnt[safe_lead]
            fc = np.where(
                foll_valid,
                self.lcnt[np.minimum(foll, B - 1)],
                np.iinfo(np.int64).max // 2,
            )
            s_best = np.argmin(fc, axis=1)
            f_best = fc[np.arange(self.P), s_best]
            usable = (lead < B) & (f_best < np.iinfo(np.int64).max // 2)
            # swap delta on total band violation (lead -1, follower +1)
            dviol = np.where(
                usable,
                bv(lc - 1) - bv(lc) + bv(f_best + 1) - bv(f_best),
                np.iinfo(np.int64).max // 2,
            )
            gain = np.where(usable, lc - f_best, np.iinfo(np.int64).min // 2)
            # batch every strictly-improving swap whose brokers are
            # untouched this pass (deltas stay exact; same jumbo-scale
            # reasoning as phase 1). Neutral chain moves remain one per
            # pass — their whole point is re-evaluating after each hop.
            improving = np.flatnonzero(dviol < 0)
            if improving.size:
                improving = improving[
                    np.lexsort((-gain[improving], dviol[improving]))
                ]
                prev_p = self._batch_swaps(improving, s_best, swap)
                stall = 0
                continue
            order = np.lexsort((-gain, dviol))
            p = int(order[0])
            if dviol[p] >= 0 and p == prev_p and self.P > 1:
                p = int(order[1])
            if dviol[p] == 0 and gain[p] >= 1 and stall < 64:
                # short neutral-chain budget: long chains are phase 3's
                # job (exact BFS augmentation); a 4*B budget burned ~7 s
                # of single-step O(P*R) passes at 50k partitions
                stall += 1
            else:
                break
            swap(p, int(s_best[p]) + 1)
            prev_p = p

        # phase 3 — BFS augmenting chains for what descent cannot reach
        # (implementation-swappable: _RepairVec overrides with the
        # flat-edge-array BFS; semantics identical)
        self._augment_leader_chains(max_repairs, lo, hi, swap)

    def _augment_leader_chains(self, max_repairs: int, lo: int, hi: int,
                               swap) -> None:
        """Phase 3 — BFS augmenting chains for what descent cannot reach:
        route one unit of leadership from an over-hi broker to any broker
        with headroom (or from any broker with slack to an under-lo one)
        through a path of leader<->follower swaps. Exact; each
        augmentation reduces total band violation by >= 1."""
        B = self.B
        for _ in range(max_repairs):
            over = np.flatnonzero(self.lcnt > hi)
            under = np.flatnonzero(self.lcnt < lo)
            if not (len(over) or len(under)):
                break
            # edges: leader broker -> (follower broker, partition, slot)
            adj: dict[int, list[tuple[int, int, int]]] = {}
            for p in range(self.P):
                L = int(self.a[p, 0])
                if L >= B:
                    continue
                for s in range(1, int(self.rf[p])):
                    F = int(self.a[p, s])
                    if F < B:
                        adj.setdefault(L, []).append((F, p, s))
            if len(over):
                # shed excess: over-hi broker -> any broker with headroom
                srcs = {int(b) for b in over}
                is_dst = lambda b: self.lcnt[b] < hi  # noqa: E731
            else:
                # feed deficit: any broker with slack -> the under-lo broker
                # (swaps shift leadership forward along the same edges)
                srcs = {b for b in range(B) if self.lcnt[b] > lo}
                dst_set = {int(b) for b in under}
                is_dst = lambda b: b in dst_set  # noqa: E731
            parent: dict[int, tuple[int, int, int]] = {}
            frontier = list(srcs)
            seen = set(srcs)
            goal = -1
            while frontier and goal < 0:
                nxt = []
                for u in frontier:
                    for (v, p, s) in adj.get(u, []):
                        if v in seen:
                            continue
                        seen.add(v)
                        parent[v] = (u, p, s)
                        if is_dst(v):
                            goal = v
                            break
                        nxt.append(v)
                    if goal >= 0:
                        break
                frontier = nxt
            if goal < 0:
                break  # disconnected; annealer's job
            # unwind: swap along the path so leadership shifts one hop per
            # edge. Path nodes (leader brokers) are distinct and each
            # partition has exactly one leader when adj was built, so every
            # edge's swap is still valid at unwind time — the augmentation
            # always applies in full, shifting one leader off the source.
            node = goal
            while node not in srcs:
                u, p, s = parent[node]
                swap(p, s)
                node = u


class _RepairVec(_Repair):
    """Vectorized implementation (the default): identical decisions to
    the legacy path — same donor ordering, same recipient lexsort, same
    BFS scan order — with the per-partition Python loops replaced by
    numpy array work (docs/CONSTRUCTOR.md has the layout)."""

    def _init_slots(self) -> None:
        # membership counts [P, B+1] built with one scatter-add instead
        # of the legacy P*R Python set loop; used_mask and the duplicate
        # guard read rows of this in O(B)
        flat = np.where(self.valid, self.a, self.B)
        self.in_part = np.zeros((self.P, self.B + 1), dtype=np.int16)
        np.add.at(
            self.in_part,
            (np.repeat(np.arange(self.P), self.R), flat.ravel()),
            1,
        )
        # donor lists per broker, built lazily (lexsort over that
        # broker's slots) and invalidated whenever the broker's slot set
        # changes; None marks "not built"
        self._donor_cache: dict[int, list] = {}

    def set_slot(self, p: int, s: int, b_new: int) -> None:
        b_old = int(self.a[p, s])
        self.last_set = (p, s, b_old, b_new)
        if b_old < self.B:
            self.cnt[b_old] -= 1
            self.rcnt[self.rack[b_old]] -= 1
            self.prc[p, self.rack[b_old]] -= 1
            if s == 0:
                self.lcnt[b_old] -= 1
            self.in_part[p, b_old] -= 1
            self._donor_cache.pop(b_old, None)
        self.a[p, s] = b_new
        if b_new < self.B:
            self.cnt[b_new] += 1
            self.rcnt[self.rack[b_new]] += 1
            self.prc[p, self.rack[b_new]] += 1
            if s == 0:
                self.lcnt[b_new] += 1
            self.in_part[p, b_new] += 1
            self._donor_cache.pop(b_new, None)

    def _note_swap(self, p: int, s: int, bl: int, bf: int) -> None:
        # membership counts are slot-order-blind; only the cached donor
        # lists (which carry slot indices) go stale
        self._donor_cache.pop(bl, None)
        self._donor_cache.pop(bf, None)

    def used_mask(self, p: int) -> np.ndarray:
        return self.in_part[p, : self.B] > 0

    def _donor_list(self, src: int) -> tuple[np.ndarray, np.ndarray]:
        """``src``'s replica slots in donor order (weight, p, s): the
        arrays ``(ps, ss)``, cached until ``src``'s slots change."""
        lst = self._donor_cache.get(src)
        if lst is None:
            ps, ss = np.nonzero((self.a == src) & self.valid)
            w = np.where(
                ss == 0,
                self.inst.w_leader[ps, src],
                self.inst.w_follower[ps, src],
            ).astype(np.int64)
            order = np.lexsort((ss, ps, w))  # (weight, p, s) — legacy order
            lst = (ps[order].astype(np.int64), ss[order].astype(np.int64))
            self._donor_cache[src] = lst
        return lst

    def relocate_one(self, src: int, dst_mask: np.ndarray) -> bool:
        """The legacy relocation, decision for decision: walk ``src``'s
        donor slots in order, pick each one's recipient as
        ``choose_broker`` would, and take the first whose move keeps the
        partition's rack diversity (else the first with any recipient).
        The recipient keys that do not depend on the partition are ranked
        once; the donor slots are then scanned in growing blocks, each
        block's recipients picked at once, so a scan that reaches deep
        into the list costs a few array operations, not one
        ``choose_broker`` a slot."""
        inst, B = self.inst, self.B
        rack = self.rack[:B]
        d_ps, d_ss = self._donor_list(src)
        n = d_ps.size
        if not n:
            return False
        rk_cnt = self.rcnt[rack]
        base = np.lexsort((
            np.arange(B), self.cnt, ~(rk_cnt < inst.rack_lo[rack]),
            ~(self.cnt < inst.broker_lo), rk_cnt + 1 > inst.rack_hi[rack],
            self.cnt + 1 > inst.broker_hi,
        ))
        rank = np.empty(B, dtype=np.int64)
        rank[base] = np.arange(B)
        fallback = None
        start, step = 0, 256
        while start < n:
            ps = d_ps[start:start + step]
            cap = inst.part_rack_hi[ps].astype(np.int64)
            allowed = dst_mask[None, :] & (self.in_part[ps, :B] == 0)
            div_bad = self.prc[ps][:, rack] + 1 > cap[:, None]
            key = (~allowed) * (2 * B) + div_bad * B + rank[None, :]
            best = key.argmin(1)
            has = allowed[np.arange(ps.size), best]
            same_rack = rack[best] == rack[src]
            fits = has & (self.prc[ps, rack[best]] + 1 - same_rack <= cap)
            if fits.any():
                i = int(np.argmax(fits))
                take = (start + i, int(best[i]))
                break
            if fallback is None and has.any():
                i = int(np.argmax(has))
                fallback = (start + i, int(best[i]))
            start += ps.size
            step *= 2
        else:
            take = fallback
        if take is None:
            return False
        i, b = take
        self.set_slot(int(d_ps[i]), int(d_ss[i]), b)  # invalidates src's...
        self._donor_cache[src] = (np.delete(d_ps, i), np.delete(d_ss, i))
        return True  # ...which is repaired exactly above

    def _augment_leader_chains(self, max_repairs: int, lo: int, hi: int,
                               swap) -> None:
        """Phase 3 on flat edge arrays: one ``np.nonzero`` builds every
        leader->follower edge per augmentation (vs the legacy
        per-partition adjacency-dict walk), and each BFS level resolves
        first-visit parents with one lexsort + unique. Scan order —
        (frontier position, edge (p, s) order) — matches the legacy
        dict/list iteration exactly, so the unwound augmenting path is
        the same path and the resulting plan is bit-identical."""
        B = self.B
        for _ in range(max_repairs):
            over = np.flatnonzero(self.lcnt > hi)
            under = np.flatnonzero(self.lcnt < lo)
            if not (len(over) or len(under)):
                break
            mask = self.valid.copy()
            mask[:, 0] = False
            mask &= (self.a[:, [0]] < B) & (self.a < B)
            ep, es = np.nonzero(mask)
            src_b = self.a[ep, 0].astype(np.int64)
            dst_b = self.a[ep, es].astype(np.int64)
            if len(over):
                srcs = {int(b) for b in over}
                dst_ok = self.lcnt < hi
            else:
                srcs = {b for b in range(B) if self.lcnt[b] > lo}
                dst_ok = np.zeros(B, dtype=bool)
                dst_ok[list({int(b) for b in under})] = True
            # frontier built exactly as the legacy set->list conversion,
            # so level-0 scan order (and with it the chosen path) matches
            frontier = list(srcs)
            seen = np.zeros(B, dtype=bool)
            seen[frontier] = True
            parent_edge = np.full(B, -1, dtype=np.int64)
            rank = np.full(B, -1, dtype=np.int64)
            goal = -1
            while frontier and goal < 0:
                rank[:] = -1
                rank[frontier] = np.arange(len(frontier))
                cand = np.flatnonzero((rank[src_b] >= 0) & ~seen[dst_b])
                if cand.size == 0:
                    break
                order = cand[np.lexsort((cand, rank[src_b[cand]]))]
                d_ord = dst_b[order]
                uniq_d, first_idx = np.unique(d_ord, return_index=True)
                scan = np.argsort(first_idx)  # restore scan order
                uniq_d, first_idx = uniq_d[scan], first_idx[scan]
                parent_edge[uniq_d] = order[first_idx]
                seen[uniq_d] = True
                goals = np.flatnonzero(dst_ok[uniq_d])
                if goals.size:
                    goal = int(uniq_d[goals[0]])
                    break
                frontier = uniq_d.tolist()
            if goal < 0:
                break  # disconnected; annealer's job
            src_member = np.zeros(B, dtype=bool)
            src_member[list(srcs)] = True
            node = goal
            while not src_member[node]:
                k = int(parent_edge[node])
                swap(int(ep[k]), int(es[k]))
                node = int(src_b[k])


def greedy_seed(inst: ProblemInstance, max_repairs: int | None = None,
                impl: str | None = None) -> np.ndarray:
    """Greedy repair seed. ``impl`` overrides the process-wide
    constructor implementation (``solvers.tpu.constructor``): ``"vec"``
    (default) or ``"legacy"`` — the oracle the vectorized path is
    parity-pinned against. The seed is a function of the instance and
    these two knobs, so it is computed once an instance (a decomposed
    solve's second map, a retry, a repeat solve) and copied out."""
    if max_repairs is None:
        max_repairs = 4 * int(inst.rf.sum()) + 64
    impl = impl or _constructor.active()
    memo = inst.__dict__.setdefault("_greedy_seed_memo", {})
    a = memo.get((max_repairs, impl))
    if a is None:
        cls = _RepairVec if impl == "vec" else _Repair
        r = cls(inst)
        r.fill_nulls()
        r.fix_diversity()
        r.fix_bands(max_repairs)
        # band repair can occasionally be forced into a
        # diversity-violating placement (every allowed broker's rack full
        # for that partition); one more pass of each usually clears it
        r.fix_diversity()
        r.fix_bands(max_repairs)
        r.fix_leaders(max_repairs)
        a = memo[(max_repairs, impl)] = r.a
    return a.copy()
