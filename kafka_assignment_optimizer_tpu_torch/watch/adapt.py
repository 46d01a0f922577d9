"""Warm-start adaptation: previous plan -> candidate for the new state.

After a cluster event the previous certified plan is almost-right:
most partitions' replicas survived the change. This module maps that
plan onto the post-event :class:`ProblemInstance` —

- replicas on surviving eligible brokers STAY IN THEIR SLOTS (slot 0 is
  the leader; keeping it keeps leadership stable) unless a balance band
  provably forces relocation (pass 3 below),
- replicas on dead/drained/failed brokers are EVICTED and their slots
  refilled greedily: a broker not already in the partition, preferring
  racks the partition under-covers and brokers with the least load so
  far (the same instincts the greedy seed has, applied only to holes),
- a previously-unknown partition (growth) is filled entirely greedily,
- when the previous leader died, the first surviving replica is
  promoted (a metadata-only change) before any refill,
- residual band violations are REPAIRED move-minimally (pass 3): a
  recovery event (``broker_add`` after a rack failure, capacity
  expansion) leaves no holes, so passes 1-2 return the previous plan
  verbatim — concentrated on the old brokers, violating every band the
  restored ones re-tightened. Each repair move strictly lowers the
  total broker+rack band violation and never creates a new one, so only
  moves that EVERY band-feasible plan needs are made.

A copy of ``kafka_assignment_optimizer_tpu.watch.adapt``. The result is
a structurally valid candidate for ``engine.solve_tpu(warm_start=...)`` — balance bands may still be
violated when the repair gets stuck (the annealer's job), the hard
families (range, fill, uniqueness) are satisfied by construction. When
no valid candidate exists (pathological shrinkage) it returns
``(None, reason)`` and the caller degrades to a cold solve via the
``warm_start_rejected`` rung.
"""

from __future__ import annotations

import numpy as np

from ..models.cluster import Assignment
from ..models.instance import ProblemInstance

__all__ = ["adapt_plan"]


def adapt_plan(
    inst: ProblemInstance, prev_plan: Assignment,
) -> tuple[np.ndarray | None, str]:
    """Adapt ``prev_plan`` to ``inst``; returns ``(candidate, "ok")``
    or ``(None, reason)``."""
    B = inst.num_brokers
    K = inst.num_racks
    R = inst.max_rf
    P = inst.num_parts
    idx_of_broker = {int(b): i for i, b in enumerate(inst.broker_ids)}
    prev_by = {
        (p.topic, p.partition): p.replicas for p in prev_plan.partitions
    }
    rack_of = inst.rack_of_broker[:B]
    topic_names = [inst.topics[t] for t in inst.topic_of_part.tolist()]
    pids = inst.part_id.tolist()
    rfs = inst.rf.tolist()
    if int(max(rfs, default=0)) > B:
        return None, f"rf {max(rfs)} exceeds {B} surviving brokers"

    a = np.full((P, R), B, dtype=np.int32)
    refilled = np.zeros((P, R), dtype=bool)  # slots passes 2-3 placed
    load = np.zeros(B, dtype=np.int64)  # replicas placed per broker
    rtot = np.zeros(K, dtype=np.int64)  # replicas placed per rack
    kept = 0
    evicted = 0
    # pass 1 — survivors stay put, and their load is counted over the
    # WHOLE cluster before any hole is filled: a refill decision that
    # only sees the partitions processed so far systematically overloads
    # the brokers that happen to sort early
    surv_by_p: list[list[int]] = []
    for p in range(P):
        r = rfs[p]
        reps = prev_by.get((topic_names[p], pids[p]), [])
        surv = []
        seen: set[int] = set()
        for b in reps:
            bi = idx_of_broker.get(int(b))
            if bi is not None and bi not in seen:
                surv.append(bi)
                seen.add(bi)
        evicted += max(len(reps) - len(surv), 0)
        surv = surv[:r]
        kept += len(surv)
        # survivors keep their relative order: the surviving leader (or
        # the first surviving follower, promoted) lands in slot 0
        for s, bi in enumerate(surv):
            a[p, s] = bi
            load[bi] += 1
            rtot[rack_of[bi]] += 1
        surv_by_p.append(surv)
    # pass 2 — fill the holes against the instance's OWN balance bands
    # (broker_hi / rack_hi / part_rack_hi), preferring the least-loaded
    # broker among those that keep every cap satisfiable; leader-band
    # repair is the caller's exact reseat, not ours
    b_hi = int(inst.broker_hi)
    for p in range(P):
        r = rfs[p]
        surv = surv_by_p[p]
        if len(surv) >= r:
            continue
        # per-partition rack histogram of the survivors
        pr = np.zeros(K, dtype=np.int64)
        for bi in surv:
            pr[rack_of[bi]] += 1
        cap = int(inst.part_rack_hi[p])
        in_part = set(surv)
        for s in range(len(surv), r):
            # candidate brokers not already hosting this partition;
            # prefer racks under the diversity cap, brokers/racks under
            # their balance caps, then least load
            best = -1
            best_key = None
            for bi in range(B):
                if bi in in_part:
                    continue
                k = rack_of[bi]
                key = (
                    0 if pr[k] < cap else 1,
                    0 if load[bi] < b_hi else 1,
                    0 if rtot[k] < int(inst.rack_hi[k]) else 1,
                    int(pr[k]),
                    int(load[bi]),
                    bi,
                )
                if best_key is None or key < best_key:
                    best, best_key = bi, key
            if best < 0:
                return None, (
                    f"partition {topic_names[p]}/{pids[p]} cannot "
                    f"fill rf={r} from {B} brokers"
                )
            a[p, s] = best
            refilled[p, s] = True
            in_part.add(best)
            pr[rack_of[best]] += 1
            rtot[rack_of[best]] += 1
            load[best] += 1
    rebalanced = _repair_bands(inst, a, refilled, load, rtot, rfs)
    # structural self-check (cheap; the engine re-validates anyway)
    valid = inst.slot_valid
    if (a[valid] >= B).any() or (a[valid] < 0).any():
        return None, "adaptation left unfilled valid slots"
    return a, (
        f"ok kept={kept} evicted={evicted} rebalanced={rebalanced}"
    )


def _repair_bands(
    inst: ProblemInstance, a: np.ndarray, refilled: np.ndarray,
    load: np.ndarray, rtot: np.ndarray, rfs: list[int],
) -> int:
    """Pass 3 — move-minimal broker/rack band repair, in place.

    Donor/receiver pairs are admitted only when the move (a) serves at
    least one band deficit — donor over ``broker_hi`` or its rack over
    ``rack_hi``, receiver under ``broker_lo`` or its rack under
    ``rack_lo`` — and (b) creates none: the donor never drops below a
    low band, the receiver never climbs above a high one (same-rack
    moves leave rack totals untouched and skip the rack guards). Every
    admitted move lowers the summed band violation by at least one, so
    the loop terminates in at most the initial violation count. Within
    the chosen pair, a slot passes 2-3 already placed is relocated
    first (it is a move either way — relocating it costs nothing
    extra); survivors move only when no such slot fits, and the leader
    slot last. Returns the number of moves made; on a stuck repair the
    residual violations simply remain for the annealer."""
    B = inst.num_brokers
    K = inst.num_racks
    P = inst.num_parts
    b_lo, b_hi = int(inst.broker_lo), int(inst.broker_hi)
    r_lo = np.asarray(inst.rack_lo[:K], dtype=np.int64)
    r_hi = np.asarray(inst.rack_hi[:K], dtype=np.int64)
    caps = np.asarray(inst.part_rack_hi[:P], dtype=np.int64)
    rk = np.asarray(inst.rack_of_broker[:B], dtype=np.int64)

    def band_viol() -> int:
        return int(
            np.maximum(load - b_hi, 0).sum()
            + np.maximum(b_lo - load, 0).sum()
            + np.maximum(rtot - r_hi, 0).sum()
            + np.maximum(r_lo - rtot, 0).sum()
        )

    viol = band_viol()
    if not viol:
        return 0
    same = rk[:, None] == rk[None, :]
    moves = 0
    for _ in range(viol):
        gain = (
            (load > b_hi).astype(np.int64)[:, None]
            + (load < b_lo).astype(np.int64)[None, :]
            + np.where(
                same, 0,
                (rtot[rk] > r_hi[rk]).astype(np.int64)[:, None]
                + (rtot[rk] < r_lo[rk]).astype(np.int64)[None, :],
            )
        )
        ok = (
            (load > b_lo)[:, None] & (load < b_hi)[None, :]
            & (same | ((rtot[rk] > r_lo[rk])[:, None]
                       & (rtot[rk] < r_hi[rk])[None, :]))
        )
        np.fill_diagonal(ok, False)
        gain = np.where(ok, gain, 0)
        if int(gain.max()) <= 0:
            break
        pairs = sorted(
            ((-int(gain[d, r]), -int(load[d]), int(load[r]), d, r)
             for d, r in np.argwhere(gain > 0).tolist()),
        )
        moved = False
        for _g, _ld, _lr, bd, br in pairs:
            kd, kr = int(rk[bd]), int(rk[br])
            cand = (a == bd).any(axis=1) & ~(a == br).any(axis=1)
            if kd != kr:
                # per-partition replica count in the receiver's rack
                in_kr = (
                    (a < B) & (rk[np.minimum(a, B - 1)] == kr)
                ).sum(axis=1)
                cand &= in_kr < caps
            ps = np.nonzero(cand)[0]
            if ps.size == 0:
                continue
            pick = None
            for p in ps.tolist():
                ss = [s for s in range(rfs[p]) if int(a[p, s]) == bd]
                s = next(
                    (x for x in reversed(ss) if refilled[p, x]), ss[-1]
                )
                score = (bool(refilled[p, s]), s)
                if pick is None or score > pick[0]:
                    pick = (score, p, s)
            _, p, s = pick
            a[p, s] = br
            refilled[p, s] = True
            load[bd] -= 1
            load[br] += 1
            rtot[kd] -= 1
            rtot[kr] += 1
            moves += 1
            moved = True
            break
        if not moved or not band_viol():
            break
    return moves
