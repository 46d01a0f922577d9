"""The rollout executor (docs/ROLLOUT.md): waves through the watch
channel.

One :class:`RolloutManager` rides a :class:`~..watch.manager.
WatchRegistry`. Commands (``start``/``advance``/``pause``/``rollback``)
mutate the epoch-fenced :class:`~.state.RolloutRecord` under a
per-cluster rollout lock, persist it to the plan store BEFORE the
in-memory commit (the watch manager's crash contract), and emit each
wave as upstream-compatible Kafka reassignment JSON. Every transition
lands simultaneously on four surfaces: the plan store (durable record),
a ``rollout`` trace span in the solve-report ring, a ``kind="rollout"``
flight record, and the ``kao_rollout_*`` counters the serve layer
renders.

Ground-truth discipline: while a rollout is active the registry's
commit does NOT fold a delta solve's plan into the cluster assignment
(the cluster is mid-move; the truth advances wave by wave via
:meth:`~..watch.manager.WatchRegistry.commit_assignment`). A
mid-rollout cluster event (``broker_remove``, ``rack_fail``) therefore
solves against the PARTIALLY-MOVED assignment, and the committed plan
flows back here through the registry's replan hook: the REMAINING
waves are re-packed against the partially-moved truth, epochs stay
monotone, and yesterday's "storm" — a reassignment fighting the
optimizer — becomes one coalesced rollout.
"""

from __future__ import annotations

import threading
import time

from ..models.cluster import Assignment
from ..obs import flight as _oflight
from ..obs import log as _olog
from ..obs import trace as _otrace
from .state import (
    TERMINAL,
    RolloutConflict,
    RolloutError,
    RolloutFenced,
    RolloutRecord,
    validate_epoch,
)
from .waves import (
    DEFAULT_BROKER_CAP,
    DEFAULT_LANES,
    DEFAULT_RACK_CAP,
    WaveCaps,
    WavePlan,
    pack_waves,
)

__all__ = ["RolloutManager", "wave_json"]


def wave_json(wave) -> dict:
    """One wave as upstream-compatible reassignment JSON
    (``README.md:52-78``): the byte dialect ``kafka-reassign-
    partitions --execute`` accepts. Partition order is the wave's
    application order — data moves first, leader-changing moves last —
    NOT the sorted order ``Assignment.to_dict`` emits: the order is
    part of the wave contract."""
    return {
        "version": 1,
        "partitions": [
            {"topic": t, "partition": p, "replicas": list(r)}
            for t, p, r in wave.targets()
        ],
    }


def _counter_dict() -> dict:
    return {
        "started_total": 0,        # rollouts created (start admitted)
        "commands_total": 0,       # admitted (post-fence) commands
        "fenced_total": 0,         # stale rollout epochs rejected
        "waves_emitted_total": 0,  # wave JSONs handed to the operator
        "waves_applied_total": 0,  # waves folded into ground truth
        "canary_fail_total": 0,    # canary verdicts that rolled back
        "rollbacks_total": 0,      # rollback commands (incl. canary)
        "replans_total": 0,        # mid-rollout remaining-wave re-plans
        "completed_total": 0,      # rollouts that reached done
    }


class RolloutManager:
    """Per-cluster rollout execution over one watch registry."""

    def __init__(self, registry, store=None, *,
                 broker_cap: int = DEFAULT_BROKER_CAP,
                 rack_cap: int = DEFAULT_RACK_CAP,
                 packer: str = "greedy",
                 lanes: int = DEFAULT_LANES,
                 trace: bool = True):
        self.registry = registry
        self.store = store if store is not None else registry.store
        self.default_caps = WaveCaps(broker=int(broker_cap),
                                     rack=int(rack_cap))
        self.packer = packer
        self.lanes = int(lanes)
        self.trace = trace
        self._lock = threading.Lock()
        self._locks: dict[str, threading.Lock] = {}
        self._records: dict[str, RolloutRecord] = {}
        self._counters = _counter_dict()
        # the watch-channel replan hook (docs/ROLLOUT.md): every plan
        # committed while a rollout holds the ground truth (the
        # registry's rollout_hold, raised by begin_execution) is
        # offered here for a remaining-wave re-plan
        registry.replan_fn = self.on_replan

    # -- bookkeeping ----------------------------------------------------

    def _count(self, **updates) -> None:
        with self._lock:
            for k, v in updates.items():
                self._counters[k] += v

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            recs = list(self._records.values())
        out["active"] = sum(1 for r in recs if r.active)
        out["packer"] = self.packer
        out["broker_cap"] = self.default_caps.broker
        out["rack_cap"] = self.default_caps.rack
        out["durable"] = int(self.store is not None)
        return out

    def _cluster_lock(self, cluster_id: str) -> threading.Lock:
        with self._lock:
            lk = self._locks.get(cluster_id)
            if lk is None:
                lk = self._locks[cluster_id] = threading.Lock()
        return lk

    def _load(self, cluster_id: str) -> RolloutRecord | None:
        """The in-memory record, lazily restored from the durable store
        (first touch after a restart resumes at the persisted wave and
        epoch). Caller holds the cluster's rollout lock."""
        rec = self._records.get(cluster_id)
        if rec is None and self.store is not None:
            payload = self.store.load_rollout(cluster_id)
            if payload is not None:
                try:
                    rec = RolloutRecord.from_dict(payload)
                except (KeyError, TypeError, ValueError) as e:
                    _olog.error("rollout_record_unreadable",
                                cluster=cluster_id,
                                error=repr(e)[:200])
                    rec = None
            if rec is not None:
                self._records[cluster_id] = rec
        return rec

    def _persist(self, rec: RolloutRecord) -> None:
        """Durably save BEFORE the in-memory commit (the watch
        manager's crash contract): a save that raises leaves memory and
        disk agreeing, so the client's retried command is admitted, not
        fenced on an epoch that was never recorded."""
        if self.store is not None:
            self.store.save_rollout(rec.cluster_id, rec.to_dict())

    # -- observability: every transition on all four surfaces -----------

    def _observe(self, cmd: str, rec: RolloutRecord, wall_s: float,
                 **extra) -> str | None:
        # the "start" transition IS the rollout's root trace (its ID
        # is the durable rec.trace_id the plan store carries); every
        # later transition gets its own ID linked back via
        # rollout_root, the same link the mid-rollout delta re-solve
        # traces record (docs/ROLLOUT.md)
        tid = None
        if self.trace:
            tid = (rec.trace_id if cmd == "start" and rec.trace_id
                   else _otrace.new_trace_id())
        tr = _otrace.begin(tid, name="rollout", cluster=rec.cluster_id,
                           command=cmd)
        if tr is not None:
            if rec.trace_id and tid != rec.trace_id:
                tr.root.set(rollout_root=rec.trace_id)
            tr.root.set(status=rec.status, wave=rec.wave_index,
                        waves=len(rec.plan.waves),
                        applied=len(rec.applied),
                        rollout_epoch=rec.rollout_epoch, **extra)
            _otrace.finish(tr)
        _oflight.record({
            "ts": round(time.time(), 3),
            "kind": "rollout",
            "trace_id": tid,
            "cluster": rec.cluster_id,
            "command": cmd,
            "status": rec.status,
            "wave": rec.wave_index,
            "waves": len(rec.plan.waves),
            "applied": len(rec.applied),
            "rollout_epoch": rec.rollout_epoch,
            "wall_s": round(wall_s, 4),
            # a rollout transition is a control action, not a solve:
            # quality is "did the state machine accept it", which it
            # did by the time this record lands
            "quality": {"feasible": True, "certified": False,
                        "degraded": False},
            **({"rollout_root": rec.trace_id}
               if rec.trace_id and tid != rec.trace_id else {}),
            **extra,
        })
        _olog.log("rollout", cluster=rec.cluster_id, command=cmd,
                  status=rec.status, wave=rec.wave_index,
                  applied=len(rec.applied), epoch=rec.rollout_epoch)
        return tid

    # -- read surface ---------------------------------------------------

    def get(self, cluster_id: str) -> dict | None:
        with self._cluster_lock(cluster_id):
            rec = self._load(cluster_id)
            if rec is None:
                return None
            return self._view(rec)

    def active_trace_root(self, cluster_id: str) -> str | None:
        """The ACTIVE rollout's durable root trace ID for
        ``cluster_id`` (None when no rollout owns the cluster) — what
        serve's delta re-solve traces link to. Safe from
        the solve path: the caller holds no manager locks there (the
        watch registry runs solves outside its commit lock), and the
        rollout→cluster lock order never reverses."""
        with self._cluster_lock(cluster_id):
            rec = self._load(cluster_id)
            if rec is None or not rec.active:
                return None
            return rec.trace_id

    def _view(self, rec: RolloutRecord) -> dict:
        plan = rec.plan
        current = None
        if rec.active and rec.status != "planned" \
                and rec.wave_index < len(plan.waves):
            current = wave_json(plan.waves[rec.wave_index])
        return {
            "cluster_id": rec.cluster_id,
            "status": rec.status,
            "trace_id": rec.trace_id,
            "rollout_epoch": rec.rollout_epoch,
            "plan_epoch": rec.plan_epoch,
            "wave_index": rec.wave_index,
            "waves": len(plan.waves),
            "applied": list(rec.applied),
            "remaining": rec.remaining,
            "replans": rec.replans,
            "caps": plan.caps.to_dict(),
            "packer": plan.packer,
            "wave_summary": [
                {
                    "index": w.index,
                    "moves": len(w.moves),
                    "data_units": w.data_units,
                    "peak_broker": w.peak_broker,
                    "peak_rack": w.peak_rack,
                    "cross_rack": w.cross_rack,
                    "applied": w.index in set(rec.applied),
                }
                for w in plan.waves
            ],
            "current_wave": current,
        }

    # -- commands -------------------------------------------------------

    def command(self, cluster_id: str, cmd: str, payload: dict,
                budget=None) -> dict:
        """Apply one fenced rollout command; returns the response body.
        Raises :class:`RolloutError` (400), :class:`RolloutConflict` /
        :class:`RolloutFenced` (409), or :class:`~..watch.events.
        EventError` for an unknown cluster."""
        if cmd not in ("start", "advance", "pause", "rollback"):
            raise RolloutError(
                f"unknown rollout command {cmd!r}; want start, "
                "advance, pause, or rollback"
            )
        if not isinstance(payload, dict):
            raise RolloutError("rollout command body must be a JSON "
                               "object")
        t0 = time.perf_counter()
        with self._cluster_lock(cluster_id):
            try:
                rec = self._load(cluster_id)
                if cmd == "start":
                    out = self._start(cluster_id, rec, payload, budget)
                else:
                    if rec is None:
                        raise RolloutConflict(
                            f"no rollout for cluster {cluster_id!r}; "
                            "POST .../rollout/start first"
                        )
                    self._check_generation(rec)
                    epoch = rec.fence(payload.get("epoch"))
                    # mutate a WORKING COPY and swap it in only after
                    # its persist succeeded: a failed save must leave
                    # memory and disk agreeing, so the client's RETRY
                    # of the same epoch is admitted, never fenced on a
                    # command that was not durably recorded. (A wave
                    # whose ground-truth commit landed before the
                    # failed save re-applies idempotently on retry —
                    # commit_assignment sets the same replica lists.)
                    work = RolloutRecord.from_dict(rec.to_dict())
                    if cmd == "advance":
                        out = self._advance(work, epoch, payload)
                    elif cmd == "pause":
                        out = self._pause(work, epoch)
                    else:
                        out = self._rollback(work, epoch,
                                             reason="command")
                    self._records[cluster_id] = work
            except RolloutFenced as e:
                # the fence is provable from the counters: fenced moves,
                # commands/waves do not, and the store was not written
                self._count(fenced_total=1)
                _olog.warn("rollout_epoch_fenced", cluster=cluster_id,
                           got=e.got, current=e.current)
                raise
            self._count(commands_total=1)
        self._observe(cmd, self._records[cluster_id],
                      time.perf_counter() - t0)
        return out

    def _check_generation(self, rec: RolloutRecord) -> None:
        """A re-bootstrap re-declared the cluster's ground truth: a
        rollout recorded against an older generation describes a dead
        world and must refuse every further command (start a fresh
        one)."""
        info = self.registry.plan_info(rec.cluster_id)
        if info is not None and rec.active \
                and info["generation"] != rec.generation:
            raise RolloutConflict(
                f"rollout for {rec.cluster_id!r} predates a "
                "re-bootstrap (generation "
                f"{rec.generation} != {info['generation']}); start a "
                "new rollout"
            )

    def _start(self, cluster_id: str, rec: RolloutRecord | None,
               payload: dict, budget) -> dict:
        if rec is not None and rec.active:
            # a record from a dead generation does not block a fresh
            # start — the re-bootstrap already invalidated it
            info = self.registry.plan_info(cluster_id)
            if info is None or info["generation"] == rec.generation:
                raise RolloutConflict(
                    f"cluster {cluster_id!r} already has an active "
                    f"rollout ({rec.status!r}, wave {rec.wave_index}); "
                    "rollback or complete it first"
                )
        epoch = validate_epoch(payload.get("epoch"))
        if rec is not None and epoch <= rec.rollout_epoch:
            raise RolloutFenced(cluster_id, epoch, rec.rollout_epoch)
        info = self.registry.plan_info(cluster_id)
        if info is None:
            from ..watch.events import EventError

            raise EventError(
                f"unknown cluster {cluster_id!r}; bootstrap it with "
                "POST /clusters/<id>/events first"
            )
        if info.get("plan") is None:
            raise RolloutConflict(
                f"cluster {cluster_id!r} has no certified plan yet; "
                "a rollout executes the plan the watch channel solved"
            )
        try:
            caps = WaveCaps(
                broker=int(payload.get("broker_cap",
                                       self.default_caps.broker)),
                rack=int(payload.get("rack_cap",
                                     self.default_caps.rack)),
            )
        except (TypeError, ValueError) as e:
            # malformed caps are the documented 400, never a 422
            raise RolloutError(
                f"'broker_cap'/'rack_cap' must be ints >= 1: {e}"
            ) from e
        if caps.broker < 1 or caps.rack < 1:
            raise RolloutError("'broker_cap'/'rack_cap' must be >= 1")
        packer = payload.get("packer", self.packer)
        # the plan is a DESTINATION: rewind the ground truth to the
        # pre-plan assignment (the registry kept it at merge time) so
        # the waves execute the actual copy work the plan implies
        base_dict = self.registry.begin_execution(cluster_id)
        try:
            current = Assignment.from_dict(base_dict)
            target = Assignment.from_dict(info["plan"])
            topo = self.registry.topology_of(cluster_id)
            try:
                plan = pack_waves(current, target, topo, caps=caps,
                                  packer=packer, lanes=self.lanes,
                                  budget=budget)
            except ValueError as e:
                raise RolloutError(str(e)) from e
            status = "planned" if plan.waves else "done"
            new = RolloutRecord(
                cluster_id=cluster_id,
                rollout_epoch=epoch,
                plan_epoch=info.get("plan_epoch"),
                status=status,
                wave_index=0,
                plan=plan,
                base=current.to_dict(),
                target=target.to_dict(),
                generation=info["generation"],
                # the durable root trace ID every transition and
                # mid-rollout re-solve links to
                trace_id=(_otrace.new_trace_id() if self.trace
                          else None),
            )
            self._persist(new)
        except BaseException:
            # NOTHING was durably created: release the hold
            # begin_execution raised (bad packer spec, unparsable plan,
            # a failed save — disk full) or the cluster would stop
            # merging plans forever with no record to drive it
            self.registry.end_execution(cluster_id)
            raise
        self._records[cluster_id] = new
        if status == "done":
            # nothing to execute: release the hold begin_execution
            # raised — the plan IS the truth already
            self.registry.end_execution(cluster_id)
        self._count(started_total=1,
                    completed_total=int(status == "done"))
        return self._view(new)

    def _advance(self, rec: RolloutRecord, epoch: int,
                 payload: dict) -> dict:
        rec.require_status("planned", "canary", "advancing", "paused")
        if rec.status == "planned":
            # emit the canary wave; nothing is applied until verified
            rec.rollout_epoch = epoch
            rec.status = "canary"
            self._persist(rec)
            self._count(waves_emitted_total=1)
            return self._view(rec)
        if rec.status == "paused":
            rec.rollout_epoch = epoch
            rec.status = rec.resumed_status or "advancing"
            rec.resumed_status = None
            self._persist(rec)
            return self._view(rec)
        if rec.status == "canary":
            ok = payload.get("canary_ok")
            if not isinstance(ok, bool):
                raise RolloutError(
                    "advancing past the canary wave requires "
                    "'canary_ok': true|false — the operator's verdict "
                    "on the canary reassignment (docs/ROLLOUT.md)"
                )
            if not ok:
                self._count(canary_fail_total=1)
                return self._rollback(rec, epoch, reason="canary_fail")
        # canary verified, or mid-rollout: apply the current wave to
        # the ground truth, then emit the next (or finish)
        return self._apply_wave(rec, epoch)

    def _apply_wave(self, rec: RolloutRecord, epoch: int) -> dict:
        wave = rec.plan.waves[rec.wave_index]
        # the wave becomes ground truth THROUGH the watch channel: the
        # registry persists the new assignment before committing it,
        # so the plan store, the next delta solve, and the rollout
        # record all agree on the partially-moved cluster
        self.registry.commit_assignment(rec.cluster_id, wave.targets())
        rec.applied.append(rec.wave_index)
        rec.wave_index += 1
        rec.rollout_epoch = epoch
        done = rec.wave_index >= len(rec.plan.waves)
        rec.status = "done" if done else "advancing"
        self._persist(rec)
        if done:
            self.registry.end_execution(rec.cluster_id)
        self._count(waves_applied_total=1,
                    waves_emitted_total=int(not done),
                    completed_total=int(done))
        return self._view(rec)

    def _pause(self, rec: RolloutRecord, epoch: int) -> dict:
        rec.require_status("planned", "canary", "advancing")
        rec.resumed_status = rec.status
        rec.status = "paused"
        rec.rollout_epoch = epoch
        self._persist(rec)
        return self._view(rec)

    def _rollback(self, rec: RolloutRecord, epoch: int, *,
                  reason: str) -> dict:
        rec.require_status("planned", "canary", "advancing", "paused")
        # replay the inverse waves in reverse order: every applied
        # wave's partitions return to their BASE replica lists, so the
        # pre-rollout assignment is restored bit-exactly (partitions no
        # wave touched were never changed by the rollout). A partition
        # the base does NOT know was created mid-rollout
        # (partition_growth) and placed by a post-replan wave: its
        # pre-rollout truth is the empty replica list growth declared,
        # so its inverse is un-placement, not survival
        base_by = {
            (p["topic"], p["partition"]): p["replicas"]
            for p in rec.base["partitions"]
        }
        inverse = []
        for idx in reversed(rec.applied):
            wave = rec.plan.waves[idx]
            targets = [
                (t, p, list(base_by.get((t, p), [])))
                for t, p, _ in wave.targets()
            ]
            if targets:
                self.registry.commit_assignment(rec.cluster_id, targets)
            inverse.append({
                "index": idx,
                "reassignment": {
                    "version": 1,
                    "partitions": [
                        {"topic": t, "partition": p, "replicas": r}
                        for t, p, r in targets
                    ],
                },
            })
        rec.status = "rolled_back"
        rec.rollout_epoch = epoch
        rec.resumed_status = None
        self._persist(rec)
        self.registry.end_execution(rec.cluster_id)
        self._count(rollbacks_total=1)
        out = self._view(rec)
        out["rollback_reason"] = reason
        out["inverse_waves"] = inverse
        return out

    # -- the watch-channel replan hook ----------------------------------

    def on_replan(self, cluster_id: str, plan_dict: dict,
                  plan_epoch: int) -> None:
        """Called by the registry AFTER a delta solve commits while a
        rollout is active: the cluster changed mid-rollout
        (broker_remove, rack_fail, growth...), the watch channel
        re-solved against the PARTIALLY-MOVED ground truth, and the
        remaining waves must now chase the new plan. Applied waves are
        history and keep their indices; waves from ``wave_index`` on
        are re-packed. Never raises into the solve path."""
        try:
            t0 = time.perf_counter()
            with self._cluster_lock(cluster_id):
                rec = self._load(cluster_id)
                if rec is None or not rec.active:
                    return
                truth = self.registry.assignment_of(cluster_id)
                if truth is None:
                    return
                current = Assignment.from_dict(truth)
                target = Assignment.from_dict(plan_dict)
                topo = self.registry.topology_of(cluster_id)
                fresh = pack_waves(
                    current, target, topo, caps=rec.plan.caps,
                    packer=rec.plan.packer, lanes=self.lanes,
                )
                # working-copy discipline (same as command()): a
                # failed save must not leave memory ahead of disk
                work = RolloutRecord.from_dict(rec.to_dict())
                kept = work.plan.waves[: work.wave_index]
                for i, w in enumerate(fresh.waves):
                    w.index = work.wave_index + i
                work.plan = WavePlan(
                    waves=kept + fresh.waves, caps=fresh.caps,
                    packer=fresh.packer,
                    lanes_raced=fresh.lanes_raced,
                    winner_lane=fresh.winner_lane,
                )
                work.target = target.to_dict()
                work.plan_epoch = plan_epoch
                work.replans += 1
                done = not fresh.waves
                if done:
                    # the new plan IS the partially-moved truth: the
                    # event undid the remaining work (e.g. the target
                    # brokers failed) — the rollout completes here.
                    # (A regenerated canary keeps status "canary": it
                    # is re-emitted and re-verified against the new
                    # plan.)
                    work.status = "done"
                self._persist(work)
                self._records[cluster_id] = work
                if done:
                    self.registry.end_execution(cluster_id)
                    self._count(completed_total=1)
            self._count(replans_total=1)
            self._observe("replan", work, time.perf_counter() - t0,
                          plan_epoch=plan_epoch)
        except Exception as e:  # the solve path must never pay for this
            _olog.error("rollout_replan_failed", cluster=cluster_id,
                        error=repr(e)[:200])
