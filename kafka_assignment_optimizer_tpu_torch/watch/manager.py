"""Per-cluster watch state machine: fencing, coalescing, backpressure.

One :class:`WatchRegistry` owns every watched cluster. For each event
(``docs/WATCH.md``):

1. **Epoch fencing** — every event carries a client epoch; only an
   epoch STRICTLY greater than the cluster's latest is admitted. A
   stale or replayed epoch raises :class:`FencedEpoch` (the serve
   layer's structured 409) BEFORE any state change and provably
   without a solve — application is idempotent because a duplicate
   can never get in twice.
2. **Apply + persist** — the pure transition (``events.apply_event``)
   runs under the cluster lock and the new state is durably persisted
   (``store.PlanStore``) before anything else happens; a crash after
   the ack can replay nothing and forget nothing.
3. **Single-flight solve with storm coalescing** — the first event on
   an idle cluster takes the *solver role*: it solves the latest state
   (warm-started from the last certified plan) and returns the plan.
   Events arriving while a solve is in flight are applied, persisted,
   and acknowledged immediately (``status: "accepted"``); the
   in-flight solve's :class:`~..resilience.budget.Budget` is cancelled
   (it is now solving a superseded epoch — the engine retires it at
   the next chunk boundary via the existing ``deadline_truncated``
   rung), and ONE re-solve of the latest state runs afterwards on a
   drain thread, no matter how many events the burst held.
4. **Backpressure** — when more than ``max_backlog`` events pile up
   behind one in-flight solve, further events raise :class:`StormShed`
   (the serve layer's 503 ``event_storm``) with a retry hint derived
   from the coalescing window. Nothing already admitted is ever
   dropped.

The registry is transport-free: ``solve_fn(state, prev_plan, budget)
-> (plan_dict, report_dict)`` is injected by the serve layer (queue +
breaker + metrics), the CLI replay, and the bench harness alike.
"""

from __future__ import annotations

import threading
import time
from dataclasses import replace

from ..models.cluster import Assignment
from ..obs import flight as _oflight
from ..obs import log as _olog
from ..resilience.budget import Budget, backoff_s
from .events import ClusterState, EventError, apply_event, valid_cluster_id
from .store import PlanStore, StoreRecord

__all__ = ["WatchRegistry", "FencedEpoch", "StormShed"]

DEFAULT_WINDOW_S = 0.05
DEFAULT_MAX_BACKLOG = 256
# a drain re-solve that keeps failing retries this many times (jittered
# backoff between attempts) before giving the solver role back; the
# durable state is intact throughout and the next admitted event
# re-solves the latest state
DRAIN_RETRIES = 3


class FencedEpoch(Exception):
    """A stale or replayed epoch hit the fence: nothing was applied,
    no solve ran."""

    def __init__(self, cluster_id: str, got: int, current: int,
                 plan_epoch: int | None):
        super().__init__(
            f"epoch {got} is not newer than cluster {cluster_id!r}'s "
            f"current epoch {current}"
        )
        self.cluster_id = cluster_id
        self.got = got
        self.current = current
        self.plan_epoch = plan_epoch


class StormShed(Exception):
    """Event-storm backpressure: too many events piled up behind one
    in-flight solve; the client should retry after the hint."""

    def __init__(self, cluster_id: str, backlog: int,
                 retry_after_s: float):
        super().__init__(
            f"event storm on cluster {cluster_id!r}: {backlog} events "
            "already coalescing behind the in-flight solve"
        )
        self.cluster_id = cluster_id
        self.backlog = backlog
        self.retry_after_s = retry_after_s


class _Cluster:
    __slots__ = ("lock", "state", "plan", "plan_epoch", "plan_report",
                 "pre_plan", "rollout_hold", "solving",
                 "active_budget", "pending_events")

    def __init__(self):
        self.lock = threading.Lock()
        self.state: ClusterState | None = None
        self.plan: dict | None = None
        self.plan_epoch: int | None = None
        self.plan_report: dict | None = None
        # the assignment as it stood immediately BEFORE the last plan
        # merge: committing a plan ASSUMES the operator applies it, and
        # a rollout `start` revisits that assumption — it rewinds the
        # ground truth here and executes the plan wave by wave
        # (docs/ROLLOUT.md)
        self.pre_plan: dict | None = None
        # True while a rollout owns this cluster's ground truth: set
        # by begin_execution, cleared by end_execution / re-bootstrap,
        # restored from the durable rollout record after a restart.
        # Read UNDER c.lock at commit time — the hold decision and the
        # commit are one atomic step, so a rollout starting mid-solve
        # can never lose a merge/hold race
        self.rollout_hold = False
        self.solving = False
        self.active_budget: Budget | None = None
        self.pending_events = 0


def _report_summary(report: dict) -> dict:
    """The scalar slice of a solve report worth persisting per cluster."""
    keys = (
        "solver", "replica_moves", "leader_changes", "objective_weight",
        "objective_upper_bound", "feasible", "proven_optimal",
        "solver_wall_clock_s", "total_wall_clock_s",
        "solver_warm_started", "solver_engine", "degradations",
    )
    return {k: report[k] for k in keys if k in report}


def _merge_plan(current: Assignment, plan: Assignment) -> Assignment:
    """Adopt the plan's replica lists into ``current`` by partition key,
    keeping partitions the plan does not know (added by events that
    landed while the solve ran) untouched."""
    plan_by = plan.by_key()
    parts = []
    for p in current.partitions:
        q = plan_by.get(p.key)
        parts.append(replace(p, replicas=list(q.replicas)) if q else p)
    return Assignment(partitions=parts, version=current.version)


class WatchRegistry:
    def __init__(self, solve_fn, store: PlanStore | None = None, *,
                 window_s: float = DEFAULT_WINDOW_S,
                 max_backlog: int = DEFAULT_MAX_BACKLOG,
                 solve_budget_s: float | None = None):
        self.solve_fn = solve_fn
        self.store = store
        self.window_s = max(float(window_s), 0.0)
        self.max_backlog = max(int(max_backlog), 1)
        self.solve_budget_s = solve_budget_s
        # streaming plan rollout hook (docs/ROLLOUT.md), registered by
        # rollout.exec.RolloutManager. While a cluster's rollout holds
        # the ground truth (``_Cluster.rollout_hold``, maintained via
        # begin_execution/end_execution and read atomically with the
        # commit), a delta solve's commit persists the PLAN but does
        # NOT fold it into the assignment (the cluster is mid-move;
        # truth advances wave by wave via :meth:`commit_assignment`),
        # and the committed plan is offered to ``replan_fn`` so the
        # remaining waves re-pack against the partially-moved state.
        # Lock ordering: the hook is only ever called while this
        # registry does NOT hold the cluster lock — the rollout side
        # takes its own lock first, then ours (strictly rollout ->
        # cluster, never the reverse).
        self.replan_fn = None
        self._lock = threading.Lock()
        self._clusters: dict[str, _Cluster] = {}
        self._counters = {
            "events_total": 0,        # admitted (post-fence) events
            "fenced_total": 0,        # stale/replayed epochs rejected
            "coalesced_total": 0,     # events acked into a pending re-solve
            "superseded_total": 0,    # in-flight solves cancelled
            "storm_sheds_total": 0,   # events refused by backpressure
            "solves_total": 0,        # delta solves completed
            "warm_solves_total": 0,   # ... that actually warm-started
            "solve_errors_total": 0,
        }

    # -- bookkeeping ----------------------------------------------------

    def _count(self, **updates) -> None:
        with self._lock:
            for k, v in updates.items():
                self._counters[k] += v

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._counters)
        out["clusters"] = len(self._clusters)
        out["window_s"] = self.window_s
        out["max_backlog"] = self.max_backlog
        out["durable"] = int(self.store is not None)
        return out

    def _cluster(self, cluster_id: str) -> _Cluster:
        """The in-memory entry, lazily restored from the durable store
        (first touch after a restart resumes at the persisted epoch)."""
        with self._lock:
            c = self._clusters.get(cluster_id)
            if c is None:
                c = self._clusters[cluster_id] = _Cluster()
        with c.lock:
            if c.state is None and self.store is not None:
                rec = self.store.load(cluster_id)
                if rec is not None:
                    c.state = rec.state
                    c.plan = rec.plan
                    c.plan_epoch = rec.plan_epoch
                    c.plan_report = rec.plan_report
                    c.pre_plan = rec.pre_plan
                    # a restart mid-rollout must keep holding the
                    # ground truth (docs/ROLLOUT.md): restore the hold
                    # from the durable rollout record's status — but
                    # ONLY for the current generation (a record that
                    # predates a re-bootstrap is a dead world and must
                    # not freeze plan merges forever)
                    ro = self.store.load_rollout(cluster_id)
                    c.rollout_hold = bool(
                        ro is not None
                        and ro.get("status") not in ("done",
                                                     "rolled_back")
                        and int(ro.get("generation", 0))
                        == rec.state.generation
                    )
        return c

    def _persist(self, state: ClusterState, plan: dict | None,
                 plan_epoch: int | None,
                 plan_report: dict | None,
                 pre_plan: dict | None = None) -> None:
        """Durably save one record. Caller holds ``c.lock`` and commits
        the same values to the in-memory cluster ONLY after this
        returns: a save that raises (disk full, EIO) must leave memory
        and disk agreeing — an in-memory epoch that advanced past the
        stored one would fence the client's retry of an event that was
        never durably recorded."""
        if self.store is not None and state is not None:
            self.store.save(StoreRecord(
                state=state, plan=plan, plan_epoch=plan_epoch,
                plan_report=plan_report, pre_plan=pre_plan,
            ))

    # -- read surface ---------------------------------------------------

    def list_clusters(self) -> list[str]:
        with self._lock:
            known = set(self._clusters)
        if self.store is not None:
            known |= set(self.store.list_clusters())
        return sorted(known)

    def get_cluster(self, cluster_id: str) -> dict | None:
        if not valid_cluster_id(cluster_id):
            raise EventError(f"bad cluster id {cluster_id!r}")
        c = self._cluster(cluster_id)
        with c.lock:
            if c.state is None:
                return None
            return {
                "cluster_id": cluster_id,
                "epoch": c.state.epoch,
                "brokers": list(c.state.brokers),
                "drained": list(c.state.drained),
                "racks": (
                    c.state.topology.racks() if c.state.topology else []
                ),
                "partitions": len(c.state.assignment.partitions),
                # the current GROUND-TRUTH assignment: equals the last
                # plan between rollouts, but mid-rollout it is the
                # partially-moved cluster the waves have built so far
                "assignment": c.state.assignment.to_dict(),
                "rf": c.state.rf,
                "plan_epoch": c.plan_epoch,
                "plan": c.plan,
                "plan_report": c.plan_report,
                "solving": c.solving,
                "pending_events": c.pending_events,
            }

    def topology_of(self, cluster_id: str):
        """The cluster's current :class:`~..models.cluster.Topology`
        (None when unracked/unknown) — the rollout packer's rack-cap
        input."""
        c = self._cluster(cluster_id)
        with c.lock:
            return c.state.topology if c.state is not None else None

    def commit_assignment(self, cluster_id: str, targets) -> dict:
        """Fold externally-executed replica movements into the
        cluster's ground-truth assignment — the rollout executor's wave
        apply/rollback path (docs/ROLLOUT.md). ``targets`` is an
        iterable of ``(topic, partition, replicas)``; partitions not
        named are untouched, and naming a partition the cluster does
        not know is an :class:`EventError` (a wave can never invent
        state). Persist-before-commit like every other mutation; the
        cluster EVENT epoch does not move — waves are fenced by the
        rollout's own epoch sequence. Returns the new assignment
        dict."""
        c = self._cluster(cluster_id)
        with c.lock:
            if c.state is None:
                raise EventError(f"unknown cluster {cluster_id!r}")
            by = {(t, int(p)): [int(b) for b in r]
                  for t, p, r in targets}
            known = {(p.topic, p.partition)
                     for p in c.state.assignment.partitions}
            unknown = sorted(set(by) - known)
            if unknown:
                raise EventError(
                    f"wave names unknown partition(s) {unknown[:5]}"
                )
            parts = [
                replace(p, replicas=list(
                    by.get((p.topic, p.partition), p.replicas)
                ))
                for p in c.state.assignment.partitions
            ]
            new_assignment = Assignment(
                partitions=parts, version=c.state.assignment.version,
            )
            new_state = replace(c.state, assignment=new_assignment)
            # the optimistic-merge assumption is dead once a wave has
            # physically moved the truth: drop the rewind point so a
            # LATER rollout can never rewind past executed work
            self._persist(new_state, c.plan, c.plan_epoch,
                          c.plan_report, None)
            c.state = new_state
            c.pre_plan = None
            return new_assignment.to_dict()

    def begin_execution(self, cluster_id: str) -> dict:
        """Rollout ``start`` (docs/ROLLOUT.md): the committed plan is a
        DESTINATION, not an applied fact. Rewind the ground-truth
        assignment to the pre-plan truth captured at the last merge —
        CONSUMING the rewind point, so a later start after this rollout
        completes can never rewind real executed state to a stale base
        — and raise the hold: until :meth:`end_execution`, delta-solve
        commits persist their plan without merging it. Returns the
        base assignment dict the rollout executes from."""
        c = self._cluster(cluster_id)
        with c.lock:
            if c.state is None:
                raise EventError(f"unknown cluster {cluster_id!r}")
            if (c.pre_plan is not None and c.plan is not None
                    and c.state.assignment.to_dict() == c.plan):
                base = Assignment.from_dict(c.pre_plan)
                new_state = replace(c.state, assignment=base)
                self._persist(new_state, c.plan, c.plan_epoch,
                              c.plan_report, None)
                c.state = new_state
            elif c.pre_plan is not None:
                # stale rewind point (events moved the world since the
                # merge): consume it DURABLY, or a crash could
                # resurrect it for a later start
                self._persist(c.state, c.plan, c.plan_epoch,
                              c.plan_report, None)
            c.pre_plan = None
            c.rollout_hold = True
            return c.state.assignment.to_dict()

    def end_execution(self, cluster_id: str) -> None:
        """The rollout reached a terminal state (done / rolled_back):
        release the ground-truth hold — future plan commits merge
        normally again."""
        c = self._cluster(cluster_id)
        with c.lock:
            c.rollout_hold = False

    def assignment_of(self, cluster_id: str) -> dict | None:
        """The current ground-truth assignment alone — the rollout
        replan path's accessor (``get_cluster`` serializes the whole
        view; this serializes one assignment)."""
        c = self._cluster(cluster_id)
        with c.lock:
            return (c.state.assignment.to_dict()
                    if c.state is not None else None)

    def plan_info(self, cluster_id: str) -> dict | None:
        """The certified plan + its epoch + the cluster generation,
        WITHOUT serializing the assignment (the plan is stored as a
        dict already, so this is reference-cheap) — the rollout
        ``start``/fence path's accessor."""
        c = self._cluster(cluster_id)
        with c.lock:
            if c.state is None:
                return None
            return {
                "plan": c.plan,
                "plan_epoch": c.plan_epoch,
                "generation": c.state.generation,
            }

    # -- the delta path -------------------------------------------------

    def handle_event(self, cluster_id: str, ev: dict) -> dict:
        """Apply one fenced event; returns the response body. Raises
        :class:`EventError` (bad request), :class:`FencedEpoch` (409),
        :class:`StormShed` (503), or whatever the injected solver
        raises."""
        if not valid_cluster_id(cluster_id):
            raise EventError(
                f"bad cluster id {cluster_id!r} (want "
                "[A-Za-z0-9][A-Za-z0-9._-]{0,63})"
            )
        if not isinstance(ev, dict):
            raise EventError("event must be a JSON object")
        c = self._cluster(cluster_id)
        with c.lock:
            # fencing FIRST, against the persisted-or-live epoch: a
            # replayed epoch must cause no state change and no solve
            epoch = ev.get("epoch")
            if c.state is not None and isinstance(epoch, int) \
                    and not isinstance(epoch, bool) \
                    and epoch <= c.state.epoch:
                self._count(fenced_total=1)
                _olog.warn("watch_epoch_fenced", cluster=cluster_id,
                           got=epoch, current=c.state.epoch)
                raise FencedEpoch(cluster_id, epoch, c.state.epoch,
                                  c.plan_epoch)
            # backpressure BEFORE mutation: an admitted event is never
            # dropped, so admission is where the storm is refused
            if c.solving and c.pending_events >= self.max_backlog:
                self._count(storm_sheds_total=1)
                raise StormShed(
                    cluster_id, c.pending_events,
                    retry_after_s=max(self.window_s * 2.0, 0.25),
                )
            new_state = apply_event(c.state, cluster_id, ev)
            # a (re-)bootstrap re-declares the ground truth: the old
            # pre-plan rewind point describes a dead world, and any
            # in-flight rollout's hold is released (its record is
            # generation-fenced on the rollout side)
            pre = None if ev.get("type") == "bootstrap" else c.pre_plan
            # persist BEFORE the in-memory commit: if the save raises,
            # the epoch has not advanced and the client's retry of the
            # same event is admitted, not fenced
            self._persist(new_state, c.plan, c.plan_epoch,
                          c.plan_report, pre)
            c.state = new_state
            c.pre_plan = pre
            if ev.get("type") == "bootstrap":
                c.rollout_hold = False
            self._count(events_total=1)
            if c.solving:
                # coalesce: ack now, cancel the superseded in-flight
                # solve (ONE cancel per solve), let the drain thread
                # re-solve the latest state once
                c.pending_events += 1
                self._count(coalesced_total=1)
                if c.active_budget is not None \
                        and not c.active_budget.cancelled:
                    c.active_budget.cancel()
                    self._count(superseded_total=1)
                    _olog.log("watch_solve_superseded",
                              cluster=cluster_id, epoch=c.state.epoch)
                return {
                    "cluster_id": cluster_id,
                    "status": "accepted",
                    "epoch": c.state.epoch,
                    "coalesced": True,
                    "pending_events": c.pending_events,
                    "plan_epoch": c.plan_epoch,
                }
            # idle cluster: this thread takes the solver role
            c.solving = True
        try:
            result, retained = self._solve_once(cluster_id, c)
        except BaseException:
            self._count(solve_errors_total=1)
            with c.lock:
                c.active_budget = None
                # events that coalesced behind this failing solve were
                # acked 202 and must not strand: keep the solver role
                # and hand it to a drain thread (bounded retries
                # there). We still hold the role here (solving never
                # went False), so this decision cannot race a new
                # solver.
                has_pending = c.pending_events > 0
                if not has_pending:
                    c.solving = False
            if has_pending:
                self._spawn_drain(cluster_id, c)
            raise
        if retained:
            self._spawn_drain(cluster_id, c)
        return result

    def _solve_once(self, cluster_id: str, c: _Cluster) -> tuple:
        """Run one solve of the cluster's LATEST state (caller holds
        the solver role) and commit the plan. Returns ``(response_body,
        retained)`` where ``retained`` says whether the commit KEPT the
        solver role (events arrived mid-solve, so the caller must
        drain). ``retained`` is decided under the same lock as the
        commit — callers must act on it rather than re-reading
        ``c.solving``, which by then may be a NEW solver's True (the
        role is released inside the commit, and a fresh event can claim
        it the moment the lock drops)."""
        with c.lock:
            target = c.state
            c.pending_events = 0
            budget = Budget(self.solve_budget_s)
            c.active_budget = budget
            prev_plan = (
                Assignment.from_dict(c.plan) if c.plan else None
            )
        # flight-record tagging (obs.flight): any engine solve the
        # injected solve_fn runs on THIS thread lands as kind="delta"
        # with the cluster/epoch identity — the CLI --events replay and
        # bench's --replay-day get per-event flight records for free.
        # (serve's solve_fn hops to a worker thread, where contextvars
        # do not follow; it re-tags inside the worker job itself.)
        with _oflight.context("delta", cluster=cluster_id,
                              epoch=target.epoch):
            plan_dict, report = self.solve_fn(target, prev_plan, budget)
        warm = bool(report.get("solver_warm_started")
                    or report.get("warm_started"))
        self._count(solves_total=1, warm_solves_total=int(warm))
        committed = False
        hold = False
        with c.lock:
            # the plan is the cluster's assignment going forward: the
            # next event diffs against it, so per-event move counts
            # stay per-event. Events that landed DURING the solve may
            # have grown the partition set — merge, never overwrite.
            # Persist first (see _persist): a failed save commits
            # nothing in memory. EXCEPT: a re-bootstrap that coalesced
            # behind this solve re-declared the whole assignment (the
            # generation bumped) — merging this plan over it would
            # clobber the operator's declared ground truth with replica
            # lists from a dead world, so nothing is committed and the
            # drain re-solve plans against the new reality instead.
            if c.state.generation == target.generation:
                summary = _report_summary(report)
                # mid-rollout the assignment is NOT the plan: the
                # waves advance it (commit_assignment); the plan is
                # the destination the remaining waves chase. On a
                # normal merge the pre-merge assignment is kept as the
                # rewind point a later rollout `start` executes from.
                # The hold is read HERE, under the same lock as the
                # commit — a rollout starting mid-solve either lands
                # its begin_execution before this commit (we hold) or
                # after it (it rewinds the merged truth); no ordering
                # loses the race.
                hold = c.rollout_hold
                if hold:
                    merged = c.state.assignment
                    pre = c.pre_plan
                else:
                    merged = _merge_plan(
                        c.state.assignment,
                        Assignment.from_dict(plan_dict)
                    )
                    pre = c.state.assignment.to_dict()
                new_state = replace(c.state, assignment=merged)
                self._persist(new_state, plan_dict, target.epoch,
                              summary, pre)
                c.plan = plan_dict
                c.plan_epoch = target.epoch
                c.plan_report = summary
                c.state = new_state
                c.pre_plan = pre
                committed = True
            superseded = budget.cancelled
            c.active_budget = None
            retained = c.pending_events > 0
            if not retained:
                c.solving = False
        _olog.log("watch_plan", cluster=cluster_id,
                  plan_epoch=target.epoch, warm=warm,
                  superseded=superseded,
                  moves=report.get("replica_moves"),
                  feasible=report.get("feasible"))
        if committed and hold and self.replan_fn is not None:
            # mid-rollout re-plan (docs/ROLLOUT.md): the new plan was
            # solved against the partially-moved truth; hand it to the
            # rollout so the REMAINING waves chase it. Outside c.lock
            # (the hook takes the rollout lock, then may re-enter ours)
            # and exception-proofed on the hook's side.
            self.replan_fn(cluster_id, plan_dict, target.epoch)
        return {
            "cluster_id": cluster_id,
            "status": "planned",
            "epoch": target.epoch,
            "plan_epoch": target.epoch,
            "assignment": plan_dict,
            "report": report,
            "superseded": superseded,
        }, retained

    def _spawn_drain(self, cluster_id: str, c: _Cluster) -> None:
        """Drain thread: the CALLER must hold the solver role when it
        spawns this (``c.solving`` True and no other thread running
        ``_solve_once``) — the role transfers to the thread. Each lap
        waits one coalescing window for the burst to settle, then ONE
        re-solve of the latest state; the loop continues only while its
        OWN commit retained the role (the ``retained`` flag
        ``_solve_once`` decides under the commit lock). It never reads
        ``c.solving`` as a reason to solve — once a commit releases the
        role, a fresh event can claim it the instant the lock drops,
        and a re-read True would be that NEW solver's role; two threads
        in ``_solve_once`` would race commits (epoch regression,
        double-reset of ``pending_events``). A failing re-solve retries
        with jittered backoff up to ``DRAIN_RETRIES`` times — events
        behind it were acked 202 and must not strand — then gives the
        role back; the durable state is intact and the next admitted
        event re-solves the latest state."""

        def run():
            attempts = 0
            while True:
                if self.window_s > 0:
                    time.sleep(self.window_s)
                try:
                    _, retained = self._solve_once(cluster_id, c)
                except BaseException as e:
                    self._count(solve_errors_total=1)
                    attempts += 1
                    _olog.error("watch_drain_solve_failed",
                                cluster=cluster_id, attempt=attempts,
                                error=repr(e)[:200])
                    with c.lock:
                        # the failed solve's budget is dead: an event
                        # landing during the backoff must not "cancel"
                        # it and inflate superseded_total
                        c.active_budget = None
                        if attempts >= DRAIN_RETRIES:
                            c.solving = False
                    if attempts >= DRAIN_RETRIES:
                        return
                    time.sleep(backoff_s(attempts))
                    continue
                attempts = 0
                if not retained:
                    return  # our commit released the role: quiet

        threading.Thread(target=run, daemon=True,
                         name=f"kao-watch-{cluster_id}").start()
