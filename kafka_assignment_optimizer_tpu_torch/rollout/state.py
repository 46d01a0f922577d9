"""Rollout records and the wave state machine (docs/ROLLOUT.md).

One :class:`RolloutRecord` per cluster, persisted in the watch plan
store (``watch.store.PlanStore.save_rollout``: atomic write-rename +
fingerprint, kill-9-safe) so a restarted process resumes at the same
wave with the same epoch. The record is the single source of truth the
executor (:mod:`exec`) mutates under the cluster's rollout lock.

State machine::

    planned --start--> (record exists, nothing emitted)
    planned --advance--> canary      (wave 0 emitted, NOT applied)
    canary  --advance{canary_ok:true}--> advancing   (wave 0 applied)
    canary  --advance{canary_ok:false}--> rolled_back
    advancing --advance--> advancing ... --> done    (last wave applied)
    canary|advancing --pause--> paused --advance--> (resumes prior)
    any non-terminal --rollback--> rolled_back

Epoch fencing mirrors the watch channel's contract: every rollout
command carries a client ``epoch`` that must be STRICTLY greater than
the record's ``rollout_epoch``; a stale or replayed command raises
:class:`RolloutFenced` BEFORE any state change and provably without
touching the store. Rollout epochs are their own per-cluster monotone
sequence, independent of the cluster-event epochs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .waves import WavePlan

__all__ = [
    "RolloutRecord", "RolloutError", "RolloutConflict", "RolloutFenced",
    "STATES", "TERMINAL", "COMMANDS",
]

STATES = ("planned", "canary", "advancing", "paused", "done",
          "rolled_back")
TERMINAL = frozenset({"done", "rolled_back"})
COMMANDS = ("start", "advance", "pause", "rollback")


class RolloutError(ValueError):
    """A malformed rollout command (missing/mistyped field) — the
    serve layer's 400."""


class RolloutConflict(Exception):
    """A well-formed command the current rollout state cannot accept
    (advance on a terminal rollout, start over an active one) — the
    serve layer's 409 ``bad_state``."""


class RolloutFenced(Exception):
    """A stale or replayed rollout epoch hit the fence: nothing was
    applied, nothing was persisted."""

    def __init__(self, cluster_id: str, got: int, current: int):
        super().__init__(
            f"rollout epoch {got} is not newer than cluster "
            f"{cluster_id!r}'s current rollout epoch {current}"
        )
        self.cluster_id = cluster_id
        self.got = got
        self.current = current


@dataclass
class RolloutRecord:
    """One cluster's rollout: the packed wave schedule, where it
    stands, and everything rollback needs (the pre-rollout base
    assignment, bit-exact)."""

    cluster_id: str
    rollout_epoch: int          # last accepted command epoch (fence)
    plan_epoch: int | None      # the watch plan this rollout executes
    status: str                 # one of STATES
    wave_index: int             # next wave to emit/apply
    plan: WavePlan              # the wave schedule (applied + remaining)
    base: dict                  # pre-rollout assignment (bit-exact)
    target: dict                # the certified plan being executed
    resumed_status: str | None = None   # what pause interrupted
    replans: int = 0            # mid-rollout re-plans of remaining waves
    applied: list[int] = field(default_factory=list)
    # the cluster generation this rollout was started against: a
    # re-bootstrap bumps it, and a rollout recorded against an older
    # generation refuses every further command (dead world)
    generation: int = 0
    # the rollout's ROOT trace ID (docs/OBSERVABILITY.md "Distributed
    # traces"): assigned at start, persisted with the record, and
    # linked from every transition trace AND every mid-rollout delta
    # re-solve trace (rollout_root attr) — the one ID a wave story
    # joins under
    trace_id: str | None = None

    @property
    def active(self) -> bool:
        return self.status not in TERMINAL

    @property
    def remaining(self) -> int:
        return max(len(self.plan.waves) - len(self.applied), 0)

    def require_status(self, *allowed: str) -> None:
        if self.status not in allowed:
            raise RolloutConflict(
                f"rollout for {self.cluster_id!r} is {self.status!r}; "
                f"this command needs one of {sorted(allowed)}"
            )

    def fence(self, epoch) -> int:
        """Validate + admit one command epoch (strictly monotone).
        Raises :class:`RolloutError` on a malformed epoch and
        :class:`RolloutFenced` on a stale one; the caller persists the
        record AFTER mutating it, so a fenced command provably never
        touches the store."""
        epoch = validate_epoch(epoch)
        if epoch <= self.rollout_epoch:
            raise RolloutFenced(self.cluster_id, epoch,
                                self.rollout_epoch)
        return epoch

    def to_dict(self) -> dict:
        return {
            "cluster_id": self.cluster_id,
            "rollout_epoch": self.rollout_epoch,
            "plan_epoch": self.plan_epoch,
            "status": self.status,
            "wave_index": self.wave_index,
            "plan": self.plan.to_dict(),
            "base": self.base,
            "target": self.target,
            "resumed_status": self.resumed_status,
            "replans": self.replans,
            "applied": list(self.applied),
            "generation": self.generation,
            "trace_id": self.trace_id,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "RolloutRecord":
        status = str(d["status"])
        if status not in STATES:
            raise ValueError(f"unknown rollout status {status!r}")
        return cls(
            cluster_id=str(d["cluster_id"]),
            rollout_epoch=int(d["rollout_epoch"]),
            plan_epoch=(None if d.get("plan_epoch") is None
                        else int(d["plan_epoch"])),
            status=status,
            wave_index=int(d["wave_index"]),
            plan=WavePlan.from_dict(d["plan"]),
            base=dict(d["base"]),
            target=dict(d["target"]),
            resumed_status=d.get("resumed_status"),
            replans=int(d.get("replans", 0)),
            applied=[int(i) for i in d.get("applied", [])],
            generation=int(d.get("generation", 0)),
            # absent on records written without one: the link reads
            # unassigned, never an error
            trace_id=(None if d.get("trace_id") is None
                      else str(d["trace_id"])),
        )


def validate_epoch(epoch) -> int:
    if isinstance(epoch, bool) or not isinstance(epoch, int) \
            or epoch < 0:
        raise RolloutError(
            "rollout commands need an 'epoch': a non-negative int, "
            "strictly greater than the rollout's current epoch"
        )
    return int(epoch)
