"""Durable per-cluster plan store (docs/WATCH.md).

One JSON record per named cluster under an OPERATOR-chosen directory
(``--watch-dir``; clients never name paths): the cluster state as of
its latest epoch, the last certified plan and the epoch it was solved
for, and a summary of that plan's report. The write discipline is the
same one ``utils.checkpoint`` uses for solver checkpoints:

- **atomic write-rename**: the record is written to a ``.tmp`` sibling,
  flushed AND fsynced, then ``os.replace``d over the real name — a
  ``kill -9`` at any instant leaves either the old complete record or
  the new complete record, never a torn file;
- **fingerprint-verified load**: the record embeds a SHA-256 over its
  canonical payload; a record that fails the check (bit rot, a partial
  copy restored from backup, hand editing) is reported as corrupt and
  treated as absent rather than silently trusted — epoch fencing from
  a corrupt epoch would reject a healthy client stream.

After a restart the registry reloads each cluster lazily on first
touch, so the event stream resumes at exactly the persisted epoch.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

from ..obs import log as _olog
from .events import ClusterState, valid_cluster_id

__all__ = ["PlanStore", "StoreRecord"]

_RECORD_VERSION = 1


class StoreRecord:
    """One cluster's durable record: ``state`` (latest epoch), the
    last certified ``plan``/``plan_epoch``/``plan_report`` (None until
    the first solve lands), and ``pre_plan`` — the ground-truth
    assignment as it stood immediately BEFORE the last plan merge, the
    rewind point a rollout ``start`` executes from (docs/ROLLOUT.md)."""

    __slots__ = ("state", "plan", "plan_epoch", "plan_report",
                 "pre_plan")

    def __init__(self, state: ClusterState, plan: dict | None = None,
                 plan_epoch: int | None = None,
                 plan_report: dict | None = None,
                 pre_plan: dict | None = None):
        self.state = state
        self.plan = plan
        self.plan_epoch = plan_epoch
        self.plan_report = plan_report
        self.pre_plan = pre_plan


def _payload(rec: StoreRecord) -> dict:
    return {
        "version": _RECORD_VERSION,
        "state": rec.state.to_dict(),
        "plan": rec.plan,
        "plan_epoch": rec.plan_epoch,
        "plan_report": rec.plan_report,
        "pre_plan": rec.pre_plan,
    }


def _fingerprint(payload: dict) -> str:
    canon = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()


class PlanStore:
    """Filesystem-backed cluster records; every public method is safe
    to call concurrently for DIFFERENT clusters (the manager serializes
    per cluster)."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, cluster_id: str) -> Path:
        if not valid_cluster_id(cluster_id):
            raise ValueError(f"bad cluster id {cluster_id!r}")
        return self.root / f"{cluster_id}.json"

    def save(self, rec: StoreRecord) -> None:
        """Atomically persist ``rec`` (write tmp, fsync, rename)."""
        path = self._path(rec.state.cluster_id)
        payload = _payload(rec)
        payload["fingerprint"] = _fingerprint(
            {k: v for k, v in payload.items() if k != "fingerprint"}
        )
        tmp = path.with_suffix(".json.tmp")
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def load(self, cluster_id: str) -> StoreRecord | None:
        """The cluster's verified record, or None (absent OR corrupt —
        a corrupt record is logged and ignored, never trusted)."""
        path = self._path(cluster_id)
        if not path.exists():
            return None
        try:
            with open(path) as f:
                payload = json.load(f)
            fp = payload.pop("fingerprint", None)
            if fp != _fingerprint(payload):
                _olog.error("watch_store_corrupt", cluster=cluster_id,
                            path=str(path))
                return None
            if payload.get("version") != _RECORD_VERSION:
                _olog.warn("watch_store_version_skew",
                           cluster=cluster_id,
                           version=payload.get("version"))
                return None
            return StoreRecord(
                state=ClusterState.from_dict(payload["state"]),
                plan=payload.get("plan"),
                plan_epoch=payload.get("plan_epoch"),
                plan_report=payload.get("plan_report"),
                pre_plan=payload.get("pre_plan"),
            )
        except (OSError, ValueError, KeyError) as e:
            _olog.error("watch_store_unreadable", cluster=cluster_id,
                        error=repr(e)[:200])
            return None

    def list_clusters(self) -> list[str]:
        return sorted(
            p.stem for p in self.root.glob("*.json")
            if valid_cluster_id(p.stem)
        )

    # -- rollout records (docs/ROLLOUT.md) ------------------------------
    # Same write discipline, separate namespace: rollout progress lives
    # under ``<root>/rollout/<cluster>.json`` (a subdirectory, not a
    # suffix — cluster ids may contain dots, so ``foo.rollout.json``
    # would collide with a legal cluster named ``foo.rollout`` in
    # ``list_clusters``). The payload is the executor's serialized
    # :class:`~..rollout.state.RolloutRecord`; this layer only verifies
    # integrity, never interprets it.

    def _rollout_path(self, cluster_id: str) -> Path:
        if not valid_cluster_id(cluster_id):
            raise ValueError(f"bad cluster id {cluster_id!r}")
        return self.root / "rollout" / f"{cluster_id}.json"

    def save_rollout(self, cluster_id: str, record: dict) -> None:
        """Atomically persist one rollout record (write tmp, fsync,
        rename — the :meth:`save` discipline verbatim)."""
        path = self._rollout_path(cluster_id)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"version": _RECORD_VERSION, "rollout": record}
        payload["fingerprint"] = _fingerprint(payload)
        tmp = path.with_suffix(".json.tmp")
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def load_rollout(self, cluster_id: str) -> dict | None:
        """The verified rollout record payload, or None (absent OR
        corrupt — logged and ignored, never trusted)."""
        path = self._rollout_path(cluster_id)
        if not path.exists():
            return None
        try:
            with open(path) as f:
                payload = json.load(f)
            fp = payload.pop("fingerprint", None)
            if fp != _fingerprint(payload):
                _olog.error("rollout_store_corrupt", cluster=cluster_id,
                            path=str(path))
                return None
            if payload.get("version") != _RECORD_VERSION:
                _olog.warn("rollout_store_version_skew",
                           cluster=cluster_id,
                           version=payload.get("version"))
                return None
            return payload["rollout"]
        except (OSError, ValueError, KeyError) as e:
            _olog.error("rollout_store_unreadable", cluster=cluster_id,
                        error=repr(e)[:200])
            return None
