"""Solver checkpoint / warm resume.

A copy of ``kafka_assignment_optimizer_tpu.utils.checkpoint`` (the files
are byte-compatible: either package resumes from the other's checkpoint).
A checkpoint is the best candidate found so far: saving it costs one
``[P, RF]`` int array; resuming seeds the next solve with it, so
interrupted or iterative solves (a service re-optimizing a live cluster
every few minutes) never regress below the last plan.

Format: a single ``.npz`` with the candidate plus an instance fingerprint
(broker ids, topic/partition layout, RF, rack map, the current assignment,
weights and bands). A checkpoint only resumes onto the SAME problem; a
mismatched fingerprint is ignored rather than poisoning the seed.
"""

from __future__ import annotations

import hashlib
import json
import zipfile
from pathlib import Path

import numpy as np

from ..models.instance import ProblemInstance


def instance_fingerprint(inst: ProblemInstance) -> str:
    """Stable digest of everything that defines candidate compatibility:
    layout (brokers, racks, partitions, RF) AND the objective/constraint
    data (current assignment a0, weight matrices, bands) — a checkpoint
    must only resume onto the same *problem*, not just the same shapes
    (a same-layout instance with a different current assignment or
    different bands is a different problem, and re-seeding from it would
    make the saved meta objective a lie)."""
    h = hashlib.sha256()
    for arr in (inst.broker_ids, inst.rack_of_broker, inst.topic_of_part,
                inst.part_id, inst.rf, inst.a0, inst.w_leader,
                inst.w_follower, inst.rack_lo, inst.rack_hi,
                inst.part_rack_hi):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(json.dumps([inst.topics, inst.broker_lo, inst.broker_hi,
                         inst.leader_lo, inst.leader_hi]).encode())
    return h.hexdigest()[:32]


def save(path: str | Path, inst: ProblemInstance, a: np.ndarray,
         meta: dict | None = None) -> None:
    """Atomically persist candidate ``a`` as the checkpoint for ``inst``."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    np.savez(
        tmp,
        a=np.asarray(a, np.int32),
        fingerprint=np.frombuffer(
            instance_fingerprint(inst).encode(), dtype=np.uint8
        ),
        meta=np.frombuffer(
            json.dumps(meta or {}, default=str).encode(), dtype=np.uint8
        ),
    )
    # np.savez appends .npz to names without it; normalize
    produced = tmp if tmp.exists() else tmp.with_suffix(tmp.suffix + ".npz")
    produced.replace(path)


def load(path: str | Path, inst: ProblemInstance) -> np.ndarray | None:
    """Return the checkpointed candidate if it belongs to ``inst`` (same
    fingerprint and shape), else None."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        with np.load(path) as z:
            fp = bytes(z["fingerprint"]).decode()
            a = np.asarray(z["a"], np.int32)
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        # corrupt/truncated/foreign file: fall back to the greedy seed
        return None
    if fp != instance_fingerprint(inst):
        return None
    if a.shape != (inst.num_parts, inst.max_rf):
        return None
    return a
