"""Streaming plan rollout (docs/ROLLOUT.md): turn a certified plan
into an executed, supervised reassignment.

- :mod:`waves` decomposes the move diff into bandwidth-budgeted waves
  (move-graph scheduling; no broker or rack exceeds a per-wave
  transfer cap).
- :mod:`state` is the epoch-fenced rollout record and its wave state
  machine (``planned -> canary -> advancing -> done | rolled_back``),
  persisted in the watch plan store.
- :mod:`exec` drives the waves through the watch channel: each
  wave emits upstream-compatible reassignment JSON, canary
  verification gates advancement, rollback replays the inverse waves,
  and mid-rollout cluster events re-plan the REMAINING waves against
  the partially-moved ground truth.
"""

from .state import RolloutConflict, RolloutError, RolloutFenced, RolloutRecord
from .waves import Move, Wave, WaveCaps, WavePlan, moves_of, pack_waves

__all__ = [
    "Move", "Wave", "WaveCaps", "WavePlan", "moves_of", "pack_waves",
    "RolloutRecord", "RolloutError", "RolloutConflict", "RolloutFenced",
]
