"""Full-candidate scoring in plain PyTorch (the reference scorer).

Counterpart of ``kafka_assignment_optimizer_tpu.ops.score``: for
candidates ``A[N, P, R]`` in broker-index space, the exact preservation
weight and the integer violation counts of the four inequality families
(replica, leader and rack balance bands; per-partition rack diversity),
the same quantities ``ProblemInstance.violations`` computes in numpy.

Histograms have ``B + 1`` buckets: invalid slots hold the null broker
``B``, which lands in the dropped last bucket. The arithmetic is B1's
plain version (``ops.score_cuda.score_plain``), which both scorers of
the reference compute alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..solvers.tpu.arrays import ModelArrays
from .score_cuda import moves, score_plain


class Score(NamedTuple):
    weight: torch.Tensor  # [N] int32 — preservation weight (maximize)
    pen_broker: torch.Tensor  # [N] int32 — replica band violations
    pen_leader: torch.Tensor  # [N] int32 — leader band
    pen_rack: torch.Tensor  # [N] int32 — rack band
    pen_part_rack: torch.Tensor  # [N] int32 — per-partition diversity
    cnt: torch.Tensor  # [N, B+1] per-broker replica totals
    lcnt: torch.Tensor  # [N, B+1] per-broker leader totals
    rcnt: torch.Tensor  # [N, K+1] per-rack totals

    @property
    def penalty(self) -> torch.Tensor:
        return (self.pen_broker + self.pen_leader + self.pen_rack
                + self.pen_part_rack)

    @property
    def feasible(self) -> torch.Tensor:
        return self.penalty == 0


def score_batch(a: torch.Tensor, m: ModelArrays) -> Score:
    """Score candidates ``a[N, P, R]`` (plain PyTorch, any device)."""
    out, cnt, lcnt, rcnt = score_plain(m, a)
    return Score(weight=out[:, 0], pen_broker=out[:, 1],
                 pen_leader=out[:, 2], pen_rack=out[:, 3],
                 pen_part_rack=out[:, 4], cnt=cnt, lcnt=lcnt, rcnt=rcnt)


def score_one(a: torch.Tensor, m: ModelArrays) -> Score:
    """Score a single candidate ``a[P, R]`` (fields lose the chain axis)."""
    return Score(*(x[0] for x in score_batch(a[None], m)))


def moves_batch(a: torch.Tensor, m: ModelArrays) -> torch.Tensor:
    """Replica-move count vs the current assignment, per candidate
    ``a[N, P, R]`` (B1's ``out[:, 5]``). [N] int32."""
    return moves(m, a)


def moves_one(a: torch.Tensor, m: ModelArrays) -> torch.Tensor:
    return moves_batch(a[None], m)[0]
