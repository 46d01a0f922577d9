"""The device solve path: greedy seed, the chunked sweep ladder on the
card, final selection, polish, oracle verification.

Counterpart of the sweep-engine path of
``kafka_assignment_optimizer_tpu.solvers.tpu.engine`` without what this
package does not have yet: the LP/flow bounds and the constructor race
(so no certificate ends the ladder early and final selection always
takes the reference's uncertified branch: rescore, rank, polish), the
chain engine, lanes, portfolio, pipelining and the host fallback.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; it never moves to the CPU on its own. On the card the
sweep runs through the hand-written kernels (the ``"cuda"`` scorer
bundle), on the CPU through their plain PyTorch versions.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ... import prng
from ...models.instance import ProblemInstance
from ...ops.score_cuda import score
from ...parallel.mesh import init_sweep_state
from ..base import SolveResult, register
from . import arrays, bucket
from .polish import polish
from .seed import greedy_seed
from .sweep import first_argmax, make_sweep_stepper_fn, out_key

_IMIN = int(np.iinfo(np.int32).min)


def resolve_device(device=None) -> torch.device:
    """The solve device: ``cuda`` unless the caller asks for ``cpu``.
    Raises when the card is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected 'cuda' "
                         "or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to solve on "
            "the CPU"
        )
    return dev


def _defaults(platform: str, engine: str | None) -> dict:
    """Search-effort defaults of the sweep engine: 8 chains, 128 sweeps on
    the card, 64 on the CPU (the reference's accelerator and CPU
    budgets)."""
    if engine not in (None, "sweep"):
        raise ValueError(
            f"unknown engine {engine!r}; this package has the 'sweep' "
            "engine only"
        )
    return {"engine": "sweep", "batch": 8,
            "rounds": 128 if platform == "gpu" else 64}


def _build_chunks(inst: ProblemInstance, rounds: int, t_hi: float,
                  t_lo: float) -> list[np.ndarray]:
    """The annealing schedule: one geometric float32 ladder cut into
    equal chunks (8 at 20k+ partitions, else 2), each a multiple of the
    snapshot cadence, the tail padded with ``t_lo`` — exactly the
    reference's cut, so the chunked run replays its ladder."""
    temps_full = arrays.geometric_temps(t_hi, t_lo, rounds)
    n_chunks = 8 if inst.num_parts >= 20_000 else 2
    c = 8 * max(1, -(-rounds // (8 * n_chunks)))
    chunks = [temps_full[i:i + c] for i in range(0, rounds, c)]
    if len(chunks) > 1 and chunks[-1].shape[0] < c:
        pad = np.full(c - chunks[-1].shape[0], t_lo, np.float32)
        chunks[-1] = np.concatenate([chunks[-1], pad])
    return chunks


def _sync(dev: torch.device) -> float:
    """Wait for the device, then read the host clock (phase timing)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _final_selection(m: arrays.ModelArrays,
                     pop_a: torch.Tensor) -> torch.Tensor:
    """Exact rescore of the shard winners (B1 on the card, which also
    counts the moves), ranked by feasibility, then weight, then fewest
    moves (first index on ties): the reference's branch for an
    uncertified champion, which the caller then polishes."""
    out, _cnt, _lcnt, _rcnt = score(m, pop_a)
    primary, moves = out_key(out), out[:, 5]
    tied = primary == primary.max()
    return pop_a[first_argmax(torch.where(tied, -moves, _IMIN))]


def _verify(inst: ProblemInstance, m: arrays.ModelArrays,
            best_a: np.ndarray) -> dict:
    """The numpy oracle's violation counts of the final plan, checked
    against the device scorer's (B1 on the card) — a disagreement means
    the device path is wrong, and raises."""
    viol = inst.violations(best_a)
    weight = inst.preservation_weight(best_a)
    dev_a = torch.from_numpy(arrays.pad_candidate(best_a, m)).to(m.device)
    out = score(m, dev_a[None])[0][0, :5].tolist()
    oracle = [weight, viol["broker_balance"], viol["leader_balance"],
              viol["rack_balance"], viol["part_rack_diversity"]]
    if out != oracle:
        raise RuntimeError(
            "verification failed: the device scores (weight, broker, "
            f"leader, rack, diversity) {out} disagree with the numpy "
            f"oracle {oracle}"
        )
    return viol


@register("tpu")
def solve_tpu(
    inst: ProblemInstance,
    seed: int = 0,
    batch: int | None = None,
    rounds: int | None = None,
    sweeps: int | None = None,  # CLI alias for rounds
    t_hi: float | None = None,
    t_lo: float | None = None,
    engine: str | None = None,
    device=None,
    **_unused,
) -> SolveResult:
    """Solve ``inst`` with the sweep engine on ``device`` (default the
    card). The public name stays ``"tpu"`` so calls match the reference
    package's call for call."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    platform = "gpu" if dev.type == "cuda" else "cpu"
    d = _defaults(platform, engine)
    batch = batch or d["batch"]
    rounds = rounds or sweeps or d["rounds"]
    t_hi = 2.0 if t_hi is None else t_hi
    t_lo = 0.02 if t_lo is None else t_lo
    scorer = "cuda" if dev.type == "cuda" else "torch"

    a_seed = greedy_seed(inst)
    t_seed = time.perf_counter()

    bkt_parts, bkt_rf = bucket.bucket_shape(inst)
    m = arrays.from_instance(inst, dev, num_parts=bkt_parts, max_rf=bkt_rf)
    seed_dev = torch.from_numpy(arrays.pad_candidate(a_seed, m)).to(dev)
    key = prng.PRNGKey(seed)
    chunks = _build_chunks(inst, rounds, t_hi, t_lo)
    # the reference's one-device mesh: one shard holding every chain,
    # with the snapshot-boundary best migration its mesh path runs
    stepper = make_sweep_stepper_fn(batch, scorer=scorer)
    state = init_sweep_state(m, seed_dev, key, batch)
    t_lower = _sync(dev)

    curves = []
    top_a = None
    for temps in chunks:
        state, top_a, _top_k, curve = stepper(m, state, temps)
        curves.append(curve)
    t_ladder = _sync(dev)

    cand = _final_selection(m, top_a[None])
    t_select = _sync(dev)
    best_a = arrays.unpad_candidate(polish(m, cand), inst)
    t_polish = _sync(dev)

    viol = _verify(inst, m, best_a)
    weight = inst.preservation_weight(best_a)
    feasible = all(v == 0 for v in viol.values())
    t_verify = time.perf_counter()
    curve = torch.cat(curves).cpu().numpy()
    return SolveResult(
        a=best_a,
        solver="tpu",
        wall_clock_s=t_verify - t0,
        objective=int(weight),
        optimal=False,
        stats={
            "platform": platform,
            "device": str(dev),
            "engine": "sweep",
            "scorer": scorer,
            "devices": 1,
            "chains_per_device": batch,
            "rounds": rounds,
            "rounds_run": sum(int(c.shape[0]) for c in chunks),
            "chunks": len(chunks),
            "bucket_parts": int(bkt_parts),
            "bucket_rf": int(bkt_rf),
            "moves_lb": inst.move_lower_bound(),
            "seed_moves": int(inst.move_count(a_seed)),
            "moves": int(inst.move_count(best_a)),
            "feasible": feasible,
            "violations": sum(viol.values()),
            "proved_optimal": False,
            "seed_s": round(t_seed - t0, 4),
            "lower_s": round(t_lower - t_seed, 4),
            "anneal_s": round(t_ladder - t_lower, 4),
            "select_s": round(t_select - t_ladder, 4),
            "polish_s": round(t_polish - t_select, 4),
            "verify_s": round(t_verify - t_polish, 4),
            "score_curve": _downsample(curve, 32),
        },
    )


def _downsample(x: np.ndarray, n: int) -> list[int]:
    if x.size <= n:
        return [int(v) for v in x]
    idx = np.linspace(0, x.size - 1, n).round().astype(int)
    return [int(v) for v in x[idx]]
