"""The one-device subset of the reference's ``parallel.mesh``: the initial
sweep state.

The reference tiles the population over a device mesh; this package runs
one device, which is the reference's mesh of one: one shard holding all
chains, its RNG key the first of ``split(key, 1)``.
"""

from __future__ import annotations

import torch

from .. import prng
from ..ops.score_cuda import score
from ..solvers.tpu.arrays import ModelArrays
from ..solvers.tpu.sweep import out_key


def init_sweep_state(m: ModelArrays, a_seed: torch.Tensor, key,
                     n_chains: int):
    """Initial sweep state: every chain starts at the seed, and every
    per-chain best snapshot starts AT the seed, so the engine never
    returns a plan that ranks below it. The population and snapshot
    leaves are two independent buffers (never two views of one
    broadcast): the stepper may later hand either to a kernel that
    writes its output beside it. The seed is scored, and its moves
    counted, by B1 (its plain version on the CPU)."""
    a = a_seed.to(torch.int32)[None]
    out, _c, _l, _r = score(m, a)
    k0, mv0 = out_key(out)[0], out[0, 5]
    pop = a.repeat(n_chains, 1, 1)
    return (
        pop,
        k0.repeat(n_chains),
        mv0.repeat(n_chains),
        pop.clone(),
        prng.split(key, 1)[0],
    )

