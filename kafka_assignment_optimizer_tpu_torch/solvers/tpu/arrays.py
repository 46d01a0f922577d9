"""Device-tensor view of a ProblemInstance: everything the sweep engine and
its kernels read, as tensors on one device.

Counterpart of ``kafka_assignment_optimizer_tpu.solvers.tpu.arrays``.
Shapes: B brokers (+1 null bucket), P partitions (padded up to the
shape bucket), R max replication factor, K racks (+1 null rack).

Penalty weights: one unit of any constraint violation outweighs the
largest single-step objective gain (a weight-4 leader keep), so the
search orders feasibility strictly above preservation while hot sweeps
can still tunnel through infeasible states.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ...models.instance import ProblemInstance

# score = SCALE_W * weight - LAMBDA * total_violations
SCALE_W = 1
LAMBDA = 64

# the default search configuration (the reference's ``LaneConfig()``):
# penalty scale, temperature-ladder multiplier, compound-move gate
DEFAULT_LAM = float(LAMBDA)
DEFAULT_TEMP_SCALE = 1.0
DEFAULT_COMP_ENABLE = 1.0


def band_pen(c, lo, hi):
    """Integer band-violation magnitude of count ``c`` vs [lo, hi]; must
    match the numpy oracle (``ProblemInstance.violations``) exactly."""
    return torch.clamp_min(c - hi, 0) + torch.clamp_min(lo - c, 0)


def u01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64 values in [0, 2**32)) -> uniform float32 in
    [0, 1) from the top 24 bits; the int -> float conversion is exact."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def geometric_temps(t_hi: float, t_lo: float, n: int) -> np.ndarray:
    """The shared annealing temperature ladder, computed end to end in
    float32 as the reference computes it (numpy on the host)."""
    f = np.float32
    expo = np.arange(n, dtype=np.float32) / f(max(n - 1, 1))
    return (f(t_hi) * (f(t_lo) / f(t_hi)) ** expo).astype(np.float32)


@dataclass(frozen=True)
class ModelArrays:
    """Model constants on one device. Every field is a tensor."""

    a0: torch.Tensor  # [P, R] int32 current assignment, null = B
    rf: torch.Tensor  # [P] int32
    slot_valid: torch.Tensor  # [P, R] bool
    w_lead: torch.Tensor  # [P, B+1] int32
    w_foll: torch.Tensor  # [P, B+1] int32
    rack_of: torch.Tensor  # [B+1] int32, null broker -> K
    broker_band: torch.Tensor  # [2] int32 (lo, hi)
    leader_band: torch.Tensor  # [2] int32 (lo, hi)
    rack_lo: torch.Tensor  # [K+1] int32 (null rack: 0)
    rack_hi: torch.Tensor  # [K+1] int32 (null rack: huge)
    part_rack_hi: torch.Tensor  # [P] int32
    lam: torch.Tensor  # [] float32 penalty scale
    temp_scale: torch.Tensor  # [] float32 temperature-ladder multiplier
    comp_enable: torch.Tensor  # [] float32 1.0/0.0 compound-move gate

    @property
    def num_parts(self) -> int:
        return self.a0.shape[0]

    @property
    def max_rf(self) -> int:
        return self.a0.shape[1]

    @property
    def num_brokers(self) -> int:
        return self.w_lead.shape[1] - 1

    @property
    def num_racks(self) -> int:
        return self.rack_lo.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.a0.device

    def _host(self) -> tuple:
        """The scalar leaves the kernels take as arguments, read to the
        host once per model."""
        cached = self.__dict__.get("_host_scalars")
        if cached is None:
            bands = torch.cat([self.broker_band, self.leader_band]).tolist()
            cached = (tuple(int(x) for x in bands), float(self.lam))
            object.__setattr__(self, "_host_scalars", cached)
        return cached

    def bands(self) -> tuple[int, int, int, int]:
        """(broker_lo, broker_hi, leader_lo, leader_hi) as host ints."""
        return self._host()[0]

    def lam_host(self) -> float:
        """The penalty scale as a host float (float32-exact)."""
        return self._host()[1]


_FIELDS = [f.name for f in dataclasses.fields(ModelArrays)]
_FLOAT_FIELDS = ("lam", "temp_scale", "comp_enable")


def from_numpy(leaves: dict, device) -> ModelArrays:
    """Build a ``ModelArrays`` from host arrays keyed by field name — the
    reference's ``ModelArrays`` leaves taken as numpy arrays carry over
    unchanged, so both packages compute on identical inputs."""
    out = {}
    for name in _FIELDS:
        x = np.asarray(leaves[name])
        if name in _FLOAT_FIELDS:
            x = x.astype(np.float32)
        elif name == "slot_valid":
            x = x.astype(bool)
        else:
            x = x.astype(np.int32)
        out[name] = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return ModelArrays(**out)


def from_instance(
    inst: ProblemInstance,
    device,
    num_parts: int | None = None,
    max_rf: int | None = None,
) -> ModelArrays:
    """Lower an instance to tensors on ``device``, optionally padded up to
    a bucket shape (``bucket.bucket_shape``). Padded partition rows are
    inert: ``rf = 0``, ``slot_valid`` all false (their slots null out to
    broker ``B``), zero weights and a zero diversity cap; every proposal
    on them is rejected. Padded slot columns are plain invalid slots."""
    B = inst.num_brokers
    big = np.iinfo(np.int32).max // 4
    P, R = inst.num_parts, inst.max_rf
    Pp = P if num_parts is None else max(int(num_parts), P)
    Rp = R if max_rf is None else max(int(max_rf), R)
    a0 = np.full((Pp, Rp), B, np.int32)
    a0[:P, :R] = inst.a0
    rf = np.zeros(Pp, np.int32)
    rf[:P] = inst.rf
    slot_valid = np.zeros((Pp, Rp), bool)
    slot_valid[:P, :R] = inst.slot_valid
    w_lead = np.zeros((Pp, B + 1), np.int32)
    w_lead[:P] = inst.w_leader
    w_foll = np.zeros((Pp, B + 1), np.int32)
    w_foll[:P] = inst.w_follower
    part_rack_hi = np.zeros(Pp, np.int32)
    part_rack_hi[:P] = inst.part_rack_hi
    return from_numpy({
        "a0": a0,
        "rf": rf,
        "slot_valid": slot_valid,
        "w_lead": w_lead,
        "w_foll": w_foll,
        "rack_of": inst.rack_of_broker,
        "broker_band": [inst.broker_lo, inst.broker_hi],
        "leader_band": [inst.leader_lo, inst.leader_hi],
        "rack_lo": np.concatenate([inst.rack_lo, [0]]),
        "rack_hi": np.concatenate([inst.rack_hi, [big]]),
        "part_rack_hi": part_rack_hi,
        "lam": DEFAULT_LAM,
        "temp_scale": DEFAULT_TEMP_SCALE,
        "comp_enable": DEFAULT_COMP_ENABLE,
    }, device)


def state_from_numpy(state, device):
    """The sweep state ``(a, best_k, best_mv, best_a, key)`` from host
    arrays: the four population leaves become int32 tensors on
    ``device`` (independent buffers, never views of one another), the
    key stays a host ``uint32[2]``."""
    a, best_k, best_mv, best_a, key = state

    def t(x):
        return torch.tensor(np.asarray(x, np.int32), device=device)

    return (t(a), t(best_k), t(best_mv), t(best_a),
            np.asarray(key, np.uint32).copy())


def chain_state_from_numpy(leaves: dict, device):
    """The chain engine's ``ChainState`` from host arrays keyed by field
    name (the reference's ``ChainState`` leaves taken as numpy arrays):
    the population and count leaves become int32 tensors on ``device``,
    the keys int64 ``[N, 2]`` tensors of their uint32 words."""
    from .anneal import ChainState

    def t(name):
        return torch.tensor(np.asarray(leaves[name], np.int32),
                            device=device)

    key = np.asarray(leaves["key"], np.uint32).astype(np.int64)
    return ChainState(a=t("a"), cnt=t("cnt"), lcnt=t("lcnt"),
                      rcnt=t("rcnt"), pen=t("pen"), w=t("w"),
                      key=torch.tensor(key, device=device))


def pad_candidate(a: np.ndarray, m: ModelArrays) -> np.ndarray:
    """Pad a host candidate ``[P, R]`` up to the model's (possibly
    bucketed) ``[Pp, Rp]`` with the null broker."""
    a = np.asarray(a, dtype=np.int32)
    Pp, Rp = m.a0.shape
    if a.shape == (Pp, Rp):
        return a
    out = np.full((Pp, Rp), m.num_brokers, np.int32)
    out[: a.shape[0], : a.shape[1]] = a
    return out


def unpad_candidate(a, inst: ProblemInstance) -> np.ndarray:
    """Slice a (possibly bucket-padded) candidate back to the instance's
    real ``[P, R]`` shape."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, dtype=np.int32)[: inst.num_parts, : inst.max_rf]
