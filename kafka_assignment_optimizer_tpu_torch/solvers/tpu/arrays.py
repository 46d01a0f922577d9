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
import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ...models.instance import ProblemInstance

# score = SCALE_W * weight - LAMBDA * total_violations
SCALE_W = 1
LAMBDA = 64


@dataclass(frozen=True)
class LaneConfig:
    """One lane's search configuration, carried as model data
    (``ModelArrays.lam`` / ``temp_scale`` / ``comp_enable``):

    - ``lam``: penalty scale (the default orders feasibility strictly
      above preservation; low values tunnel through penalized states);
    - ``temp_scale``: multiplier on the shared temperature ladder;
    - ``compound``: whether the lane accepts compound 2-move exchange
      proposals (the sweeps still run; a disabled lane rejects them).
    """

    lam: float = float(LAMBDA)
    temp_scale: float = 1.0
    compound: bool = True


DEFAULT_CONFIG = LaneConfig()

# the portfolio ladder: lane 0 is always the default config, so a
# portfolio never does worse than the solo solve it replaces; the rest
# trade penalty scale against temperature
PORTFOLIO_TABLE = (
    DEFAULT_CONFIG,                        # anchor: the solo config
    LaneConfig(lam=8.0),                   # tunneler: cheap violations
    LaneConfig(temp_scale=4.0),            # hot ladder: wide exploration
    LaneConfig(lam=256.0, temp_scale=0.5),  # strict quench
    LaneConfig(lam=4.0, temp_scale=2.0),   # hot + soft
    LaneConfig(compound=False),            # plain move set
    LaneConfig(lam=16.0, temp_scale=0.25),  # near-greedy cold descent
    LaneConfig(lam=128.0, temp_scale=2.0),  # hot + strict
)

# the adaptive table: with KAO_PORTFOLIO_ADAPT set and enough evidence
# banked, winners move to the front and never-winners sink to the tail;
# with the gate off (the default) the table stays in the order above
_ADAPT_LOCK = threading.Lock()
_ADAPT_WINS = [0] * len(PORTFOLIO_TABLE)
_ADAPT_SOLVES = [0]
# below this many portfolio solves the table never reorders
ADAPT_MIN_SOLVES = 16


def portfolio_adapt_enabled() -> bool:
    return os.environ.get("KAO_PORTFOLIO_ADAPT", "").lower() not in (
        "", "0", "false", "no",
    )


def note_portfolio_result(winner: LaneConfig | None) -> None:
    """Bank one finished portfolio solve: ``winner`` is the config of
    the lane whose plan won (None when no lane won outright). Called
    once a portfolio solve, gate on or off."""
    with _ADAPT_LOCK:
        _ADAPT_SOLVES[0] += 1
        if winner is not None:
            try:
                _ADAPT_WINS[PORTFOLIO_TABLE.index(winner)] += 1
            except ValueError:
                pass  # a config outside the table has no slot


def reset_portfolio_adapt() -> None:
    with _ADAPT_LOCK:
        _ADAPT_SOLVES[0] = 0
        for i in range(len(_ADAPT_WINS)):
            _ADAPT_WINS[i] = 0


def portfolio_adapt_snapshot() -> dict:
    """The banked evidence and the table order in force."""
    with _ADAPT_LOCK:
        wins = list(_ADAPT_WINS)
        solves = _ADAPT_SOLVES[0]
    enabled = portfolio_adapt_enabled()
    order = _adapted_order(wins) if (
        enabled and solves >= ADAPT_MIN_SOLVES
    ) else list(range(len(PORTFOLIO_TABLE)))
    return {
        "enabled": enabled,
        "solves": solves,
        "min_solves": ADAPT_MIN_SOLVES,
        "wins": wins,
        "order": order,
        "adapted": order != list(range(len(PORTFOLIO_TABLE))),
    }


def _adapted_order(wins: list[int]) -> list[int]:
    """Lane 0 stays the default config; the rest sort by win count,
    the table order breaking ties."""
    tail = sorted(range(1, len(PORTFOLIO_TABLE)),
                  key=lambda i: (-wins[i], i))
    return [0] + tail


def portfolio_configs(width: int) -> list[LaneConfig]:
    """The first ``width`` portfolio lane configs (cycling past the
    table). Lane 0 is the default config."""
    w = max(1, int(width))
    table = PORTFOLIO_TABLE
    if portfolio_adapt_enabled():
        with _ADAPT_LOCK:
            wins = list(_ADAPT_WINS)
            solves = _ADAPT_SOLVES[0]
        if solves >= ADAPT_MIN_SOLVES:
            table = tuple(PORTFOLIO_TABLE[i]
                          for i in _adapted_order(wins))
    return [table[i % len(table)] for i in range(w)]


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
    """Model constants on one device. Every field is a tensor. A stacked
    model (:func:`stack_models`) gives every field a leading lane axis
    ``[L]``; the shape properties read the trailing axes, so they hold
    for both."""

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
        return self.a0.shape[-2]

    @property
    def max_rf(self) -> int:
        return self.a0.shape[-1]

    @property
    def num_brokers(self) -> int:
        return self.w_lead.shape[-1] - 1

    @property
    def num_racks(self) -> int:
        return self.rack_lo.shape[-1] - 1

    @property
    def num_lanes(self) -> int:
        """The lane count of a stacked model; 0 for a single model."""
        return self.a0.shape[0] if self.a0.dim() == 3 else 0

    @property
    def device(self) -> torch.device:
        return self.a0.device

    def lane_scalars(self) -> tuple[list, list, list]:
        """The scalar leaves the kernels take as arguments, one entry a
        lane (one for a single model): ``(bands, lam, temp_scale)`` with
        bands ``(broker_lo, broker_hi, leader_lo, leader_hi)``,
        float32-exact floats. Every constructor of this module carries
        them over from the host arrays or the models it derives from
        (:func:`_carry`), so the chunk step never reads them from the
        device; a model built otherwise reads them once."""
        cached = self.__dict__.get("_host_scalars")
        if cached is None:
            bands = torch.cat([self.broker_band, self.leader_band],
                              -1).reshape(-1, 4).tolist()
            cached = ([tuple(int(x) for x in b) for b in bands],
                      [float(x) for x in self.lam.reshape(-1).tolist()],
                      [float(x)
                       for x in self.temp_scale.reshape(-1).tolist()])
            object.__setattr__(self, "_host_scalars", cached)
        return cached


def lane_temps(temps, m: ModelArrays) -> np.ndarray:
    """The temperature of every sweep of ``temps [..., c]`` (the shared
    ladder) on every lane of the stacked model ``m``: host float32
    ``[..., c, lanes]``, each entry the float32 product ``temps[i] *
    temp_scale[l]`` of the reference's per-lane scaling, from the model's
    host scalars."""
    scales = np.asarray(m.lane_scalars()[2], np.float32)
    return np.asarray(temps, np.float32)[..., None] * scales


_FIELDS = [f.name for f in dataclasses.fields(ModelArrays)]
_FLOAT_FIELDS = ("lam", "temp_scale", "comp_enable")


def _carry(m: ModelArrays, scalars) -> ModelArrays:
    """Cache ``scalars`` (:meth:`ModelArrays.lane_scalars`'s value, or
    None when the source had none) on ``m``; returns ``m``."""
    if scalars is not None:
        object.__setattr__(m, "_host_scalars", scalars)
    return m


def _picked(m: ModelArrays, pick):
    """The host scalars cached on ``m``, each lane list through
    ``pick``; None when ``m`` has none cached."""
    sc = m.__dict__.get("_host_scalars")
    return None if sc is None else tuple(pick(x) for x in sc)


def from_numpy(leaves: dict, device) -> ModelArrays:
    """Build a ``ModelArrays`` from host arrays keyed by field name — the
    reference's ``ModelArrays`` leaves taken as numpy arrays carry over
    unchanged, so both packages compute on identical inputs. Stacked
    leaves (a leading lane axis, the reference's ``stack_models``) carry
    over as a stacked model."""
    out, host = {}, {}
    for name in _FIELDS:
        x = np.asarray(leaves[name])
        if name in _FLOAT_FIELDS:
            x = x.astype(np.float32)
        elif name == "slot_valid":
            x = x.astype(bool)
        else:
            x = x.astype(np.int32)
        host[name] = x
        out[name] = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    bands = np.concatenate([host["broker_band"], host["leader_band"]],
                           -1).reshape(-1, 4).tolist()
    return _carry(ModelArrays(**out), (
        [tuple(int(v) for v in b) for b in bands],
        [float(v) for v in host["lam"].reshape(-1).tolist()],
        [float(v) for v in host["temp_scale"].reshape(-1).tolist()]))


def from_instance(
    inst: ProblemInstance,
    device,
    num_parts: int | None = None,
    max_rf: int | None = None,
    config: LaneConfig | None = None,
) -> ModelArrays:
    """Lower an instance to tensors on ``device``, optionally padded up to
    a bucket shape (``bucket.bucket_shape``), with the search
    configuration ``config`` (default :data:`DEFAULT_CONFIG`). Padded partition rows are
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
        **_config_values(config or DEFAULT_CONFIG),
    }, device)


def _config_values(cfg: LaneConfig) -> dict:
    """The config fields as float32 values."""
    return {"lam": np.float32(cfg.lam),
            "temp_scale": np.float32(cfg.temp_scale),
            "comp_enable": np.float32(1.0 if cfg.compound else 0.0)}


def _config_leaves(cfg: LaneConfig, device) -> dict:
    """The config fields as float32 scalar tensors on ``device``."""
    return {k: torch.tensor(v, device=device)
            for k, v in _config_values(cfg).items()}


def with_config(m: ModelArrays, cfg: LaneConfig) -> ModelArrays:
    """``m`` with its config leaves replaced; the model tables are the
    same tensors (a portfolio's stack shares them across lanes)."""
    out = dataclasses.replace(m, **_config_leaves(cfg, m.device))
    sc = m.__dict__.get("_host_scalars")
    if sc is None or m.num_lanes:
        return out
    vals = _config_values(cfg)
    return _carry(out, (sc[0], [float(vals["lam"])],
                        [float(vals["temp_scale"])]))


def model_config(m: ModelArrays) -> dict:
    """Host view of a single model's config leaves."""
    return {
        "lam": float(m.lam),
        "temp_scale": float(m.temp_scale),
        "compound": bool(float(m.comp_enable) > 0.5),
    }


def stack_models(models: list[ModelArrays]) -> ModelArrays:
    """Stack L same-shape models along a new leading lane axis: the
    model the lane stepper and the lane kernels take. A field that every
    model shares (the same tensor, as :func:`with_config` leaves the
    tables of a portfolio) becomes a read-only lane-stride-0 view of it;
    any other is stacked. Raises ValueError on shape skew: the lanes
    must already share a bucket (same padded P/R, same B/K)."""
    if not models:
        raise ValueError("stack_models needs at least one model")
    first = [getattr(models[0], f).shape for f in _FIELDS]
    for m in models[1:]:
        got = [getattr(m, f).shape for f in _FIELDS]
        if got != first:
            raise ValueError(
                "lane models disagree on shape; pad every instance to a "
                f"common bucket first (expected {first}, got {got})"
            )
    out = {}
    for f in _FIELDS:
        xs = [getattr(m, f) for m in models]
        if all(x is xs[0] for x in xs):
            out[f] = xs[0].unsqueeze(0).expand(len(xs), *xs[0].shape)
        else:
            out[f] = torch.stack(xs)
    scs = [m.__dict__.get("_host_scalars") for m in models]
    return _carry(ModelArrays(**out), None if None in scs else tuple(
        [x for sc in scs for x in sc[i]] for i in range(3)))


def lane_model(m: ModelArrays, lane: int) -> ModelArrays:
    """Lane ``lane`` of a stacked model as a single model (views of the
    stacked tensors, cached on the stacked model)."""
    views = m.__dict__.get("_lane_views")
    if views is None:
        views = [None] * m.num_lanes
        object.__setattr__(m, "_lane_views", views)
    if views[lane] is None:
        views[lane] = _carry(ModelArrays(**{f: getattr(m, f)[lane]
                                            for f in _FIELDS}),
                             _picked(m, lambda x: [x[lane]]))
    return views[lane]


def lane_range(m: ModelArrays, lo: int, hi: int) -> ModelArrays:
    """Lanes ``lo`` to ``hi - 1`` of a stacked model as a stacked model
    (views of its tensors, shared tables still at lane stride 0; cached
    on ``m``, so each range keeps its kernel arguments)."""
    ranges = m.__dict__.get("_lane_ranges")
    if ranges is None:
        ranges = {}
        object.__setattr__(m, "_lane_ranges", ranges)
    if (lo, hi) not in ranges:
        ranges[lo, hi] = _carry(ModelArrays(**{f: getattr(m, f)[lo:hi]
                                               for f in _FIELDS}),
                                _picked(m, lambda x: x[lo:hi]))
    return ranges[lo, hi]


def shard_models(m: ModelArrays, shards: int) -> ModelArrays:
    """The stacked model ``m`` of L lanes as ``shards * L`` lanes, lane
    ``c * L + l`` being lane ``l`` (the lanes of ``shards`` chain shards
    in shard order, as one launch takes them). A table the lanes share
    stays one lane-stride-0 view; any other repeats. Cached on ``m``."""
    if shards == 1:
        return m
    cache = m.__dict__.get("_shard_models")
    if cache is None:
        cache = {}
        object.__setattr__(m, "_shard_models", cache)
    if shards not in cache:
        out = {}
        for f in _FIELDS:
            t = getattr(m, f)
            if t.stride(0) == 0:
                out[f] = t[:1].expand(shards * t.shape[0], *t.shape[1:])
            else:
                out[f] = t.repeat(shards, *([1] * (t.dim() - 1)))
        cache[shards] = _carry(ModelArrays(**out),
                               _picked(m, lambda x: x * shards))
    return cache[shards]


def model_on(m: ModelArrays, device) -> ModelArrays:
    """``m`` with every table on ``device`` (``m`` itself when it is
    there already; cached on ``m``)."""
    device = torch.device(device)
    if m.device == device:
        return m
    cache = m.__dict__.get("_model_on")
    if cache is None:
        cache = {}
        object.__setattr__(m, "_model_on", cache)
    if str(device) not in cache:
        cache[str(device)] = _carry(ModelArrays(
            **{f: getattr(m, f).contiguous().to(device) for f in _FIELDS}),
            _picked(m, list))
    return cache[str(device)]


def state_from_numpy(state, device):
    """The sweep state ``(a, best_k, best_mv, best_a, key)`` from host
    arrays: the four population leaves become int32 tensors on
    ``device`` (independent buffers, never views of one another), the
    key stays a host ``uint32[2]``. The reference's lane state on its
    mesh of one (``a [1, L, N, P, R]``, ``key [1, L, 2]``) becomes the
    port's lane state (``a [L, N, P, R]``, keys ``uint32[L, 2]``)."""
    a, best_k, best_mv, best_a, key = state
    key = np.asarray(key, np.uint32)
    lanes = key.ndim == 3
    if lanes and key.shape[0] != 1:
        raise ValueError(f"a lane state of {key.shape[0]} devices; this "
                         "converts the one-shard layout (a mesh's state "
                         "keeps its shard axis)")

    def t(x):
        x = np.asarray(x, np.int32)
        return torch.tensor(x[0] if lanes else x, device=device)

    return (t(a), t(best_k), t(best_mv), t(best_a),
            (key[0] if lanes else key).copy())


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
