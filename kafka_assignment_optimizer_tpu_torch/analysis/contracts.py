"""Runtime contracts pass (``kao-check``'s KAO201/KAO202) in place of the
reference's jaxpr one.

The reference traces its solvers with ``jax.make_jaxpr`` and reads the
equations. This package has no trace to read, so the pass RUNS the real
steppers once, on the demo instance's bucket shape, under a
``TorchDispatchMode`` that records every aten op: the recorder is the
counterpart of walking the jaxpr. Five steps run:

- the sweep stepper (``sweep.make_sweep_stepper_fn``) over one chunk;
- the lane stepper (``sweep.make_lane_stepper_fn``) at L=2;
- the fused group steppers (``sweep.make_mega_stepper_fn`` and
  ``make_mega_lane_stepper_fn`` at L=2), armed, K=2, run eagerly with the
  device keys a fused ladder carries: the work a group graph captures,
  which must read nothing from the host (its ``done`` flag, keys and
  temperatures live on the device);
- one eager round of the chain engine (``anneal.make_round_runner``).

On the card the steppers take the ``cuda`` scorer, so the chunk launches
the hand-written kernels. A call into the CUDA extension bypasses the
dispatcher: the recorder sees the wrappers' allocations and every torch
op around the kernels, and the wrappers' launch counters
(``ops.kernels``) show that the kernels ran; the report carries them.

- **KAO201**: a float64 tensor made inside a step (the device path is
  float32 end to end), and a host sync inside a step: an
  ``aten._local_scalar_dense`` (``.item()``, ``int(t)``, ``if t:``) or a
  copy from the device to the CPU — the counterpart of "no host
  callbacks".
- **KAO202**: the state does not round-trip, tensor for tensor, in
  shape, dtype and device; ``best_a`` (the sweep's ``[P, R]``, the lanes'
  ``[L, P, R]``, the chain round's ``[N, P, R]``) or the ``curve`` is not
  at the bucket shape; ``bucket_shape`` pads down; or two state tensors
  overlap in storage, or one has a zero stride, before or after a step
  (the aliased-state class of bug: an in-place kernel output through one
  of them corrupts the other).

``run_contracts(device=...)`` takes the card by default, like every entry
point of the package; without a card it raises unless the caller asks
for the CPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from .findings import Finding

_SYNC_OPS = ("aten._local_scalar_dense",)


@dataclass
class ContractReport:
    findings: list
    checks_run: int = 0
    ops: int = 0  # aten ops the recorder saw across the steps
    # kernel launches of each step, by kernel name (the card only)
    launches: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings


def _recorder():
    """A ``TorchDispatchMode`` that counts every aten op and notes the
    float64 tensors it makes and the host syncs it makes. Imported here:
    torch loads only when the contracts run."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0
            self.float64: dict[str, int] = {}
            self.syncs: dict[str, int] = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            self.ops += 1
            name = str(func.overloadpacket)
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            if name in _SYNC_OPS or (
                any(t.device.type != "cpu" for t in ins)
                and any(t.device.type == "cpu" for t in outs)
            ):
                self.syncs[name] = self.syncs.get(name, 0) + 1
            if any(t.dtype == torch.float64 for t in outs):
                self.float64[name] = self.float64.get(name, 0) + 1
            return out

    return Recorder()


def run_step(name: str, fn, args, findings: list):
    """``fn(*args)`` under the recorder; its float64 tensors and host
    syncs become KAO201 findings. Returns ``(output, ops recorded)``."""
    with _recorder() as rec:
        out = fn(*args)
    if rec.float64:
        findings.append(Finding(
            "KAO201", name, 0,
            f"float64 tensors made inside the {name} ({_census(rec.float64)}"
            "); the device path is float32 end to end"))
    if rec.syncs:
        findings.append(Finding(
            "KAO201", name, 0,
            f"host sync inside the {name} ({_census(rec.syncs)}): the host "
            "waits for the device mid-step"))
    return out, rec.ops


def _census(counts: dict) -> str:
    return ", ".join(f"{k} x{v}" for k, v in sorted(counts.items()))


def _leaves(state) -> list:
    """A state's leaves in order: a tuple's items, a dataclass's fields."""
    if dataclasses.is_dataclass(state):
        return [getattr(state, f.name) for f in dataclasses.fields(state)]
    return list(state)


def _signature(x) -> tuple:
    import torch

    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype), str(x.device))
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    return (None if shape is None else tuple(shape), str(dtype), "host")


def check_round_trip(name: str, before, after, findings: list) -> None:
    """KAO202 unless the state comes back tensor for tensor in shape,
    dtype and device (host leaves, the sweep's numpy keys, in shape and
    dtype)."""
    b = [_signature(x) for x in _leaves(before)]
    a = [_signature(x) for x in _leaves(after)]
    if a != b:
        findings.append(Finding(
            "KAO202", name, 0,
            f"state does not round-trip tensor for tensor (in {b} vs out "
            f"{a}): the next chunk cannot take the returned state"))


def check_shape(name: str, what: str, got, want: tuple,
                findings: list) -> None:
    got = tuple(getattr(got, "shape", ()))
    if got != tuple(want):
        findings.append(Finding(
            "KAO202", name, 0,
            f"{what} shape {got} != {tuple(want)} (the bucket shape in the "
            "[C, (L,) N, ...] layout)"))


def _span(t) -> tuple[int, int]:
    """The bytes ``[lo, hi)`` of its storage that a tensor can touch."""
    if t.numel() == 0:
        return (t.data_ptr(), t.data_ptr())
    last = sum((s - 1) * st for s, st in zip(t.shape, t.stride()))
    return (t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size())


def check_storage(name: str, state, when: str, findings: list) -> None:
    """KAO202 for two state tensors overlapping in storage, or one with
    a zero stride on an axis longer than 1 (a broadcast view)."""
    import torch

    ts = [(i, x) for i, x in enumerate(_leaves(state))
          if isinstance(x, torch.Tensor)]
    for i, t in ts:
        if any(st == 0 and s > 1 for s, st in zip(t.shape, t.stride())):
            findings.append(Finding(
                "KAO202", name, 0,
                f"state tensor {i} {when} the step has a zero stride "
                f"(shape {tuple(t.shape)}, strides {t.stride()}): a "
                "broadcast view, whose rows one in-place write clobbers "
                "together (aliased-state bug class)"))
    for x, (i, t) in enumerate(ts):
        for j, u in ts[x + 1:]:
            if t.device != u.device or t.untyped_storage().data_ptr() \
                    != u.untyped_storage().data_ptr():
                continue
            (a0, a1), (b0, b1) = _span(t), _span(u)
            if a0 < b1 and b0 < a1:
                findings.append(Finding(
                    "KAO202", name, 0,
                    f"state tensors {i} and {j} overlap in storage {when} "
                    "the step: an in-place write through one corrupts the "
                    "other (aliased-state bug class)"))


def check_stepper(name: str, stepper, m, state, temps, want: dict,
                  findings: list) -> int:
    """One stepper run of the sweep engine's contract: the op census
    (KAO201), the state's storage before and after, its round trip, and
    the shapes of ``(best_a, best_k, curve)`` against ``want`` (five
    checks). Returns the ops recorded."""
    check_storage(name, state, "before", findings)
    out, ops = run_step(name, stepper, (m, state, temps), findings)
    if not isinstance(out, tuple) or len(out) != 4:
        # an arity regression is itself the contract violation — it
        # must surface as a finding, never crash the checker
        n = len(out) if isinstance(out, tuple) else 1
        findings.append(Finding(
            "KAO202", name, 0,
            "expected (state, best_a, best_k, curve), got "
            f"{type(out).__name__} of {n}"))
        return ops
    check_round_trip(name, state, out[0], findings)
    check_storage(name, out[0], "after", findings)
    for what, got in zip(("best_a", "best_k", "curve"), out[1:]):
        check_shape(name, what, got, want[what], findings)
    return ops


def check_group(name: str, stepper, args, want: dict,
                findings: list) -> int:
    """One fused group's contract: the op census (KAO201), the state's
    storage before and after and its round trip, and the shapes of
    ``(top_a, top_k, curves, execd)`` against ``want`` (six checks).
    Returns the ops recorded."""
    state = args[1]
    check_storage(name, state, "before", findings)
    out, ops = run_step(name, stepper, args, findings)
    if not isinstance(out, tuple) or len(out) != 8:
        n = len(out) if isinstance(out, tuple) else 1
        findings.append(Finding(
            "KAO202", name, 0,
            "expected (state, top_a, top_k, cert_a, cert_ok, cert_mv, "
            f"curves, execd), got {type(out).__name__} of {n}"))
        return ops
    check_round_trip(name, state, out[0], findings)
    check_storage(name, out[0], "after", findings)
    for what, got in zip(("top_a", "top_k", "curves", "execd"),
                         (out[1], out[2], out[6], out[7])):
        check_shape(name, what, got, want[what], findings)
    return ops


def _demo_instance():
    from ..api import build_instance
    from ..models.cluster import (
        demo_assignment,
        demo_broker_list,
        demo_topology,
    )

    return build_instance(
        demo_assignment(), demo_broker_list(), demo_topology()
    )


def resolve_device(device):
    """``device`` as a ``torch.device``; raises when it names the card and
    there is none (never a fall back to the CPU)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the contracts on the CPU")
    return dev


def _launched(kernels) -> dict:
    return {k.name: k.launches for k in kernels.KERNELS}


def run_contracts(chains: int = 2, sweeps: int = 8,
                  device="cuda") -> ContractReport:
    """Run the real steppers on the demo instance's bucket shape and
    verify every contract above on ``device`` (the card by default; the
    ``cuda`` scorer there, the plain one on the CPU). Returns a report
    whose ``findings`` (KAO201/KAO202) merge into the lint output."""
    import numpy as np
    import torch

    from .. import prng
    from ..ops import kernels
    from ..parallel import mesh as pm
    from ..solvers.tpu import anneal, arrays, bucket, sweep
    from ..solvers.tpu.seed import greedy_seed

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    scorer = "cuda" if on_card else "torch"
    if on_card:
        kernels.build_all()
    findings: list = []
    checks = ops = 0
    launches: dict = {}
    inst = _demo_instance()
    bkt_p, bkt_r = bucket.bucket_shape(inst)
    if bkt_p < inst.num_parts or bkt_r < inst.max_rf:
        findings.append(Finding(
            "KAO202", "bucket", 0,
            f"bucket_shape({inst.num_parts}, {inst.max_rf}) returned a "
            f"smaller shape ({bkt_p}, {bkt_r}); the ladder must only "
            "pad up"))
    checks += 1
    m = arrays.from_instance(inst, dev, num_parts=bkt_p, max_rf=bkt_r)
    check_shape("arrays.from_instance", "padded model a0", m.a0,
                (bkt_p, bkt_r), findings)
    seed = torch.from_numpy(
        arrays.pad_candidate(greedy_seed(inst), m)).to(dev)
    key = prng.PRNGKey(0)
    temps = arrays.geometric_temps(2.0, 0.02, sweeps)

    # ---- the sweep stepper: one chunk
    state = pm.init_sweep_state(m, seed, key, chains)
    kernels.reset_counts()
    ops += check_stepper(
        "sweep stepper", sweep.make_sweep_stepper_fn(chains, scorer=scorer),
        m, state, temps,
        {"best_a": (bkt_p, bkt_r), "best_k": (), "curve": (sweeps,)},
        findings)
    launches["sweep stepper"] = _launched(kernels)
    checks += 5

    # ---- the lane stepper at L=2: the same contracts, lane axis
    L = 2
    m_stack = arrays.stack_models([m, m])
    lane_state = pm.init_lane_state(
        m_stack, np.stack([seed.cpu().numpy()] * L), prng.split(key, L),
        chains)
    kernels.reset_counts()
    ops += check_stepper(
        "lane stepper", sweep.make_lane_stepper_fn(chains, scorer=scorer),
        m_stack, lane_state, temps,
        {"best_a": (L, bkt_p, bkt_r), "best_k": (L,), "curve": (L, sweeps)},
        findings)
    launches["lane stepper"] = _launched(kernels)
    checks += 5

    # ---- the fused groups, armed (thresholds no chain reaches), K=2,
    # eagerly, with the device keys of a fused ladder
    K = 2
    group_in = (np.stack([temps] * K), np.ones(K, bool),
                sweep.MEGA_DISARMED_KEY - 1, 0)
    for name, fn, mm, st, lead in (
            ("group stepper", sweep.make_mega_stepper_fn, m,
             pm.init_sweep_state(m, seed, key, chains), ()),
            ("lane group stepper", sweep.make_mega_lane_stepper_fn,
             m_stack, pm.init_lane_state(
                 m_stack, np.stack([seed.cpu().numpy()] * L),
                 prng.split(key, L), chains), (L,))):
        st = (*st[:4], prng.to_device_keys(st[4], dev))
        kernels.reset_counts()
        ops += check_group(
            name, fn(chains, scorer=scorer, graph=False),
            (mm, st, *group_in),
            {"top_a": (*lead, bkt_p, bkt_r), "top_k": lead,
             "curves": (*lead, K, sweeps), "execd": (*lead, K)}, findings)
        launches[name] = _launched(kernels)
        checks += 6

    # ---- one eager round of the chain engine
    st0 = anneal.init_chain(m, seed, anneal.chain_keys(key, chains, dev))
    bk0, ba0 = anneal.best_key(st0), st0.a.clone()
    check_storage("chain round", st0, "before", findings)
    kernels.reset_counts()
    (st1, bk1, ba1), n = run_step(
        "chain round", anneal.make_round_runner(4, graph=False),
        (m, st0, bk0, ba0, temps[0]), findings)
    launches["chain round"] = _launched(kernels)
    ops += n
    check_round_trip("chain round", st0, st1, findings)
    check_storage("chain round", st1, "after", findings)
    check_shape("chain round", "chain best_a", ba1,
                (chains, bkt_p, bkt_r), findings)
    check_shape("chain round", "chain best_k", bk1, (chains,), findings)
    checks += 5
    return ContractReport(findings=findings, checks_run=checks, ops=ops,
                          launches=launches)
