#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``kafka_assignment_optimizer_tpu_torch``)
on one NVIDIA GPU and fail hard on anything wrong.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. header — the card's name and power limit, torch/CUDA versions, the
   max SM clock behind the INT32 rate the bounds use;
2. build — every CUDA kernel from ``csrc/`` (one nvcc per source, all at
   once), timed;
3. kernel check — B1 (with its move count), the fused site sweep
   (B2+B3) and the fused exchange sweep (B4+B5+B6) against their plain
   PyTorch versions on the card at the shapes of the main path (the
   ``adversarial`` scenario: 8 chains, 10,000 partitions padded to the
   10,240-row bucket, RF up to 4, 256 brokers with one removed); exact
   equality; kernel, plain and library times in CUDA events, device time
   under the profiler, and each kernel's bound; B1 also at 1 chain, the
   verification call. The two fused kernels are checked at two
   temperatures, the exchange sweep's records and maps too. A B1 call and
   a site sweep through their wrappers, and an exchange sweep as the
   engine runs it (the ``cuda`` bundle on one lane) must each launch
   their kernel once (the wrapper's count) and make no other device
   activity that the profiler sees, the exchange sweep with no ``prng``
   draw on the device. The fused kernels' operations bounds
   count threefry's integer instructions in the SASS that ``cuobjdump``
   shows;
3b. lane kernels — the lane forms of the three kernels (one launch for
   L lanes, each with its own tables, bands, penalty scale, temperature
   and key) at the main path's shapes: L=8 lanes on the eight
   ``PORTFOLIO_TABLE`` configs (the tables shared), each launch equal to
   its lane plain version and to 8 single-lane launches, one launch and
   no other device activity a call, wrapper, plain, library and device
   times (L=1 beside L=8) and the bound at L=8; then 3 lanes of three
   adversarial instances whose tables and bands differ, equal likewise;
4. sweep times — median wall ms of one site, exchange and compound sweep
   and one snapshot as the engine runs them (the ``cuda`` bundle on one
   lane), synchronized around each call, and of the plain random draws that the fused kernels
   replace; the device activities and device ms of one B1 call, exchange
   sweep and snapshot;
5. trajectory check — 2 chunks of 8 sweeps through the ``cuda`` bundle
   and through the ``torch`` bundle, both on the card, from one state;
   the states must be equal after every chunk;
6. main path, each solve with the launch counts set to 0 just before
   it and read just after —
   (a) the reference's decisions at the defaults: the demo
   (``construct``/``milp``, 1 move, proven), the demo through
   ``"auto"`` (``milp``) and ``adversarial`` (``construct``/``reseat``,
   117 moves, weight 59,802, proven), all certified on the host by the
   constructor race with no kernel launched;
   (b) ``adversarial`` with ``batch=8, rounds=128, portfolio=False``
   (knobs set turn the reseat race off), the solo anchor: 8 chains x 128
   sweeps on the card, every kernel launched (64 site and 32 exchange
   launches), certified at final selection (``final_cert``
   ``ok``/``ok_reseat``) at 117 moves, weight 59,802;
   (c) the same call with ``portfolio`` at its default: 8 lanes (the
   ``PORTFOLIO_TABLE`` configs) x 8 chains x 128 sweeps, still 64 site
   and 32 exchange launches (one a sweep for all lanes), B1 no more
   often than in (b), at the JAX package's plan for the call (117 moves,
   59,802, proven); wall and phases beside (b)'s;
   (d) ``messy_case(1)`` (``seed=1, engine="sweep", batch=8,
   rounds=32``) with the portfolio and without, on the card and on the
   CPU: equal plans on both devices, the portfolio's (weight 18,
   feasible) not the solo one's (17), as in the JAX package on one
   device;
   (e) the batch path: ``optimize_batch`` of 8 full-size adversarial
   instances (seeds 0-7, one 10,240 x 4 bucket) at its defaults, every
   lane feasible and verified (B1 held to the numpy oracle), lanes 0 and
   7 equal to one-instance ``solve_tpu_batch`` solves; wall and
   instances a second; then 3 of them padded to 8 lanes (the default)
   and run at 3 (``KAO_LANE_BUCKETS=off``), equal plans, both walls;
   (f) the chain engine (plain PyTorch replayed as CUDA graphs, 512
   chains x 24 rounds x 256 steps) on a 40-partition random cluster:
   feasible, B1 launched 3 times and equal to the numpy oracle on its
   plan; its wall beside the card's power limit;
   (g) the sweep->chain retry at its largest budget (512 chains x 24
   rounds x 4P steps) on a 500-partition random cluster: one round as
   CUDA graphs equal to the eager step loop, both timed; then the whole
   24-round anneal the retry runs, feasible and equal to the numpy
   oracle under B1.

The last two lines of stdout are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
INT32_LANES_PER_SM = 64  # Hopper issues 64 INT32 operations a clock per SM
REPS = 20  # launches per timed window
WINDOWS = 5  # windows per time (the median is kept)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed(fn, torch, reps: int = REPS, windows: int = WINDOWS) -> float:
    """Median milliseconds per call over ``windows`` windows of ``reps``
    calls, after a warm-up, in CUDA events."""
    for _ in range(min(reps, 3)):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    return statistics.median(times)


# the __global__ functions each wrapper launches, for the profiler's view
KERNEL_FUNCS = {
    "B1 score": ("score_grid",),
    "B2+B3 site sweep": ("site_sweep",),
    "B4+B5+B6 exchange sweep": ("exchange_sweep",),
}


def profiled(fn, torch, reps: int = 1):
    """Device activity of ``reps`` calls of ``fn`` under torch.profiler:
    ``([(name, microseconds)], wall seconds)``. The list is empty where
    the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    return events, wall


def one_launch(what: str, fn, kernel, func: str, torch) -> list[str]:
    """Fail unless each call of ``fn`` launches ``kernel`` once and makes
    no other device activity: the wrapper's launch count over REPS + 1
    calls, and the names of all that the profiler sees of REPS of them
    (its count of a window's activities has been seen to be off now and
    then, so it counts nothing here). Returns those names."""
    before = kernel.launches
    events, _w = profiled(fn, torch, REPS)  # REPS + 1 calls
    names = sorted({n for n, _us in events})
    launched = kernel.launches - before
    if launched != REPS + 1 or not names or any(func not in n
                                                for n in names):
        fail(f"{REPS + 1} calls of {what} launched {kernel.name} {launched} "
             f"times and made the device activities {names}, expected one "
             f"{func} launch a call and nothing else")
    return names


def max_abs_err(xs, ys, torch) -> float:
    """Largest |x - y| over paired outputs; raises unless all are equal."""
    err = 0.0
    for i, (x, y) in enumerate(zip(xs, ys)):
        if x.shape != y.shape:
            fail(f"output {i}: shape {tuple(x.shape)} vs {tuple(y.shape)}")
        d = (x.to(torch.float64) - y.to(torch.float64)).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def check_equal(name, xs, ys) -> float:
    """Fail unless every paired output is equal; returns max |x - y|."""
    import torch

    err = max_abs_err(xs, ys, torch)
    for i, (x, y) in enumerate(zip(xs, ys)):
        if not torch.equal(x, y):
            fail(f"{name}: output {i} differs from the plain version "
                 f"(max |diff| {err})")
    return err


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def gathered(B1: int, *reads) -> int:
    """Bytes of the distinct weight-table entries that ``reads`` address.
    Each read is ``(table, b, mask)``: ``table`` is 0 for ``w_lead`` and 1
    for ``w_foll`` (an int or an [N, P] tensor), ``b`` the broker indices
    [N, P], and ``mask`` (broadcast to [N, P]) the entries read. Both
    tables are [P, B+1] int32."""
    import torch

    keys = []
    for table, b, mask in reads:
        P = b.shape[1]
        k = ((torch.as_tensor(table, device=b.device) * P
              + torch.arange(P, device=b.device)[None, :]) * B1 + b.long())
        mask = torch.as_tensor(mask, device=b.device)
        keys.append(k[torch.broadcast_to(mask, k.shape)])
    return int(torch.unique(torch.cat(keys)).numel()) * 4


def random_cluster(rng, n_brokers, n_parts, rf, n_racks, drop=0):
    """A seeded random cluster: ``n_parts`` partitions of one topic, each
    on ``rf`` distinct brokers, brokers in racks ``b % n_racks``, and the
    last ``drop`` brokers decommissioned. Returns the port's
    ``(current, broker_list, topology)``."""
    from kafka_assignment_optimizer_tpu_torch.models.cluster import (
        Assignment,
        PartitionAssignment,
        Topology,
    )

    parts = []
    for p in range(n_parts):
        reps = rng.choice(n_brokers, size=rf, replace=False).tolist()
        parts.append(PartitionAssignment("t", p, [int(b) for b in reps]))
    topo = Topology(rack_of={b: f"r{b % n_racks}" for b in range(n_brokers)})
    return Assignment(partitions=parts), list(range(n_brokers - drop)), topo


def smi(query: str) -> str:
    """One line of ``nvidia-smi --query-gpu=<query>`` for the first card
    (empty when nvidia-smi gives nothing)."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0] if out else ""


def header(torch) -> float:
    """Print the card's name and power limit, the versions and the max
    SM clock; return the card's INT32 issue rate in operations/s."""
    print(smi("name,power.limit")
          or f"{torch.cuda.get_device_name(0)}, power limit not read")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    clock = smi("clocks.max.sm")
    if not clock.endswith(" MHz"):
        fail(f"max SM clock not read (nvidia-smi said {clock!r})")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * INT32_LANES_PER_SM * float(clock.split()[0]) * 1e6
    print(f"INT32 issue rate: {sms} SMs x {INT32_LANES_PER_SM} lanes x "
          f"{clock} = {rate:.6g} ops/s")
    return rate


def engine_stages(m, a):
    """The sweep engine's stages as it runs them on one model: the
    ``cuda`` bundle on ``m`` as a stacked model of one lane and the
    chains ``a`` as lane 0, with the histograms and the best snapshot of
    ``a``. Returns ``(bundle, m1, (a1, cnt, lcnt, rcnt), best)``."""
    import torch

    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import sweep

    sc = sweep._make_lane_scorer("cuda")
    m1, a1 = sweep._one_lane(m), a[None]
    out, cnt, lcnt, rcnt = sc.full(m1, a1)
    best = (sweep.best_key(out[..., 0],
                           out[..., 1:5].sum(-1, dtype=torch.int32)),
            out[..., 5], a1.clone())
    return sc, m1, (a1, cnt, lcnt, rcnt), best


def sweep_times(torch, m, a, reps: int = 20) -> dict:
    """Median wall ms of one site, exchange and compound sweep and one
    snapshot (exact rescore, best update, migration) as the engine runs
    them (the ``cuda`` bundle, one lane) on population ``a``, synchronized
    around each call; also, for scale, the wall of the plain draws that
    the fused kernels make in registers: the site sweep's random words,
    and the exchange sweep's words and pairing (the stride and the
    phases' keys are drawn in the exchange launcher's C code)."""
    import numpy as np

    from kafka_assignment_optimizer_tpu_torch import prng
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import sweep

    sc, m1, st, best = engine_stages(m, a)
    temps = [float(np.float32(0.5))]
    key = prng.PRNGKey(5)
    calls = {
        "site": lambda k: sc.site_step(m1, *st, [k], temps),
        "exchange": lambda k: sc.exch_step(m1, *st, [k], temps),
        "compound": lambda k: sc.comp_step(m1, *st, [k], temps),
        "snapshot": lambda k: sweep.snapshot_step(sc, m1, st[0], *best),
        "site bits draw": lambda k: prng.bits(k, (*a.shape[:2], 8),
                                              a.device),
        "exchange draws": lambda k: exchange_draws(k, *a.shape[:2],
                                                   a.device),
    }
    out = {}
    for name, fn in calls.items():
        walls = []
        for i in range(reps + 3):
            k = prng.fold_in(key, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(k)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[name] = statistics.median(walls[3:]) * 1e3
    return out


def call_activities(torch, m, a) -> dict:
    """Device activities of one call and their summed device ms, under
    the profiler over REPS calls: B1 on ``a`` and on its first chain, one
    exchange sweep and one snapshot as the engine runs them (the ``cuda``
    bundle, one lane)."""
    import numpy as np

    from kafka_assignment_optimizer_tpu_torch import prng
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import sweep

    sc, m1, st, best = engine_stages(m, a)
    a1 = a[:1].clone()[None]
    temps = [float(np.float32(0.5))]
    key = prng.PRNGKey(5)
    calls = {
        "B1 call": lambda: sc.full(m1, st[0]),
        "B1 call N=1": lambda: sc.full(m1, a1),
        "exchange sweep": lambda: sc.exch_step(m1, *st, [key], temps),
        "snapshot": lambda: sweep.snapshot_step(sc, m1, st[0], *best),
    }
    res = {}
    for name, fn in calls.items():
        events, _w = profiled(fn, torch, REPS)
        res[name] = {"activities": len(events) / REPS,
                     "device_ms": sum(us for _n, us in events) / REPS / 1e3}
    return res


def exchange_draws(key, N: int, P: int, device):
    """The random draws of one plain exchange proposal
    (``sweep.propose_exchange``): the words ``bits [N, P, 4]`` and the
    pairing."""
    from kafka_assignment_optimizer_tpu_torch import prng
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import sweep

    kd, kbits = prng.split(key)
    return (prng.bits(kbits, (N, P, 4), device),
            sweep._pair_partners(kd, N, P, device))


def adversarial_population(torch, dev, N: int = 8):
    """The adversarial scenario lowered to its bucket on ``dev``, and N
    chains of its greedy seed with one seeded random slot change per
    partition: ``(inst, m, seed [P, R] numpy, a [N, P, R])``."""
    import numpy as np

    from kafka_assignment_optimizer_tpu_torch.models.instance import (
        build_instance,
    )
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import (
        arrays,
        bucket,
    )
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu.seed import (
        greedy_seed,
    )
    from kafka_assignment_optimizer_tpu_torch.utils import gen

    scen = gen.adversarial()
    inst = build_instance(scen.current, scen.broker_list, scen.topology)
    Pp, Rp = bucket.bucket_shape(inst)
    m = arrays.from_instance(inst, dev, num_parts=Pp, max_rf=Rp)
    rng = np.random.default_rng(0)
    seed_np = arrays.pad_candidate(greedy_seed(inst), m)
    a_np = np.broadcast_to(seed_np, (N, Pp, Rp)).copy()
    sl = rng.integers(0, inst.max_rf, size=(N, inst.num_parts))
    bk = rng.integers(0, inst.num_brokers, size=(N, inst.num_parts))
    a_np[np.arange(N)[:, None], np.arange(inst.num_parts)[None, :], sl] = bk
    valid_np = np.asarray(m.slot_valid.cpu())
    a_np[~np.broadcast_to(valid_np, a_np.shape)] = inst.num_brokers
    return scen, inst, m, seed_np, torch.from_numpy(a_np).to(dev)


# the seven threefry words of one partition, as csrc/site.cu draws them
# (common.cuh's threefry_word, which csrc/exchange.cu draws too);
# compiled to a cubin and never launched: its SASS is counted
THREEFRY_PROBE = r"""
#include "site.cu"
__global__ void threefry_words(uint32_t k0, uint32_t k1, uint64_t i0,
                               uint32_t* out) {
  const uint64_t i = i0 + threadIdx.x;
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#pragma unroll
  for (int j = 0; j < 7; ++j)
    out[7 * threadIdx.x + j] = threefry_word(k0, k1, k2, i * 8 + j);
}
"""
# SASS that moves no data through the integer lanes: memory, control,
# constant and special-register loads, register moves
NOT_ALU = {"LDC", "LDG", "STG", "S2R", "CS2R", "EXIT", "BRA", "RET", "NOP",
           "MOV", "BAR"}


def sass_opcodes(kernels, binary: str, fn: str) -> list[tuple[str, str]]:
    """``(opcode, modifiers)`` of every SASS instruction of the functions
    whose name contains ``fn`` in ``binary`` (a cubin or a library), as
    ``cuobjdump`` from the toolkit beside nvcc lists them."""
    nvcc = kernels._nvcc()
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", binary],
        check=True, capture_output=True, text=True, timeout=300).stdout
    out, name = [], None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            continue
        hit = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)", line)
        if hit and name is not None and fn in name:
            out.append(hit.groups())
    return out


def alu_ops(opcodes) -> dict:
    """The vector ALU instructions among ``opcodes`` (no memory, control,
    constant or special-register loads, moves or uniform-datapath ones),
    by opcode."""
    ops: dict = {}
    for op, mods in opcodes:
        if not (op in NOT_ALU or op.startswith("U")
                or (op == "IMAD" and ".MOV" in mods)):
            ops[op] = ops.get(op, 0) + 1
    return ops


def threefry_ops(kernels) -> tuple[int, dict]:
    """Integer instructions a thread issues for its partition's seven
    threefry words: the vector ALU instructions in the SASS of
    ``THREEFRY_PROBE``, built with the kernels' nvcc flags. Returns
    ``(count, {opcode: count})``."""
    nvcc = kernels._nvcc()
    flags = [f for f in kernels.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "threefry_probe.cu")
        with open(src, "w") as f:
            f.write(THREEFRY_PROBE)
        cubin = os.path.join(tmp, "threefry_probe.cubin")
        subprocess.run([nvcc, *flags, "-cubin", "-I", str(kernels.CSRC),
                        "-o", cubin, src], check=True, capture_output=True,
                       timeout=300)
        ops = alu_ops(sass_opcodes(kernels, cubin, "threefry_words"))
    count = sum(ops.values())
    if count < 7 * 60:  # 20 rounds of add, rotate, xor a word at least
        fail(f"threefry SASS count {count} is below 7 x 60: parse failed "
             f"({ops})")
    return count, ops


def lane_equal(torch, ms, al, temp: float, label: str) -> tuple:
    """Hold the three lane launches on the chains ``al [L, N, P, R]`` of
    the stacked model ``ms`` to their lane plain versions and to L
    launches of the single-lane wrappers, bit for bit. Returns ``({kernel
    name: max_abs_err}, (cnt, lcnt, rcnt), keys, temps)``: the lanes'
    histograms, sweep keys and float32 temperatures (the shared
    temperature times each lane's scale)."""
    import numpy as np

    from kafka_assignment_optimizer_tpu_torch import prng
    from kafka_assignment_optimizer_tpu_torch.ops import exchange_cuda
    from kafka_assignment_optimizer_tpu_torch.ops import kernels
    from kafka_assignment_optimizer_tpu_torch.ops.score_cuda import (
        score,
        score_lanes,
        score_lanes_plain,
    )
    from kafka_assignment_optimizer_tpu_torch.ops.site_cuda import (
        site_step_cuda,
        site_step_lanes,
    )
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import (
        arrays,
        sweep,
    )

    L = al.shape[0]
    lanes = [arrays.lane_model(ms, i) for i in range(L)]
    _o, cnt, lcnt, rcnt = score_lanes_plain(ms, al)
    temps = [float(np.float32(temp) * np.float32(x))
             for x in ms.lane_scalars()[2]]
    keys = [prng.fold_in(prng.PRNGKey(11), i) for i in range(L)]

    def stack(outs):
        return tuple(torch.stack(x) for x in zip(*outs))

    def exch_flat(out):
        return (out[0], out[1], *out[2], out[3], out[4])

    errs = {}
    got = score_lanes(ms, al)
    errs[kernels.SCORE.name] = max(
        check_equal(f"B1 ({label}) vs plain", got,
                    score_lanes_plain(ms, al)),
        check_equal(f"B1 ({label}) vs {L} launches", got,
                    stack(score(lanes[i], al[i]) for i in range(L))))
    got = site_step_lanes(ms, al, cnt, lcnt, rcnt, keys, temps)
    errs[kernels.SITE.name] = max(
        check_equal(f"site sweep ({label}) vs plain", got,
                    sweep.site_lanes_delta(ms, al, cnt, lcnt, rcnt, keys,
                                           temps)),
        check_equal(f"site sweep ({label}) vs {L} launches", got,
                    stack(site_step_cuda(lanes[i], al[i], cnt[i], lcnt[i],
                                         rcnt[i], keys[i], temps[i])
                          for i in range(L))))
    got = exch_flat(exchange_cuda.exchange_sweep_lanes(ms, al, lcnt, keys,
                                                       temps))
    errs[kernels.EXCHANGE.name] = max(
        check_equal(f"exchange sweep ({label}) vs plain", got, stack(
            exch_flat(exchange_cuda._plain_sweep(
                lanes[i], al[i], lcnt[i], keys[i], temps[i]))
            for i in range(L))),
        check_equal(f"exchange sweep ({label}) vs {L} launches", got,
                    stack(exch_flat(exchange_cuda.exchange_sweep_cuda(
                        lanes[i], al[i], lcnt[i], keys[i], temps[i]))
                        for i in range(L))))
    torch.cuda.synchronize()
    changed = int((got[0] != al).any(-1).sum())
    print(f"  {label}: the three lane launches equal their plain versions "
          f"and {L} single-lane launches ({changed} chain-partitions "
          "changed by the exchange sweep)")
    return errs, (cnt, lcnt, rcnt), keys, temps


def lane_kernels(torch, dev, m, a, temp: float, int32_ops_per_s: float,
                 tf_ops: int, solo_device_us: dict) -> list[dict]:
    """The lane forms at the main path's shapes: L=8 lanes of the
    adversarial bucket on the eight ``PORTFOLIO_TABLE`` configs (the
    tables shared, lane stride 0), each lane its own chain order; then 3
    lanes of three instances whose tables and bands differ. Each lane
    launch must equal its lane plain version and L single-lane launches,
    and make one launch and no other device activity a call. Returns the
    ``kernels`` rows of the 8-lane launches (launches filled in later)."""
    import numpy as np

    from kafka_assignment_optimizer_tpu_torch import prng
    from kafka_assignment_optimizer_tpu_torch.models.instance import (
        build_instance,
    )
    from kafka_assignment_optimizer_tpu_torch.ops import exchange_cuda
    from kafka_assignment_optimizer_tpu_torch.ops import kernels
    from kafka_assignment_optimizer_tpu_torch.ops.score_cuda import (
        score_lanes,
        score_lanes_plain,
    )
    from kafka_assignment_optimizer_tpu_torch.ops.site_cuda import (
        site_step_lanes,
    )
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import (
        arrays,
        bucket,
        sweep,
    )
    from kafka_assignment_optimizer_tpu_torch.utils import gen

    L = 8
    N, P, R = a.shape
    B1 = m.num_brokers + 1
    ms = arrays.stack_models([arrays.with_config(m, c)
                              for c in arrays.portfolio_configs(L)])
    al = torch.stack([a.roll(i, 0) for i in range(L)])
    print(f"lane kernels (L={L} portfolio configs, N={N} P={P} R={R} "
          f"B+1={B1}):")
    errs, (cnt, lcnt, rcnt), keys, temps = lane_equal(
        torch, ms, al, temp, f"{L} portfolio lanes")
    lanes = [arrays.lane_model(ms, i) for i in range(L)]

    calls = {
        kernels.SCORE.name: (lambda: score_lanes(ms, al),
                             lambda: score_lanes_plain(ms, al)),
        kernels.SITE.name: (
            lambda: site_step_lanes(ms, al, cnt, lcnt, rcnt, keys, temps),
            lambda: sweep.site_lanes_delta(ms, al, cnt, lcnt, rcnt, keys,
                                           temps)),
        kernels.EXCHANGE.name: (
            lambda: exchange_cuda.exchange_step_lanes(
                ms, al, cnt, lcnt, rcnt, keys, temps),
            lambda: sweep.exchange_lanes_delta(ms, al, cnt, lcnt, rcnt,
                                               keys, temps)),
    }
    for k in kernels.KERNELS:
        one_launch(f"an {L}-lane {k.name}", calls[k.name][0], k,
                   KERNEL_FUNCS[k.name][0], torch)

    # the bounds at L=8: each input once (the shared tables once), the
    # distinct weight and a0 entries every lane reads (one table, so
    # the lanes' reads overlap), each output once; the operations as in
    # the single-lane rows, summed over the lanes
    flat = torch.where(m.slot_valid[None, None], al, m.num_brokers)
    b1_reads = [(t, al[i, :, :, r], m.slot_valid[None, :, r])
                for i in range(L) for t, r in
                [(0, r) for r in range(R)] + [(1, r) for r in range(1, R)]]
    b1_bytes = (nbytes(al, m.slot_valid, m.part_rack_hi, m.rack_of,
                       m.rack_lo, m.rack_hi)
                + gathered(B1, *b1_reads)
                + nbytes(*score_lanes(ms, al)))
    a0_keys, site_reads, real = [], [], 0
    for i in range(L):
        bits = prng.bits(keys[i], (N, P, 8), dev)
        pp = sweep.propose_site(lanes[i], al[i], bits, temps[i],
                                hists=sweep._carried(cnt[i], lcnt[i],
                                                     rcnt[i]))
        s_orig = sweep._rand_idx(arrays.u01(bits[..., 3]), R)
        a0_keys.append((torch.arange(P, device=dev)[None] * R
                        + s_orig).reshape(-1))
        in_row = ((al[i] == pp.b_new[..., None])
                  & m.slot_valid[None]).any(-1)
        legal = torch.where(pp.is_lsw, m.rf > 1, ~in_row) & (m.rf > 0)
        rep_, lsw = legal & ~pp.is_lsw, legal & pp.is_lsw
        tbl = (pp.s != 0).to(torch.int64)
        site_reads += [(tbl, pp.b_new, rep_), (tbl, pp.b_at_s, rep_),
                       (0, pp.b_lead, lsw), (1, pp.b_lead, lsw),
                       (0, pp.b_at_s, lsw), (1, pp.b_at_s, lsw)]
        real += N * int((m.rf > 0).sum())
    site_bytes = (nbytes(al, m.rf, m.slot_valid, m.part_rack_hi, m.rack_of,
                         m.rack_lo, m.rack_hi, cnt, lcnt, rcnt)
                  + int(torch.unique(torch.cat(a0_keys)).numel()) * 4
                  + gathered(B1, *site_reads)
                  + nbytes(*calls[kernels.SITE.name][0]()))
    ex = exchange_cuda.exchange_sweep_lanes(ms, al, lcnt, keys, temps)
    s_own, b_other, acc = ex[2][0], ex[2][1], ex[2][4] > 0
    b_own = al.gather(3, s_own.clamp(min=0)[..., None].long())[..., 0]
    tbl = (s_own != 0).to(torch.int64)
    ex_reads = [(tbl[i], b_other[i], acc[i]) for i in range(L)] + [
        (tbl[i], b_own[i], acc[i]) for i in range(L)]
    ex_bytes = (nbytes(al, m.rf, m.slot_valid, m.part_rack_hi, m.rack_of,
                       lcnt)
                + gathered(B1, *ex_reads) + nbytes(ex[0], ex[1]))
    n_words = real + int(acc.sum()) // 2 + 2 * N * L
    bounds = {
        kernels.SCORE.name: (b1_bytes, L * N * P * R * (12 + 2 * R), 0),
        kernels.SITE.name: (site_bytes, real * tf_ops, real * 9),
        kernels.EXCHANGE.name: (ex_bytes, round(n_words * tf_ops / 7),
                                n_words),
    }
    # the library yardsticks: the replica histogram of every lane in one
    # torch.bincount; the exchange maps of every lane in one
    # scatter_reduce_
    keys_b = (torch.arange(L * N, device=dev).reshape(L, N, 1, 1) * B1
              + flat).reshape(-1)
    idx = torch.cat([ex[2][2], ex[2][3] + B1], -1).reshape(L * N, -1).long()
    src = torch.cat([ex[2][4], ex[2][4]], -1).reshape(L * N, -1)
    maps = torch.zeros(L * N, 2 * B1, dtype=torch.float32, device=dev)
    library = {
        kernels.SCORE.name: timed(
            lambda: torch.bincount(keys_b, minlength=L * N * B1), torch),
        kernels.SITE.name: None,
        kernels.EXCHANGE.name: timed(
            lambda: maps.scatter_reduce_(1, idx, src, "amax"), torch),
    }
    rows = []
    for k in kernels.KERNELS:
        call, plain = calls[k.name]
        events, _w = profiled(call, torch, REPS)
        mine = [us for name, us in events if KERNEL_FUNCS[k.name][0] in name]
        dev_ms = sum(mine) / REPS / 1e3 if len(mine) == REPS else None
        bytes_, int_ops, fp_ops = bounds[k.name]
        t_bytes = bytes_ / HBM_BYTES_PER_S
        t_ops = max(int_ops / int32_ops_per_s, fp_ops / FP32_OPS_PER_S)
        bound_ms = max(t_bytes, t_ops) * 1e3
        ms_ = timed(call, torch)
        plain_ms = timed(plain, torch, reps=2, windows=3)
        solo = solo_device_us.get(k.name)
        rows.append({
            "name": f"{k.name} ({L} lanes)", "route": "cuda",
            "source": f"kafka_assignment_optimizer_tpu_torch/csrc/"
                      f"{k.source}.cu",
            "replaces": " + ".join(r.split(" ")[0] for r in k.replaces),
            "launches": 0, "max_abs_err": errs[k.name], "ms": ms_,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library[k.name],
        })
        print(f"  {k.name} at L={L}: exact; wrapper {ms_:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bytes_} bytes, "
              f"{int_ops} INT32 ops), library "
              + ("n/a" if library[k.name] is None
                 else f"{library[k.name]:.4f} ms")
              + ", device (profiler) L=8 "
              + ("not measured" if dev_ms is None else f"{dev_ms:.5f} ms")
              + ", L=1 "
              + ("not measured" if solo is None else f"{solo / 1e3:.5f} ms"))

    # the stages with no kernel, run lane by lane: the compound sweep and
    # the snapshot (one B1 for every lane, then each lane's bookkeeping
    # and migration)
    sc = sweep._make_lane_scorer("cuda")
    out = sc.full(ms, al)
    best = (sweep.best_key(out[0][..., 0],
                           out[0][..., 1:5].sum(-1, dtype=torch.int32)),
            out[0][..., 5], al.clone())
    comp_ms = timed(lambda: sc.comp_step(ms, al, cnt, lcnt, rcnt, keys,
                                         temps), torch, reps=2, windows=3)
    snap_ms = timed(lambda: sweep.snapshot_step(sc, ms, al, *best),
                    torch, reps=2, windows=3)
    print(f"  L={L} stages without a kernel (lane by lane, CUDA events): "
          f"compound sweep {comp_ms:.4f} ms, snapshot {snap_ms:.4f} ms")

    # three lanes whose tables and bands differ: three adversarial
    # instances of one bucket with 10,000, 9,800 and 9,600 partitions
    ms3, pops = [], []
    for i, ppt in enumerate((100, 98, 96)):
        scen = gen.adversarial(parts_per_topic=ppt, seed=i)
        inst = build_instance(scen.current, scen.broker_list, scen.topology)
        if bucket.bucket_shape(inst) != (P, R):
            fail(f"lane batch: instance {i} has bucket "
                 f"{bucket.bucket_shape(inst)}, expected {(P, R)}")
        mi = arrays.from_instance(inst, dev, num_parts=P, max_rf=R)
        ms3.append(mi)
        pops.append(torch.where(mi.slot_valid[None], a.roll(i, 0),
                                mi.num_brokers))
    ms3 = arrays.stack_models(ms3)
    if len(set(ms3.lane_scalars()[0])) < 2:
        fail("lane batch: the three instances' bands do not differ")
    lane_equal(torch, ms3, torch.stack(pops), temp,
               "3 lanes of three instances")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from kafka_assignment_optimizer_tpu_torch import optimize, prng
    from kafka_assignment_optimizer_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. header ------------------------------------------------------
    int32_ops_per_s = header(torch)

    from kafka_assignment_optimizer_tpu_torch.models.instance import (
        build_instance,
    )
    from kafka_assignment_optimizer_tpu_torch.ops.exchange_cuda import (
        exchange_sweep_cuda,
    )
    from kafka_assignment_optimizer_tpu_torch.ops.score import moves_batch
    from kafka_assignment_optimizer_tpu_torch.ops.score_cuda import (
        score,
        score_plain,
    )
    from kafka_assignment_optimizer_tpu_torch.ops.site_cuda import (
        site_step_cuda,
    )
    from kafka_assignment_optimizer_tpu_torch.parallel.mesh import (
        init_sweep_state,
    )
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import (
        arrays,
        sweep,
    )
    from kafka_assignment_optimizer_tpu_torch.utils import gen

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build_all()
    for src in kernels.SOURCES:
        kernels.library(src)
    nvcc_version = subprocess.run(
        [kernels._nvcc(), "--version"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[-1]
    print(f"build: {len(kernels.SOURCES)} sources in "
          f"{time.perf_counter() - t0:.3f} s ({nvcc_version})")

    # ---- 3. kernel check at the main path's shapes -----------------------
    N = 8
    scen, inst, m, seed_np, a = adversarial_population(torch, dev, N)
    Pp, Rp = m.a0.shape
    B1, K1 = m.num_brokers + 1, m.rack_lo.shape[0]
    _f, _r, cnt, lcnt, rcnt = sweep.histograms(m, a)
    temp = float(np.float32(0.5))
    print(f"kernel shapes: N={N} P={Pp} (instance {inst.num_parts}) "
          f"R={Rp} B+1={B1} K+1={K1}")

    rows = []
    device_us = {}

    def report(k, ok_outs, ms, plain_ms, bytes_, int_ops, fp_ops,
               library_ms, call):
        events, _wall = profiled(call, torch, REPS)
        mine = [us for name, us in events
                if any(f in name for f in KERNEL_FUNCS[k.name])]
        # a device time only where the profiler saw every launch
        device_us[k.name] = (sum(mine) / REPS if len(mine)
                             == REPS * len(KERNEL_FUNCS[k.name]) else None)
        t_bytes = bytes_ / HBM_BYTES_PER_S
        t_ops = max(int_ops / int32_ops_per_s, fp_ops / FP32_OPS_PER_S)
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        rows.append({
            "name": k.name, "route": "cuda",
            "source": f"kafka_assignment_optimizer_tpu_torch/csrc/"
                      f"{k.source}.cu",
            "replaces": " + ".join(r.split(" ")[0] for r in k.replaces),
            "launches": 0, "max_abs_err": ok_outs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
        })
        print(f"  {k.name}: exact (max_abs_err {ok_outs}); kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {bytes_} bytes, {int_ops} INT32 ops, {fp_ops} "
              "FP32 ops), library "
              f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}, "
              "device (profiler) "
              + ("not measured" if device_us[k.name] is None
                 else f"{device_us[k.name] / 1e3:.4f} ms"))

    NP = N * Pp
    print("kernel check:")
    # B1 — score, with the move count in out[:, 5]; one launch a call
    kout = score(m, a)
    pout = score_plain(m, a)
    torch.cuda.synchronize()
    err = check_equal("B1", kout, pout)
    if not torch.equal(kout[0][:, 5], moves_batch(a, m)):
        fail("B1: out[:, 5] differs from moves_batch")
    one_launch("B1", lambda: score(m, a), kernels.SCORE, "score_grid", torch)
    # what a snapshot ran beside B1 before the count was folded in
    ev_mv, _w = profiled(lambda: moves_batch(a, m), torch, REPS)
    print(f"  (moves_batch, no longer on the cuda path: "
          f"{len(ev_mv) // REPS} device activities, "
          f"{sum(us for _n, us in ev_mv) / REPS / 1e3:.5f} ms of device time "
          "a call)")
    # the verification call: one chain
    a1 = a[:1].clone()
    err = max(err, check_equal("B1 (N=1)", score(m, a1), score_plain(m, a1)))
    ev1, _w = profiled(lambda: score(m, a1), torch, REPS)
    dev1 = [us for n, us in ev1 if "score_grid" in n]
    print(f"  (B1: one device activity a call; moves {kout[0][:, 5].tolist()}"
          f"; at N=1 kernel {timed(lambda: score(m, a1), torch):.4f} ms, "
          "device (profiler) "
          + (f"{sum(dev1) / REPS / 1e3:.5f} ms)" if len(dev1) == REPS
             else "not measured)"))
    flat = torch.where(m.slot_valid[None], a, m.num_brokers)
    keys_b = (torch.arange(N, device=dev)[:, None, None] * B1
              + flat).reshape(-1)
    lib = timed(lambda: torch.bincount(keys_b, minlength=N * B1), torch)
    # the bytes: each input once, the distinct weight entries the valid
    # slots read (w_lead at every valid slot for the moves, w_foll at the
    # followers), each output once
    b1_bytes = (nbytes(a, m.slot_valid, m.part_rack_hi, m.rack_of,
                       m.rack_lo, m.rack_hi)
                + gathered(B1, *((0, a[:, :, r], m.slot_valid[None, :, r])
                                 for r in range(Rp)),
                           *((1, a[:, :, r], m.slot_valid[None, :, r])
                             for r in range(1, Rp)))
                + nbytes(*kout))
    report(kernels.SCORE, err, timed(lambda: score(m, a), torch),
           timed(lambda: score_plain(m, a), torch), b1_bytes,
           NP * Rp * (12 + 2 * Rp), 0, lib, lambda: score(m, a))

    # B2+B3 — the fused site sweep, at two temperatures, against the
    # plain site sweep
    key = prng.PRNGKey(1)
    err = 0.0
    for t in (temp, float(np.float32(0.02))):
        ref = sweep._site_sweep_delta(m, a, cnt, lcnt, rcnt, key, t)
        got = site_step_cuda(m, a, cnt, lcnt, rcnt, key, t)
        torch.cuda.synchronize()
        err = max(err, check_equal(f"B2+B3 (temp {t})", got, ref))
        print(f"  (site sweep at temp {t:.4g}: "
              f"{int((ref[0] != a).any(-1).sum())} partitions changed)")
    one_launch("site_step_cuda",
               lambda: site_step_cuda(m, a, cnt, lcnt, rcnt, key, temp),
               kernels.SITE, "site_sweep", torch)
    # the bytes: each input once, the distinct a0 entries and weights the
    # proposals read (a replace its slot's table at the old and new
    # broker, a leader swap both tables at both brokers, legal proposals
    # only), each output once; no random words and no records
    bits = prng.bits(key, (N, Pp, 8), dev)
    pp = sweep.propose_site(m, a, bits, temp,
                            hists=sweep._carried(cnt, lcnt, rcnt))
    s_orig = sweep._rand_idx(arrays.u01(bits[..., 3]), Rp)
    a0_read = int(torch.unique(torch.arange(Pp, device=dev)[None] * Rp
                               + s_orig).numel()) * 4
    in_row = ((a == pp.b_new[..., None]) & m.slot_valid[None]).any(-1)
    legal = torch.where(pp.is_lsw, m.rf > 1, ~in_row) & (m.rf > 0)
    rep_, lsw = legal & ~pp.is_lsw, legal & pp.is_lsw
    tbl = (pp.s != 0).to(torch.int64)
    site_out = site_step_cuda(m, a, cnt, lcnt, rcnt, key, temp)
    site_bytes = (nbytes(a, m.rf, m.slot_valid, m.part_rack_hi, m.rack_of,
                         m.rack_lo, m.rack_hi, cnt, lcnt, rcnt)
                  + a0_read
                  + gathered(B1, (tbl, pp.b_new, rep_),
                             (tbl, pp.b_at_s, rep_),
                             (0, pp.b_lead, lsw), (1, pp.b_lead, lsw),
                             (0, pp.b_at_s, lsw), (1, pp.b_at_s, lsw))
                  + nbytes(*site_out))
    # the operations: the seven threefry words of each partition that has
    # replicas, counted in the SASS; the rest of the proposal is not
    # counted, so the bound is below the least time. The float work: the
    # scale multiply of each of the 7 uniforms, the delta's multiply and
    # subtract
    tf_ops, tf_hist = threefry_ops(kernels)
    real = N * int((m.rf > 0).sum())
    print(f"  (threefry: {tf_ops} integer instructions for 7 words in the "
          f"SASS: {json.dumps(tf_hist, sort_keys=True)})")
    site_int = real * tf_ops
    report(kernels.SITE, err,
           timed(lambda: site_step_cuda(m, a, cnt, lcnt, rcnt, key, temp),
                 torch),
           timed(lambda: sweep._site_sweep_delta(m, a, cnt, lcnt, rcnt, key,
                                                 temp), torch),
           site_bytes, site_int, real * 9, None,
           lambda: site_step_cuda(m, a, cnt, lcnt, rcnt, key, temp))

    # B4+B5+B6 — the fused exchange sweep, at two temperatures: its
    # records and maps against the plain proposal, its a_new and lcnt'
    # against the plain finish fed with the kernel's own records and
    # against the plain sweep
    key = prng.PRNGKey(2)

    def exch(t):
        a2, l2, rec, m_out, m_in = exchange_sweep_cuda(m, a, lcnt, key, t)
        return (a2, l2, *rec, m_out, m_in)

    def exch_plain(t):
        pr, m_out, m_in = sweep.exchange_propose(m, a, lcnt, key, t)
        rec = (pr.s, pr.b_other, pr.tok_out, pr.tok_in, pr.prio)
        a2, d_lcnt = sweep.exch_finish(a, *rec, m_out, m_in)
        return (a2, lcnt + d_lcnt, *rec, m_out, m_in)

    err = 0.0
    for t in (temp, float(np.float32(0.02))):
        ref = exch_plain(t)
        got = exch(t)
        torch.cuda.synchronize()
        err = max(err, check_equal(f"B4+B5+B6 (temp {t})", got, ref))
        fin = sweep.exch_finish(a, *got[2:])
        err = max(err, check_equal(f"B6 phase (temp {t})", got[:2],
                                   (fin[0], lcnt + fin[1])))
        whole = sweep._exchange_sweep_delta(m, a, cnt, lcnt, rcnt, key, t)
        check_equal(f"exchange sweep (temp {t})", got[:2],
                    (whole[0], whole[2]))
        print(f"  (exchange sweep at temp {t:.4g}: "
              f"{int((ref[6] > 0).sum())} accepted halves, "
              f"{int((ref[4] != B1 - 1).sum())} moving leadership, "
              f"{int((ref[0] != a).any(-1).sum())} partitions changed)")
    got = exch(temp)
    ref = exch_plain(temp)
    sc, m1, st, _best = engine_stages(m, a)
    # one exchange sweep as the engine runs it: no prng draw on the
    # device, and exactly one device activity, the fused launch
    drawn = []

    def spy(fn, at: int):  # ``at``: the position of fn's device argument
        def call(*args, **kw):
            if kw.get("device", args[at] if len(args) > at else None) \
                    is not None:
                drawn.append(fn.__name__)
            return fn(*args, **kw)
        return call

    bits_fn, randint_fn = prng.bits, prng.randint
    prng.bits, prng.randint = spy(bits_fn, 2), spy(randint_fn, 4)
    try:
        sc.exch_step(m1, *st, [key], [temp])
    finally:
        prng.bits, prng.randint = bits_fn, randint_fn
    if drawn:
        fail(f"one exchange sweep drew {drawn} on the device")
    names = one_launch(
        "an exchange sweep",
        lambda: sc.exch_step(m1, *st, [key], [temp]),
        kernels.EXCHANGE, "exchange_sweep", torch)
    print(f"  (one exchange sweep as the engine runs it: one device "
          f"activity, no prng draw on the device: {names})")
    # the library yardstick of the maps: one scatter_reduce_ amax over
    # both token sets side by side
    idx = torch.cat([ref[4], ref[5] + B1], 1).long()
    src = torch.cat([ref[6], ref[6]], 1)
    lib_maps = torch.zeros(N, 2 * B1, dtype=torch.float32, device=dev)
    lib_maps.scatter_reduce_(1, idx, src, "amax")
    if not torch.equal(lib_maps, torch.cat([ref[7], ref[8]], 1)):
        fail("the scatter_reduce_ yardstick disagrees with the maps")
    lib = timed(lambda: lib_maps.scatter_reduce_(1, idx, src, "amax"), torch)
    # counted from the records: the bytes are each input once, the
    # weights an accepted pair's sides read (its slot's table at the
    # broker it gives and at the one it takes), each output once (a_new
    # and lcnt'; the records and the maps are the kernel's scratch, written
    # in phase 1 and read back in phase 2, a cost of its design and not of
    # the function). The operations are threefry words
    # at the SASS count of one word: a slot word for each partition that
    # has replicas, a priority word for each accepted pair, two a chain
    # for the phase; the float work is the scale multiply of each word's
    # uniform. Left out, so that the bound stays below the least time: the
    # weights of rejected legal pairs, the Metropolis words, the slot
    # words of wrapped partners
    s_own, b_other, acc = got[2], got[3], got[6] > 0
    b_own = a.gather(2, s_own.clamp(min=0)[..., None].long())[..., 0]
    tbl = (s_own != 0).to(torch.int64)
    ex_bytes = (nbytes(a, m.rf, m.slot_valid, m.part_rack_hi, m.rack_of,
                       lcnt)
                + gathered(B1, (tbl, b_other, acc), (tbl, b_own, acc))
                + nbytes(*got[:2]))
    n_words = real + int(acc.sum()) // 2 + 2 * N
    print(f"  (exchange: at least {n_words} threefry words, "
          f"{tf_ops / 7:.4g} integer instructions a word)")
    report(kernels.EXCHANGE, err, timed(lambda: exch(temp), torch),
           timed(lambda: exch_plain(temp), torch), ex_bytes,
           round(n_words * tf_ops / 7), n_words, lib,
           lambda: exch(temp))

    # ---- 3b. the lane forms ----------------------------------------------
    lane_rows = lane_kernels(torch, dev, m, a, temp, int32_ops_per_s, tf_ops,
                             device_us)

    # ---- 4. sweep times --------------------------------------------------
    print("sweep times (cuda bundle, one lane, median wall ms, "
          "synchronized): "
          + json.dumps(sweep_times(torch, m, a)))
    print("device activities a call (cuda bundle, one lane, profiler): "
          + json.dumps(call_activities(torch, m, a)))

    # ---- 5. trajectory check: cuda bundle vs torch bundle ---------------
    seed_t = torch.from_numpy(seed_np).to(dev)
    temps = arrays.geometric_temps(2.0, 0.02, 16)
    trajectories = {}
    for scorer in ("cuda", "torch"):
        step = sweep.make_sweep_stepper_fn(N, scorer=scorer)
        st = init_sweep_state(m, seed_t, prng.PRNGKey(0), N)
        seq = []
        t0 = time.perf_counter()
        for c in (temps[:8], temps[8:]):
            st, top_a, top_k, curve = step(m, st, c)
            seq.append([x.clone() if torch.is_tensor(x) else x.copy()
                        for x in st] + [top_a, top_k, curve])
        torch.cuda.synchronize()
        trajectories[scorer] = (seq, time.perf_counter() - t0)
    for i, (xs, ys) in enumerate(zip(trajectories["cuda"][0],
                                     trajectories["torch"][0])):
        if not np.array_equal(xs[4], ys[4]):
            fail(f"trajectory chunk {i}: RNG keys differ")
        for j, (x, y) in enumerate(zip(xs[:4] + xs[5:], ys[:4] + ys[5:])):
            if not torch.equal(x, y):
                fail(f"trajectory chunk {i}: state leaf {j} differs between "
                     "the cuda and torch bundles")
    step = sweep.make_sweep_stepper_fn(N, scorer="cuda")
    st = init_sweep_state(m, seed_t, prng.PRNGKey(0), N)
    events, wall = profiled(lambda: step(m, st, temps), torch)
    busy_s = sum(us for _n, us in events) / 1e6
    ours = sum(us for n, us in events
               if any(f in n for fs in KERNEL_FUNCS.values() for f in fs))
    print("ladder (cuda bundle, 16 sweeps, one chunk, profiled): wall "
          f"{wall:.4f} s, device busy {busy_s:.4f} s "
          f"({busy_s / wall:.3f} of wall; kernels {ours / 1e6:.4f} s, "
          f"{len(events)} device activities)" if events else
          "ladder device busy share: not measured (no device activity "
          "seen by the profiler)")
    moved = int((trajectories["cuda"][0][-1][0] != seed_t).any(-1).sum())
    print(f"trajectory: 2 chunks x 8 sweeps equal in both bundles "
          f"(cuda {trajectories['cuda'][1]:.3f} s, torch "
          f"{trajectories['torch'][1]:.3f} s wall; {moved} "
          "chain-partitions off the seed)")

    # ---- 6. main path ---------------------------------------------------
    # (a) defaulted solves take the reference's decisions: the host
    # constructor race certifies both, and no kernel is launched
    power = smi("name,power.limit") or torch.cuda.get_device_name(0)
    demo = gen.demo()
    for label, kw in (("demo", {"solver": "tpu"}),
                      ("demo auto", {"solver": "auto"})):
        kernels.reset_counts()
        t0 = time.perf_counter()
        res = optimize(demo.current, demo.broker_list, demo.topology, **kw)
        wall = time.perf_counter() - t0
        rep = res.report()
        expect = {"solver": "tpu", "solver_engine": "construct",
                  "solver_construct_path": "milp"} if label == "demo" \
            else {"solver": "milp"}
        got = {k: rep.get(k) for k in expect}
        if got != expect or not rep["feasible"] or not \
                rep["proven_optimal"] or res.replica_moves != 1:
            fail(f"{label}: expected {expect}, 1 move, proven; got {rep}")
        print(f"{label}: {got}, 1 move, proven optimal, weight "
              f"{res.solve.objective}, wall {wall:.3f} s, launches "
              f"{sum(k.launches for k in kernels.KERNELS)} ({power})")
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = optimize(scen.current, scen.broker_list, scen.topology,
                   solver="tpu")
    wall = time.perf_counter() - t0
    st = res.solve.stats
    got = (st["engine"], st.get("construct_path"), res.replica_moves,
           res.solve.objective, res.solve.optimal)
    if got != ("construct", "reseat", 117, 59_802, True):
        fail(f"adversarial at defaults: expected the certified reseat "
             f"plan (construct, reseat, 117, 59802, True), got {got}")
    print(f"adversarial at defaults: construct/reseat, 117 moves, weight "
          f"59802, proven optimal, platform {st['platform']}, wall "
          f"{wall:.3f} s (race {st['race_s']} s), launches "
          f"{sum(k.launches for k in kernels.KERNELS)} ({power})")

    # (b) the annealer pinned by its knobs (setting them turns the reseat
    # race off, as in the reference) with the portfolio off: the solo
    # anchor, 8 chains x 128 sweeps on the card, every kernel, then
    # certify-first selection. The boundary certificate is off (it would
    # end the ladder at its first boundary wherever a chunk takes over
    # cert_min_savings_s, as on a CPU), so the path does not depend on the
    # card's speed
    pinned = dict(solver="tpu", batch=8, rounds=128,
                  cert_min_savings_s=float("inf"))
    phase_keys = ("build_s", "race_s", "seed_s", "lower_s", "anneal_s",
                  "select_s", "polish_s", "verify_s")

    def adversarial_solve(label, portfolio):
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = optimize(scen.current, scen.broker_list, scen.topology,
                       portfolio=portfolio, **pinned)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.name: k.launches for k in kernels.KERNELS}
        rep = res.report()
        st = res.solve.stats
        if not rep["feasible"]:
            fail(f"{label}: infeasible plan ({rep['violations']})")
        if (st["engine"], st["chains_per_device"], st["rounds_run"]) != (
                "sweep", 8, 128):
            fail(f"{label}: ran {st['engine']} {st['chains_per_device']} "
                 f"chains x {st['rounds_run']} sweeps, expected sweep 8 x "
                 "128")
        for name, n in counts.items():
            if n <= 0:
                fail(f"{label}: {name} was not launched on the main path")
        # one launch a site sweep (sweeps 0, 2, 4, ...) and an exchange
        # sweep (sweeps 1, 5, 9, ...), for every lane at once
        n_site, n_exch = st["rounds"] // 2, st["rounds"] // 4
        if (counts[kernels.SITE.name], counts[kernels.EXCHANGE.name]) != (
                n_site, n_exch):
            fail(f"{label}: site / exchange kernel launched "
                 f"{counts[kernels.SITE.name]} / "
                 f"{counts[kernels.EXCHANGE.name]} times, expected one a "
                 f"sweep ({n_site} / {n_exch})")
        if st.get("final_cert") not in ("ok", "ok_reseat"):
            fail(f"{label}: final_cert {st.get('final_cert')!r}, expected "
                 "a certificate at final selection")
        # the JAX package's plan for this call (its CPU run on one device,
        # either setting: 117 moves, weight 59,802, proven)
        if (res.replica_moves, res.solve.objective, res.solve.optimal) != (
                117, 59_802, True):
            fail(f"{label}: {res.replica_moves} moves, weight "
                 f"{res.solve.objective}, proven {res.solve.optimal}; "
                 "expected 117, 59802, proven")
        print(f"{label} (batch=8, rounds=128): feasible, "
              f"{res.replica_moves} moves (lower bound {st['moves_lb']}, "
              f"seed {st['seed_moves']}), weight {res.solve.objective} "
              f"(bound {st['weight_ub']}), final_cert {st['final_cert']}, "
              f"proven optimal, {st['chains_per_device']} chains x "
              f"{st['rounds_run']} sweeps, wall {wall:.3f} s ({power})")
        print(f"{label} phases (s): "
              + json.dumps({k: st[k] for k in phase_keys}))
        print(f"{label} launches: " + json.dumps(counts))
        return res, counts, wall

    _res, counts, wall_solo = adversarial_solve("adversarial pinned solo",
                                                False)
    if "portfolio" in _res.solve.stats:
        fail("adversarial pinned solo: ran the portfolio")
    for row in rows:
        row["launches"] = counts[row["name"]]

    # (c) the same call with the portfolio at its default: the eight
    # PORTFOLIO_TABLE configs as eight lanes, one launch of each kernel a
    # sweep for all of them; the plan the JAX package gives for it
    res, port_counts, wall_port = adversarial_solve(
        "adversarial portfolio", None)
    p = res.solve.stats.get("portfolio") or {}
    if (p.get("width"), p.get("lane_bucket")) != (8, 8):
        fail(f"adversarial portfolio: stats {p}, expected width 8 and "
             "lane_bucket 8")
    if port_counts[kernels.SCORE.name] > counts[kernels.SCORE.name]:
        fail(f"adversarial portfolio: B1 launched "
             f"{port_counts[kernels.SCORE.name]} times, more than the solo "
             f"solve's {counts[kernels.SCORE.name]}")
    print(f"adversarial portfolio: winner lane {p['winner_lane']} "
          f"{json.dumps(p['winner_config'])}; wall {wall_port:.3f} s "
          f"against the solo {wall_solo:.3f} s ({power})")
    for row in lane_rows:
        row["launches"] = port_counts[row["name"].split(" (")[0]]

    # (d) messy_case(1) (seed=1, engine="sweep", batch=8, rounds=32): the
    # portfolio's plan and the solo plan differ (here both feasible; the
    # JAX package on one device gives weights 18 and 17), and each equals
    # the port's plain path on the CPU, computed here
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu.engine import (
        solve_tpu,
        solve_tpu_batch,
    )

    current, brokers, topo, target_rf = gen.messy_case(1)
    messy = {}
    for portfolio in (None, False):
        for device in ("cuda", "cpu"):
            inst = build_instance(current, brokers, topo, target_rf)
            inst.move_lower_bound_exact()
            inst.weight_upper_bound()
            r = solve_tpu(inst, seed=1, engine="sweep", batch=8, rounds=32,
                          portfolio=portfolio, device=device,
                          cert_min_savings_s=float("inf"))
            messy[portfolio, device] = r
        card, cpu = messy[portfolio, "cuda"], messy[portfolio, "cpu"]
        if not np.array_equal(card.a, cpu.a):
            fail(f"messy_case(1) portfolio={portfolio}: the card's plan "
                 "differs from the CPU's")
    port, solo = messy[None, "cuda"], messy[False, "cuda"]
    if not port.stats["feasible"] or (port.objective, solo.objective) != (
            18, 17):
        fail(f"messy_case(1): portfolio feasible {port.stats['feasible']} "
             f"weight {port.objective}, solo weight {solo.objective}; "
             "expected a feasible portfolio plan of weight 18 and a solo "
             "plan of 17")
    print(f"messy_case(1): portfolio feasible, {port.stats['moves']} moves, "
          f"weight {port.objective} (winner lane "
          f"{port.stats['portfolio']['winner_lane']}); solo feasible "
          f"{solo.stats['feasible']}, weight {solo.objective}; both equal "
          "to the CPU's plans")

    # (e) the batch path: 8 full-size adversarial instances (seeds 0-7:
    # 256 brokers, 10,000 partitions each, one 10,240 x 4 bucket) through
    # optimize_batch at its defaults, every lane feasible and verified;
    # lanes 0 and 7 each equal a one-instance solve_tpu_batch
    from kafka_assignment_optimizer_tpu_torch import optimize_batch

    t0 = time.perf_counter()
    scens = [gen.adversarial(seed=i) for i in range(8)]
    insts = [build_instance(x.current, x.broker_list, x.topology)
             for x in scens]
    build_s = time.perf_counter() - t0
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = optimize_batch([x.current for x in scens], insts)
    torch.cuda.synchronize()
    batch_wall = time.perf_counter() - t0
    batch_counts = {k.name: k.launches for k in kernels.KERNELS}
    for i, r in enumerate(out):
        st = r.solve.stats
        if not r.report()["feasible"] or (st["lanes"], st["lane"],
                                          st["lane_bucket"]) != (8, i, 8):
            fail(f"batch lane {i}: feasible {r.report()['feasible']}, "
                 f"lanes {st['lanes']} lane {st['lane']} bucket "
                 f"{st['lane_bucket']}")
    for i in (0, 7):
        one = solve_tpu_batch([insts[i]], seeds=i)[0]
        if not np.array_equal(one.a, out[i].solve.a):
            fail(f"batch lane {i} differs from its one-instance batch")
    st = out[0].solve.stats
    print(f"batch: 8 adversarial instances (seeds 0-7), {st['engine']} "
          f"{st['chains_per_device']} chains x {st['rounds_run']} sweeps, "
          f"every lane feasible and verified, moves "
          f"{[r.replica_moves for r in out]}; wall {batch_wall:.3f} s "
          f"({8 / batch_wall:.3f} instances/s; building the instances "
          f"{build_s:.3f} s more), launches {json.dumps(batch_counts)}; "
          f"lanes 0 and 7 equal their one-instance batches ({power})")
    # the lane padding: 3 of the instances padded up the lane ladder to 8
    # lanes (the default) and run at 3 lanes (KAO_LANE_BUCKETS=off), in
    # the order padded, unpadded, unpadded, padded; the real lanes' plans
    # are equal either way
    walls = {"8": [], "off": []}
    plans = {}
    saved = os.environ.get("KAO_LANE_BUCKETS")
    try:
        for env in ("8", "off", "off", "8"):
            if env == "off":
                os.environ["KAO_LANE_BUCKETS"] = "off"
            else:
                os.environ.pop("KAO_LANE_BUCKETS", None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = solve_tpu_batch(insts[:3], seeds=0)
            torch.cuda.synchronize()
            walls[env].append(time.perf_counter() - t0)
            if got[0].stats["lane_bucket"] != (8 if env == "8" else 3):
                fail(f"lane padding {env}: lane_bucket "
                     f"{got[0].stats['lane_bucket']}")
            plans.setdefault(env, [r.a for r in got])
    finally:
        if saved is None:
            os.environ.pop("KAO_LANE_BUCKETS", None)
        else:
            os.environ["KAO_LANE_BUCKETS"] = saved
    if not all(np.array_equal(x, y) for x, y in zip(plans["8"],
                                                     plans["off"])):
        fail("lane padding: 3 instances at 8 lanes and at 3 lanes give "
             "different plans")
    print(f"batch of 3 (seeds 0-2): padded to 8 lanes wall "
          f"{walls['8'][0]:.3f} / {walls['8'][1]:.3f} s, at 3 lanes "
          f"{walls['off'][0]:.3f} / {walls['off'][1]:.3f} s, plans equal "
          f"({power})")

    # (f) the chain engine on the card at its card budget (512 chains x
    # 24 rounds x 256 steps), plain PyTorch replayed as CUDA graphs:
    # feasible, and the engine's verification holds B1 to the numpy
    # oracle on its plan
    def chain_solve(label, case, steps):
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = optimize(*case, solver="tpu", engine="chain")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        chain_counts = {k.name: k.launches for k in kernels.KERNELS}
        st = res.solve.stats
        rep = res.report()
        if (st["engine"], st["chains_per_device"], st["rounds_run"],
                st["steps_per_round"]) != ("chain", 512, 24, steps):
            fail(f"{label}: ran {st['engine']} {st['chains_per_device']} x "
                 f"{st['rounds_run']} x {st['steps_per_round']}")
        if not rep["feasible"]:
            fail(f"{label}: infeasible plan ({rep['violations']})")
        # one B1 at the chunk's start, one in final selection, one in
        # verification
        if chain_counts[kernels.SCORE.name] != 3:
            fail(f"{label}: B1 launched {chain_counts} times, expected 3 "
                 "(seed, selection, verify)")
        a_dev = torch.from_numpy(res.solve.a).to(dev)[None]
        m_c = arrays.from_instance(res.instance, dev)
        out = score(m_c, a_dev)[0][0, :5].tolist()
        viol = res.instance.violations(res.solve.a)
        if out != [res.solve.objective, viol["broker_balance"],
                   viol["leader_balance"], viol["rack_balance"],
                   viol["part_rack_diversity"]]:
            fail(f"{label}: B1 scores {out} disagree with the oracle")
        print(f"{label} (512 chains x 24 rounds x {steps} steps, plain "
              f"PyTorch as CUDA graphs): feasible, {res.replica_moves} "
              f"moves, weight {res.solve.objective}, final_cert "
              f"{st.get('final_cert')}, wall {wall:.3f} s, anneal_s "
              f"{st['anneal_s']} ({power}); launches "
              + json.dumps(chain_counts))

    chain_solve("chain engine", random_cluster(
        np.random.default_rng(0), n_brokers=12, n_parts=40, rf=2,
        n_racks=2, drop=2), 256)

    # (g) the sweep->chain retry at its largest: a defaulted solve below
    # 512 partitions whose sweep ends infeasible retries the chain engine
    # at the card's budget, 512 chains x 24 rounds x 4P steps, with no
    # time limit unless the caller set one. One round as CUDA graphs
    # against the eager step loop (equal state, both timed), then the
    # whole chain solve the retry runs
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import (
        anneal,
        bucket,
    )
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu.seed import (
        greedy_seed,
    )

    case = random_cluster(np.random.default_rng(0), n_brokers=24,
                          n_parts=500, rf=3, n_racks=3, drop=1)
    inst = build_instance(*case)
    steps = 4 * inst.num_parts
    Pp, Rp = bucket.bucket_shape(inst)
    m_r = arrays.from_instance(inst, dev, num_parts=Pp, max_rf=Rp)
    seed_r = torch.from_numpy(arrays.pad_candidate(greedy_seed(inst),
                                                   m_r)).to(dev)
    keys = anneal.chain_keys(prng.PRNGKey(0), 512, dev)
    rounds = {}
    for graph in (True, False, True):
        run = anneal.make_round_runner(steps, graph=graph)
        st0 = anneal.init_chain(m_r, seed_r, keys)
        bk, ba = anneal.best_key(st0), st0.a.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st1, bk, ba = run(m_r, st0, bk, ba, np.float32(1.0))
        torch.cuda.synchronize()
        rounds.setdefault(graph, []).append(
            (time.perf_counter() - t0,
             (st1.a, st1.cnt, st1.lcnt, st1.rcnt, st1.pen, st1.w, st1.key,
              bk, ba)))
    for i, (x, y) in enumerate(zip(rounds[True][0][1], rounds[False][0][1])):
        if not torch.equal(x, y):
            fail(f"chain round: leaf {i} differs between the CUDA graphs "
                 "and the eager steps")
    (g_first, _), (g_warm, _) = rounds[True]
    e_s = rounds[False][0][0]
    print(f"chain round at the retry's size (512 chains, {inst.num_parts} "
          f"partitions, {steps} steps): equal state; CUDA graphs "
          f"{g_first:.3f} s with capture, {g_warm:.3f} s captured, "
          f"{1e3 * g_warm / steps:.4f} ms a step; eager {e_s:.3f} s, "
          f"{1e3 * e_s / steps:.4f} ms a step ({power})")
    # the whole anneal the retry runs: 24 rounds on the engine's chain
    # ladder (2.5 -> 0.05) from the greedy seed. The retry's own solve
    # adds the constructor race (this caps-binding case races the LP
    # decode, which certifies it at once) and final selection
    solve = anneal.make_solver_fn(512, steps)
    temps = arrays.geometric_temps(2.5, 0.05, 24)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best_a, best_k, _curve = solve(m_r, seed_r, prng.PRNGKey(0), temps)
    torch.cuda.synchronize()
    anneal_s = time.perf_counter() - t0
    plan = arrays.unpad_candidate(best_a, inst)
    viol = inst.violations(plan)
    out = score(m_r, best_a[None])[0][0, :5].tolist()
    if out != [inst.preservation_weight(plan), viol["broker_balance"],
               viol["leader_balance"], viol["rack_balance"],
               viol["part_rack_diversity"]] or int(best_k) < 0:
        fail(f"retry anneal: plan scores {out}, best key {int(best_k)}: "
             "infeasible or disagreeing with the oracle")
    print(f"sweep->chain retry anneal (512 chains x 24 rounds x {steps} "
          f"steps, CUDA graphs, {inst.num_parts} partitions): feasible, "
          f"{inst.move_count(plan)} moves, weight "
          f"{inst.preservation_weight(plan)}, wall {anneal_s:.3f} s, "
          f"{1e3 * anneal_s / (24 * steps):.4f} ms a step ({power})")
    print("kernel device time per call (profiler, ms): " + json.dumps(
        {k: (None if v is None else v / 1e3) for k, v in device_us.items()}))
    print(json.dumps({"kernels": rows + lane_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
