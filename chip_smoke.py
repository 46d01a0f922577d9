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
   launches), its two chunks pipelined (the default) with no rung taken,
   certified at final selection (``final_cert`` ``ok``/``ok_reseat``) at
   117 moves, weight 59,802;
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
   7 equal to one-instance ``solve_tpu_batch`` solves, the pipelined
   lane ladder (the default) equal to the synchronous one (walls in the
   order P S S P); wall and instances a second; then 3 of them padded to 8 lanes (the default)
   and run at 3 (``KAO_LANE_BUCKETS=off``), equal plans, both walls;
   (f) the chain engine (plain PyTorch replayed as CUDA graphs, 512
   chains x 24 rounds x 256 steps) on a 40-partition random cluster:
   feasible, B1 launched 3 times and equal to the numpy oracle on its
   plan; its wall beside the card's power limit;
   (g) the sweep->chain retry at its largest budget (512 chains x 24
   rounds x 4P steps) on a 500-partition random cluster: one round as
   CUDA graphs equal to the eager step loop, both timed; then the
   retry's anneal at 8 of its 24 rounds (its ms a step; the whole anneal
   is three times the wall), feasible and equal to the numpy oracle
   under B1;
   (h) the decomposed solve: the smoke ``ultra_jumbo`` instance
   (``engine="sweep", rounds=32, decompose=True``) on the card and on the
   CPU, equal plans; then ``ultra_jumbo_case(seed=0)`` at its published
   size (200,000 partitions, 4 AZs): the three lane launches held to
   their plain versions on the decomposed map's first chunk state (8
   lanes of the 62,208-row bucket; the ``kernels`` rows of the
   decomposed map, with the map's own launches), then ``optimize`` at
   its defaults (the auto trigger decides): the map through the lane
   kernels, one AZ lane of its first call replayed through the CPU's
   plain path with the same budget and held equal to the card's (plan,
   weight, violations; that CPU solve runs after the last timed phase,
   so it takes no core from a timed one), then the stitched plan or ``decompose_to_flat``
   and the flat path, the plan feasible under the numpy oracle with B1
   held to it; build, split, the AZ seeds, map and reduce by iteration,
   certify, total and the cold total;
   (i) the delta API: the adversarial scenario's certified plan with one
   more broker drained, through ``optimize_delta`` and a cold
   ``optimize``, both feasible and held to the oracle (B1 too);
   (j) the host fallback: the pinned solo adversarial solve with
   ``nan_chunk`` armed returns the host plan flagged
   ``anneal_to_construct``, verified; with the site kernel's launch
   failing as a real failed launch does, the solve raises out of
   ``optimize`` (that one error is caught and checked) and takes no
   fallback;
   (k) the ladder's dispatch modes: the solo anchor of (b) with
   ``time_limit_s=3600`` (8 chunks of 16 sweeps) synchronous, pipelined
   and fused in groups of 4 and 8 (``megachunk``) in both modes, in the
   order A..F F..A: the same plan, curve and rounds, every kernel
   launched, ``dispatches`` 8 or ceil(8 / K); per mode ``dispatches``,
   ``dispatch_s``, ``device_s``, ``boundary_overlap_s``, ``anneal_s``,
   wall, and (one profiled run a mode) the card's idle share of the
   ladder, from a profiler session around the ladder alone; the
   portfolio's call synchronous against pipelined, S P P S.
   Then a fused group with thresholds every chain meets retires
   after its first step on the card, equal to the CPU's plain path; the
   injected kernel fault at the second chunk takes ``pallas_to_xla`` and
   ``pipelined_to_sync`` with the unfaulted plan; a checkpoint written
   and resumed;
   (l) the service: ``serve.make_server(port=0)`` in this process, on
   the card (its default), driven over HTTP with ``urllib``: ``POST
   /warmup`` for the adversarial shape (its wall and row); the demo
   through ``/submit`` (``milp``, 1 move, proven); the pinned solo
   adversarial solve through ``/submit`` (``engine sweep, batch 8,
   rounds 128, portfolio false`` under the service's 300 s cap: 8 chunks
   of 16 sweeps), its plan equal to a direct ``optimize`` with the same
   options and cap, its launches counted, its ``trace_id`` echoed and
   ``GET /debug/solves/<tid>`` holding a ``ladder`` span with its
   ``chunk`` children; 5 such requests in a row (the median wall at the
   client); three concurrent ``/submit`` of (e)'s seeds 0-2 in one
   coalescing window: one ``optimize_batch``, each lane's plan equal to
   (e)'s; ``POST /evaluate`` of the solo plan (feasible, proven, 117
   moves); ``POST /clusters/adv/events`` (bootstrap, then the broker of
   (i) drained: the plan equal to (i)'s ``optimize_delta``); ``/healthz``
   and ``/metrics`` scraped; with the default two workers a chain-engine
   solve and a sweep solve at once, both verified; and with the
   sanitizer armed and ``nan_chunk``, the status and body the JAX
   package's service gives on the CPU (pinned there by
   ``tests/test_torch_sanitize.py``) and one NaN abort on ``/metrics``;
   (m) the measurement plane, with the roofline profiler (``obs.prof``)
   cleared and the device sampler (``obs.sampler``) at 10 Hz: the
   catalogue's ``decommission``, ``scale_out``, ``rf_change`` and
   ``leader_only`` at their published sizes through ``optimize`` at the
   defaults, each feasible under the numpy oracle (B1 held to it) with
   its moves against the scenario's bound (equal where the bound is
   tight), its path, launches, wall and phases printed; ``decommission``
   pinned to the annealer (``engine="sweep", batch=8, rounds=128``, the
   portfolio, the certificate and the host race off: ``precompile=True``,
   since the race's aggregated MILP certifies it even with the knobs
   set), every kernel launched; ``adv50k`` (512 brokers, 50,000
   partitions) at its defaults and, when the race certifies it on the
   host, pinned the same way under a profiler session (the card's idle
   share of the solve), with the sampler's ``kao_device_hbm_bytes`` read
   during it; ``jumbo`` at its defaults; then the roofline (every key
   with its analytic cost, no occupancy above 1.05), the phase's
   ledgers summing to their walls, the profiler's own time under 2% of
   the solves' and the sampler's duty cycle in [0, 1] at under 1%
   overhead; the pinned ``decommission`` solve again with
   ``profile_dir`` (a trace naming the three kernels, the same plan);
   ``ops.bench_kernel.kernel_vs_torch`` at the headline's and
   ``adv50k``'s shapes (6 rows each, every kernel equal to its plain
   version, no share of the bound above 1.05); and the service with an
   SLO spec, the sampler, a flight directory and a profile directory:
   two pinned ``decommission`` ``/submit``s (certified in the host race)
   and the pinned adversarial one of (l) (its ladder profiled, the first
   of its bucket), then that one again under a profiler session (the
   sampler's duty cycle across it, above 0, beside the card's idle
   share), ``/debug/profile``,
   ``/debug/slo``, ``/healthz`` (``devices``, ``slo``), the ``kao_slo_*``,
   ``kao_drift_*``, ``kao_device_*`` and ``kao_prof_*`` families on
   ``/metrics``, ``?format=chrome`` equal to ``obs.trace_cli convert`` of
   the same report, and ``obs.prof`` over the flight directory; the
   measured request's stop reason (every chunk and final selection, or
   the boundary certificate) from its solve trace;
   (n) fleet and rollout: two workers (``python -m
   kafka_assignment_optimizer_tpu_torch.serve``, each a process of its
   own on the card, a shared ``--watch-dir``, a ``--flight-dir`` each,
   the scored wave packer on 8 lanes) behind ``kao-router``
   (``fleet.router``), whose process maps no torch or jax library; a
   fleet ``/warmup`` of the ``decommission`` and ``adv50k`` shapes
   through the router (each bucket to its rendezvous owner, then spread
   to the other worker, no kernel built by a worker); the pinned
   ``decommission`` request (certified in the host race) and the pinned
   adversarial one (one chunk of 16 sweeps) through the router, the
   first of its key on a worker and then again, the second an affinity
   hit and equal to the same request sent to the answering worker
   directly (plan, moves, dispatches; the stop reasons printed), feasible
   under the numpy oracle with B1 held to it, the adversarial one
   launching every kernel on the worker (``/debug/kernels``), its trace
   one tree across router and worker (``/debug/traces/<id>``,
   ``?format=chrome`` pids 1 and 2); a rollout of ``decommission``'s drain (117 moves) and
   one of ``adv50k``'s (292 moves, a second broker drained after the
   first applied wave: only the remaining waves re-planned, the re-solve's
   trace linked by ``rollout_root``), each wave within its caps and the
   worker's ground truth the base with the applied waves, ending at the
   plan; a rollback to the pre-rollout assignment bit for bit and a stale
   rollout epoch answered 409 with the record on disk unchanged;
   ``kao-fleet`` over both flight directories (the merged count the sum,
   and worker 1's ``/debug/fleet`` with ``--fleet-peers`` the same); then
   the owner of ``decommission``'s bucket SIGKILLed: the pinned request
   answered by the other worker with the same plan, nothing dropped, the
   dead worker out of the router's live set and ``/clusters/prod``
   readable through the shared watch directory;
   (o) the sharded mesh: two chain shards on the one card (the mesh
   ``[cuda:0, cuda:0]``, one launch of each kernel a stage for both),
   every run held equal to the CPU's two-shard run (``device="cpu",
   n_devices=2``, which the tier-1 tests hold to the JAX package's two
   devices): the pinned adversarial solo (``batch=8, rounds=16,
   portfolio=False``: plan, moves, curve, and the launches of one
   shard's ladder) and each shard's winners of one chunk through
   ``solve_on_mesh``; a batch of 4 adversarial instances under
   ``KAO_MESH_SHARDING=2x1`` and ``1x2`` (equal plans) and the sharding
   search on that bucket (parity asserted), both over two blocks on the
   one card (positions ``cuda:0`` and ``cuda``, which the mesh keeps
   apart: the several-card layout's launches, one a block, and its
   copies between blocks; on one block every split is the same work and
   the chooser is skipped); the chain engine (64 chains x
   2 rounds); a megachunk whose certificate exits (the ``decommission``
   smoke case, the weight bound forced to 1); and two processes on the
   card under ``init_distributed`` (gloo: they share the card), one shard
   each, both giving the one-process plan. Each run prints its wall, its
   launches and the migration's host time as a share of ``anneal_s``;
   (p) ``kao-check`` over the port: ``python -m
   kafka_assignment_optimizer_tpu_torch.analysis --baseline
   analysis_baseline_torch.json`` in a child process (the default
   ``--device cuda``: lint, then the runtime contracts on the card) must
   exit 0; meanwhile ``run_contracts(device="cuda")`` in this process
   must give 0 findings, the sweep stepper's chunk launching B1, the site and
   the exchange kernel as ``sweep.stage_counts(8)`` says (the counts set
   to 0 just before each step) and the lane stepper at L=2 one launch a
   stage. Then the lock sanitizer: a child arms ``analysis.lsan`` before
   it imports the port and runs the C8 scenario three times (a chain
   solve whose rounds are captured as CUDA graphs, 64 chains x 4 rounds
   x 256 steps, in one thread beside a sweep solve, 8 chains x 64
   sweeps, in another), then (q)'s two step-graph captures (the
   adversarial solo and portfolio under ``megachunk="auto"``, one
   thread each: one capture each, 8 dispatches, no degradation); each
   plan must equal the solve's alone and no violation may be recorded
   (a ``_CAPTURE_LOCK`` hold over the 5 s budget is one). It prints the
   acquisitions, the order edges and the longest hold of
   ``_CAPTURE_LOCK`` with its site;
   (q) the fused group as CUDA-graph replays of one step graph, and the
   measured width on top of it, on the adversarial instance at full
   width (bucket 10,240 x 4, 8 chains, 128 sweeps in 8 chunks of 16, the boundary
   certificate off), the solo (``portfolio=False``) and the portfolio
   (8 lanes): per chunk eagerly (the default), as one replay a chunk
   (``megachunk="auto"`` with no evidence: K=1) and fused at K=2, 4 and
   8, with the counts set to 0 just before each solve: dispatches 8 / 8 /
   4 / 2 / 1, 64 site and 32 exchange launches each (a replay adds its
   graph's captured launches), every plan equal to the others and to
   (k)'s, exactly one step graph captured per (bucket, L) on the first
   fused solve and none after it (other widths, seed 1), printed with
   ``dispatch_s``, ``device_s``, ``anneal_s``, the capture seconds and
   the card's idle share of the ladder (a profiler session around the
   second solve's ladder); the armed exit through the graph (the
   ``decommission`` smoke solo at K=4, the weight bound forced to 1:
   ``early_exit``, the per-chunk ladder's plan, no degradation); two
   threads replaying K=4 groups of the solo's bucket at once, each plan
   equal to its solo run; and the chooser: 16 ``megachunk="auto"``
   solves of the pinned solo from empty evidence, then a 17th, which
   must run at the width ``choose_megachunk_k`` gives (recomputed from
   the printed evidence ``o`` and ``d``) with the same plan; the solo's
   step graph replayed alone (host launch against device time). Phase
   (k)'s forced exit launches all four steps (four replays; the host
   cannot see the exit, so the steps after it run and are dropped),
   (p)'s contracts run the armed fused groups too (two steps: twice the
   chunk's launches), and (p)'s lock-sanitizer child also runs (q)'s two
   captures (the solo and the portfolio, one thread each).

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

# the JAX package's service on the CPU answers a sanitized nan_chunk
# solve so (tests/test_torch_sanitize.py holds both services to it)
SANITIZED_NAN_CHUNK = (500, {"error": "internal error: chaos: injected "
                                      "fault at point 'nan_chunk'"})
INT32_LANES_PER_SM = 64  # Hopper issues 64 INT32 operations a clock per SM
REPS = 20  # launches per timed window
PROFILED = (5, 4)  # profiler windows, launches per window, of a lane row
RETRY_ROUNDS = 8  # rounds of phase (g)'s retry anneal (the retry runs 24)
WINDOWS = 5  # windows per time (the median is kept)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed(fn, reps: int = REPS, windows: int = WINDOWS) -> float:
    """Median milliseconds per call over ``windows`` windows of ``reps``
    calls, after a warm-up, in CUDA events (``ops.bench_kernel``'s
    timing, the one every kernel row uses)."""
    from kafka_assignment_optimizer_tpu_torch.ops.bench_kernel import (
        timed_ms,
    )

    return timed_ms(fn, True, reps, windows)


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
    phases' keys are drawn in the exchange kernel's first phase)."""
    import numpy as np

    from kafka_assignment_optimizer_tpu_torch import prng
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import sweep

    from kafka_assignment_optimizer_tpu_torch.ops import kernels

    sc, m1, st, best = engine_stages(m, a)
    temps = [float(np.float32(0.5))]
    key = prng.PRNGKey(5)
    # the kernels take their lane values on the card, as the ladder
    # hands them (one copy a chunk), the compound sweep on the host
    calls = {
        "site": lambda k: sc.site_step(
            m1, *st, *kernels.lane_values([k], temps, 1, a.device)),
        "exchange": lambda k: sc.exch_step(
            m1, *st, *kernels.lane_values([k], temps, 1, a.device)),
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

    from kafka_assignment_optimizer_tpu_torch.ops import kernels

    sc, m1, st, best = engine_stages(m, a)
    a1 = a[:1].clone()[None]
    temps = [float(np.float32(0.5))]
    key = prng.PRNGKey(5)
    # the kernel's lane values on the card, as the ladder hands them
    dkey, dtemp = kernels.lane_values([key], temps, 1, a.device)
    calls = {
        "B1 call": lambda: sc.full(m1, st[0]),
        "B1 call N=1": lambda: sc.full(m1, a1),
        "exchange sweep": lambda: sc.exch_step(m1, *st, dkey, dtemp),
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


def kernel_row(k, label: str, err: float, call, plain, cost: dict,
               library, peaks: dict, plain_reps: tuple = (REPS, WINDOWS)
               ) -> dict:
    """The ``kernels`` row of launch ``k`` (an ``ops.kernels`` kernel)
    from ``ops.bench_kernel``: the wrapper ``call`` and its ``plain``
    version timed by ``timed_ms``, the bound of ``cost`` (``data_cost``)
    by ``bound_ms`` over ``peaks``, and the library yardstick ``(label,
    fn)`` of ``library_calls`` (or None). Launches are filled in later."""
    from kafka_assignment_optimizer_tpu_torch.ops import bench_kernel

    bound, by = bench_kernel.bound_ms(cost, peaks)
    return {
        "name": k.name + label, "route": "cuda",
        "source": f"kafka_assignment_optimizer_tpu_torch/csrc/{k.source}.cu",
        "replaces": " + ".join(r.split(" ")[0] for r in k.replaces),
        "launches": 0, "max_abs_err": err, "ms": timed(call),
        "plain_ms": timed(plain, *plain_reps), "bound_ms": bound,
        "bound_by": by,
        "library_ms": timed(library[1]) if library else None,
    }


def lane_rows(torch, ms, al, errs: dict, hists, keys, temps,
              peaks: dict, tf_ops: int, label: str,
              solo_device_us: dict | None = None) -> list[dict]:
    """The ``kernels`` rows of the three lane launches on the chains ``al
    [L, N, P, R]`` of the stacked model ``ms`` (``hists``, ``keys`` and
    ``temps`` as :func:`lane_equal` returns them; ``errs`` its max
    errors): each launch must make one launch and no other device
    activity a call; wrapper, plain, library and device times, and the
    bound (``ops.bench_kernel.data_cost``: a table the lanes share is
    read once, else each lane's own). Launches are filled in later."""
    from kafka_assignment_optimizer_tpu_torch.ops import (
        bench_kernel,
        exchange_cuda,
        kernels,
    )
    from kafka_assignment_optimizer_tpu_torch.ops.score_cuda import (
        score_lanes,
        score_lanes_plain,
    )
    from kafka_assignment_optimizer_tpu_torch.ops.site_cuda import (
        site_step_lanes,
    )
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import sweep

    L = al.shape[0]
    cnt, lcnt, rcnt = hists
    # the kernels as the engine's ladder calls them: the lanes' keys and
    # temperatures already on the card (one copy a chunk), so a call is
    # its launch alone
    dkeys, dtemps = kernels.lane_values(keys, temps, L, al.device)
    calls = {
        kernels.SCORE.name: (lambda: score_lanes(ms, al),
                             lambda: score_lanes_plain(ms, al)),
        kernels.SITE.name: (
            lambda: site_step_lanes(ms, al, cnt, lcnt, rcnt, dkeys, dtemps),
            lambda: sweep.site_lanes_delta(ms, al, cnt, lcnt, rcnt, keys,
                                           temps)),
        kernels.EXCHANGE.name: (
            lambda: exchange_cuda.exchange_step_lanes(
                ms, al, cnt, lcnt, rcnt, dkeys, dtemps),
            lambda: sweep.exchange_lanes_delta(ms, al, cnt, lcnt, rcnt,
                                               keys, temps)),
    }
    for k in kernels.KERNELS:
        one_launch(f"an {L}-lane {k.name} ({label})", calls[k.name][0], k,
                   KERNEL_FUNCS[k.name][0], torch)
    library = bench_kernel.library_calls(
        ms, al, exchange_cuda.exchange_sweep_lanes(ms, al, lcnt, keys, temps))
    rows = []
    for k in kernels.KERNELS:
        call, plain = calls[k.name]
        # device time: the launches the profiler saw, over short windows
        # (one window of 20 launches at the decomposed map's shape has
        # shown only 11 of them); each seen launch's time is whole
        mine, seen = [], []
        for _ in range(PROFILED[0]):
            events, _w = profiled(call, torch, PROFILED[1])
            got = [us for name, us in events
                   if KERNEL_FUNCS[k.name][0] in name]
            mine += got
            seen.append(len(got))
        dev_ms = sum(mine) / len(mine) / 1e3 if mine else None
        cost = bench_kernel.data_cost(k.name, ms, al, hists, keys, temps,
                                      tf_ops / 7)
        row = kernel_row(k, f" ({label})", errs[k.name], call, plain, cost,
                         library[k.name], peaks, (2, 3))
        rows.append(row)
        solo = (solo_device_us or {}).get(k.name)
        print(f"  {k.name} ({label}): exact; wrapper {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} "
              f"ms ({cost['bytes']} bytes, {cost['int_ops']} INT32 ops), "
              "library "
              + ("n/a" if row["library_ms"] is None
                 else f"{row['library_ms']:.4f} ms")
              + f", device (profiler) L={L} "
              + ("not measured" if dev_ms is None else f"{dev_ms:.5f} ms")
              + f" ({len(mine)} of {PROFILED[0] * PROFILED[1]} launches "
              f"seen, by window {seen})"
              + ("" if solo_device_us is None else ", L=1 "
                 + ("not measured" if solo is None
                    else f"{solo / 1e3:.5f} ms")))
    return rows


def lane_kernels(torch, dev, m, a, temp: float, peaks: dict,
                 tf_ops: int, solo_device_us: dict) -> list[dict]:
    """The lane forms at the main path's shapes: L=8 lanes of the
    adversarial bucket on the eight ``PORTFOLIO_TABLE`` configs (the
    tables shared, lane stride 0), each lane its own chain order; then 3
    lanes of three instances whose tables and bands differ. Each lane
    launch must equal its lane plain version and L single-lane launches,
    and make one launch and no other device activity a call. Returns the
    ``kernels`` rows of the 8-lane launches (launches filled in later)."""
    from kafka_assignment_optimizer_tpu_torch.models.instance import (
        build_instance,
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
    errs, hists, keys, temps = lane_equal(torch, ms, al, temp,
                                          f"{L} portfolio lanes")
    cnt, lcnt, rcnt = hists
    rows = lane_rows(torch, ms, al, errs, hists, keys, temps, peaks,
                     tf_ops, f"{L} lanes", solo_device_us)

    # the stages with no kernel, run lane by lane: the compound sweep and
    # the snapshot (one B1 for every lane, then each lane's bookkeeping
    # and migration)
    sc = sweep._make_lane_scorer("cuda")
    out = sc.full(ms, al)
    best = (sweep.best_key(out[0][..., 0],
                           out[0][..., 1:5].sum(-1, dtype=torch.int32)),
            out[0][..., 5], al.clone())
    comp_ms = timed(lambda: sc.comp_step(ms, al, cnt, lcnt, rcnt, keys,
                                         temps), reps=2, windows=3)
    snap_ms = timed(lambda: sweep.snapshot_step(sc, ms, al, *best),
                    reps=2, windows=3)
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


def b1_holds(torch, dev, inst, a, label: str) -> None:
    """Fail unless B1 on the card, on plan ``a`` of ``inst`` (lowered at
    its own shape), gives the numpy oracle's weight and violations."""
    from kafka_assignment_optimizer_tpu_torch.ops.score_cuda import score
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import arrays

    m = arrays.from_instance(inst, dev)
    out = score(m, torch.from_numpy(a).to(dev)[None])[0][0, :5].tolist()
    viol = inst.violations(a)
    oracle = [inst.preservation_weight(a), viol["broker_balance"],
              viol["leader_balance"], viol["rack_balance"],
              viol["part_rack_diversity"]]
    if out != oracle:
        fail(f"{label}: B1 scores {out} disagree with the oracle {oracle}")


# the decomposed map's witness, held for the script's last lines: AZ lane
# g of ultra_jumbo_case(seed=0)'s split, its sub-instance, seed, budget
# and the card's result for it
WITNESS: dict = {}


def map_witness() -> None:
    """Solve (h)'s AZ lane again through the CPU's plain path with the
    card's budget, after the last timed phase (it takes ~80 s of the
    host's cores, which would compete with the host-bound phases), and
    hold it to the card's lane: the same plan, weight, violations and
    sweeps."""
    import numpy as np

    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine

    w = WITNESS
    budget, g, bkt = w["budget"], w["g"], w["bkt"]
    t0 = time.perf_counter()
    cpu_lane = engine.solve_tpu_batch(
        [w["sub"]], seeds=[w["seed"]], engine=budget["engine"],
        batch=budget["batch"], rounds=budget["rounds"], device="cpu")[0]
    t_witness = time.perf_counter() - t0
    card_lane = w["card"]
    if (not np.array_equal(cpu_lane.a, card_lane.a)
            or [cpu_lane.objective, cpu_lane.stats["violations"],
                cpu_lane.stats["rounds_run"]]
            != [card_lane.objective, card_lane.stats["violations"],
                card_lane.stats["rounds_run"]]):
        fail(f"ultra_jumbo_case: AZ lane {g} of the map on the card "
             f"(weight {card_lane.objective}, violations "
             f"{card_lane.stats['violations']}) differs from the CPU's "
             f"plain path (weight {cpu_lane.objective}, violations "
             f"{cpu_lane.stats['violations']})")
    print(f"map witness: AZ lane {g} of the first map call ({budget['engine']}"
          f", {budget['batch']} chains x {budget['rounds']} sweeps, seed "
          f"{w['seed']}, bucket {bkt[0]} x {bkt[1]}) through the CPU's "
          f"plain path (after the last timed phase) equals the card's lane: "
          f"the same plan, weight {cpu_lane.objective}, "
          f"{cpu_lane.stats['violations']} violations (its seed's "
          f"{w['seed_viol']}), {cpu_lane.stats['moves']} moves; CPU "
          f"{t_witness:.3f} s")


def decomposed_phase(torch, dev, power: str, peaks: dict,
                     tf_ops: int, partitions: int = 200_000) -> list[dict]:
    """(h) The decomposed solve. The smoke ``ultra_jumbo`` instance with
    ``engine="sweep", rounds=32, decompose=True`` on the card and on the
    CPU: equal plans. Then ``ultra_jumbo_case(seed=0)`` at its published
    size through ``optimize`` at its defaults (the auto trigger decides):
    the three lane launches held to their plain versions on the map's
    first chunk state (the kernels rows of the decomposed map), then the
    solve: the map through the 8-lane bucket, every kernel launched by
    the map; one AZ lane of the map's first call equal to the CPU's plain
    path with the same budget; ``decomposed`` with 4 subproblems and lane
    bucket 8, or ``decompose_to_flat`` with its record and the flat path;
    feasible under the numpy oracle with B1 held to it. Returns the rows,
    their launches the map's."""
    import numpy as np

    from kafka_assignment_optimizer_tpu_torch import decompose, optimize
    from kafka_assignment_optimizer_tpu_torch.models.instance import (
        build_instance,
    )
    from kafka_assignment_optimizer_tpu_torch.ops import kernels
    from kafka_assignment_optimizer_tpu_torch.parallel.mesh import (
        init_lane_state,
    )
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import (
        bucket,
        engine,
    )
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu.seed import (
        greedy_seed,
    )
    from kafka_assignment_optimizer_tpu_torch.utils import gen

    smoke = gen.ultra_jumbo(seed=0, **gen.SMOKE_KWARGS["ultra_jumbo"])
    got = {}
    for device in ("cuda", "cpu"):
        inst = build_instance(smoke.current, smoke.broker_list,
                              smoke.topology)
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = engine.solve_tpu(inst, seed=0, engine="sweep", rounds=32,
                             decompose=True, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if r.stats["engine"] != "decomposed" or not r.stats["feasible"]:
            fail(f"decomposed smoke ({device}): engine "
                 f"{r.stats['engine']}, feasible {r.stats['feasible']}")
        got[device] = (r, wall, {k.name: k.launches
                                 for k in kernels.KERNELS})
    (card, w_card, counts), (cpu, w_cpu, _c) = got["cuda"], got["cpu"]
    if not np.array_equal(card.a, cpu.a) or (
            card.stats["decompose"] != cpu.stats["decompose"]):
        fail("decomposed smoke: the card's plan or decompose stats differ "
             "from the CPU's")
    d = card.stats["decompose"]
    print(f"decomposed smoke ({smoke.notes}; sweep, 32 rounds): "
          f"{d['subproblems']} subproblems, {d['iterations']} iterations, "
          f"{card.stats['moves']} moves, weight {card.objective}, bound gap "
          f"{d['bound_gap']}; equal to the CPU's plan; wall card "
          f"{w_card:.3f} s, CPU {w_cpu:.3f} s ({power}); launches "
          + json.dumps(counts))

    t0 = time.perf_counter()
    scen = gen.ultra_jumbo_case(seed=0, partitions=partitions)
    t_gen = time.perf_counter()
    inst = build_instance(scen.current, scen.broker_list, scen.topology)
    t_build = time.perf_counter()
    print(f"ultra_jumbo_case(seed=0): {scen.notes}; generated in "
          f"{t_gen - t0:.3f} s, instance built in {t_build - t_gen:.3f} s")
    # the map's first chunk state: the split and the lanes exactly as the
    # solve's first map iteration builds them (the split, and each lane's
    # greedy seed, are memoized on the instance, so the solve reuses them;
    # the cold total below adds them back)
    t0_split = time.perf_counter()
    sp = decompose.split_of(inst)
    if sp is None or sp.n_groups != 4:
        fail("ultra_jumbo_case: the instance does not split into 4 AZs")
    t_split = time.perf_counter()
    for sub in sp.subs:
        greedy_seed(sub)
    t_seeds = time.perf_counter()
    m_stack, lane_seeds, keys = engine.stack_lanes(
        sp.subs, list(range(sp.n_groups)), dev)
    pop = init_lane_state(m_stack, lane_seeds, keys, 8)[0]
    torch.cuda.synchronize()
    t_lanes = time.perf_counter()
    L, N, P, R = pop.shape
    seed_viol = [sum(sub.violations(lane_seeds[g][:sub.num_parts,
                                                  :sub.max_rf]).values())
                 for g, sub in enumerate(sp.subs)]
    print(f"decomposed map's first chunk state: L={L} (of {sp.n_groups} "
          f"AZs) N={N} P={P} R={R} B+1={m_stack.num_brokers + 1} "
          f"K+1={m_stack.num_racks + 1}; split {t_split - t0_split:.3f} s, "
          f"the AZs' greedy seeds {t_seeds - t_split:.3f} s, lowering "
          f"{t_lanes - t_seeds:.3f} s; the seeds' violations {seed_viol}")
    errs, hists, k_lanes, temps = lane_equal(
        torch, m_stack, pop, float(np.float32(0.5)), "decomposed map")
    rows = lane_rows(torch, m_stack, pop, errs, hists, k_lanes, temps,
                     peaks, tf_ops, f"{L} lanes, decomposed map")
    del m_stack, pop, hists

    from kafka_assignment_optimizer_tpu_torch.parallel.mesh import (
        lane_serve_report,
    )

    served = lane_serve_report()
    key = f"{sp.subs[0].num_brokers}x{sp.subs[0].num_racks}x{P}x{R}"
    before = decompose.STATS.snapshot()["counters"]
    # the map's own calls: solve_tpu_batch as the map makes them, each
    # call's arguments, lane results and kernel launches kept
    map_calls = []
    batch_fn = engine.solve_tpu_batch

    def map_call(insts, **kw):
        at = {k.name: k.launches for k in kernels.KERNELS}
        out = batch_fn(insts, **kw)
        map_calls.append((list(insts), kw, out, {
            k.name: k.launches - at[k.name] for k in kernels.KERNELS}))
        return out

    kernels.reset_counts()
    engine.solve_tpu_batch = map_call
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = optimize(scen.current, scen.broker_list, scen.topology,
                       instance=inst)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine.solve_tpu_batch = batch_fn
    counts = {k.name: k.launches for k in kernels.KERNELS}
    snap = decompose.STATS.snapshot()
    st = res.solve.stats
    d = st.get("decompose") or {}
    # the map ran through the lane ladder at the 8-lane bucket, every
    # kernel launched by the map itself; then the stitched plan
    # ("decomposed", 4 subproblems) or, when the stitch stays infeasible
    # after the last iteration, decompose_to_flat and the flat path
    dispatches = (lane_serve_report().get(key, {}).get("dispatches", 0)
                  - served.get(key, {}).get("dispatches", 0))
    if dispatches < 1 or 8 not in lane_serve_report()[key]["lane_buckets"]:
        fail(f"ultra_jumbo_case: no 8-lane map dispatch at {key}")
    if len(map_calls) != dispatches:
        fail(f"ultra_jumbo_case: {len(map_calls)} map calls seen, "
             f"{dispatches} dispatches served")
    map_counts = {name: sum(c[3][name] for c in map_calls)
                  for name in counts}
    for name, n in map_counts.items():
        if n <= 0:
            fail(f"ultra_jumbo_case: the map did not launch {name}")
    att = snap["attempt"]

    # the witness: one AZ lane of the map's first call again, through the
    # CPU's plain path with the card's budget (the map passes none, so the
    # lane takes the card's defaults; the CPU's would be smaller): the
    # same plan, weight and violations as the card's map gave that lane
    subs, kw, lane_res, _n = map_calls[0]
    if set(kw) != {"seeds", "engine", "device"} or kw["engine"] is not None:
        fail(f"ultra_jumbo_case: the map's call {sorted(kw)} is not the "
             "defaults' one the witness replays")
    bkt = (lane_res[0].stats["bucket_parts"], lane_res[0].stats["bucket_rf"])
    g = next(i for i, sub in enumerate(subs)
             if (bucket.part_bucket(sub.num_parts),
                 bucket.rf_bucket(sub.max_rf)) == bkt)
    budget = engine._defaults(subs[g], "gpu", None)
    if (subs[g].num_parts, subs[g].num_brokers) != (
            sp.subs[g].num_parts, sp.subs[g].num_brokers) or \
            not np.array_equal(subs[g].a0, sp.subs[g].a0):
        fail("ultra_jumbo_case: the map's first call is not on the split's "
             "sub-instances the witness rebuilds")
    # the CPU's plain path takes ~80 s here: it runs after the last timed
    # phase (map_witness)
    WITNESS.update(card=lane_res[g], g=g, sub=subs[g], seed=kw["seeds"][g],
                   budget=budget, bkt=bkt, seed_viol=seed_viol[g])
    if st["engine"] == "decomposed":
        if (d.get("subproblems"),
                (d.get("sub_shape") or {}).get("lane_bucket")) != (4, 8):
            fail(f"ultra_jumbo_case: decompose stats {d}; expected 4 "
                 "subproblems, lane bucket 8")
        outcome = (f"decomposed, {d['iterations']} iterations, "
                   + ("proved_optimal" if res.solve.optimal
                      else f"bound_gap {d['bound_gap']}"))
    else:
        if ("decompose_to_flat" not in st.get("degradations", [])
                or snap["counters"]["fallback"] != before["fallback"] + 1
                or att.get("stitch_violations", 0) <= 0
                or len(att.get("lane_violations", [])) != 4):
            fail(f"ultra_jumbo_case: engine {st['engine']} without a "
                 f"recorded decompose_to_flat ({st.get('degradations')}, "
                 f"{snap})")
        outcome = (f"decompose_to_flat after {att['iteration']} iterations "
                   f"(stitched plan {att['stitch_violations']} violations, "
                   f"lanes {att['lane_violations']}), then the flat path: "
                   f"{st['engine']}"
                   + (f"/{st['construct_path']}" if st.get("construct_path")
                      else "")
                   + (f", final_cert {st['final_cert']}"
                      if st.get("final_cert") else "")
                   + f", proven {res.solve.optimal}")
    viol = inst.violations(res.solve.a)
    if any(viol.values()) or not res.report()["feasible"]:
        fail(f"ultra_jumbo_case: infeasible plan {viol}")
    b1_holds(torch, dev, inst, res.solve.a, "ultra_jumbo_case")
    for row in rows:
        row["launches"] = map_counts[row["name"].split(" (")[0]]
    print(f"ultra_jumbo_case at the defaults: {outcome}; {res.replica_moves} "
          f"moves (lower bound {inst.move_lower_bound_exact()}), weight "
          f"{res.solve.objective} (bound {inst.best_known_weight_ub()}); "
          f"feasible, the oracle and B1 agree; wall {wall:.3f} s with the "
          f"split and the AZ seeds memoized, cold "
          f"{t_split - t0_split + t_seeds - t_split + wall:.3f} s ({power})")
    flat = {k: st[k] for k in ("race_s", "seed_s", "lower_s", "anneal_s",
                               "select_s", "polish_s", "verify_s") if k in st}
    print("ultra_jumbo_case phases (s): " + json.dumps({
        "build": round(t_build - t_gen, 4),
        "split": round(t_split - t0_split, 4),
        "map": att.get("times", {}).get("map"),
        "reduce": att.get("times", {}).get("reduce"),
        "certify": att.get("times", {}).get("certify"),
        **({"flat": flat} if st["engine"] != "decomposed" else {}),
        "total": round(wall, 4),
        "cold_total": round(t_seeds - t0_split + wall, 4)})
          + f"; {dispatches} map dispatches; launches by the map "
          + json.dumps(map_counts) + ", after it "
          + json.dumps({n: counts[n] - map_counts[n] for n in counts}))
    return rows


def delta_phase(torch, dev, power: str) -> None:
    """(i) The delta API. The adversarial scenario's certified plan at
    the defaults, then one more broker drained: ``optimize_delta`` from
    that plan and a cold ``optimize`` of the same post-event cluster,
    both feasible and held to the oracle (B1 too)."""
    from kafka_assignment_optimizer_tpu_torch import optimize, optimize_delta
    from kafka_assignment_optimizer_tpu_torch.ops import kernels
    from kafka_assignment_optimizer_tpu_torch.utils import gen

    scen = gen.adversarial()
    prev = optimize(scen.current, scen.broker_list, scen.topology)
    if not prev.solve.optimal:
        fail("delta: the adversarial plan at the defaults is not certified")
    brokers = scen.broker_list[:-1]  # the event: one more broker drained
    out = {}
    for label, call in (
            ("optimize_delta", lambda: optimize_delta(
                prev.assignment, brokers, scen.topology,
                prev_plan=prev.assignment)),
            ("cold optimize", lambda: optimize(prev.assignment, brokers,
                                               scen.topology))):
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.name: k.launches for k in kernels.KERNELS}
        if not r.report()["feasible"]:
            fail(f"delta ({label}): infeasible plan")
        b1_holds(torch, dev, r.instance, r.solve.a, f"delta ({label})")
        st = r.solve.stats
        out[label] = r
        print(f"delta ({label}, broker {scen.broker_list[-1]} drained): "
              f"engine {st['engine']}, construct_path "
              f"{st.get('construct_path')}, warm_started "
              f"{st.get('warm_started')}, {r.replica_moves} moves, weight "
              f"{r.solve.objective}, proven {r.solve.optimal}, wall "
              f"{wall:.3f} s ({power}); launches " + json.dumps(counts))
    if not out["optimize_delta"].solve.stats.get("warm_started"):
        fail("delta: the adapted previous plan did not seed the solve")
    return out["optimize_delta"]


def fallback_phase(torch, dev, power: str) -> None:
    """(j) The host fallback. The pinned solo adversarial solve with
    ``nan_chunk`` armed: the host plan, flagged ``anneal_to_construct``,
    feasible and verified. Then the same solve with the site kernel's
    launch failing as a real failed launch does: it must raise out of
    ``optimize`` (no host plan hides the device), and that one expected
    error is caught here; any other fails the run."""
    from kafka_assignment_optimizer_tpu_torch import optimize
    from kafka_assignment_optimizer_tpu_torch.ops import kernels
    from kafka_assignment_optimizer_tpu_torch.resilience import chaos, ladder
    from kafka_assignment_optimizer_tpu_torch.utils import gen

    scen = gen.adversarial()
    pinned = dict(solver="tpu", batch=8, rounds=128, portfolio=False,
                  cert_min_savings_s=float("inf"))
    chaos.arm("nan_chunk")
    try:
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = optimize(scen.current, scen.broker_list, scen.topology,
                       **pinned)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.name: k.launches for k in kernels.KERNELS}
    finally:
        chaos.disarm()
    st = res.solve.stats
    if (st["engine"], st.get("degraded")) != ("host_fallback",
                                              "anneal_to_construct") or (
            "anneal_to_construct" not in st.get("degradations", [])):
        fail(f"host fallback: engine {st['engine']}, degraded "
             f"{st.get('degraded')}, degradations {st.get('degradations')}")
    if not res.report()["feasible"]:
        fail("host fallback: infeasible plan")
    b1_holds(torch, dev, res.instance, res.solve.a, "host fallback")
    print(f"host fallback (nan_chunk, batch=8, rounds=128, portfolio off): "
          f"engine {st['engine']}, degraded {st['degraded']}, degradations "
          f"{st['degradations']}, {res.replica_moves} moves, weight "
          f"{res.solve.objective}, proven {res.solve.optimal}, wall "
          f"{wall:.3f} s ({power}); launches " + json.dumps(counts))
    saved = kernels.SITE._fn
    if saved is None:
        fail("host fallback: the site kernel was never loaded")
    before = ladder.snapshot()["anneal_to_construct"]
    kernels.SITE._fn = lambda *args: 700  # cudaErrorIllegalAddress
    try:
        optimize(scen.current, scen.broker_list, scen.topology,
                 **dict(pinned, rounds=8))
    except RuntimeError as e:
        if "failed to launch" not in str(e):
            raise
        err = e
    else:
        fail("a failed site launch did not raise out of optimize")
    finally:
        kernels.SITE._fn = saved
    if ladder.snapshot()["anneal_to_construct"] != before:
        fail("a failed site launch took the host fallback")
    print(f"failed site launch: raised out of optimize ({err}); no host "
          "fallback")


def dispatch_phase(torch, dev, power: str) -> None:
    """(k) The ladder's dispatch modes on the pinned solo anchor with a
    never-binding deadline, so the 8-chunk schedule forms (``batch=8,
    rounds=128, portfolio=False, cert_min_savings_s=1e9,
    time_limit_s=3600``): synchronous, pipelined, and megachunks of 4 and
    8 in both modes, run in the order A..F F..A within this call, each
    with the launch counts set to 0 just before it and read just after:
    every run the same plan, curve and rounds, every kernel launched
    (site 64, exchange 32), ``dispatches`` 8 or ceil(8 / K); the same
    call with the portfolio at its default, synchronous against
    pipelined (S P P S, equal plans); then one profiled run a mode for
    the card's idle share of the ladder, from a profiler session around
    the ladder alone. Then, on
    the card: a fused group with thresholds every chain meets retires
    after its first step, equal to the CPU's plain path; the injected
    kernel fault at the second chunk re-runs the rest on the plain
    versions (``pallas_to_xla``, ``pipelined_to_sync``) with the same
    plan; a checkpoint written and resumed."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kafka_assignment_optimizer_tpu_torch import optimize, prng
    from kafka_assignment_optimizer_tpu_torch.models.instance import (
        build_instance,
    )
    from kafka_assignment_optimizer_tpu_torch.ops import kernels
    from kafka_assignment_optimizer_tpu_torch.parallel.mesh import (
        init_sweep_state,
        solve_megachunk,
    )
    from kafka_assignment_optimizer_tpu_torch.resilience import chaos
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import (
        arrays,
        bucket,
        engine,
    )
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu.seed import (
        greedy_seed,
    )
    from kafka_assignment_optimizer_tpu_torch.utils import checkpoint, gen

    scen = gen.adversarial()
    inst = build_instance(scen.current, scen.broker_list, scen.topology)
    kw = dict(solver="tpu", seed=0, batch=8, rounds=128, portfolio=False,
              cert_min_savings_s=1e9, time_limit_s=3600.0, instance=inst)
    modes = {
        "sync": dict(pipeline=False),
        "pipelined": dict(pipeline=True),
        "mega4 sync": dict(pipeline=False, megachunk=4),
        "mega4 pipelined": dict(pipeline=True, megachunk=4),
        "mega8 sync": dict(pipeline=False, megachunk=8),
        "mega8 pipelined": dict(pipeline=True, megachunk=8),
    }

    def solve(name, **extra):
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = optimize(scen.current, scen.broker_list, scen.topology,
                       **{**kw, **modes[name], **extra})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return res, wall, {k.name: k.launches for k in kernels.KERNELS}

    runs = {name: [] for name in modes}
    for name in list(modes) + list(reversed(modes)):
        runs[name].append(solve(name))
    base = runs["sync"][0][0]
    for name, rs in runs.items():
        for res, _wall, counts in rs:
            st = res.solve.stats
            k = modes[name].get("megachunk", 1)
            if (not np.array_equal(res.solve.a, base.solve.a)
                    or st["score_curve"] != base.solve.stats["score_curve"]
                    or st["rounds_run"] != 128 or st["chunks"] != 8):
                fail(f"dispatch {name}: plan, curve or rounds "
                     f"({st['rounds_run']}, {st['chunks']} chunks) differ "
                     "from the synchronous ladder's")
            if (st["dispatches"], st["pipeline"], st["megachunk"]["k"]) != (
                    -(-8 // k), modes[name]["pipeline"], k):
                fail(f"dispatch {name}: dispatches {st['dispatches']}, "
                     f"pipeline {st['pipeline']}, megachunk "
                     f"{st['megachunk']}")
            if st.get("degradations") or st.get("final_cert") not in (
                    "ok", "ok_reseat") or not res.report()["feasible"]:
                fail(f"dispatch {name}: degradations "
                     f"{st.get('degradations')}, final_cert "
                     f"{st.get('final_cert')}")
            if (counts[kernels.SITE.name], counts[kernels.EXCHANGE.name]) \
                    != (64, 32) or counts[kernels.SCORE.name] <= 0:
                fail(f"dispatch {name}: launches {counts}")
    for name, rs in runs.items():
        st = [r.solve.stats for r, _w, _c in rs]
        print(f"dispatch {name}: " + json.dumps({
            "dispatches": st[0]["dispatches"],
            "dispatch_s": [s["dispatch_s"] for s in st],
            "device_s": [s["device_s"] for s in st],
            "boundary_overlap_s": [s["boundary_overlap_s"] for s in st],
            "anneal_s": [s["anneal_s"] for s in st],
            "wall_s": [round(w, 4) for _r, w, _c in rs],
            "launches": rs[0][2]}) + f" ({power})")
    # the default portfolio solve of the same call, synchronous against
    # pipelined (the default), in the order S P P S
    port = {False: [], True: []}
    for pipe in (False, True, True, False):
        res, wall, _c = solve("pipelined" if pipe else "sync",
                              portfolio=None)
        st = res.solve.stats
        if st["pipeline"] is not pipe or st.get("degradations") or (
                st["portfolio"]["width"] != 8):
            fail(f"dispatch portfolio pipeline={pipe}: {st['pipeline']}, "
                 f"{st.get('degradations')}, {st['portfolio']}")
        port[pipe].append((res, wall))
    if not all(np.array_equal(r.solve.a, port[False][0][0].solve.a)
               for r, _w in port[True] + port[False]):
        fail("dispatch portfolio: the pipelined and synchronous plans differ")
    summary = {("pipelined" if p else "sync"): {
        "anneal_s": [r.solve.stats["anneal_s"] for r, _w in rs],
        "dispatch_s": [r.solve.stats["dispatch_s"] for r, _w in rs],
        "wall_s": [round(w, 4) for _r, w in rs]} for p, rs in port.items()}
    print("dispatch portfolio (8 lanes, 8 chunks), order S P P S: "
          + json.dumps(summary) + f" ({power})")
    print(f"dispatch modes: {base.replica_moves} moves, weight "
          f"{base.solve.objective}, final_cert "
          f"{base.solve.stats['final_cert']}, 8 chunks x 16 sweeps, every "
          "mode the same plan, curve and rounds")
    # the card's idle share of the ladder, one run a mode: a profiler
    # session of its own around the ladder (``engine._run_ladder``, the
    # device idle at its start and drained at its end, as the engine's
    # next line does); busy is the device activity of that session, the
    # window the host clock inside it (the ladder's wall, as anneal_s)
    real_ladder = engine._run_ladder
    seen = {}

    def profiled_ladder(*a, **k):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = real_ladder(*a, **k)
            torch.cuda.synchronize()
            seen["window_s"] = time.perf_counter() - t0
        seen["busy_s"] = sum(e.time_range.elapsed_us()
                             for e in prof.events()
                             if e.device_type == DeviceType.CUDA) / 1e6
        return out

    idle = {}
    engine._run_ladder = profiled_ladder
    try:
        for name in modes:
            seen.clear()
            res, _w, _c = solve(name)
            if not seen.get("busy_s"):
                idle[name] = "not measured (no device event kept)"
                continue
            idle[name] = {
                "idle": round(1 - seen["busy_s"] / seen["window_s"], 4),
                "busy_s": round(seen["busy_s"], 4),
                "window_s": round(seen["window_s"], 4),
                "anneal_s": res.solve.stats["anneal_s"]}
    finally:
        engine._run_ladder = real_ladder
    print("dispatch idle share of the ladder (a profiler session around "
          "the ladder; 1 - device busy / its wall): " + json.dumps(idle)
          + f" ({power})")

    # the forced early exit on the card: a group of 4 steps x 16 sweeps
    # whose thresholds every chain meets from the seed runs step 0 only;
    # its outputs equal the CPU's plain path
    Pb, Rb = bucket.bucket_shape(inst)
    temps = arrays.geometric_temps(2.0, 0.02, 64)
    segs = np.stack([temps[i * 16:(i + 1) * 16] for i in range(4)])
    outs = {}
    for device, scorer in ((dev, "cuda"), (torch.device("cpu"), "torch")):
        m = arrays.from_instance(inst, device, num_parts=Pb, max_rf=Rb)
        seed = torch.from_numpy(arrays.pad_candidate(greedy_seed(inst),
                                                     m)).to(device)
        st = init_sweep_state(m, seed, prng.PRNGKey(0), 8)
        kernels.reset_counts()
        out = solve_megachunk(m, 8, segs, st, cert_k=-(2 ** 31) + 1,
                              cert_mv=2 ** 31 - 1, scorer=scorer)
        outs[scorer] = ([np.asarray(x.cpu()) if torch.is_tensor(x) else x
                         for x in out[1:]],
                        {k.name: k.launches for k in kernels.KERNELS})
    (card, counts), (plain, _c) = outs["cuda"], outs["torch"]
    if card[-1].tolist() != [True, False, False, False] or not card[3]:
        fail(f"forced exit: execd {card[-1].tolist()}, cert_ok {card[3]}")
    for name, x, y in zip(("top_a", "top_k", "cert_a", "cert_ok", "cert_mv",
                           "curves", "execd"), card, plain):
        if not np.array_equal(x, y):
            fail(f"forced exit: {name} differs between the card and the "
                 "CPU's plain path")
    # the group is four replays of its step graph: the host cannot see the
    # exit without a read, so the steps after it run and are dropped (the
    # reference's lax.cond under vmap), and it launches four steps'
    if (counts[kernels.SITE.name], counts[kernels.EXCHANGE.name]) != (32,
                                                                      16):
        fail(f"forced exit: launches {counts}, expected four steps'")
    print("forced exit on the card: a group of 4 steps x 16 sweeps "
          f"retired after step 0 (execd {card[-1].tolist()}), every output "
          "equal to the CPU's plain path; launches (four replays, every step "
          "run, the ones after the exit dropped) " + json.dumps(counts))

    # the injected kernel fault at the second chunk, pipelined: the
    # speculation drains, the chunk and the rest re-run on the plain
    # versions on the card, the plan is the unfaulted one
    real_hooks = engine._chaos_chunk_hooks
    calls = {"n": 0}

    def hooks():
        calls["n"] += 1
        if calls["n"] == 2:
            chaos.arm("pallas_fault")
        real_hooks()

    engine._chaos_chunk_hooks = hooks
    try:
        res, wall, counts = solve("pipelined")
    finally:
        engine._chaos_chunk_hooks = real_hooks
        chaos.disarm()
    st = res.solve.stats
    if (st.get("degradations") != ["pallas_to_xla", "pipelined_to_sync"]
            or st["scorer"] != "torch"
            or "pallas_fault" not in st.get("pallas_fallback", "")):
        fail(f"kernel fault: degradations {st.get('degradations')}, scorer "
             f"{st['scorer']}")
    if not np.array_equal(res.solve.a, base.solve.a) or (
            st["score_curve"] != base.solve.stats["score_curve"]):
        fail("kernel fault: the plain rung's plan or curve differs")
    if (counts[kernels.SITE.name], counts[kernels.EXCHANGE.name]) != (8, 4):
        fail(f"kernel fault: launches {counts}, expected chunk 0's only")
    print(f"kernel fault at chunk 1 (pipelined): degradations "
          f"{st['degradations']}, chunks 1-7 on the plain versions, the "
          f"same plan and curve; wall {wall:.3f} s, anneal_s "
          f"{st['anneal_s']} ({power}); launches " + json.dumps(counts))

    # a checkpoint written and resumed on the card
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck", "plan.npz")
        r1, _w1, _c1 = solve("pipelined", checkpoint=path)
        saved = checkpoint.load(path, inst)
        r2, w2, _c2 = solve("pipelined", checkpoint=path)
    if saved is None or not np.array_equal(saved, r1.solve.a):
        fail("checkpoint: the written plan is not the solve's")
    if (r1.solve.stats["resumed_from_checkpoint"],
            r2.solve.stats["resumed_from_checkpoint"]) != (False, True) or (
            not np.array_equal(r2.solve.a, r1.solve.a)):
        fail("checkpoint: the second solve did not resume to the same plan")
    print(f"checkpoint: written, resumed (resumed_from_checkpoint True), "
          f"the same plan; resumed solve wall {w2:.3f} s ({power})")
    return base.solve.a, port[False][0][0].solve.a


def _http(url: str, path: str, payload=None):
    """``(status, body, wall s)`` of one request; the body parsed as JSON
    when it is JSON."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url + path, method="GET" if payload is None else "POST",
        data=None if payload is None else json.dumps(payload).encode())
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    wall = time.perf_counter() - t0
    try:
        return status, json.loads(raw), wall
    except ValueError:
        return status, raw.decode(), wall


def _spans(sp: dict):
    yield sp
    for c in sp.get("spans", ()):
        yield from _spans(c)


def service_phase(torch, power: str, batch3: list, delta) -> None:
    """(l) The service on the card (see the module docstring). The launch
    counts are process-wide, so they are read around requests that run
    alone."""
    import threading

    import numpy as np

    from kafka_assignment_optimizer_tpu_torch import optimize, serve
    from kafka_assignment_optimizer_tpu_torch.analysis import sanitize
    from kafka_assignment_optimizer_tpu_torch.models.cluster import (
        demo_assignment,
    )
    from kafka_assignment_optimizer_tpu_torch.ops import kernels
    from kafka_assignment_optimizer_tpu_torch.resilience import chaos
    from kafka_assignment_optimizer_tpu_torch.utils import gen

    t_phase = time.perf_counter()
    srv = serve.make_server(port=0)  # tpu solves on the card, the default
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def ok(path, payload=None, label=None):
        st, body, wall = _http(url, path, payload)
        if st != 200:
            fail(f"service {label or path}: {st} {body}")
        return body, wall

    def payload(scen, **extra):
        return {"assignment": scen.current.to_dict(),
                "brokers": list(scen.broker_list),
                "topology": scen.topology.to_dict(), **extra}

    try:
        # 1. warm-up of the adversarial shape
        body, wall = ok("/warmup", {"shapes": [{
            "brokers": 256, "partitions": 10_000, "rf": 4, "racks": 8}],
            "engine": "sweep"})
        print(f"service /warmup (256 brokers, 10,000 partitions, rf 4, 8 "
              f"racks): wall {wall:.3f} s ({power}); row "
              + json.dumps(body["warmed"][0]))
        # 2. the demo through the exact MILP
        body, _ = ok("/submit", {"assignment": demo_assignment().to_dict(),
                                 "brokers": "0-18", "topology": "even-odd",
                                 "solver": "milp"})
        rep = body["report"]
        if (rep["replica_moves"], rep["proven_optimal"]) != (1, True):
            fail(f"service demo: {rep['replica_moves']} moves, proven "
                 f"{rep['proven_optimal']}")
        print("service /submit demo (milp): 1 move, proven optimal")
        # 3. the pinned solo, against a direct optimize under the same cap
        scen = gen.adversarial()
        opts = {"engine": "sweep", "batch": 8, "rounds": 128,
                "portfolio": False}
        direct = optimize(scen.current, scen.broker_list, scen.topology,
                          solver="tpu", time_limit_s=300.0, **opts)
        kernels.reset_counts()
        body, wall = ok("/submit", payload(scen, solver="tpu",
                                           options=opts), "pinned solo")
        counts = {k.name: k.launches for k in kernels.KERNELS}
        rep, tid = body["report"], body.get("trace_id")
        if body["assignment"] != direct.assignment.to_dict():
            fail("service pinned solo: the served plan differs from the "
                 "direct optimize's")
        if (counts[kernels.SITE.name], counts[kernels.EXCHANGE.name]) != (
                64, 32) or counts[kernels.SCORE.name] < 1:
            fail(f"service pinned solo: launches {counts}")
        if not tid:
            fail("service pinned solo: no trace_id echoed")
        trace, _ = ok(f"/debug/solves/{tid}")
        ladders = [sp for sp in _spans(trace["spans"])
                   if sp["name"] == "ladder"]
        chunks = [c for lad in ladders for c in lad.get("spans", ())
                  if c["name"] == "chunk"]
        if len(ladders) != 1 or len(chunks) != rep["solver_chunks"]:
            fail(f"service pinned solo: trace {tid} holds {len(ladders)} "
                 f"ladder spans and {len(chunks)} chunk spans")
        print(f"service /submit pinned solo (batch 8, rounds 128, "
              f"portfolio off, 300 s cap): {rep['solver_engine']} "
              f"{rep['solver_rounds_run']} sweeps in "
              f"{rep['solver_dispatches']} chunks, final_cert "
              f"{rep.get('solver_final_cert')}, {rep['replica_moves']} "
              f"moves, weight {rep['objective_weight']}, proven "
              f"{rep['proven_optimal']}, equal to the direct optimize; "
              f"trace {tid}: 1 ladder span, {len(chunks)} chunk spans; "
              f"launches {json.dumps(counts)}; wall {wall:.3f} s")
        solo_plan = body["assignment"]
        walls = []
        for _ in range(5):
            body, wall = ok("/submit", payload(scen, solver="tpu",
                                               options=opts), "solo x5")
            if body["assignment"] != solo_plan:
                fail("service pinned solo: a repeat gave another plan")
            walls.append(wall)
        print(f"service pinned solo x5 at the client: median "
              f"{statistics.median(walls):.3f} s, walls "
              f"{[round(w, 3) for w in walls]} ({power})")
        # 4. three concurrent requests coalesced into one batch: the
        # coalescer holds each request for the group (its bypass off, as
        # a busy pool would make it) and flushes at three
        co = serve._COALESCER
        saved = (co.should_bypass, co.max_batch, co.window_s)
        co.should_bypass = lambda key: False
        co.max_batch, co.window_s = 3, 30.0
        with serve._METRICS_LOCK:
            batches0 = serve._METRICS["batch_solves_total"]
        res = [None] * 3

        def one(i):
            res[i] = _http(url, "/submit", payload(
                gen.adversarial(seed=i), solver="tpu",
                options={"seed": i}))

        try:
            kernels.reset_counts()
            ths = [threading.Thread(target=one, args=(i,))
                   for i in range(3)]
            t0 = time.perf_counter()
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=600)
            batch_wall = time.perf_counter() - t0
            counts = {k.name: k.launches for k in kernels.KERNELS}
        finally:
            co.should_bypass = saved[0]
            co.max_batch, co.window_s = saved[1], saved[2]
        with serve._METRICS_LOCK:
            batches = serve._METRICS["batch_solves_total"] - batches0
        for i, r in enumerate(res):
            if r is None or r[0] != 200:
                fail(f"service batch request {i}: {r}")
            rep = r[1]["report"]
            if (rep["solver_lanes"], rep["solver_lane_bucket"]) != (3, 8) \
                    or not r[1].get("coalesced_into"):
                fail(f"service batch request {i}: lanes "
                     f"{rep['solver_lanes']}, bucket "
                     f"{rep['solver_lane_bucket']}")
            if r[1]["assignment"] != batch3[i]:
                fail(f"service batch request {i}: the lane's plan differs "
                     "from (e)'s")
        if batches != 1:
            fail(f"service batch: {batches} batched solves, expected 1")
        print(f"service 3 concurrent /submit (seeds 0-2): one coalesced "
              f"optimize_batch, 3 lanes padded to 8, each lane equal to "
              f"(e)'s; moves {[r[1]['report']['replica_moves'] for r in res]}"
              f"; batch wall at the client {batch_wall:.3f} s ({power}); "
              f"launches {json.dumps(counts)}")
        # 5. the audit of the solo plan: host work only (its bound LPs
        # take tens of seconds at this size), on its own lock, so it runs
        # beside steps 6-8 and is read before step 9
        audit = {}
        audit_t = threading.Thread(target=lambda: audit.update(r=_http(
            url, "/evaluate", payload(scen, plan=solo_plan))))
        audit_t.start()
        # 6. the watch: bootstrap, then (i)'s drain
        body, _ = ok("/clusters/adv/events", {
            "type": "bootstrap", "epoch": 1,
            **payload(scen)}, "bootstrap")
        drained = scen.broker_list[-1]
        body, wall = ok("/clusters/adv/events", {
            "type": "broker_drain", "epoch": 2, "brokers": [drained]},
            "broker_drain")
        rep = body["report"]
        if body["assignment"] != delta.assignment.to_dict():
            fail("service watch: the drain's plan differs from (i)'s "
                 "optimize_delta")
        print(f"service /clusters/adv/events (bootstrap, broker {drained} "
              f"drained): {rep['solver_engine']}/"
              f"{rep.get('solver_construct_path')}, {rep['replica_moves']} "
              f"moves, weight {rep['objective_weight']}, equal to (i)'s "
              f"optimize_delta; wall {wall:.3f} s")
        # 7. health and metrics
        hz, _ = ok("/healthz")
        st, text, _ = _http(url, "/metrics")
        families = [ln.split()[2] for ln in text.splitlines()
                    if ln.startswith("# TYPE ")]
        if hz["platform"] != "gpu" or st != 200:
            fail(f"service /healthz platform {hz['platform']}, /metrics "
                 f"{st}")
        print(f"service /healthz: platform gpu, cache "
              + json.dumps({k: hz["cache"][k] for k in (
                  "executables_held", "exec_hits", "exec_misses",
                  "compiles_total", "persistent_cache")})
              + f"; /metrics: {len(families)} families")
        # 8. two workers: a chain-engine solve beside a sweep solve
        chain_case = random_cluster(np.random.default_rng(0), 12, 40, 2, 2,
                                    drop=2)
        reqs = {
            "chain": {"assignment": chain_case[0].to_dict(),
                      "brokers": chain_case[1],
                      "topology": chain_case[2].to_dict(), "solver": "tpu",
                      "options": {"engine": "chain",
                                  "steps_per_round": 256}},
            "sweep": payload(scen, solver="tpu",
                             options={**opts, "steps_per_round": 1}),
        }
        spans, outs = {}, {}

        def run(name):
            t0 = time.perf_counter()
            outs[name] = _http(url, "/submit", reqs[name])
            spans[name] = (t0, time.perf_counter())

        ths = [threading.Thread(target=run, args=(n,)) for n in reqs]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=600)
        for name, r in outs.items():
            if r[0] != 200 or not r[1]["report"]["feasible"] or \
                    r[1]["report"]["solver_engine"] != name:
                fail(f"service two workers ({name}): {r[0]} "
                     f"{str(r[1])[:300]}")
        overlap = (max(s[0] for s in spans.values())
                   < min(s[1] for s in spans.values()))
        if not overlap:
            fail("service two workers: the two solves did not overlap")
        print("service two workers at once: chain engine (512 chains, "
              "CUDA graphs) and sweep, both feasible and verified; walls "
              + json.dumps({k: round(v[1] - v[0], 3)
                            for k, v in spans.items()}) + f" ({power})")
        audit_t.join(timeout=600)
        st, body, wall = audit.get("r", (None, None, None))
        if st != 200 or (body["feasible"], body["proven_optimal"],
                         body["replica_moves"]) != (True, True, 117):
            fail(f"service /evaluate: {st} {body}")
        print(f"service /evaluate of the solo plan (beside steps 6-8): "
              f"feasible, proven, 117 moves, weight "
              f"{body['objective_weight']} (bound "
              f"{body['objective_upper_bound']}), wall {wall:.3f} s")
        # 9. the sanitizer armed with nan_chunk
        sanitize.enable()
        chaos.arm("nan_chunk")
        try:
            st, body, _ = _http(url, "/submit", payload(
                scen, solver="tpu", options=opts))
            _s, text, _ = _http(url, "/metrics")
        finally:
            chaos.disarm()
            sanitize.disable()
        aborts = [ln for ln in text.splitlines()
                  if ln.startswith("kao_sanitizer_nan_aborts_total ")]
        if (st, body) != SANITIZED_NAN_CHUNK or aborts != [
                "kao_sanitizer_nan_aborts_total 1"]:
            fail(f"service sanitized nan_chunk: {st} {body}, {aborts}")
        print(f"service sanitized nan_chunk: {st} {json.dumps(body)} (the "
              f"JAX package's service on the CPU gives the same), "
              f"{aborts[0]}")
    finally:
        srv.shutdown()
        srv.server_close()
    print(f"service phase: {time.perf_counter() - t_phase:.3f} s")


def measure_phase(torch, power: str) -> None:
    """(m) The measurement plane on the card (see the module docstring):
    the scenario catalogue at its published sizes with the roofline
    profiler armed and the device sampler at 10 Hz, a profiled solve,
    the kernel-vs-torch bench, and the service's measurement surfaces.
    Nothing here is caught: a sampler that reads no card, a bench that
    skips or a refused ``profile_dir`` fails the phase."""
    import glob
    import threading

    from kafka_assignment_optimizer_tpu_torch import optimize, serve
    from kafka_assignment_optimizer_tpu_torch.models.instance import (
        build_instance,
    )
    from kafka_assignment_optimizer_tpu_torch.obs import flight, prof
    from kafka_assignment_optimizer_tpu_torch.obs.sampler import SAMPLER
    from kafka_assignment_optimizer_tpu_torch.ops import bench_kernel
    from kafka_assignment_optimizer_tpu_torch.ops import kernels
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine
    from kafka_assignment_optimizer_tpu_torch.utils import gen

    t_phase = time.perf_counter()
    # the annealer pinned by its knobs, the portfolio and the boundary
    # certificate off (as (b)): every kernel, a plan that does not depend
    # on the card's speed. The catalogue's symmetric scenarios certify in
    # the host race's aggregated MILP even with the knobs set (as in the
    # reference), so the pinned solves also switch the race off
    # (precompile=True, the service warm-up's mode; such a solve lands
    # no flight record)
    pinned = {"engine": "sweep", "batch": 8, "rounds": 128,
              "portfolio": False}
    no_race = {"cert_min_savings_s": float("inf"), "precompile": True}
    prof.clear()
    t_unix = time.time()
    SAMPLER.configure(10.0)
    walls = []

    def solve(name, scen, label, **kw):
        """One solve at the scenario's published size, its launches
        counted from 0: feasible under the numpy oracle (B1 held to it),
        its moves against the scenario's bound."""
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = optimize(scen.current, scen.broker_list, scen.topology,
                       target_rf=scen.target_rf, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls.append(wall)
        counts = {k.name: k.launches for k in kernels.KERNELS}
        rep, st = res.report(), res.solve.stats
        inst = res.instance
        if not rep["feasible"] or sum(inst.violations(res.solve.a).values()):
            fail(f"{label}: infeasible plan ({rep['violations']})")
        b1_holds(torch, torch.device("cuda"), inst, res.solve.a, label)
        moves = rep["replica_moves"]
        if moves < scen.min_moves_lb or (scen.lb_tight
                                         and moves != scen.min_moves_lb):
            fail(f"{label}: {moves} moves against the bound "
                 f"{scen.min_moves_lb} (tight: {scen.lb_tight})")
        phases = {k: st[k] for k in ("build_s", "race_s", "seed_s",
                                     "lower_s", "anneal_s", "select_s",
                                     "polish_s", "verify_s") if k in st}
        print(f"{label}: {inst.num_brokers} brokers, {inst.num_parts} "
              f"partitions; path {st.get('engine')}/"
              f"{st.get('construct_path')}, {moves} moves (bound "
              f"{scen.min_moves_lb}, tight {scen.lb_tight}), weight "
              f"{res.solve.objective}, proven {rep['proven_optimal']}, "
              f"wall {wall:.3f} s ({power}); launches "
              + json.dumps(counts) + "; phases s " + json.dumps(phases))
        return res, counts, wall

    # 1. the catalogue's four published scenarios at the defaults
    for name in ("decommission", "scale_out", "rf_change", "leader_only"):
        solve(name, gen.SCENARIOS[name](), f"{name} at defaults")

    # 2. decommission pinned to the annealer: every launch; then adv50k at
    # its defaults (pinned as well when the race certifies it on the host)
    decom = gen.SCENARIOS["decommission"]()
    pinned_res, counts, _w = solve("decommission", decom,
                                   "decommission pinned (batch=8, "
                                   "rounds=128, portfolio off)",
                                   solver="tpu", **pinned, **no_race)
    if not all(counts.values()):
        fail(f"decommission pinned: a kernel never launched: {counts}")
    adv = gen.SCENARIOS["adv50k"]()
    hbm = []
    stop = threading.Event()

    def watch_hbm():
        while not stop.wait(0.05):
            devs = SAMPLER.stats()["devices"]
            hbm.append(max((d["bytes_in_use"] for d in devs.values()),
                           default=0))

    poller = threading.Thread(target=watch_hbm, daemon=True)
    poller.start()
    try:
        _res, counts, _w = solve("adv50k", adv, "adv50k at defaults")
        if not any(counts.values()):
            print("adv50k: the constructor race certified it on the host "
                  "with no launch; solved again pinned to the annealer")
            # the card's idle share of this solve: a profiler session
            # around it, 1 - device busy over its wall
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as p:
                _res, counts, wall = solve("adv50k", adv, "adv50k pinned",
                                           solver="tpu", **pinned,
                                           **no_race)
            busy = sum(e.time_range.elapsed_us() for e in p.events()
                       if e.device_type == DeviceType.CUDA) / 1e6
            if not all(counts.values()):
                fail(f"adv50k pinned: a kernel never launched: {counts}")
            idle = (f"{1 - busy / wall:.4f} (device busy {busy:.4f} s of "
                    f"{wall:.3f} s)" if busy else
                    "not measured (no device event kept)")
        else:
            idle = "not measured (the defaulted solve ran unprofiled)"
    finally:
        stop.set()
        poller.join(timeout=5)
    if not hbm or max(hbm) <= 0:
        fail(f"the sampler read no card memory during adv50k ({hbm[:5]})")
    # the pinned solves land no flight record, so the duty cycle reads
    # what the recorded solves before them left; (7) reads it across a
    # served solve that lands one
    snap = SAMPLER.snapshot()
    if not 0.0 <= snap["duty_cycle"] <= 1.0 or snap["overhead_frac"] >= 0.01:
        fail(f"sampler: duty cycle {snap['duty_cycle']}, overhead "
             f"{snap['overhead_frac']}")
    print(f"sampler during adv50k: kao_device_hbm_bytes max {max(hbm)}, "
          f"duty cycle {snap['duty_cycle']}, overhead_frac "
          f"{snap['overhead_frac']}, samples {snap['samples_total']}, avg "
          f"sample {snap['avg_sample_s']} s; the profiler's idle share of "
          f"the pinned adv50k solve {idle} ({power})")
    print("sampler snapshot: " + json.dumps(
        {k: snap[k] for k in ("enabled", "hz", "samples_total",
                              "overhead_frac", "duty_cycle", "devices",
                              "duty_totals", "roofline")}))

    # 3. jumbo at its defaults
    solve("jumbo", gen.SCENARIOS["jumbo"](), "jumbo at defaults")

    # 4. the roofline of everything above
    roof = prof.roofline()
    snapp = prof.snapshot()
    for row in snapp["executables"]:
        if row["flops"] is None or row["bytes_accessed"] is None:
            fail(f"roofline: key {row['key_id']} ({row['path']}, "
                 f"{row['scorer']}) has no analytic cost")
        over = {k: v for k, v in row.items()
                if k.startswith("occupancy_") and v is not None and v > 1.05}
        if over:
            fail(f"roofline: key {row['key_id']} reads {over}: above any "
                 "card")
    recs = [r for r in flight.recent() if r.get("ts", 0.0) >= t_unix]
    bad = [r.get("trace_id") for r in recs
           if not (r.get("ledger") or {}).get("ok")]
    if bad:
        fail(f"roofline: ledgers that do not sum to the wall: {bad}")
    ovh = prof.overhead()["seconds_total"]
    if ovh > 0.02 * sum(walls):
        fail(f"roofline: the profiler's own {ovh:.4f} s is over 2% of the "
             f"solves' {sum(walls):.3f} s")
    print(f"roofline ({len(snapp['executables'])} keys; peaks "
          + json.dumps(snapp["peaks"]) + f"; profiler overhead {ovh:.5f} s "
          f"of {sum(walls):.3f} s of solves; {len(recs)} ledgers ok): "
          + json.dumps(roof))
    print("roofline keys: " + json.dumps(
        [{k: r.get(k) for k in ("path", "scorer", "chains", "bucket",
                                "launches", "flops", "bytes_accessed",
                                "peak_hbm_bytes", "dispatches",
                                "window_s", "occupancy_flops",
                                "occupancy_hbm", "occupancy_hbm_p99")}
         for r in snapp["executables"]]))

    # 5. the profiled solve: the pinned decommission solve with a
    # torch.profiler trace, the plan equal to the unprofiled one
    with tempfile.TemporaryDirectory() as tmp:
        inst = build_instance(decom.current, decom.broker_list,
                              decom.topology, decom.target_rf)
        res = engine.solve_tpu(inst, profile_dir=tmp, **pinned, **no_race)
        files = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        if not files:
            fail(f"profile_dir: no trace file under it ({os.listdir(tmp)})")
        text = open(files[0]).read()
        missing = [f for f in ("score_grid", "site_sweep", "exchange_sweep")
                   if f not in text]
        if missing:
            fail(f"profile_dir: the trace names none of {missing}")
        if not (res.a == pinned_res.solve.a).all():
            fail("profile_dir: the profiled plan differs from the "
                 "unprofiled one")
        print(f"profile_dir: {os.path.basename(files[0])} "
              f"({len(text)} bytes) names score_grid, site_sweep and "
              "exchange_sweep; the plan equals the unprofiled one")

    # 6. the kernel-vs-torch bench at the headline's shape and adv50k's
    for scen in ("decommission", "adv50k"):
        rep = bench_kernel.kernel_vs_torch(scenario=scen)
        if rep.get("skipped") or rep["platform"] != "gpu":
            fail(f"kernel_vs_torch ({scen}) did not run on the card: "
                 f"{rep.get('skipped')}")
        rows = rep["rows"]
        if len(rows) != 6 or not all(r["parity"] for r in rows):
            fail(f"kernel_vs_torch ({scen}): "
                 + json.dumps([(r["name"], r["lanes"], r["parity"])
                               for r in rows]))
        if any(r["share"] > 1.05 for r in rows):
            fail(f"kernel_vs_torch ({scen}): a share of the bound over "
                 "1.05")
        print(f"kernel_vs_torch ({scen}, {rep['partitions']} partitions, "
              f"bucket {rep['bucket']}, {rep['chains']} chains; {power}): "
              + json.dumps(rows))

    # 7. the service's measurement surfaces: --slo, --sample-devices 10,
    # --flight-dir and --profile-dir as main() sets them
    with tempfile.TemporaryDirectory() as tmp:
        flight_dir = os.path.join(tmp, "flight")
        serve._oslo.ENGINE.configure(spec="solve:5:0.99")
        flight.configure(flight_dir)
        serve.OBS["flight_dir"] = flight_dir
        serve.OBS["profile_dir"] = os.path.join(tmp, "prof")
        serve.OBS["profile_solves"] = 1
        srv = serve.make_server(port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"

        def ok(path, payload=None):
            st, body, _wall = _http(url, path, payload)
            if st != 200:
                fail(f"service {path}: {st} {str(body)[:300]}")
            return body

        try:
            # the served decommission certifies in the host race (no
            # ladder, so no profiler session); the pinned adversarial
            # solve of (l) runs the ladder, the first of its bucket
            # under --profile-dir
            adv_sc = gen.adversarial()
            tids = []
            for scen, moves in ((decom, decom.min_moves_lb),
                                (decom, decom.min_moves_lb),
                                (adv_sc, 117)):
                body = ok("/submit", {
                    "assignment": scen.current.to_dict(),
                    "brokers": list(scen.broker_list),
                    "topology": scen.topology.to_dict(), "solver": "tpu",
                    "options": pinned})
                if body["report"]["replica_moves"] != moves:
                    fail(f"service: {body['report']['replica_moves']} "
                         f"moves, expected {moves}")
                tids.append(body["trace_id"])
            # the pinned adversarial solve once more (its bucket's profile
            # budget spent): the sampler's duty cycle across the request
            # (the recorded device_s + dispatch_s it added, over the
            # request's wall) beside a profiler session's idle share of it
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            d0 = SAMPLER.snapshot()["duty_totals"]
            kernels.reset_counts()
            with profile(activities=[ProfilerActivity.CUDA]) as p:
                t0 = time.perf_counter()
                body = ok("/submit", {
                    "assignment": adv_sc.current.to_dict(),
                    "brokers": list(adv_sc.broker_list),
                    "topology": adv_sc.topology.to_dict(), "solver": "tpu",
                    "options": pinned})
                torch.cuda.synchronize()
                req_wall = time.perf_counter() - t0
            d1 = SAMPLER.snapshot()["duty_totals"]
            counts = {k.name: k.launches for k in kernels.KERNELS}
            solved = {k: body["report"].get(f"solver_{k}") for k in (
                "engine", "final_cert", "dispatches", "dispatch_s",
                "device_s", "anneal_s")}
            # why its ladder stopped where it did (the JAX package's
            # service stops the same request at the same boundary on the
            # CPU: the savings gate reads the chunk time, which the
            # profiler session stretches)
            stop = _stop_reason(body["report"],
                                ok(f"/debug/solves/{body['trace_id']}"))
            busy = sum(e.time_range.elapsed_us() for e in p.events()
                       if e.device_type == DeviceType.CUDA) / 1e6
            duty = ((d1["device_s"] + d1["dispatch_s"] - d0["device_s"]
                     - d0["dispatch_s"]) / req_wall)
            if d1["solves"] != d0["solves"] + 1 or not 0.0 < duty <= 1.0:
                fail(f"sampler duty cycle across the served adversarial "
                     f"solve: {duty} ({d0} -> {d1}, wall {req_wall:.3f} s)")
            duty_line = (
                f"served pinned adversarial solve: sampler duty cycle "
                f"{duty:.4f} (recorded dispatch_s + device_s "
                f"{duty * req_wall:.4f} s of the request's {req_wall:.3f} "
                "s); profiler idle share "
                + (f"{1 - busy / req_wall:.4f} (device busy {busy:.4f} s)"
                   if busy else "not measured (no device event kept)")
                + f", sampler EWMA {SAMPLER.snapshot()['duty_cycle']}; "
                f"launches {json.dumps(counts)}; the solve "
                + json.dumps(solved) + f"; stop: {stop} ({power})")
            profd = ok("/debug/profile")
            slo = ok("/debug/slo")
            hz = ok("/healthz")
            _st, metrics, _w = _http(url, "/metrics")
            chrome = ok(f"/debug/solves/{tids[-1]}?format=chrome")
            report = ok(f"/debug/solves/{tids[-1]}")
        finally:
            srv.shutdown()
            srv.server_close()
            serve.OBS["profile_dir"] = None
        if not profd["roofline"] or not profd["attribution"]:
            fail(f"/debug/profile: {json.dumps(profd)[:300]}")
        if not {"slo", "drift", "flight"} <= set(slo):
            fail(f"/debug/slo keys {sorted(slo)}")
        if not hz["devices"]["enabled"] or not hz["devices"]["devices"] \
                or "slo" not in hz:
            fail(f"/healthz devices/slo: {json.dumps(hz['devices'])[:300]}")
        fams = {ln.split()[2] for ln in metrics.splitlines()
                if ln.startswith("# TYPE")}
        for pre in ("kao_slo_", "kao_drift_", "kao_device_", "kao_prof_"):
            if not any(f.startswith(pre) for f in fams):
                fail(f"/metrics has no {pre}* family")
        if not chrome.get("traceEvents"):
            fail("?format=chrome: no traceEvents")
        traces = glob.glob(os.path.join(tmp, "prof", "**",
                                        "*.pt.trace.json"), recursive=True)
        if len(traces) != 1:
            fail(f"--profile-dir: {len(traces)} traces of the served "
                 "ladders, expected the adversarial solve's one")
        rep_path = os.path.join(tmp, "report.json")
        with open(rep_path, "w") as f:
            json.dump(report, f)
        cli = [sys.executable, "-m",
               "kafka_assignment_optimizer_tpu_torch.obs.trace_cli",
               "convert", rep_path]
        out = subprocess.run(cli, capture_output=True, text=True,
                             timeout=300)
        if out.returncode != 0 or json.loads(out.stdout) != chrome:
            fail(f"trace_cli convert: rc {out.returncode}, "
                 f"{out.stderr[-300:]}")
        out = subprocess.run(
            [sys.executable, "-m",
             "kafka_assignment_optimizer_tpu_torch.obs.prof", flight_dir,
             "--json"], capture_output=True, text=True, timeout=300)
        offline = json.loads(out.stdout) if out.returncode == 0 else {}
        if not {"records", "attribution", "worst_solves"} <= set(offline):
            fail(f"obs.prof over the flight dir: rc {out.returncode}, "
                 f"{out.stderr[-300:]}")
        flight.configure(None)
        serve.OBS["flight_dir"] = None
    SAMPLER.configure(None)
    print(f"service measurement surfaces: /debug/profile "
          f"{len(profd['roofline'])} buckets, attribution "
          + json.dumps(profd["attribution"])
          + f"; /debug/slo status {slo['slo'].get('status')}, drift "
          f"alarms {slo['drift'].get('alarms_total')}; /healthz devices "
          + json.dumps(hz["devices"]["devices"])
          + f" duty {hz['devices']['duty_cycle']}; /metrics "
          f"{len(fams)} families; chrome {len(chrome['traceEvents'])} "
          f"events = trace_cli convert; obs.prof over the flight dir: "
          f"{offline['records']} records")
    print(duty_line)
    print(f"measurement phase: {time.perf_counter() - t_phase:.3f} s")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_up(url: str, proc, what: str, timeout_s: float = 180.0) -> None:
    """Poll ``url/healthz`` until it answers 200; fail if the process
    exits first or the time runs out."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if proc.poll() is not None:
            fail(f"{what} exited with {proc.returncode} before serving")
        try:
            if _http(url, "/healthz")[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.25)
    fail(f"{what} did not answer /healthz within {timeout_s:.0f} s")


def _stop_reason(rep: dict, trace: dict | None) -> str:
    """Why a served solve's ladder stopped, from its report and its
    solve trace: every chunk run and final selection, the boundary
    certificate (the chunk after it already in flight), an adopted
    constructor plan, or the deadline."""
    spans = list(_spans(trace["spans"])) if trace else []
    lad = next((sp for sp in spans if sp["name"] == "ladder"), None)
    attrs = (lad or {}).get("attrs") or {}
    adopted = any(sp["name"] == "adopt"
                  and (sp.get("attrs") or {}).get("certified")
                  and "boundary" in (sp.get("attrs") or {})
                  for sp in spans)
    n = rep.get("solver_dispatches")
    if lad is None or attrs.get("skipped"):
        return (f"no ladder: {rep.get('solver_engine')}/"
                f"{rep.get('solver_construct_path')} certified on the host")
    if attrs.get("timed_out"):
        return f"the deadline after {attrs.get('rounds_run')} sweeps"
    if attrs.get("boundary_certified"):
        how = ("the constructor race's certified plan adopted"
               if adopted else "the boundary certificate (moves at the "
               "lower bound, weight at the upper bound)")
        return (f"{how} at a chunk boundary after "
                f"{attrs.get('rounds_run')} sweeps of {attrs.get('chunks')}"
                f" chunks; {n} dispatches (the next chunk was in flight)")
    return (f"every chunk ({n} dispatches, {attrs.get('rounds_run')} "
            f"sweeps), final selection {rep.get('solver_final_cert')}")


def fleet_phase(torch, power: str, device: str = "cuda") -> None:
    """(n) Fleet and rollout (see the module docstring): two workers, each
    a process of its own on the card, behind ``kao-router``; every process
    the phase starts is stopped in its ``finally``, and a failure still
    ends the run non-zero."""
    import shutil
    import signal

    from kafka_assignment_optimizer_tpu_torch.fleet import affinity
    from kafka_assignment_optimizer_tpu_torch.models.cluster import (
        Assignment,
    )
    from kafka_assignment_optimizer_tpu_torch.models.instance import (
        build_instance,
    )
    from kafka_assignment_optimizer_tpu_torch.rollout import waves as rw
    from kafka_assignment_optimizer_tpu_torch.utils import gen

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="kao-fleet-")
    watch_dir = os.path.join(tmp, "watch")
    flights = [os.path.join(tmp, f"flight{i}") for i in (1, 2)]
    ports = [_free_port() for _ in range(3)]
    urls = [f"http://127.0.0.1:{p}" for p in ports[:2]]
    rurl = f"http://127.0.0.1:{ports[2]}"
    procs: dict = {}
    logs: list = []
    pinned = {"engine": "sweep", "batch": 8, "rounds": 128,
              "portfolio": False}

    def start(name, args):
        log = open(os.path.join(tmp, f"{name}.log"), "w")
        logs.append(log)
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", *args], cwd=root, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True)
        return procs[name]

    def ok(url, path, payload=None, want=200):
        st, body, wall = _http(url, path, payload)
        if st != want:
            fail(f"fleet {path} at {url}: {st} {str(body)[:400]}")
        return body, wall

    def payload(scen, **extra):
        return {"assignment": scen.current.to_dict(),
                "brokers": list(scen.broker_list),
                "topology": scen.topology.to_dict(), **extra}

    # a terminated run still stops the processes it started
    old_term = signal.signal(signal.SIGTERM,
                             lambda *_a: fail("terminated"))
    try:
        # 1. the fleet: two workers on the card, a shared watch dir, a
        # flight dir each (worker 1 names worker 2 as its fleet peer),
        # the router in front of them
        t0 = time.perf_counter()
        for i in (0, 1):
            start(f"worker{i + 1}", [
                "kafka_assignment_optimizer_tpu_torch.serve", "--port",
                str(ports[i]), "--device", device, "--watch-dir",
                watch_dir, "--flight-dir", flights[i], "--sample-devices",
                "5", "--rollout-packer", "scored", "--rollout-lanes", "8",
                *(["--fleet-peers", urls[1]] if i == 0 else [])])
        router = start("router", [
            "kafka_assignment_optimizer_tpu_torch.fleet.router", "--port",
            str(ports[2]), "--workers", ",".join(urls),
            "--health-interval-s", "0.5"])
        for i, u in enumerate(urls):
            _wait_up(u, procs[f"worker{i + 1}"], f"worker {i + 1}")
        _wait_up(rurl, router, "the router")
        with open(f"/proc/{router.pid}/maps") as f:
            mapped = {ln.split()[-1] for ln in f if "/" in ln}
        heavy = sorted(p for p in mapped if any(
            s in p for s in ("/torch/", "libtorch", "/jax/", "/jaxlib/")))
        probe = subprocess.run(
            [sys.executable, "-c",
             "import sys, kafka_assignment_optimizer_tpu_torch.fleet.router"
             "; print(sorted(n for n in ('torch', 'jax') "
             "if n in sys.modules))"],
            cwd=root, capture_output=True, text=True, timeout=120)
        if heavy or probe.stdout.strip() != "[]":
            fail(f"the router loaded torch or jax: {heavy[:4]} "
                 f"{probe.stdout.strip()} {probe.stderr[-300:]}")
        print(f"fleet: 2 workers ({device}) + kao-router up in "
              f"{time.perf_counter() - t0:.3f} s; the router process maps "
              f"no torch or jax library ({len(mapped)} files mapped) and "
              "its import loads neither")

        # 2. fleet warmup through the router, at the shapes of the
        # requests below (their bucket keys): each bucket to its
        # rendezvous owner once, then spread; no worker builds a kernel
        decom = gen.SCENARIOS["decommission"]()
        adv50k = gen.SCENARIOS["adv50k"]()
        adv = gen.adversarial()
        shapes = []
        for scen in (decom, adv50k):
            b, k, p, r = affinity.payload_shape(payload(scen))
            shapes.append({"brokers": b, "partitions": p, "rf": r,
                           "racks": k})
        out, wall = ok(rurl, "/warmup", {"shapes": shapes,
                                         "engine": "sweep"})
        for owner, shs in out["partition"].items():
            for sh in shs:
                key = affinity.shape_key(sh["brokers"], sh["partitions"],
                                         sh["rf"], sh["racks"])
                if affinity.rendezvous_rank(key, urls)[0] != owner:
                    fail(f"warmup: {sh} went to {owner}, not its owner")
        owned = sorted(json.dumps(sh, sort_keys=True)
                       for shs in out["partition"].values() for sh in shs)
        if owned != sorted(json.dumps(sh, sort_keys=True) for sh in shapes):
            fail(f"warmup partition {out['partition']}")
        if out.get("errors") or out["fresh_compiles"] != 0 \
                or out["spread_fresh_compiles"] != 0:
            fail(f"warmup: errors {out.get('errors')}, fresh compiles "
                 f"{out['fresh_compiles']} / "
                 f"{out['spread_fresh_compiles']} (want 0 / 0)")
        mem = {}
        for i, u in enumerate(urls):
            hz, _w = ok(u, "/healthz")
            mem[f"worker{i + 1}"] = hz["devices"]["devices"]
        print(f"fleet warmup (decommission and adv50k at their requests' "
              f"shapes): wall {wall:.3f} s ({power}); partition "
              + json.dumps({u[-5:]: [(s["brokers"], s["partitions"],
                                      s["rf"], s["racks"]) for s in shs]
                            for u, shs in out["partition"].items()})
              + "; persistent misses 0 in both phases; card memory "
              + json.dumps(mem))

        # 3. pinned solves through the router, each against the same
        # request sent to the answering worker directly, each run's stop
        # reason printed. The pinned decommission request certifies in
        # the host race (the race cannot be switched off over HTTP); the
        # adversarial one reaches the kernels, as one chunk of 16
        # sweeps: a ladder of several chunks may stop at its first
        # boundary or run on, as the certificate's savings gate reads
        # the chunk time, so only one chunk compares two runs exactly
        routed = {}
        for name, scen, opts in (
                ("decommission", decom, pinned),
                ("adversarial", adv, {**pinned, "rounds": 16})):
            req = payload(scen, solver="tpu", options=opts)
            first, f_wall = ok(rurl, "/submit", req)
            wurl = first["route"]["worker"]
            ftrace, _w = ok(wurl, f"/debug/solves/{first['trace_id']}")
            # the router sees the bucket in the worker's ledger (its
            # health poll) before the request it should route warm
            key = list(affinity.bucket_key_of(req))
            t0 = time.perf_counter()
            while True:
                hz0, _w = ok(rurl, "/healthz")
                if key in hz0["fleet"]["workers"][wurl]["warm_buckets"]:
                    break
                if time.perf_counter() - t0 > 30:
                    fail(f"the router never saw {key} warm on {wurl}")
                time.sleep(0.2)
            before = ok(wurl, "/debug/kernels")[0]["launches"]
            body, r_wall = ok(rurl, "/submit", req)
            after = ok(wurl, "/debug/kernels")[0]["launches"]
            hz1, _w = ok(rurl, "/healthz")
            counts = {k: after[k] - before[k] for k in after}
            hits = (hz1["counters"]["affinity_hits_total"]
                    - hz0["counters"]["affinity_hits_total"])
            trace, _w = ok(wurl, f"/debug/solves/{body['trace_id']}")
            direct, d_wall = ok(wurl, "/submit", req)
            dtrace, _w = ok(wurl, f"/debug/solves/{direct['trace_id']}")
            rep, drep = body["report"], direct["report"]
            same = (body["assignment"] == direct["assignment"]
                    and rep["replica_moves"] == drep["replica_moves"]
                    and rep.get("solver_dispatches")
                    == drep.get("solver_dispatches"))
            print(f"routed pinned {name} (the first of its key on worker "
                  f":{wurl[-5:]}): {first['report']['replica_moves']} "
                  f"moves, dispatches "
                  f"{first['report'].get('solver_dispatches')}, stop: "
                  f"{_stop_reason(first['report'], ftrace)}; wall "
                  f"{f_wall:.3f} s. Again through the router: "
                  f"{rep['replica_moves']} moves, weight "
                  f"{rep['objective_weight']}, proven "
                  f"{rep['proven_optimal']}, dispatches "
                  f"{rep.get('solver_dispatches')}, stop: "
                  f"{_stop_reason(rep, trace)}; wall {r_wall:.3f} s; "
                  f"launches {json.dumps(counts)}; affinity hit "
                  f"+{hits}. Direct to the worker: "
                  f"{drep['replica_moves']} moves, dispatches "
                  f"{drep.get('solver_dispatches')}, stop: "
                  f"{_stop_reason(drep, dtrace)}; wall {d_wall:.3f} s; "
                  f"equal: {same} ({power})")
            if not same:
                fail(f"routed pinned {name} differs from the direct one")
            if body["route"]["worker"] != wurl or hits != 1:
                fail(f"routed pinned {name} again: worker "
                     f"{body['route']['worker']}, affinity hits +{hits}")
            for out in (first, body):
                if not out["report"]["feasible"]:
                    fail(f"routed pinned {name}: infeasible")
                inst = build_instance(scen.current, scen.broker_list,
                                      scen.topology)
                a = inst.encode(Assignment.from_dict(out["assignment"]))
                if not inst.is_feasible(a) or inst.move_count(a) \
                        != out["report"]["replica_moves"]:
                    fail(f"routed pinned {name}: the numpy oracle "
                         "disagrees")
                if device == "cuda":
                    b1_holds(torch, torch.device("cuda"), inst, a,
                             f"routed pinned {name}")
            routed[name] = (body, wurl, counts, rep)
        counts = routed["adversarial"][2]
        if device == "cuda" and not all(counts.values()):
            fail(f"routed pinned adversarial: a kernel never launched on "
                 f"the worker: {counts}")
        # one trace across router and worker
        tid = routed["adversarial"][0]["trace_id"]
        merged, _w = ok(rurl, f"/debug/traces/{tid}")
        chrome, _w = ok(rurl, f"/debug/traces/{tid}?format=chrome")
        names = {sp["name"] for sp in _spans(merged["root"]["spans"])}
        wrep = [p for p in merged["processes"] if p["attached_to"]]
        pids = sorted({e["pid"] for e in chrome["traceEvents"]})
        wnames = {sp["name"] for p in wrep
                  for sp in _spans(p["report"]["spans"])}
        if not {"attempt"} <= names or not wrep \
                or {p["report"]["trace_id"] for p in wrep} != {tid} \
                or "ladder" not in wnames or pids[:2] != [1, 2]:
            fail(f"merged trace {tid}: router spans {sorted(names)}, "
                 f"worker processes {len(wrep)}, pids {pids}")
        print(f"merged trace {tid}: router spans {sorted(names)}; worker "
              f"spans {sorted(wnames)[:8]}... attached under one trace "
              f"ID; chrome pids {pids} ({len(chrome['traceEvents'])} "
              "events)")

        # 4. rollouts at published size through the router
        def rollout(cid, scen, moves_want, mid_event=None):
            brokers = sorted(set(scen.current.broker_ids())
                             | set(scen.broker_list))
            drained = sorted(set(brokers) - set(scen.broker_list))
            topo = scen.topology.to_dict()
            t0 = time.perf_counter()
            ok(rurl, f"/clusters/{cid}/events", {
                "type": "bootstrap", "epoch": 1,
                "assignment": scen.current.to_dict(), "brokers": brokers,
                "topology": topo})
            ev, ev_wall = ok(rurl, f"/clusters/{cid}/events", {
                "type": "broker_drain", "epoch": 2, "brokers": drained})
            if ev["report"]["replica_moves"] != moves_want \
                    or not ev["report"]["proven_optimal"]:
                fail(f"{cid}: the drain's plan has "
                     f"{ev['report']['replica_moves']} moves, proven "
                     f"{ev['report']['proven_optimal']}; want "
                     f"{moves_want}, proven")
            view, w_start = ok(rurl, f"/clusters/{cid}/rollout/start",
                               {"epoch": 1})
            # the ground truth start rewound to: the pre-plan assignment
            info, _w = ok(rurl, f"/clusters/{cid}")
            base = {(p["topic"], p["partition"]): p["replicas"]
                    for p in info["assignment"]["partitions"]}
            local = rw.pack_waves(
                Assignment.from_dict(info["assignment"]),
                Assignment.from_dict(info["plan"]), scen.topology,
                caps=rw.WaveCaps(), packer="scored", lanes=8)
            if view["waves"] != local.makespan or view["caps"] \
                    != local.caps.to_dict() or not rw.verify_caps(local):
                fail(f"{cid}: served {view['waves']} waves, caps "
                     f"{view['caps']}; the local packing "
                     f"{local.makespan}, {local.caps.to_dict()}")
            truth = dict(base)
            ep, steps, replanned = 2, [], None
            view, w = ok(rurl, f"/clusters/{cid}/rollout/advance",
                         {"epoch": ep})
            steps.append(w)
            extra = {"canary_ok": True}
            while view["status"] in ("canary", "advancing"):
                wave = view["current_wave"]
                loads: dict = {}
                racks: dict = {}
                for p in wave["partitions"]:
                    old = truth[(p["topic"], p["partition"])]
                    src = old[0] if old else None
                    for b in (b for b in p["replicas"] if b not in old):
                        loads[b] = loads.get(b, 0) + 1
                        r = scen.topology.rack(b)
                        racks[r] = racks.get(r, 0) + 1
                        if src is not None:
                            loads[src] = loads.get(src, 0) + 1
                if max(loads.values(), default=0) > view["caps"]["broker"] \
                        or max(racks.values(), default=0) \
                        > view["caps"]["rack"]:
                    fail(f"{cid}: wave {view['wave_index']} breaks its "
                         f"caps {view['caps']}")
                ep += 1
                view, w = ok(rurl, f"/clusters/{cid}/rollout/advance",
                             {"epoch": ep, **extra})
                steps.append(w)
                extra = {}
                for p in wave["partitions"]:
                    truth[(p["topic"], p["partition"])] = p["replicas"]
                got, _w = ok(rurl, f"/clusters/{cid}")
                now = {(p["topic"], p["partition"]): p["replicas"]
                       for p in got["assignment"]["partitions"]}
                if now != truth:
                    fail(f"{cid}: after wave {view['wave_index'] - 1} the "
                         "worker's ground truth is not the base with the "
                         "applied waves")
                if mid_event and replanned is None \
                        and view["status"] == "advancing":
                    applied = [s for s in view["wave_summary"]
                               if s["applied"]]
                    ev, _w = ok(rurl, f"/clusters/{cid}/events",
                                {**mid_event, "epoch": 3})
                    after, _w = ok(rurl, f"/clusters/{cid}/rollout")
                    kept = [s for s in after["wave_summary"]
                            if s["index"] < len(applied)]
                    tr, _w = ok(rurl, f"/debug/traces/"
                                      f"{ev['report']['trace_id']}")
                    roots = [(p["report"]["spans"].get("attrs") or {})
                             .get("rollout_root")
                             for p in tr["processes"]]
                    if after["replans"] != 1 or kept != applied \
                            or view["trace_id"] not in roots:
                        fail(f"{cid}: the mid-rollout event: replans "
                             f"{after['replans']}, applied waves kept "
                             f"{kept == applied}, rollout_root {roots}")
                    replanned = (len(applied), view["waves"],
                                 after["waves"],
                                 ev["report"]["replica_moves"])
                    view = after
            if view["status"] != "done":
                fail(f"{cid}: the rollout ended {view['status']}")
            got, _w = ok(rurl, f"/clusters/{cid}")
            if got["assignment"] != got["plan"]:
                fail(f"{cid}: the assignment at the end is not the plan")
            print(f"rollout {cid} ({scen.name}, {len(base)} partitions): "
                  f"drain plan {moves_want} moves (event wall "
                  f"{ev_wall:.3f} s), scored packer winner lane "
                  f"{local.winner_lane} of {local.lanes_raced}, "
                  f"{local.makespan} waves under caps "
                  f"{json.dumps(local.caps.to_dict())}, peak broker "
                  f"{local.peak_broker}, peak rack {local.peak_rack}"
                  + (f"; mid-rollout event after {replanned[0]} waves: "
                     f"{replanned[1]} -> {replanned[2]} waves, re-plan "
                     f"{replanned[3]} moves, rollout_root linked"
                     if replanned else "")
                  + f"; start {w_start:.3f} s, steps s "
                  + json.dumps([round(s, 3) for s in steps])
                  + f", total {time.perf_counter() - t0:.3f} s ({power})")
            return view

        rollout("prod", decom, decom.min_moves_lb)
        brokers = sorted(adv50k.broker_list)
        second = next(b for b in brokers
                      if adv50k.topology.rack(b) != adv50k.topology.rack(
                          brokers[0]))
        rollout("big", adv50k, adv50k.min_moves_lb,
                mid_event={"type": "broker_drain", "brokers": [second]})
        # a rollback to the pre-rollout assignment, and a stale epoch
        brokers = sorted(set(decom.current.broker_ids())
                         | set(decom.broker_list))
        ok(rurl, "/clusters/prod/events", {
            "type": "bootstrap", "epoch": 3,
            "assignment": decom.current.to_dict(), "brokers": brokers,
            "topology": decom.topology.to_dict()})
        ok(rurl, "/clusters/prod/events", {
            "type": "broker_drain", "epoch": 4,
            "brokers": sorted(set(brokers) - set(decom.broker_list))})
        ok(rurl, "/clusters/prod/rollout/start", {"epoch": 100})
        pre, _w = ok(rurl, "/clusters/prod")
        ok(rurl, "/clusters/prod/rollout/advance", {"epoch": 101})
        ok(rurl, "/clusters/prod/rollout/advance",
           {"epoch": 102, "canary_ok": True})
        ok(rurl, "/clusters/prod/rollout/advance", {"epoch": 103})
        mid, _w = ok(rurl, "/clusters/prod")
        back, _w = ok(rurl, "/clusters/prod/rollout/rollback",
                      {"epoch": 104})
        post, _w = ok(rurl, "/clusters/prod")
        if json.dumps(post["assignment"], sort_keys=True) != json.dumps(
                pre["assignment"], sort_keys=True) \
                or mid["assignment"] == pre["assignment"]:
            fail("rollback: the assignment is not the pre-rollout one")
        rec = os.path.join(watch_dir, "rollout", "prod.json")
        with open(rec, "rb") as f:
            disk0 = f.read()
        stale, _w = ok(rurl, "/clusters/prod/rollout/advance",
                       {"epoch": 104}, want=409)
        with open(rec, "rb") as f:
            disk1 = f.read()
        if stale.get("reason") != "stale_rollout_epoch" \
                or stale.get("current_rollout_epoch") != 104 \
                or disk1 != disk0:
            fail(f"stale rollout epoch: {stale}, store untouched "
                 f"{disk1 == disk0}")
        print(f"rollback after {len(back['inverse_waves'])} applied "
              "waves: the assignment is the pre-rollout one, bit for bit; "
              "a stale rollout epoch answers 409 stale_rollout_epoch "
              "(current 104) and leaves the record on disk unchanged")

        # 5. kao-fleet over both flight dirs, and /debug/fleet. Which
        # worker served the routed work above follows the rendezvous
        # hash of the workers' (random) ports, so one demo solve is sent
        # to each worker directly: both flight dirs hold a record
        demo = gen.demo()
        for u in urls:
            body, _w = ok(u, "/submit", payload(demo, solver="milp"))
            if body["report"]["replica_moves"] != 1:
                fail(f"demo /submit at {u}: {body['report']}")

        def kao_fleet(*dirs):
            r = subprocess.run(
                [sys.executable, "-m",
                 "kafka_assignment_optimizer_tpu_torch.obs.fleet", *dirs,
                 "--format", "json"], cwd=root, capture_output=True,
                text=True, timeout=300)
            if r.returncode != 0:
                fail(f"kao-fleet {dirs}: rc {r.returncode} "
                     f"{r.stderr[-300:]}")
            return json.loads(r.stdout)

        each = [kao_fleet(d)["records"] for d in flights]
        both = kao_fleet(*flights)
        view, _w = ok(urls[0], "/debug/fleet")
        if both["records"] != sum(each) or both["workers"] != 2 \
                or view["records"] != both["records"]:
            fail(f"kao-fleet: {both['records']} merged of {each}; "
                 f"/debug/fleet on worker 1 {view['records']}")
        print(f"kao-fleet over both flight dirs: {both['records']} records "
              f"= {each[0]} + {each[1]}, 2 workers; worker 1's "
              f"/debug/fleet (--fleet-peers worker 2): {view['records']}")

        # 6. failover: SIGKILL the owner of decommission's bucket
        owner = routed["decommission"][1]
        victim = f"worker{urls.index(owner) + 1}"
        survivor = urls[1 - urls.index(owner)]
        prod_before, _w = ok(rurl, "/clusters/prod")
        os.killpg(procs[victim].pid, signal.SIGKILL)
        procs[victim].wait(timeout=60)
        body, f_wall = ok(rurl, "/submit", payload(
            decom, solver="tpu", options=pinned))
        if body["route"]["worker"] != survivor or body["assignment"] \
                != routed["decommission"][0]["assignment"]:
            fail(f"failover: answered by {body['route']['worker']}, the "
                 "same plan: "
                 f"{body['assignment'] == routed['decommission'][0]['assignment']}")
        t0 = time.perf_counter()
        while True:
            hz, _w = ok(rurl, "/healthz")
            if owner not in hz["fleet"]["live"]:
                break
            if time.perf_counter() - t0 > 30:
                fail(f"the router still counts {owner} live")
            time.sleep(0.25)
        prod_after, _w = ok(rurl, "/clusters/prod")
        if prod_after["assignment"] != prod_before["assignment"]:
            fail("/clusters/prod after the failover differs")
        print(f"failover: {victim} (decommission's bucket owner) killed; "
              f"the pinned request answered by the other worker with the "
              f"same plan, wall {f_wall:.3f} s; router retries "
              + json.dumps(hz["counters"]["retries_total"])
              + f", exhausted {hz['counters']['exhausted_total']}; "
              f"/healthz live {len(hz['fleet']['live'])} of 2; "
              "/clusters/prod read back equal through the shared watch "
              "dir")
        if hz["counters"]["exhausted_total"]:
            fail("the router dropped a request")
    finally:
        for name, p in procs.items():
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGTERM)
                    p.wait(timeout=20)
                except (OSError, subprocess.TimeoutExpired):
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait(timeout=20)
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
        signal.signal(signal.SIGTERM, old_term)
    print(f"fleet phase: {time.perf_counter() - t_phase:.3f} s")


# phase (o)'s child: one process of a two-process group on the card, its
# launcher's environment naming the group; it solves the pinned solo on
# its own chain shard and prints the plan, its launches and its times
_MESH_CHILD = r"""
import json, sys
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance)
from kafka_assignment_optimizer_tpu_torch.ops import kernels
from kafka_assignment_optimizer_tpu_torch.parallel import distributed as dist
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine
from kafka_assignment_optimizer_tpu_torch.utils import gen
device, kw = sys.argv[1], json.loads(sys.argv[2])
rank, world = dist.init_distributed(device=device)
s = gen.adversarial()
inst = build_instance(s.current, s.broker_list, s.topology)
if device == "cuda":
    kernels.build_all()
kernels.reset_counts()
res = engine.solve_tpu(inst, device=device, **kw)
print(json.dumps({
    "rank": rank, "world": world, "backend": dist.backend(),
    "a": res.a.tolist(), "moves": res.stats["moves"],
    "devices": res.stats["devices"], "mesh": res.stats["mesh"],
    "anneal_s": res.stats["anneal_s"], "wall": res.wall_clock_s,
    "launches": {k.name: k.launches for k in kernels.KERNELS}}))
dist.shutdown_distributed()
"""


def mesh_phase(torch, power: str, device: str = "cuda") -> None:
    """(o) The sharded mesh (see the module docstring): the runs on the
    mesh ``[cuda:0, cuda:0]`` (two chain shards on the one card, one
    launch of each kernel a stage for both) held equal to the CPU's
    two-shard run, the batch's splits and the search over two blocks on
    the card (``[cuda:0, cuda]``); the two-process run's children are
    stopped in the ``finally``, and a failure still ends the run
    non-zero. ``device`` ``"cpu"`` rehearses the phase on the CPU."""
    import signal

    import numpy as np

    from kafka_assignment_optimizer_tpu_torch import prng
    from kafka_assignment_optimizer_tpu_torch.models.instance import (
        build_instance,
    )
    from kafka_assignment_optimizer_tpu_torch.ops import kernels
    from kafka_assignment_optimizer_tpu_torch.parallel import mesh as pm
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import (
        anneal,
        arrays,
        bucket,
        engine,
        sweep,
    )
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu.seed import (
        greedy_seed,
    )
    from kafka_assignment_optimizer_tpu_torch.utils import gen

    t_phase = time.perf_counter()
    card = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    two = [card, card]
    # two positions the mesh keeps apart on the one device (a device
    # with and without its index): a block each
    spread = [torch.device(device, 0), torch.device(device)]
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # the migration's host time: sweep._migrate_blocks (the sweep's
    # snapshot) and anneal._migrate_blocks (the chain round's end) timed
    # around each call; the ladder is host-bound, so its host time is
    # its cost
    mig = {"s": 0.0}
    real = {mod: mod._migrate_blocks for mod in (sweep, anneal)}

    def timed_migration(fn):
        def run(*args):
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                mig["s"] += time.perf_counter() - t

        return run

    def counted(label, fn):
        """``fn()`` with the launch counts and the migration's time set
        to 0 just before it and read just after: ``(result, wall,
        launches, migration s)``."""
        kernels.reset_counts()
        mig["s"] = 0.0
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
        return (out, wall, {k.name: k.launches for k in kernels.KERNELS},
                mig["s"])

    def share(mig_s, anneal_s):
        return f"{mig_s / anneal_s:.4f}" if anneal_s > 0 else "n/a"

    def same(label, x, y):
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            fail(f"mesh {label}: the card's run differs from the CPU's")

    procs = []
    old_term = signal.signal(signal.SIGTERM, lambda *_a: fail("terminated"))
    for mod in real:
        mod._migrate_blocks = timed_migration(real[mod])
    try:
        # 1. the pinned adversarial solo on two shards: plan, moves,
        # curve and launches; one launch of each kernel a stage for both
        # shards, the launches of one shard's ladder
        scen = gen.adversarial()
        inst = build_instance(scen.current, scen.broker_list, scen.topology)
        solo = dict(seed=0, engine="sweep", batch=8, rounds=16,
                    portfolio=False, cert_min_savings_s=float("inf"))
        runs = {}
        for where, kw in (("card", dict(device=two)),
                          ("cpu", dict(device="cpu"))):
            runs[where] = counted(where, lambda kw=kw: engine.solve_tpu(
                inst, n_devices=2, **solo, **kw))
        (res, wall, counts, mig_s), cpu = runs["card"], runs["cpu"][0]
        st = res.stats
        same("solo plan", res.a, cpu.a)
        for f in ("moves", "score_curve", "rounds_run", "devices",
                  "chains_per_device", "final_cert"):
            if st[f] != cpu.stats[f]:
                fail(f"mesh solo: {f} {st[f]} on the card, {cpu.stats[f]} "
                     "on the CPU")
        if (st["devices"], st["chains_per_device"]) != (2, 4) or \
                st["mesh"]["devices"] != [str(card)] * 2:
            fail(f"mesh solo: ran on {st['mesh']}, {st['devices']} shards "
                 f"of {st['chains_per_device']}")
        chunk = st["rounds_run"] // st["dispatches"]
        per = sweep.stage_counts(chunk)
        expect = {k: v * st["dispatches"] for k, v in per.items()}
        expect["B1 score"] += 3  # the seed, final selection, verification
        if on_card and counts != expect:
            fail(f"mesh solo: launches {counts}, expected {expect} (one a "
                 "stage for both shards)")
        print(f"mesh solo (adversarial, 2 shards x 4 chains x 16 sweeps on "
              f"{[str(d) for d in two]}): plan equal to the CPU's "
              f"two-shard run, {st['moves']} moves, weight {res.objective}, "
              f"final_cert {st.get('final_cert')}, wall {wall:.3f} s, "
              f"anneal_s {st['anneal_s']}, migration {mig_s:.4f} s "
              f"(share of anneal_s {share(mig_s, st['anneal_s'])}), "
              f"launches {json.dumps(counts)} ({power})")
        # the two-shard solo against the one-shard solo (the same knobs:
        # 8 chains in all), in the order 2 1 1 2 on the warm process
        walls = {1: [], 2: []}
        for n in (2, 1, 1, 2):
            r_n, w_n, _c, m_n = counted(f"solo {n}", lambda n=n: (
                engine.solve_tpu(inst, n_devices=n, device=[card] * n,
                                 **solo)))
            walls[n].append((w_n, r_n.stats["anneal_s"], m_n))
        print("mesh solo warm, order 2 1 1 2 (wall s, anneal_s, migration "
              "s): two shards " + json.dumps(walls[2]) + ", one shard "
              + json.dumps(walls[1]) + f" ({power})")
        # each shard's winners of one chunk, through solve_on_mesh
        Pp, Rp = bucket.bucket_shape(inst)
        seed_np = np.asarray(greedy_seed(inst), np.int32)
        temps = arrays.geometric_temps(2.0, 0.02, 16)[:8]
        outs = {}
        for where, dev, scorer, mesh in (
                ("card", card, "cuda" if on_card else "torch",
                 pm.make_mesh(device=two)),
                ("cpu", torch.device("cpu"), "torch",
                 pm.make_mesh(2, device="cpu"))):
            m = arrays.from_instance(inst, dev, num_parts=Pp, max_rf=Rp)
            seed = torch.from_numpy(arrays.pad_candidate(seed_np, m)).to(dev)
            st0 = pm.init_sweep_state(m, seed, prng.PRNGKey(0), 4, mesh)
            outs[where] = [x.cpu() for x in pm.solve_on_mesh(
                m, seed, None, mesh, 4, 8, 1, engine="sweep", temps=temps,
                scorer=scorer, state=st0)[1:]]
        for name, x, y in zip(("best_a", "best_k", "curve"), outs["card"],
                              outs["cpu"]):
            same(f"per-shard {name}", x, y)
        print(f"mesh per-shard winners (one chunk of 8 sweeps): best_k "
              f"{outs['card'][1].tolist()} on both devices")

        # 2. a batch of 4 adversarial instances on two shards over two
        # blocks under both splits: equal plans
        insts4 = [build_instance(x.current, x.broker_list, x.topology)
                  for x in (gen.adversarial(seed=i) for i in range(4))]
        bkw = dict(seeds=0, engine="sweep", batch=8, rounds=16)
        plans = {}
        saved = os.environ.get(pm.MESH_ENV)
        try:
            for spec in ("2x1", "1x2"):
                os.environ[pm.MESH_ENV] = spec
                out, wall_b, counts_b, mig_b = counted(
                    spec, lambda: engine.solve_tpu_batch(
                        insts4, n_devices=2, device=spread, **bkw))
                plans[spec] = [r.a for r in out]
                sb = out[0].stats
                if sb["mesh"]["axes"] != dict(zip(
                        ("chains", "lanes"),
                        (int(x) for x in spec.split("x")))):
                    fail(f"mesh batch {spec}: ran on {sb['mesh']}")
                if not all(r.stats["feasible"] for r in out):
                    fail(f"mesh batch {spec}: an infeasible lane")
                print(f"mesh batch {spec} (4 adversarial instances, 2 shards "
                      f"x 4 chains x 16 sweeps, blocks on "
                      f"{[str(d) for d in spread]}): wall {wall_b:.3f} s, "
                      f"anneal_s {sb['anneal_s']}, migration {mig_b:.4f} s "
                      f"(share {share(mig_b, sb['anneal_s'])}), moves "
                      f"{[r.stats['moves'] for r in out]}, launches "
                      f"{json.dumps(counts_b)} ({power})")
        finally:
            if saved is None:
                os.environ.pop(pm.MESH_ENV, None)
            else:
                os.environ[pm.MESH_ENV] = saved
        for i, (x, y) in enumerate(zip(plans["2x1"], plans["1x2"])):
            same(f"batch lane {i} under 2x1 and 1x2", x, y)
        # 3. the sharding search on that bucket, parity asserted
        m_stack, lane_seeds, keys = engine.stack_lanes(insts4, [0, 1, 2, 3],
                                                       card)
        rows_s = pm.run_sharding_search(
            m_stack, lane_seeds, keys, temps, n_devices=2,
            chains_per_device=4, bucket_key=(256, 8, Pp, Rp),
            scorer="cuda" if on_card else "torch", repeats=1, device=spread)
        if not all(r["parity_vs_default"] for r in rows_s):
            fail(f"mesh sharding search: parity {rows_s}")
        print("mesh sharding search (4 lanes, 2 shards over two blocks, "
              "8 sweeps): "
              + json.dumps(rows_s) + f" ({power})")

        # 4. the chain engine on two shards, 64 chains x 2 rounds
        case = random_cluster(np.random.default_rng(0), n_brokers=12,
                              n_parts=40, rf=2, n_racks=2, drop=2)
        inst_c = build_instance(*case)
        ckw = dict(seed=0, engine="chain", batch=64, rounds=2,
                   precompile=True, n_devices=2)
        (rc, wall_c, counts_c, mig_c), (rcc, *_r) = (
            counted("chain", lambda: engine.solve_tpu(inst_c, device=two,
                                                      **ckw)),
            counted("chain cpu", lambda: engine.solve_tpu(
                inst_c, device="cpu", **ckw)))
        same("chain plan", rc.a, rcc.a)
        if rc.stats["score_curve"] != rcc.stats["score_curve"]:
            fail("mesh chain: curves differ between the card and the CPU")
        print(f"mesh chain engine (2 shards x 32 chains x 2 rounds x "
              f"{rc.stats['steps_per_round']} steps): plan equal to the "
              f"CPU's, {rc.stats['moves']} moves, wall {wall_c:.3f} s, "
              f"anneal_s {rc.stats['anneal_s']}, migration {mig_c:.4f} s "
              f"(share {share(mig_c, rc.stats['anneal_s'])}), launches "
              f"{json.dumps(counts_c)} ({power})")

        # 5. a megachunk whose certificate exits, on two shards: the
        # bounds prewarmed, the constructor stood down, the weight bound
        # forced to 1 and the certificate's economics off
        def no_worker(*_a, **_k):
            return None, False, False

        sc = gen.SCENARIOS["decommission"](**gen.SMOKE_KWARGS["decommission"])
        mkw = dict(seed=0, engine="sweep", batch=8, rounds=32,
                   time_limit_s=3600.0, cert_min_savings_s=-1.0,
                   megachunk=4, n_devices=2)
        saved_worker = engine._construct_worker
        engine._construct_worker = no_worker
        try:
            mres = {}
            for where, d in (("card", two), ("cpu", "cpu")):
                inst_m = build_instance(sc.current, sc.broker_list,
                                        sc.topology, sc.target_rf)
                inst_m.move_lower_bound_exact()
                inst_m.weight_upper_bound = lambda *a, **k: 1
                mres[where] = counted(where, lambda d=d, i=inst_m:
                                      engine.solve_tpu(i, device=d, **mkw))
        finally:
            engine._construct_worker = saved_worker
        (rm, wall_m, counts_m, mig_m), rmc = mres["card"], mres["cpu"][0]
        mg = rm.stats["megachunk"]
        same("megachunk plan", rm.a, rmc.a)
        if not mg["early_exit"] or mg != rmc.stats["megachunk"] or \
                rm.stats["rounds_run"] >= rm.stats["rounds"]:
            fail(f"mesh megachunk: {mg}, rounds_run "
                 f"{rm.stats['rounds_run']}; the CPU's "
                 f"{rmc.stats['megachunk']}")
        print(f"mesh megachunk (decommission smoke, 2 shards, portfolio, "
              f"K=4): the certificate exit after {mg['chunks']} chunk(s) "
              f"({rm.stats['rounds_run']} of {rm.stats['rounds']} sweeps), "
              f"winner lane {rm.stats['portfolio']['winner_lane']}, plan "
              f"equal to the CPU's, wall {wall_m:.3f} s, anneal_s "
              f"{rm.stats['anneal_s']}, migration {mig_m:.4f} s (share "
              f"{share(mig_m, rm.stats['anneal_s'])}), launches "
              f"{json.dumps(counts_m)} ({power})")

        # 6. two processes on the card under gloo, one shard each: the
        # plan of the in-process two-shard solo of step 1
        root = os.path.dirname(os.path.abspath(__file__))
        port = _free_port()
        t0 = time.perf_counter()
        for rank in (0, 1):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE="2",
                       RANK=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _MESH_CHILD, device,
                 json.dumps(solo)], cwd=root, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                start_new_session=True))
        got = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                fail("mesh two processes: a process hung past 300 s")
            if p.returncode != 0:
                fail(f"mesh two processes: rc {p.returncode}: {err[-1500:]}")
            got.append(json.loads(out.strip().splitlines()[-1]))
        wall_p = time.perf_counter() - t0
        for g in got:
            if (g["world"], g["devices"]) != (2, 2):
                fail(f"mesh two processes: rank {g['rank']} ran world "
                     f"{g['world']}, {g['devices']} shards")
            same(f"two-process plan (rank {g['rank']})", g["a"], res.a)
            if on_card and g["launches"] != counts:
                fail(f"mesh two processes: rank {g['rank']} launches "
                     f"{g['launches']}, expected the one-process run's "
                     f"{counts}")
        print(f"mesh two processes ({got[0]['backend']}, one shard each on "
              f"{device}): both plans equal to the one-process two-shard "
              f"plan; solve walls "
              f"{[round(g['wall'], 3) for g in got]} s, anneal_s "
              f"{[g['anneal_s'] for g in got]}, launches a process "
              f"{json.dumps(got[0]['launches'])}; {wall_p:.3f} s with the "
              f"processes' start ({power})")
    finally:
        for mod, fn in real.items():
            mod._migrate_blocks = fn
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGTERM)
                    p.wait(timeout=20)
                except (OSError, subprocess.TimeoutExpired):
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait(timeout=20)
        signal.signal(signal.SIGTERM, old_term)
    print(f"mesh phase: {time.perf_counter() - t_phase:.3f} s ({power})")


# phase (p)'s child: the lock sanitizer armed BEFORE the port binds its
# locks, then the C8 scenario of tests/test_torch_cuda.py (a chain-engine
# solve whose rounds are captured as CUDA graphs, in one thread, beside a
# sweep solve in another) three times, each plan held to the solve alone;
# then, on the card, phase (q)'s captures: the adversarial solo and
# portfolio under megachunk="auto", one thread each, each capturing its
# bucket's step graph
_LSAN_CHILD = r"""
import json, sys, threading, time
from kafka_assignment_optimizer_tpu_torch.analysis import lsan
lsan.install()
import numpy as np
from kafka_assignment_optimizer_tpu_torch.models.cluster import (
    Assignment, PartitionAssignment, Topology)
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance)
from kafka_assignment_optimizer_tpu_torch.ops import kernels
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import anneal, engine
from kafka_assignment_optimizer_tpu_torch.utils import gen
device, kw, runs = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
fused = json.loads(sys.argv[4])
if device == "cuda":
    kernels.build_all()
rng = np.random.default_rng(0)
parts = [PartitionAssignment("t", p, [int(b) for b in rng.choice(
    12, size=2, replace=False)]) for p in range(40)]
s = gen.adversarial(n_brokers=24, n_racks=4, n_topics_low=3,
                    n_topics_high=3, parts_per_topic=10)
cases = {"chain": (Assignment(partitions=parts), list(range(10)),
                   Topology(rack_of={b: f"r{b % 2}" for b in range(12)})),
         "sweep": (s.current, s.broker_list, s.topology)}

def solve(name):
    return engine.solve_tpu(build_instance(*cases[name]), seed=0,
                            device=device, **kw[name])

t0 = time.perf_counter()
alone = {n: solve(n) for n in kw}
walls, equal, errs = [], [], []
for _ in range(runs):
    got = {}

    def run(name):
        try:
            got[name] = solve(name)
        except BaseException as e:
            errs.append(repr(e))

    t1 = time.perf_counter()
    ths = [threading.Thread(target=run, args=(n,)) for n in kw]
    for t in ths: t.start()
    for t in ths: t.join(timeout=300)
    walls.append(time.perf_counter() - t1)
    equal.append({n: n in got and bool(np.array_equal(got[n].a, alone[n].a))
                  and got[n].stats["feasible"] == alone[n].stats["feasible"]
                  for n in kw})
caps0, fused_out = anneal.GRAPH_CAPTURES["captures"], {}
if fused:
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import sweep
    big = gen.adversarial()

    def fsolve(name):
        try:
            r = engine.solve_tpu(build_instance(
                big.current, big.broker_list, big.topology), seed=0,
                device=device, megachunk="auto", **fused[name])
            fused_out[name] = [r.stats["dispatches"],
                               r.stats["megachunk"]["mode"],
                               r.stats.get("degradations", [])]
        except BaseException as e:
            errs.append(repr(e))

    sweep.clear_group_graphs()
    ths = [threading.Thread(target=fsolve, args=(n,)) for n in fused]
    for t in ths: t.start()
    for t in ths: t.join(timeout=300)
    fused_out["captures"] = anneal.GRAPH_CAPTURES["captures"] - caps0
print(json.dumps({
    "fused": fused_out,
    "engines": {n: alone[n].stats["engine"] for n in kw},
    "equal": equal, "errors": errs, "walls": walls,
    "wall": time.perf_counter() - t0,
    "capture_site": anneal._CAPTURE_LOCK._site,
    "captures": anneal.GRAPH_CAPTURES["captures"],
    "violations": [[v.kind, v.detail, v.site_a] for v in lsan.violations()],
    "edges": lsan.edges(), "holds": lsan.holds(),
    "budget_s": lsan.hold_budget_s()}))
"""


def analysis_phase(torch, power: str, device: str = "cuda") -> None:
    """(p) ``kao-check`` over the port on the card, then the lock
    sanitizer around the capture lock (see the module docstring). Each
    child runs under a timeout that kills it; ``device`` ``"cpu"``
    rehearses the phase on the CPU, the scenario cut to CPU sizes."""
    from kafka_assignment_optimizer_tpu_torch.analysis.contracts import (
        run_contracts,
    )
    from kafka_assignment_optimizer_tpu_torch.ops import kernels
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import sweep

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    on_card = device == "cuda"

    # 1. kao-check in a child (the default --device cuda on the card),
    # and meanwhile the runtime contracts in this process with the
    # launches; the child is killed if it outlives its timeout
    t0 = time.perf_counter()
    argv = [sys.executable, "-m", "kafka_assignment_optimizer_tpu_torch"
            ".analysis", "--baseline", "analysis_baseline_torch.json"]
    if not on_card:
        argv += ["--device", "cpu"]
    proc = subprocess.Popen(argv, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        rep = run_contracts(device=device)
        wall_c = time.perf_counter() - t0
        out = proc.communicate(timeout=240)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=20)
    wall_cli = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"kao-check exited {proc.returncode}: {out[-3000:]}")
    if not rep.ok:
        fail("runtime contracts: " + "; ".join(f.render()
                                               for f in rep.findings))
    want = sweep.stage_counts(8) if on_card else {
        k.name: 0 for k in kernels.KERNELS}
    for step, k in (("sweep stepper", 1), ("lane stepper", 1),
                    ("group stepper", 2), ("lane group stepper", 2)):
        if rep.launches[step] != {n: k * v for n, v in want.items()}:
            fail(f"contracts' {step}: launches {rep.launches[step]}, "
                 f"expected {k} x {want} (one launch a stage a step)")
    print(f"kao-check over the port: {out.strip().splitlines()[-1]!r}"
          f" in {wall_cli:.3f} s (a child process, lint and contracts on "
          f"{device}); runtime contracts in process beside it: 0 findings, "
          f"{rep.checks_run} checks run, {rep.ops} aten ops recorded, "
          f"launches {json.dumps(rep.launches)}, {wall_c:.3f} s ({power})")

    # 2. the lock sanitizer around the capture lock: the C8 scenario
    kw = ({"chain": dict(engine="chain", batch=64, rounds=4,
                         steps_per_round=256),
           "sweep": dict(engine="sweep", batch=8, sweeps=64,
                         portfolio=False)} if on_card else
          {"chain": dict(engine="chain", batch=8, rounds=2,
                         steps_per_round=16),
           "sweep": dict(engine="sweep", batch=4, sweeps=16,
                         portfolio=False)})
    runs = 3
    # (q)'s captures, on the card: the adversarial solo and portfolio
    fused = {n: dict(engine="sweep", batch=8, rounds=128,
                     cert_min_savings_s=1e9, time_limit_s=3600.0,
                     portfolio=p)
             for n, p in (("solo", False), ("portfolio", None))
             } if on_card else {}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _LSAN_CHILD, device,
                        json.dumps(kw), str(runs), json.dumps(fused)],
                       cwd=root, capture_output=True, text=True,
                       timeout=420)
    if r.returncode != 0:
        fail(f"lsan child exited {r.returncode}: {r.stderr[-2000:]}")
    got = json.loads(r.stdout.strip().splitlines()[-1])
    wall_l = time.perf_counter() - t0
    if got["engines"] != {"chain": "chain", "sweep": "sweep"}:
        fail(f"lsan scenario engines {got['engines']}")
    if got["errors"] or got["equal"] != [{"chain": True,
                                          "sweep": True}] * runs:
        fail(f"lsan scenario: errors {got['errors']}, plans equal to the "
             f"solves alone {got['equal']}")
    if got["violations"]:
        fail(f"lock sanitizer violations: {got['violations']}")
    if fused and (got["fused"].pop("captures") != 2 or got["fused"] != {
            "solo": [8, "auto", []], "portfolio": [8, "auto", []]}):
        fail(f"lsan: (q)'s captures {got['fused']}, expected one step "
             "graph each, 8 dispatches, no degradation")
    cap = got["holds"].get(got["capture_site"])
    if on_card and (cap is None or not cap["acquisitions"]):
        fail(f"the capture lock ({got['capture_site']}) was never taken: "
             f"{got['holds']}")
    cap = cap or {"acquisitions": 0, "max_hold_s": 0.0, "max_hold_at": ""}
    print(f"lock sanitizer (armed before import), C8 scenario x{runs} "
          f"(chain {kw['chain']} with CUDA graphs beside sweep "
          f"{kw['sweep']})"
          + (", then (q)'s step graphs (the adversarial solo and "
             "portfolio under megachunk=\"auto\", one thread each)"
             if fused else "")
          + ": plans equal to the solves alone, 0 violations; "
          f"{sum(h['acquisitions'] for h in got['holds'].values())} "
          f"acquisitions of {len(got['holds'])} locks, "
          f"{len(got['edges'])} order edges; _CAPTURE_LOCK "
          f"({got['capture_site']}): {cap['acquisitions']} acquisitions, "
          f"{got['captures']} graph captures, longest hold "
          f"{cap['max_hold_s']:.4f} s at {cap['max_hold_at']} (budget "
          f"{got['budget_s']} s); concurrent walls "
          f"{[round(w, 3) for w in got['walls']]} s; child {wall_l:.3f} s "
          f"({power})")
    print(f"analysis phase: {time.perf_counter() - t_phase:.3f} s ({power})")


def replay_probe(torch, power: str) -> None:
    """(q) The solo's step graphs of the adversarial bucket (captured in
    step 1 of the phase, replayed on their last inputs): the host seconds
    of one step's ``replay()`` calls (their launch) against the device
    seconds of the step (CUDA events), the median of 5 each."""
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import sweep

    with sweep._GROUP_LOCK:
        graphs = [v[0] for k, v in sweep._GROUP_GRAPHS.items()
                  if k[3] and k[5] == 1]
    if len(graphs) != 1:
        fail(f"(q) replay probe: {len(graphs)} step graphs of the solo")
    host, dev = [], []
    for _ in range(5):
        torch.cuda.current_stream().synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        e0.record()
        t0 = time.perf_counter()
        for g in graphs[0].graphs:
            g.replay()
        host.append(time.perf_counter() - t0)
        e1.record()
        e1.synchronize()
        dev.append(e0.elapsed_time(e1) / 1e3)
    print(f"(q) one step of the solo's step graphs ({len(graphs[0].graphs)} "
          "pieces), host launch against device time (s, median of 5): "
          f"{json.dumps({'launch_s': statistics.median(host), 'device_s': statistics.median(dev)})}"
          f" ({power})")


def megachunk_phase(torch, power: str, k_plans) -> None:
    """(q) The fused group as CUDA-graph replays of one step, and the
    measured width on top of it, at full width on the adversarial
    instance (10,240 x 4 bucket, N=8, 128 sweeps in 8 chunks of 16; the
    boundary certificate off): the solo (``portfolio=False``) and the
    portfolio (L=8), each per chunk eagerly (the default), as K=1 group
    replays (``megachunk="auto"`` with no evidence) and fused at K=2, 4
    and 8 (dispatches 8 / 8 / 4 / 2 / 1), equal plans among the modes and
    to (k)'s; one step graph captured per (bucket, L) on the first
    fused solve and none after it (other widths, another seed); the
    launches, dispatch
    and device seconds, ``anneal_s`` and the card's idle share of the
    ladder (a profiler session around the second solve's ladder). Then
    the armed exit through the graph (the ``decommission`` smoke solo,
    the weight bound forced to 1), two threads replaying groups of one
    bucket at once, and the chooser: 16 "auto" solves of the pinned
    solo, then a 17th at the width its printed evidence gives."""
    import threading

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kafka_assignment_optimizer_tpu_torch.models.instance import (
        build_instance,
    )
    from kafka_assignment_optimizer_tpu_torch.ops import kernels
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import (
        anneal,
        engine,
        sweep,
    )
    from kafka_assignment_optimizer_tpu_torch.utils import gen

    t_phase = time.perf_counter()
    sweep.clear_group_graphs()
    engine.reset_megachunk_adapt()
    scen = gen.adversarial()
    kw = dict(engine="sweep", batch=8, rounds=128, cert_min_savings_s=1e9,
              time_limit_s=3600.0, device="cuda")
    real_ladder = engine._run_ladder
    seen = {}

    def profiled_ladder(*a, **k):
        torch.cuda.current_stream().synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = real_ladder(*a, **k)
            torch.cuda.current_stream().synchronize()
            seen["window_s"] = time.perf_counter() - t0
        seen["busy_s"] = sum(e.time_range.elapsed_us()
                             for e in prof.events()
                             if e.device_type == DeviceType.CUDA) / 1e6
        return out

    def solve_one(seed, portfolio, megachunk, profiled=False,
                  inst=None):
        inst = inst or build_instance(scen.current, scen.broker_list,
                                      scen.topology)
        kernels.reset_counts()
        caps = anneal.GRAPH_CAPTURES["captures"]
        cap_s = anneal.GRAPH_CAPTURES["capture_s"]
        torch.cuda.current_stream().synchronize()
        t0 = time.perf_counter()
        if profiled:
            seen.clear()
            engine._run_ladder = profiled_ladder
        try:
            res = engine.solve_tpu(inst, seed=seed, portfolio=portfolio,
                                   megachunk=megachunk, **kw)
        finally:
            engine._run_ladder = real_ladder
        torch.cuda.current_stream().synchronize()
        res.stats["_capture_s"] = round(
            anneal.GRAPH_CAPTURES["capture_s"] - cap_s, 4)
        return (res, time.perf_counter() - t0,
                {k.name: k.launches for k in kernels.KERNELS},
                anneal.GRAPH_CAPTURES["captures"] - caps)

    modes = (("per chunk", None, 8), ("K=1 replays", "auto", 8),
             ("K=2", 2, 4), ("K=4", 4, 2), ("K=8", 8, 1))
    # the profiler's own cost grows with the launches it records (in PR
    # 15's call 2 a profiled ladder took 9-25 s solo and 57-117 s at 8
    # lanes): the idle share is taken on the solo's second solve of the
    # K=1 replays and of K=8 (the per-chunk ladder's is (k)'s)
    profiled_modes = {("solo", "K=1 replays"), ("solo", "K=8")}
    plans = {}
    k_plans = k_plans or (None, None)
    captured = set()  # the configs whose step graph is captured
    for config, portfolio, want_plan in (("solo", False, k_plans[0]),
                                         ("portfolio", None, k_plans[1])):
        rows = {}
        for name, mk, n_disp in modes:
            first = solve_one(0, portfolio, mk)
            # the per-chunk ladder captures nothing: one solve
            seen.clear()
            second = (solve_one(1, portfolio, mk, profiled=(
                config, name) in profiled_modes) if mk is not None
                else None)
            runs = [x for x in (first, second) if x is not None]
            for i, (res, _w, counts, caps) in enumerate(runs):
                st = res.stats
                mg = st["megachunk"]
                graph = mk is not None
                if (st["dispatches"], st["rounds_run"]) != (n_disp, 128) or (
                        mg["k"] != (1 if mk in (None, "auto") else mk)):
                    fail(f"(q) {config} {name}: dispatches "
                         f"{st['dispatches']}, rounds {st['rounds_run']}, "
                         f"megachunk {mg}")
                if st.get("degradations"):
                    fail(f"(q) {config} {name}: degradations "
                         f"{st['degradations']}")
                if caps != (0 if not graph or config in captured else 1):
                    fail(f"(q) {config} {name}: {caps} graph captures on "
                         f"solve {i + 1} of the mode")
                if graph:
                    captured.add(config)
                if (counts[kernels.SITE.name], counts[kernels.EXCHANGE.name]
                        ) != (64, 32) or counts[kernels.SCORE.name] <= 0:
                    fail(f"(q) {config} {name}: launches {counts}")
            plans.setdefault(config, []).append(first[0].a)
            if want_plan is not None and not np.array_equal(first[0].a,
                                                            want_plan):
                fail(f"(q) {config} {name}: the plan differs from (k)'s")
            st = first[0].stats
            idle = ("see (k)" if second is None else
                    "not measured (the profiler's cost)"
                    if (config, name) not in profiled_modes else
                    "not measured (no device event kept)"
                    if not seen.get("busy_s") else
                    round(1 - seen["busy_s"] / seen["window_s"], 4))
            rows[name] = {
                "dispatches": st["dispatches"],
                "dispatch_s": [r[0].stats["dispatch_s"] for r in runs],
                "device_s": [r[0].stats["device_s"] for r in runs],
                "anneal_s": [r[0].stats["anneal_s"] for r in runs],
                "dispatch_share": [
                    round(r[0].stats["dispatch_s"]
                          / r[0].stats["anneal_s"], 4)
                    if r[0].stats["anneal_s"] else None for r in runs],
                "idle_share": idle, "launches": first[2],
                "captures": [r[3] for r in runs],
                "capture_s": [r[0].stats["_capture_s"] for r in runs],
                "wall_s": [round(r[1], 4) for r in runs]}
        for name, r in rows.items():
            print(f"(q) {config} {name}: " + json.dumps(r) + f" ({power})")
        if any(not np.array_equal(p, plans[config][0])
               for p in plans[config]):
            fail(f"(q) {config}: the modes' plans differ")
    snap = sweep.group_graphs_snapshot()
    print(f"(q) group graphs: {json.dumps(snap)}; capture seconds "
          f"{anneal.GRAPH_CAPTURES['capture_s']:.3f} in the process "
          f"({power})")
    # the host time of one replay (the graph's launch) against its device
    # time, for the solo's step graph
    replay_probe(torch, power)

    # 3. the armed exit through the graph: the decommission smoke solo,
    # bounds prewarmed, the constructor stood down, the weight bound
    # forced to 1 and the certificate's economics off
    sc = gen.SCENARIOS["decommission"](**gen.SMOKE_KWARGS["decommission"])
    ex = {}
    saved = engine._construct_worker
    engine._construct_worker = lambda *_a, **_k: (None, False, False)
    try:
        for mk in (None, 4):
            inst = build_instance(sc.current, sc.broker_list, sc.topology,
                                  sc.target_rf)
            inst.move_lower_bound_exact()
            inst.weight_upper_bound = lambda *a, **k: 1
            kernels.reset_counts()
            caps = sweep.GROUP_STATS["replays"]
            ex[mk] = engine.solve_tpu(
                inst, seed=0, engine="sweep", batch=8, rounds=32,
                time_limit_s=3600.0, cert_min_savings_s=-1.0,
                megachunk=mk, portfolio=False, device="cuda")
            ex[mk].stats["_replays"] = sweep.GROUP_STATS["replays"] - caps
            ex[mk].stats["_launches"] = {k.name: k.launches
                                         for k in kernels.KERNELS}
    finally:
        engine._construct_worker = saved
    mg = ex[4].stats["megachunk"]
    if not mg["early_exit"] or ex[4].stats.get("degradations") or \
            not np.array_equal(ex[4].a, ex[None].a) or \
            ex[4].stats["_replays"] < 1:
        fail(f"(q) armed exit: megachunk {mg}, degradations "
             f"{ex[4].stats.get('degradations')}, replays "
             f"{ex[4].stats['_replays']}, plan equal "
             f"{np.array_equal(ex[4].a, ex[None].a)}")
    print(f"(q) armed exit (decommission smoke solo, K=4, "
          f"{ex[4].stats['_replays']} steps replayed): "
          f"early_exit after {mg['chunks']} chunk(s), "
          f"{ex[4].stats['rounds_run']} of 32 sweeps, {ex[4].stats['moves']} "
          f"moves, plan equal to the per-chunk ladder's "
          f"({ex[None].stats['rounds_run']} sweeps), no degradation; "
          f"launches {json.dumps(ex[4].stats['_launches'])} ({power})")

    # 4. two threads replaying groups of one bucket at once (K=4 solo,
    # seeds 0 and 1): each plan equal to its solo run above
    solo = {0: None, 1: None}
    for seed in solo:
        solo[seed] = solve_one(seed, False, 4)[0].a
    got, errs = {}, []

    def worker(seed):
        try:
            got[seed] = engine.solve_tpu(
                build_instance(scen.current, scen.broker_list,
                               scen.topology),
                seed=seed, portfolio=False, megachunk=4, **kw).a
        except Exception as e:  # noqa: BLE001 (reported below)
            errs.append(repr(e))

    t0 = time.perf_counter()
    ts = [threading.Thread(target=worker, args=(s,)) for s in solo]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
        if t.is_alive():
            fail("(q) concurrency: a solve thread hung past 600 s")
    if errs or any(not np.array_equal(got[s], solo[s]) for s in solo):
        fail(f"(q) concurrency: errors {errs}, plans equal "
             f"{[np.array_equal(got.get(s), solo[s]) for s in solo]}")
    print(f"(q) two threads, K=4 solo, seeds 0 and 1 at once: each plan "
          f"equal to its solo run, {time.perf_counter() - t0:.3f} s; "
          f"graphs {json.dumps(sweep.group_graphs_snapshot())} ({power})")

    # 5. the chooser: 16 "auto" solves of the pinned solo, then a 17th at
    # the width its evidence gives
    engine.reset_megachunk_adapt()
    autos = [solve_one(0, False, "auto")[0] for _ in range(16)]
    snap = engine.megachunk_snapshot()
    if len(snap["buckets"]) != 1:
        fail(f"(q) chooser: evidence under {list(snap['buckets'])}")
    (key, ev), = snap["buckets"].items()
    o = ev["dispatch_s"] / max(1, ev["dispatches"])
    d = ev["device_s"] / max(1, ev["chunks"])
    k_ev = next((k for k in snap["candidates"]
                 if o <= snap["host_fraction"] * (o + k * d)),
                snap["candidates"][-1])
    chosen = snap["chosen"][key]
    last = solve_one(0, False, "auto")[0]
    mg = last.stats["megachunk"]
    anneal = [r.stats["anneal_s"] for r in autos] + [last.stats["anneal_s"]]
    if ev["solves"] != 16 or chosen != k_ev or mg["k"] != chosen or \
            mg["mode"] != "auto" or \
            not np.array_equal(last.a, autos[0].a) or any(
                not np.array_equal(r.a, autos[0].a) for r in autos):
        fail(f"(q) chooser: evidence {ev}, chosen {chosen}, recomputed "
             f"{k_ev}, the 17th solve's megachunk {mg}")
    print(f"(q) chooser: evidence {json.dumps(ev)} -> o {o:.6f} s a "
          f"dispatch, d {d:.6f} s a chunk, chosen K={chosen} (recomputed "
          f"{k_ev}); the 17th solve ran {json.dumps(mg)}, the same plan; "
          f"anneal_s of the 17 solves {anneal} ({power})")
    print(f"(q) phase {time.perf_counter() - t_phase:.3f} s ({power})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() != 1:
        # a solve's default mesh takes every visible card: with several,
        # every phase would run the several-card path its counts and
        # plans are not pinned to
        print(f"chip_smoke: {torch.cuda.device_count()} cards visible; "
              "run it with exactly one (CUDA_VISIBLE_DEVICES)",
              file=sys.stderr)
        return 1
    import numpy as np

    from kafka_assignment_optimizer_tpu_torch import optimize, prng
    from kafka_assignment_optimizer_tpu_torch.ops import bench_kernel, kernels

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. header ------------------------------------------------------
    int32_ops_per_s = header(torch)
    from kafka_assignment_optimizer_tpu_torch.obs import prof

    # the bounds' rates: the profiler's (INT32 from the card's properties,
    # device memory by the card's name), held to the header's clock
    peaks = prof.peaks()
    if peaks["platform"] != "gpu" or abs(peaks["flops"] / int32_ops_per_s
                                         - 1) > 0.01:
        fail(f"the profiler's peaks {peaks} disagree with the card's INT32 "
             f"rate {int32_ops_per_s:.6g}")
    print("bound rates (obs.prof.peaks): " + json.dumps(peaks))

    from kafka_assignment_optimizer_tpu_torch.models.instance import (
        build_instance,
    )
    from kafka_assignment_optimizer_tpu_torch.ops.exchange_cuda import (
        exchange_sweep_cuda,
        exchange_sweep_lanes,
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
    # the adversarial scenario lowered to its bucket, and 8 chains of its
    # greedy seed with one seeded random slot change per partition
    scen, inst, m, seed_np, a = bench_kernel.population(dev, "adversarial")
    N = a.shape[0]
    Pp, Rp = m.a0.shape
    B1, K1 = m.num_brokers + 1, m.rack_lo.shape[0]
    _f, _r, cnt, lcnt, rcnt = sweep.histograms(m, a)
    temp = float(np.float32(0.5))
    print(f"kernel shapes: N={N} P={Pp} (instance {inst.num_parts}) "
          f"R={Rp} B+1={B1} K+1={K1}")

    rows = []
    device_us = {}
    # the one-lane form the engine runs (lane 0 of a stacked model), for
    # the bounds and the library yardsticks of ops.bench_kernel
    m1, a1l = sweep._one_lane(m), a[None]
    hists1 = (cnt[None], lcnt[None], rcnt[None])
    tf_ops, tf_hist = threefry_ops(kernels)

    def report(k, err, call, plain, key, library):
        events, _wall = profiled(call, torch, REPS)
        mine = [us for name, us in events
                if any(f in name for f in KERNEL_FUNCS[k.name])]
        # a device time only where the profiler saw every launch
        device_us[k.name] = (sum(mine) / REPS if len(mine)
                             == REPS * len(KERNEL_FUNCS[k.name]) else None)
        cost = bench_kernel.data_cost(k.name, m1, a1l, hists1, [key],
                                      [temp], tf_ops / 7)
        row = kernel_row(k, "", err, call, plain, cost, library, peaks)
        rows.append(row)
        print(f"  {k.name}: exact (max_abs_err {err}); kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{cost['bytes']} bytes, {cost['int_ops']} INT32 ops, "
              f"{cost['fp_ops']} FP32 ops), library "
              + ("n/a" if row["library_ms"] is None
                 else f"{row['library_ms']:.4f} ms")
              + ", device (profiler) "
              + ("not measured" if device_us[k.name] is None
                 else f"{device_us[k.name] / 1e3:.4f} ms"))

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
          f"; at N=1 kernel {timed(lambda: score(m, a1)):.4f} ms, "
          "device (profiler) "
          + (f"{sum(dev1) / REPS / 1e3:.5f} ms)" if len(dev1) == REPS
             else "not measured)"))
    report(kernels.SCORE, err, lambda: score(m, a),
           lambda: score_plain(m, a), prng.PRNGKey(1),
           bench_kernel.library_calls(m1, a1l, None)[kernels.SCORE.name])

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
    # the kernel as the ladder calls it: its key and temperature on the
    # card already (a host key and float cost one copy a call)
    dkey, dtemp = kernels.lane_values([key], [temp], 1, dev)
    one_launch("site_step_cuda",
               lambda: site_step_cuda(m, a, cnt, lcnt, rcnt, dkey[0],
                                      dtemp[0]),
               kernels.SITE, "site_sweep", torch)
    print(f"  (threefry: {tf_ops} integer instructions for 7 words in the "
          f"SASS: {json.dumps(tf_hist, sort_keys=True)})")
    report(kernels.SITE, err,
           lambda: site_step_cuda(m, a, cnt, lcnt, rcnt, dkey[0], dtemp[0]),
           lambda: sweep._site_sweep_delta(m, a, cnt, lcnt, rcnt, key, temp),
           key, None)

    # B4+B5+B6 — the fused exchange sweep, at two temperatures: its
    # records and maps against the plain proposal, its a_new and lcnt'
    # against the plain finish fed with the kernel's own records and
    # against the plain sweep
    key = prng.PRNGKey(2)

    def exch(t):
        a2, l2, rec, m_out, m_in = exchange_sweep_cuda(m, a, lcnt, key, t)
        return (a2, l2, *rec, m_out, m_in)

    # the kernel as the ladder calls it, its lane values on the card
    dkey, dtemp = kernels.lane_values([key], [temp], 1, dev)

    def exch_dev():
        a2, l2, rec, m_out, m_in = exchange_sweep_cuda(m, a, lcnt, dkey[0],
                                                       dtemp[0])
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
        sc.exch_step(m1, *st, dkey, dtemp)
    finally:
        prng.bits, prng.randint = bits_fn, randint_fn
    if drawn:
        fail(f"one exchange sweep drew {drawn} on the device")
    names = one_launch(
        "an exchange sweep",
        lambda: sc.exch_step(m1, *st, dkey, dtemp),
        kernels.EXCHANGE, "exchange_sweep", torch)
    print(f"  (one exchange sweep as the engine runs it: one device "
          f"activity, no prng draw on the device: {names})")
    # the library yardstick of the maps: one scatter_reduce_ amax over
    # both token sets side by side, on the one-lane launch's records
    lib = bench_kernel.library_calls(m1, a1l, exchange_sweep_lanes(
        m1, a1l, lcnt[None], [key], [temp]))[kernels.EXCHANGE.name]
    if not torch.equal(lib[1](), torch.cat([ref[7], ref[8]], 1)):
        fail("the scatter_reduce_ yardstick disagrees with the maps")
    if not all(torch.equal(x, y) for x, y in zip(exch_dev(), got)):
        fail("the exchange sweep differs with its lane values on the card")
    report(kernels.EXCHANGE, err, exch_dev, lambda: exch_plain(temp), key,
           lib)

    # ---- 3b. the lane forms ----------------------------------------------
    lane_rows = lane_kernels(torch, dev, m, a, temp, peaks, tf_ops,
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
        # the reference's default dispatch: its two chunks pipelined, no
        # rung taken
        if st["pipeline"] is not True or st.get("degradations"):
            fail(f"{label}: pipeline {st['pipeline']}, degradations "
                 f"{st.get('degradations')}; expected the pipelined ladder "
                 "and no rung")
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
    # the default lane ladder is pipelined; the synchronous one gives the
    # same plans. Walls in the order pipelined (above), sync, sync,
    # pipelined
    walls = {True: [batch_wall], False: []}
    for pipe in (False, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = solve_tpu_batch(insts, seeds=0, pipeline=pipe)
        torch.cuda.synchronize()
        walls[pipe].append(time.perf_counter() - t0)
        if again[0].stats["pipeline"] is not pipe or not all(
                np.array_equal(r.solve.a, q.a) for r, q in zip(out, again)):
            fail(f"batch: the lane ladder with pipeline={pipe} differs")
    print(f"batch of 8, pipelined / synchronous lane ladder: the same "
          f"plans, walls (order P S S P) pipelined "
          f"{walls[True][0]:.3f}, {walls[True][1]:.3f} s, synchronous "
          f"{walls[False][0]:.3f}, {walls[False][1]:.3f} s ({power})")
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
    # (e)'s seeds 0-2 as plans, for the service's coalesced batch in (l)
    batch3 = [inst.decode(a).to_dict() for inst, a in zip(insts[:3],
                                                           plans["8"])]
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
    # retry's anneal, cut to RETRY_ROUNDS rounds
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
        st1 = anneal._migrate(st1, anneal.best_key(st1), 1)
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
    # the anneal the retry runs, from the greedy seed (feasible here, so
    # the result is too), over the engine's chain ladder (2.5 -> 0.05) cut
    # to RETRY_ROUNDS of its 24 rounds: the same steps, a third of the
    # wall. The retry's own solve adds the constructor race (this
    # caps-binding case races the LP decode, which certifies it at once)
    # and final selection
    solve = anneal.make_solver_fn(512, steps)
    temps = arrays.geometric_temps(2.5, 0.05, RETRY_ROUNDS)
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
    print(f"sweep->chain retry anneal (512 chains x {RETRY_ROUNDS} of the "
          f"retry's 24 rounds x {steps} steps, CUDA graphs, "
          f"{inst.num_parts} partitions): feasible, "
          f"{inst.move_count(plan)} moves, weight "
          f"{inst.preservation_weight(plan)}, wall {anneal_s:.3f} s, "
          f"{1e3 * anneal_s / (RETRY_ROUNDS * steps):.4f} ms a step "
          f"({power})")

    # (h) the decomposed solve; (i) the delta API; (j) the host fallback;
    # (k) the ladder's dispatch modes
    map_rows = decomposed_phase(torch, dev, power, peaks, tf_ops)
    delta = delta_phase(torch, dev, power)
    fallback_phase(torch, dev, power)
    k_plans = dispatch_phase(torch, dev, power)
    # (l) the service on the card
    service_phase(torch, power, batch3, delta)
    # (m) the measurement plane
    measure_phase(torch, power)
    # (n) fleet and rollout: a router over two workers on the card
    fleet_phase(torch, power)
    # (o) the sharded mesh: two chain shards on the one card
    mesh_phase(torch, power)
    # (p) kao-check over the port, and the lock sanitizer around the
    # capture lock
    analysis_phase(torch, power)
    # (q) the fused group as CUDA-graph replays, and the measured width
    megachunk_phase(torch, power, k_plans)
    # (h)'s witness on the CPU, after the last timed phase
    map_witness()
    print("kernel device time per call (profiler, ms): " + json.dumps(
        {k: (None if v is None else v / 1e3) for k, v in device_us.items()}))
    print(json.dumps({"kernels": rows + lane_rows + map_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
