#!/usr/bin/env python3
"""Time build variants of the hand-written kernels (``csrc/site.cu``,
``csrc/exchange.cu`` and ``csrc/score.cu``) on one NVIDIA GPU at the main
path's shape, to show where their device time goes and which build knobs
to ship.

Run from the root of a checkout:
    python3 site_probe.py [--only site|exchange|score|sync] [--out FILE]

Each variant is a kernel source built with the kernels' nvcc flags and
``-D`` overrides of its build knobs (all variants at once, one nvcc
each). For ``site.cu``: ``KAO_SITE_CLUSTER`` (CTAs per chain),
``KAO_SITE_THREADS`` (the largest CTA), ``KAO_SITE_PHASES`` (the sweep
cut after phase 0, 1 or 2) and ``KAO_SITE_FAKE_WORDS`` (cheap stand-ins
for the threefry words); a whole, true-words variant must equal
``sweep._site_sweep_delta`` exactly, the others give wrong results and
are only timed. For ``exchange.cu``: ``KAO_EXCH_PHASES`` (the sweep cut
after phase 0 or 1), ``KAO_EXCH_STAGES`` (1: the pairing, the slots and
the records only) and ``KAO_EXCH_FAKE_WORDS`` (stand-in words); the
whole, true-words build must equal the plain exchange sweep (records,
maps, a_new, lcnt') exactly. For ``score.cu`` (B1, timed at 8 chains and
at 1, the verification call): the whole kernel, which must equal
``score_plain`` exactly, and ``KAO_SCORE_ROWS=0`` (phase 1's rows left
out: the launch, the barriers and the outputs). ``--only sync`` times
bare grid and cluster barriers. Device time per call is the kernel's own
time under ``torch.profiler``, over 20 launches. One line per variant
(with ptxas's register and spill counts), then one JSON object (also
written to ``--out``).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import chip_smoke

REPS = 20
# (kernel, label, -D overrides)
VARIANTS = [
    *(("site", f"C={c}, {t} threads",
       {"KAO_SITE_CLUSTER": c, "KAO_SITE_THREADS": t})
      for c, t in ((8, 640), (8, 1024), (16, 640), (16, 320), (10, 1024),
                   (12, 1024), (14, 1024))),
    *(("site", f"C=8, 640 threads, phases 0-{k}",
       {"KAO_SITE_CLUSTER": 8, "KAO_SITE_THREADS": 640,
        "KAO_SITE_PHASES": k}) for k in (0, 1, 2)),
    ("site", "C=8, 640 threads, stand-in words, phases 0-1",
     {"KAO_SITE_CLUSTER": 8, "KAO_SITE_THREADS": 640,
      "KAO_SITE_FAKE_WORDS": 1, "KAO_SITE_PHASES": 1}),
    ("exchange", "whole", {}),
    ("exchange", "phase 0", {"KAO_EXCH_PHASES": 0}),
    ("exchange", "phases 0-1", {"KAO_EXCH_PHASES": 1}),
    ("exchange", "phases 0-1, stages 1",
     {"KAO_EXCH_PHASES": 1, "KAO_EXCH_STAGES": 1}),
    ("exchange", "stand-in words", {"KAO_EXCH_FAKE_WORDS": 1}),
    ("exchange", "stand-in words, phases 0-1, stages 1",
     {"KAO_EXCH_FAKE_WORDS": 1, "KAO_EXCH_PHASES": 1,
      "KAO_EXCH_STAGES": 1}),
    ("score", "whole", {}),
    ("score", "no rows", {"KAO_SCORE_ROWS": 0}),
]

# the barriers the kernels are built from, alone: k grid-wide barriers in
# a cooperative launch of 320 blocks of 256 threads (the exchange sweep's
# and B1's grid at 8 chains), and k cluster barriers in a launch of 8
# clusters of 8 CTAs of 640 threads (the site sweep's); nothing else
SYNC_PROBE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void grid_syncs(int k, int* out) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < k; ++i) grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = k;
}

__global__ void __cluster_dims__(8, 1, 1) cluster_syncs(int k, int* out) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < k; ++i) cluster.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) out[blockIdx.y] = k;
}

extern "C" int kao_sync_probe(int kind, int k, int* out,
                              cudaStream_t stream) {
  if (kind == 0) {
    void* args[] = {&k, &out};
    return (int)cudaLaunchCooperativeKernel((void*)grid_syncs, dim3(320),
                                            dim3(256), args, 0, stream);
  }
  cluster_syncs<<<dim3(8, 8), 640, 0, stream>>>(k, out);
  return (int)cudaGetLastError();
}
"""


def sync_probe(kernels, torch) -> list[dict]:
    """Device ms per launch of SYNC_PROBE at 0, 1, 2 and 4 barriers."""
    proc, lib = build(kernels, "sync", {"SYNC_PROBE": 1})
    fn = load_variant(kernels, proc, lib, "kao_sync_probe",
                      [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p], "syncs")
    out = torch.zeros(8, dtype=torch.int32, device="cuda")
    rows = []
    for kind, name in ((0, "grid_syncs"), (1, "cluster_syncs")):
        for k in (0, 1, 2, 4):
            def call():
                err = fn(kind, k, out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
                return (out,)
            ms = time_call(name, call, None, False)
            rows.append({"kernel": "sync", "variant": f"{name} x {k}",
                         "device_ms": ms})
            print(f"sync {name} x {k}: device "
                  + ("not measured" if ms is None else f"{ms:.5f} ms"))
    return rows


def build(kernels, source: str, defines: dict):
    """Start nvcc for one variant of ``csrc/<source>.cu`` (or, where
    ``defines`` has ``SYNC_PROBE``, of the source above); returns
    ``(process, library path)``."""
    flags = [*kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(kernels.CSRC),
             *(f"-D{k}={v}" for k, v in sorted(defines.items()))]
    text = (SYNC_PROBE if defines.get("SYNC_PROBE")
            else (kernels.CSRC / f"{source}.cu").read_text())
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(text.encode())
    h.update((kernels.CSRC / "common.cuh").read_bytes())
    out = (kernels.BUILD_DIR / "variants"
           / f"{source}-{h.hexdigest()[:16]}.so")
    out.parent.mkdir(parents=True, exist_ok=True)
    src = out.with_suffix(".cu")
    src.write_text(text)
    proc = subprocess.Popen(
        [kernels._nvcc(), *flags, "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def load_variant(kernels, proc, lib_path, symbol: str, argtypes,
                 fn_name: str):
    """Wait for one variant's build, print ptxas's lines and the SASS
    count of ``fn_name``, and return its C entry point. Raises on a failed
    build."""
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log}")
    # ptxas's register and spill lines for the kernel
    lines = log.splitlines()
    for j, line in enumerate(lines):
        if fn_name in line and "Compiling" in line:
            print("  ptxas: " + " | ".join(x.split("ptxas info    :")[-1]
                                           .strip() for x in lines[j:j + 4]))
    ops = chip_smoke.sass_opcodes(kernels, str(lib_path), fn_name)
    print(f"  SASS: {len(ops)} instructions, "
          f"{sum(chip_smoke.alu_ops(ops).values())} vector ALU")
    fn = getattr(ctypes.CDLL(str(lib_path)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def time_call(fn_name, call, ref, whole: bool):
    """Hold ``call``'s output to the plain version where the variant is
    whole, and return its device ms per call (None, with the activities
    the profiler saw, where it missed a launch). Raises where a whole
    variant differs."""
    import torch

    got = call()
    torch.cuda.synchronize()
    if whole and not all(torch.equal(x, y) for x, y in zip(got, ref)):
        raise ValueError("differs from the plain version")
    events, _w = chip_smoke.profiled(call, torch, REPS)
    mine = [us for name, us in events if fn_name in name]
    if len(mine) != REPS:
        print(f"  profiler: {len(mine)} launches for {REPS} calls among "
              f"{sorted(set(n for n, _us in events))}")
    return sum(mine) / REPS / 1e3 if len(mine) == REPS else None


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("site_probe: no CUDA device", file=sys.stderr)
        return 1
    from kafka_assignment_optimizer_tpu_torch import prng
    from kafka_assignment_optimizer_tpu_torch.ops import kernels
    from kafka_assignment_optimizer_tpu_torch.ops.exchange_cuda import (
        exchange_sweep_cuda,
    )
    from kafka_assignment_optimizer_tpu_torch.ops.score_cuda import (
        score,
        score_plain,
    )
    from kafka_assignment_optimizer_tpu_torch.ops.site_cuda import (
        site_step_cuda,
    )
    from kafka_assignment_optimizer_tpu_torch.ops import bench_kernel
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import sweep

    out_path = argv[argv.index("--out") + 1] if "--out" in argv else None
    only = argv[argv.index("--only") + 1] if "--only" in argv else None
    chip_smoke.header(torch)
    jobs = [(src, label, defines, *build(kernels, src, defines))
            for src, label, defines in VARIANTS if only in (None, src)]
    dev = torch.device("cuda")
    _s, _i, m, _seed, a = bench_kernel.population(dev, "adversarial")
    a1 = a[:1].clone()
    _f, _r, cnt, lcnt, rcnt = sweep.histograms(m, a)
    key = prng.PRNGKey(1)
    temp = 0.5
    N, P = a.shape[:2]
    B1, K1 = m.num_brokers + 1, m.rack_lo.shape[0]

    def exch():
        a2, l2, rec, m_out, m_in = exchange_sweep_cuda(m, a, lcnt, key, temp)
        return (a2, l2, *rec, m_out, m_in)

    p, m_out, m_in = sweep.exchange_propose(m, a, lcnt, key, temp)
    ex_rec = (p.s, p.b_other, p.tok_out, p.tok_in, p.prio)
    ex_a, ex_d = sweep.exch_finish(a, *ex_rec, m_out, m_in)

    # per kernel: (Kernel, __global__ name, [(label, call, plain output)])
    targets = {
        "site": (kernels.SITE, "site_sweep", [(
            "", lambda: site_step_cuda(m, a, cnt, lcnt, rcnt, key, temp),
            sweep._site_sweep_delta(m, a, cnt, lcnt, rcnt, key, temp))]),
        "exchange": (kernels.EXCHANGE, "exchange_sweep", [(
            "", exch, (ex_a, lcnt + ex_d, *ex_rec, m_out, m_in))]),
        "score": (kernels.SCORE, "score_grid", [
            ("N=8", lambda: score(m, a), score_plain(m, a)),
            ("N=1", lambda: score(m, a1), score_plain(m, a1))]),
    }

    print(f"shape: N={N} P={P} R={a.shape[2]} B+1={B1} K+1={K1}")
    rows, failed = [], []
    if only in (None, "sync"):
        rows += sync_probe(kernels, torch)
    for src, label, defines, proc, lib_path in jobs:
        kernel, fn_name, calls = targets[src]
        whole = (defines.get("KAO_SITE_PHASES", 3) == 3
                 and defines.get("KAO_SCORE_ROWS", 1) == 1
                 and defines.get("KAO_EXCH_PHASES", 2) == 2
                 and defines.get("KAO_EXCH_STAGES", 2) == 2
                 and not defines.get("KAO_SITE_FAKE_WORDS")
                 and not defines.get("KAO_EXCH_FAKE_WORDS"))
        try:
            # the wrapper launches this variant
            kernel._fn = load_variant(kernels, proc, lib_path, kernel.symbol,
                                      kernel.argtypes, fn_name)
            times = [(sub, time_call(fn_name, call, ref, whole))
                     for sub, call, ref in calls]
        except (RuntimeError, ValueError) as e:
            print(f"{src} {label}: FAILED: {e}")
            failed.append(label)
            continue
        for sub, ms in times:
            rows.append({"kernel": src, "variant": label, "at": sub,
                         "defines": defines,
                         "exact": True if whole else None,
                         "device_ms": ms})
            print(f"{src} {label}{f' ({sub})' if sub else ''}: device "
                  + ("not measured" if ms is None
                     else f"{ms:.5f} ms per call")
                  + (", exact" if whole else ""))
    for k in kernels.KERNELS:
        k._fn = None
    line = json.dumps({"site_variants": rows})
    if out_path:
        with open(out_path, "w") as f:
            f.write(line + "\n")
    print(line)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
