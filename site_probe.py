#!/usr/bin/env python3
"""Time build variants of the fused sweep kernels (``csrc/site.cu`` and
``csrc/exchange.cu``) on one NVIDIA GPU at the main path's shape, to show
where their device time goes and which build knobs to ship.

Run from the root of a checkout:  python3 site_probe.py [--only site|exchange] [--out FILE]

Each variant is a kernel source built with the kernels' nvcc flags and
``-D`` overrides of its build knobs (all variants at once, one nvcc
each). For ``site.cu``: ``KAO_SITE_CLUSTER`` (CTAs per chain),
``KAO_SITE_THREADS`` (the largest CTA), ``KAO_SITE_PHASES`` (the sweep
cut after phase 0, 1 or 2) and ``KAO_SITE_FAKE_WORDS`` (cheap stand-ins
for the threefry words); a whole, true-words variant must equal
``sweep._site_sweep_delta`` exactly, the others give wrong results and
are only timed. For ``exchange.cu``: ``KAO_EXCH_STAGES`` (1: the
pairing, the slots and the records only) and ``KAO_EXCH_FAKE_WORDS``
(stand-in words); the whole, true-words build must equal
``sweep.exchange_propose`` exactly. Device time per call is the kernel's
own time under ``torch.profiler``, over 20 launches. One line per
variant (with ptxas's register and spill counts), then one JSON object
(also written to ``--out``).
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
    ("exchange", "stages 1", {"KAO_EXCH_STAGES": 1}),
    ("exchange", "stand-in words", {"KAO_EXCH_FAKE_WORDS": 1}),
    ("exchange", "stand-in words, stages 1",
     {"KAO_EXCH_FAKE_WORDS": 1, "KAO_EXCH_STAGES": 1}),
]


def build(kernels, source: str, defines: dict):
    """Start nvcc for one variant of ``csrc/<source>.cu``; returns
    ``(process, library path)``."""
    flags = [*kernels.NVCC_FLAGS, "-Xptxas", "-v",
             *(f"-D{k}={v}" for k, v in sorted(defines.items()))]
    h = hashlib.sha256(" ".join(flags).encode())
    h.update((kernels.CSRC / f"{source}.cu").read_bytes())
    h.update((kernels.CSRC / "common.cuh").read_bytes())
    out = (kernels.BUILD_DIR / "variants"
           / f"{source}-{h.hexdigest()[:16]}.so")
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [kernels._nvcc(), *flags, "-o", str(out),
         str(kernels.CSRC / f"{source}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def time_variant(kernels, kernel, fn_name, proc, lib_path, call, ref,
                 whole: bool):
    """Load one built variant into ``kernel``'s wrapper, hold its output
    to the plain version where it is whole, and return its device ms per
    call (None where the profiler missed a launch). Raises on a failed
    build, launch or comparison."""
    import torch

    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log}")
    # ptxas's register and spill lines for the kernel
    lines = log.splitlines()
    for j, line in enumerate(lines):
        if fn_name in line and "Compiling" in line:
            print("  ptxas: " + " | ".join(x.split("ptxas info    :")[-1]
                                           .strip() for x in lines[j:j + 4]))
    fn = getattr(ctypes.CDLL(str(lib_path)), kernel.symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    kernel._fn = fn  # the wrapper launches this variant
    got = call()
    torch.cuda.synchronize()
    if whole and not all(torch.equal(x, y) for x, y in zip(got, ref)):
        raise ValueError("differs from the plain version")
    ops = chip_smoke.sass_opcodes(kernels, str(lib_path), fn_name)
    print(f"  SASS: {len(ops)} instructions, "
          f"{sum(chip_smoke.alu_ops(ops).values())} vector ALU")
    events, _w = chip_smoke.profiled(call, torch, REPS)
    mine = [us for name, us in events if fn_name in name]
    return sum(mine) / REPS / 1e3 if len(mine) == REPS else None


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("site_probe: no CUDA device", file=sys.stderr)
        return 1
    from kafka_assignment_optimizer_tpu_torch import prng
    from kafka_assignment_optimizer_tpu_torch.ops import kernels
    from kafka_assignment_optimizer_tpu_torch.ops.exchange_cuda import (
        exchange_propose_cuda,
    )
    from kafka_assignment_optimizer_tpu_torch.ops.site_cuda import (
        site_step_cuda,
    )
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import sweep

    out_path = argv[argv.index("--out") + 1] if "--out" in argv else None
    only = argv[argv.index("--only") + 1] if "--only" in argv else None
    chip_smoke.header(torch)
    jobs = [(src, label, defines, *build(kernels, src, defines))
            for src, label, defines in VARIANTS if only in (None, src)]
    dev = torch.device("cuda")
    _s, _i, m, _seed, a = chip_smoke.adversarial_population(torch, dev)
    _f, _r, cnt, lcnt, rcnt = sweep.histograms(m, a)
    key = prng.PRNGKey(1)
    temp = 0.5
    p, m_out, m_in = sweep.exchange_propose(m, a, lcnt, key, temp)
    # per kernel: (Kernel, __global__ name, call, plain output)
    targets = {
        "site": (kernels.SITE, "site_sweep",
                 lambda: site_step_cuda(m, a, cnt, lcnt, rcnt, key, temp),
                 sweep._site_sweep_delta(m, a, cnt, lcnt, rcnt, key, temp)),
        "exchange": (kernels.EXCHANGE, "exchange_propose",
                     lambda: (lambda r: (*r[0], r[1], r[2]))(
                         exchange_propose_cuda(m, a, lcnt, key, temp)),
                     (p.s, p.b_other, p.tok_out, p.tok_in, p.prio, m_out,
                      m_in)),
    }

    print(f"shape: N={a.shape[0]} P={a.shape[1]} R={a.shape[2]} "
          f"B+1={m.num_brokers + 1} K+1={m.rack_lo.shape[0]}")
    rows, failed = [], []
    for src, label, defines, proc, lib_path in jobs:
        kernel, fn_name, call, ref = targets[src]
        whole = (defines.get("KAO_SITE_PHASES", 3) == 3
                 and defines.get("KAO_EXCH_STAGES", 2) == 2
                 and not defines.get("KAO_SITE_FAKE_WORDS")
                 and not defines.get("KAO_EXCH_FAKE_WORDS"))
        try:
            ms = time_variant(kernels, kernel, fn_name, proc, lib_path, call,
                              ref, whole)
        except (RuntimeError, ValueError) as e:
            print(f"{src} {label}: FAILED: {e}")
            failed.append(label)
            continue
        rows.append({"kernel": src, "variant": label, "defines": defines,
                     "exact": True if whole else None, "device_ms": ms})
        print(f"{src} {label}: device "
              + ("not measured" if ms is None else f"{ms:.5f} ms per call")
              + (", exact" if whole else ""))
    kernels.SITE._fn = kernels.EXCHANGE._fn = None
    line = json.dumps({"site_variants": rows})
    if out_path:
        with open(out_path, "w") as f:
            f.write(line + "\n")
    print(line)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
