#!/usr/bin/env python3
"""Time build variants of the fused site-sweep kernel (``csrc/site.cu``)
on one NVIDIA GPU at the main path's shape, to show where its device time
goes and which cluster size to ship.

Run from the root of a checkout:  python3 site_probe.py [--out FILE]

Each variant is ``csrc/site.cu`` built with the kernels' nvcc flags and
``-D`` overrides of its build knobs (all variants at once, one nvcc
each): ``KAO_SITE_CLUSTER`` (CTAs per chain), ``KAO_SITE_THREADS`` (the
largest CTA), ``KAO_SITE_PHASES`` (the sweep cut after phase 0, 1 or 2)
and ``KAO_SITE_FAKE_WORDS`` (cheap stand-ins for the threefry words).
A whole, true-words variant must equal ``sweep._site_sweep_delta``
exactly; the others give wrong results and are only timed. Device time
per call is the kernel's own time under ``torch.profiler``, over 20
launches. One line per variant (with ptxas's register and spill counts),
then one JSON object (also written to ``--out``).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import chip_smoke

REPS = 20
# (label, -D overrides)
VARIANTS = [
    *((f"C={c}, {t} threads", {"KAO_SITE_CLUSTER": c, "KAO_SITE_THREADS": t})
      for c, t in ((8, 640), (8, 1024), (16, 640), (16, 320), (10, 1024),
                   (12, 1024), (14, 1024))),
    *((f"C=8, 640 threads, phases 0-{k}",
       {"KAO_SITE_CLUSTER": 8, "KAO_SITE_THREADS": 640,
        "KAO_SITE_PHASES": k}) for k in (0, 1, 2)),
    ("C=8, 640 threads, stand-in words, phases 0-1",
     {"KAO_SITE_CLUSTER": 8, "KAO_SITE_THREADS": 640,
      "KAO_SITE_FAKE_WORDS": 1, "KAO_SITE_PHASES": 1}),
]


def build(kernels, defines: dict):
    """Start nvcc for one variant; returns ``(process, library path)``."""
    flags = [*kernels.NVCC_FLAGS, "-Xptxas", "-v",
             *(f"-D{k}={v}" for k, v in sorted(defines.items()))]
    h = hashlib.sha256(" ".join(flags).encode())
    h.update((kernels.CSRC / "site.cu").read_bytes())
    h.update((kernels.CSRC / "common.cuh").read_bytes())
    out = kernels.BUILD_DIR / "variants" / f"site-{h.hexdigest()[:16]}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [kernels._nvcc(), *flags, "-o", str(out),
         str(kernels.CSRC / "site.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def time_variant(kernels, proc, lib_path, call, ref, whole: bool):
    """Load one built variant into the site-sweep wrapper, hold a whole
    sweep to the plain version, and return its device ms per call (None
    where the profiler missed a launch). Raises on a failed build,
    launch or comparison."""
    import torch

    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log}")
    # ptxas's register and spill lines for the kernel
    lines = log.splitlines()
    for j, line in enumerate(lines):
        if "site_sweep" in line and "Compiling" in line:
            print("  ptxas: " + " | ".join(x.split("ptxas info    :")[-1]
                                           .strip() for x in lines[j:j + 4]))
    fn = ctypes.CDLL(str(lib_path)).kao_site_sweep
    fn.argtypes = kernels.SITE.argtypes
    fn.restype = ctypes.c_int
    kernels.SITE._fn = fn  # the wrapper launches this variant
    got = call()
    torch.cuda.synchronize()
    if whole and not all(torch.equal(x, y) for x, y in zip(got, ref)):
        raise ValueError("differs from the plain version")
    ops = chip_smoke.sass_opcodes(kernels, str(lib_path), "site_sweep")
    print(f"  SASS: {len(ops)} instructions, "
          f"{sum(chip_smoke.alu_ops(ops).values())} vector ALU")
    events, _w = chip_smoke.profiled(call, torch, REPS)
    mine = [us for name, us in events if "site_sweep" in name]
    return sum(mine) / REPS / 1e3 if len(mine) == REPS else None


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("site_probe: no CUDA device", file=sys.stderr)
        return 1
    from kafka_assignment_optimizer_tpu_torch import prng
    from kafka_assignment_optimizer_tpu_torch.ops import kernels
    from kafka_assignment_optimizer_tpu_torch.ops.site_cuda import (
        site_step_cuda,
    )
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import sweep

    out_path = argv[argv.index("--out") + 1] if "--out" in argv else None
    chip_smoke.header(torch)
    jobs = [(label, defines, *build(kernels, defines))
            for label, defines in VARIANTS]
    dev = torch.device("cuda")
    _s, _i, m, _seed, a = chip_smoke.adversarial_population(torch, dev)
    _f, _r, cnt, lcnt, rcnt = sweep.histograms(m, a)
    key = prng.PRNGKey(1)
    temp = 0.5
    ref = sweep._site_sweep_delta(m, a, cnt, lcnt, rcnt, key, temp)

    def call():
        return site_step_cuda(m, a, cnt, lcnt, rcnt, key, temp)

    print(f"shape: N={a.shape[0]} P={a.shape[1]} R={a.shape[2]} "
          f"B+1={m.num_brokers + 1} K+1={m.rack_lo.shape[0]}")
    rows, failed = [], []
    for label, defines, proc, lib_path in jobs:
        whole = (defines.get("KAO_SITE_PHASES", 3) == 3
                 and not defines.get("KAO_SITE_FAKE_WORDS"))
        try:
            ms = time_variant(kernels, proc, lib_path, call, ref, whole)
        except (RuntimeError, ValueError) as e:
            print(f"{label}: FAILED: {e}")
            failed.append(label)
            continue
        rows.append({"variant": label, "defines": defines,
                     "exact": True if whole else None, "device_ms": ms})
        print(f"{label}: device "
              + ("not measured" if ms is None else f"{ms:.5f} ms per call")
              + (", exact" if whole else ""))
    kernels.SITE._fn = None
    line = json.dumps({"site_variants": rows})
    if out_path:
        with open(out_path, "w") as f:
            f.write(line + "\n")
    print(line)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
