#!/usr/bin/env python3
"""Time the default per-chunk sweep ladder of ``chip_smoke.py``'s phase
(k) on two checkouts of the repo within one run, on one NVIDIA GPU.

Run from the root of a checkout, with a second checkout (for example the
parent commit, unpacked by ``git archive`` into a directory that
``.gitignore`` lists):

    python3 ladder_ab.py OTHER_CHECKOUT [--out FILE]

The other checkout is A, this one B; they run in the order A B B A, each
in a process of its own started in its checkout (so it imports that
checkout's package and builds that checkout's kernels). A process builds
the kernels, solves once to warm up, then solves phase (k)'s pinned
solo (the adversarial instance, ``batch=8, rounds=128,
portfolio=False``, the boundary certificate off, 8 chunks of 16 sweeps)
on the default per-chunk ladder, synchronous and pipelined in the order
S P P S, and prints each solve's ``anneal_s``, ``dispatch_s``,
``device_s`` and wall. Every solve of every process must give the same
plan. Prints the card's name and power limit, one line a process, and
one JSON object last (also written to ``--out``); exits 1 on a
mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import json, time
import numpy as np
import torch
from kafka_assignment_optimizer_tpu_torch import optimize
from kafka_assignment_optimizer_tpu_torch.ops import kernels
from kafka_assignment_optimizer_tpu_torch.utils import gen

kernels.build_all()
scen = gen.adversarial()
kw = dict(solver="tpu", seed=0, batch=8, rounds=128, portfolio=False,
          cert_min_savings_s=1e9, time_limit_s=3600.0)
out = {"sync": [], "pipelined": []}
plans = []
for i, pipe in enumerate((False, False, True, True, False)):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = optimize(scen.current, scen.broker_list, scen.topology,
                   pipeline=pipe, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = res.solve.stats
    plans.append(np.asarray(res.solve.a).tolist())
    if i == 0:
        continue  # the warm-up solve
    out["pipelined" if pipe else "sync"].append({
        "anneal_s": st["anneal_s"], "dispatch_s": st["dispatch_s"],
        "device_s": st["device_s"], "dispatches": st["dispatches"],
        "wall_s": wall})
print(json.dumps({"runs": out, "same_plan": all(p == plans[0]
                                                for p in plans),
                  "plan": plans[0]}))
"""


def _run(tree: str) -> dict:
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=tree,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        print(r.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"ladder_ab: the process in {tree} exited "
                         f"{r.returncode}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other checkout (A)")
    ap.add_argument("--out", help="also write the JSON summary here")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"A": os.path.abspath(args.other), "B": here}
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(power)
    runs = []
    for name in "ABBA":
        got = _run(trees[name])
        runs.append({"tree": name, **got})
        print(f"{name} ({trees[name]}): " + json.dumps(got["runs"]))
    plans = [r.pop("plan") for r in runs]
    ok = all(r["same_plan"] for r in runs) and all(p == plans[0]
                                                   for p in plans)
    summary = {"card": power, "order": "ABBA", "trees": trees,
               "same_plan": ok, "runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
