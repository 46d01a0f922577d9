"""LP-format emitter + lp_solve subprocess adapter (reference L4/L5).

Emits the exact lp_solve LP-format dialect of the reference's worked sample
(the upstream ``README.md:144-185``): ``max:`` objective over
``t{topicIdx}b{brokerId}p{partitionId}[_l]`` variables, ``//``-commented
constraint sections in the same order, and a trailing ``bin`` block
declaring the *full* broker x partition cross product binary
(``README.md:182-184``).

The reference solves this text with the external native lp_solve 5.5 C
solver (``README.md:135-137``). When an ``lp_solve`` binary is on PATH,
``--solver=lp_solve`` shells out to it exactly as the reference does;
otherwise the in-process HiGHS backend (`.milp`) covers the exact path.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

from ..models.instance import ProblemInstance
from .base import SolveResult, register


def var_name(inst: ProblemInstance, p: int, b: int, leader: bool) -> str:
    """``t{t}b{b}p{p}`` naming with 1-based topic index (README.md:146)."""
    t = int(inst.topic_of_part[p]) + 1
    broker = int(inst.broker_ids[b])
    part = int(inst.part_id[p])
    return f"t{t}b{broker}p{part}" + ("_l" if leader else "")


def emit_lp(inst: ProblemInstance) -> str:
    """Serialize the model to lp_solve LP format, section-for-section in the
    reference sample's order (README.md:144-185)."""
    P, B, K = inst.num_parts, inst.num_brokers, inst.num_racks
    out: list[str] = []

    # objective (README.md:145-146)
    out.append("// Optimization function, based on current assignment ")
    terms = []
    for p in range(P):
        for b in range(B):
            wl = int(inst.w_leader[p, b])
            wf = int(inst.w_follower[p, b])
            if wl:
                terms.append(f"{wl} {var_name(inst, p, b, True)}")
            if wf:
                terms.append(f"{wf} {var_name(inst, p, b, False)}")
    out.append("max: " + " + ".join(terms) + ";")
    out.append("")

    def row(coeffs: list[str], op: str, rhs: int) -> str:
        return " + ".join(coeffs) + f" {op} {rhs};"

    # C4 replication factor (README.md:148-151)
    out.append("// Constrain on replication factor for every partition")
    for p in range(P):
        vs = [var_name(inst, p, b, r) for b in range(B) for r in (False, True)]
        out.append(row(vs, "=", int(inst.rf[p])))
    out.append("")

    # C5 one leader per partition (README.md:153-156)
    out.append("// Constraint on having one and only one leader per partition")
    for p in range(P):
        out.append(row([var_name(inst, p, b, True) for b in range(B)], "=", 1))
    out.append("")

    # C6 per-broker replica band (README.md:158-161)
    out.append("// Constraint on min/max replicas per broker")
    for b in range(B):
        vs = [var_name(inst, p, b, r) for p in range(P) for r in (False, True)]
        out.append(row(vs, "<=", inst.broker_hi))
        out.append(row(vs, ">=", inst.broker_lo))
    out.append("")

    # C7 per-broker leader band (README.md:163-166)
    out.append("// Constraint on min/max leaders per broker")
    for b in range(B):
        vs = [var_name(inst, p, b, True) for p in range(P)]
        out.append(row(vs, "<=", inst.leader_hi))
        out.append(row(vs, ">=", inst.leader_lo))
    out.append("")

    # C8 uniqueness per (broker, partition) (README.md:168-171)
    out.append("// Constraint on no leader and replicas on the same broker")
    for b in range(B):
        for p in range(P):
            out.append(
                row([var_name(inst, p, b, False), var_name(inst, p, b, True)],
                    "<=", 1)
            )
    out.append("")

    # C9 per-rack replica band (README.md:173-176)
    rack_members = [
        [b for b in range(B) if int(inst.rack_of_broker[b]) == k]
        for k in range(K)
    ]
    # each rack block carries its rack name in the comment, matching the
    # reference sample's "... per racks. tor02 here" (README.md:173)
    for k in range(K):
        members = rack_members[k]
        out.append(
            "// Constrain on min/max total replicas per racks. "
            f"{inst.rack_names[k]} here"
        )
        vs = [
            var_name(inst, p, b, r)
            for b in members
            for p in range(P)
            for r in (False, True)
        ]
        out.append(row(vs, "<=", int(inst.rack_hi[k])))
        out.append(row(vs, ">=", int(inst.rack_lo[k])))
    out.append("")

    # C10 per-partition per-rack diversity (README.md:178-180); comment
    # names the (partition, rack) pair per the sample's "p0 on tor02
    # here" (README.md:178)
    for p in range(P):
        for k in range(K):
            out.append(
                "// Constrain on min/max replicas per partitions per "
                f"racks. p{p} on {inst.rack_names[k]} here"
            )
            vs = [
                var_name(inst, p, b, r)
                for b in rack_members[k]
                for r in (False, True)
            ]
            out.append(row(vs, "<=", int(inst.part_rack_hi[p])))
    out.append("")

    # binary domain over the full cross product (README.md:182-184)
    out.append("// All variables are binary")
    out.append("bin")
    names = [
        var_name(inst, p, b, r)
        for p in range(P)
        for b in range(B)
        for r in (False, True)
    ]
    out.append(", ".join(names) + ";")
    return "\n".join(out) + "\n"


def parse_lp_solve_output(
    inst: ProblemInstance, text: str
) -> np.ndarray:
    """Parse ``lp_solve -S4`` variable listing back to a candidate
    ``A[P, R]`` (reference L6, README.md:65-78)."""
    P, B = inst.num_parts, inst.num_brokers
    x = np.zeros((P, B), dtype=np.int64)
    y = np.zeros((P, B), dtype=np.int64)
    name_to = {}
    for p in range(P):
        for b in range(B):
            name_to[var_name(inst, p, b, False)] = (x, p, b)
            name_to[var_name(inst, p, b, True)] = (y, p, b)
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 2 and parts[0] in name_to:
            arr, p, b = name_to[parts[0]]
            arr[p, b] = int(round(float(parts[1])))
    a = np.full((P, inst.max_rf), B, dtype=np.int32)
    for p in range(P):
        leaders = np.flatnonzero(y[p])
        followers = np.flatnonzero(x[p])
        if len(leaders) != 1:
            raise RuntimeError(
                f"lp_solve solution: partition {p} has {len(leaders)} leaders"
            )
        reps = [int(leaders[0])] + [int(b) for b in followers]
        a[p, : len(reps)] = reps
    return a


def _bundled_lp_solve() -> Path | None:
    """Build (once) and return the bundled lp_solve-compatible CLI.

    Upstream lp_solve 5.5 cannot be fetched here (no network egress), so
    the repo bundles a work-alike (``native/lp_cli.cpp``): a real
    separate binary that parses the emitted LP text and solves the 0-1
    program exactly — the subprocess path executes end to end either
    way. A system ``lp_solve`` on PATH always takes precedence."""
    try:
        from ..native import build_lp_cli

        return build_lp_cli()
    except Exception:  # no g++ / build failure: path simply unavailable
        return None


def _lp_solve_exe() -> tuple[str, bool] | None:
    """(executable, is_system) for the preferred LP-solving subprocess."""
    exe = shutil.which("lp_solve")
    if exe is not None:
        return exe, True
    bundled = _bundled_lp_solve()
    if bundled is not None:
        return str(bundled), False
    return None


def lp_solve_available() -> bool:
    return _lp_solve_exe() is not None


@register("lp_solve")
def solve_lp_solve(
    inst: ProblemInstance, time_limit_s: float = 600.0, **_unused
) -> SolveResult:
    picked = _lp_solve_exe()
    if picked is None:
        raise RuntimeError(
            "no lp_solve binary on PATH and the bundled lp_cli failed to "
            "build; use --solver=milp for the exact in-process backend"
        )
    exe, is_system = picked
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        lp_path = Path(td) / "model.lp"
        lp_path.write_text(emit_lp(inst))
        # both the system lp_solve 5.5 and the bundled CLI honor
        # -timeout and return their best-so-far incumbent as rc=1; the
        # subprocess timeout is only a backstop against a hung binary
        cmd = [exe, "-S4", "-timeout", str(int(max(1, time_limit_s))),
               str(lp_path)]
        try:
            proc = subprocess.run(
                cmd,
                capture_output=True,
                text=True,
                timeout=time_limit_s + 30.0,
            )
        except subprocess.TimeoutExpired as e:
            raise RuntimeError(
                f"lp_solve ignored -timeout and ran past "
                f"{time_limit_s + 30.0:.0f}s; raise --time-limit or use "
                "--solver=milp"
            ) from e
        if proc.returncode == 7:  # timeout before any incumbent
            raise RuntimeError(
                f"lp_solve found no solution within {time_limit_s:.0f}s; "
                "raise --time-limit or use --solver=milp"
            )
        if proc.returncode not in (0, 1):  # 1 = feasible but timed out
            raise RuntimeError(
                f"lp_solve failed (rc={proc.returncode}): "
                f"{(proc.stderr or proc.stdout)[:500]}"
            )
        a = parse_lp_solve_output(inst, proc.stdout)
    return SolveResult(
        a=a,
        solver="lp_solve",
        wall_clock_s=time.perf_counter() - t0,
        objective=inst.preservation_weight(a),
        optimal=proc.returncode == 0,
        stats={"backend": "system" if is_system else "bundled_lp_cli"},
    )
