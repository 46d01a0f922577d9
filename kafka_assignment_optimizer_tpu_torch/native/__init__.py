"""Native (C++) runtime components and their build/loading machinery.

The reference's native component is the external lp_solve 5.5 C solver it
shells out to (the upstream ``README.md:135-137``). This package bundles
the equivalent *in-process*: ``bb.cpp`` — a specialized exact
branch-and-bound for the reassignment model — compiled on first use with
the system ``g++`` into a cached shared library and bound via ctypes
(no pybind11 dependency).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path

_SRC = Path(__file__).with_name("bb.cpp")


def _build_dir() -> Path:
    d = Path(__file__).with_name("_build")
    d.mkdir(exist_ok=True)
    return d


def lib_path() -> Path:
    """Content-addressed artifact path: a source edit changes the hash, so
    stale libraries are never loaded and parallel builds never collide."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _build_dir() / f"libkao_{digest}.so"


def _compile(src: Path, out: Path, extra_flags: list[str],
             verbose: bool = False) -> Path:
    """Compile ``src`` to ``out`` with g++ if not already present:
    content-addressed artifact names make staleness impossible, a
    tempdir + ``os.replace`` makes concurrent builds publish atomically."""
    if out.exists():
        return out
    with tempfile.TemporaryDirectory(dir=_build_dir()) as td:
        tmp = Path(td) / out.name
        cmd = [
            "g++", "-std=c++17", "-Wall", "-Wextra", *extra_flags,
            str(src), "-o", str(tmp),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build failed:\n{' '.join(cmd)}\n{proc.stderr}"
            )
        if verbose and proc.stderr:
            logging.getLogger(__name__).warning(
                "native_build_warnings: %s", proc.stderr)
        os.replace(tmp, out)  # atomic publish
    return out


def build(verbose: bool = False) -> Path:
    return _compile(_SRC, lib_path(), ["-O3", "-shared", "-fPIC"], verbose)


_LIB: ctypes.CDLL | None = None


def load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.kao_solve.restype = ctypes.c_int
        lib.kao_solve.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # P B K R
            i32p, i32p, i32p, i32p,  # rf rack_of w_leader w_follower
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bands
            i32p, i32p, i32p,  # rack_lo rack_hi part_rack_hi
            i32p, ctypes.c_int64, ctypes.c_int,  # seed_a seed_w has_seed
            ctypes.c_double,  # time limit
            i32p, i64p, i64p,  # out_a out_objective out_nodes
        ]
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# min-cost max-flow kernel (mcmf.cpp) — leader-aware plan completion

_MCMF_SRC = Path(__file__).with_name("mcmf.cpp")


def mcmf_lib_path() -> Path:
    digest = hashlib.sha256(_MCMF_SRC.read_bytes()).hexdigest()[:16]
    return _build_dir() / f"libkao_mcmf_{digest}.so"


_MCMF_LIB: ctypes.CDLL | None = None


def load_mcmf() -> ctypes.CDLL:
    global _MCMF_LIB
    if _MCMF_LIB is None:
        path = _compile(_MCMF_SRC, mcmf_lib_path(),
                        ["-O3", "-shared", "-fPIC"])
        lib = ctypes.CDLL(str(path))
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.kao_mcmf.restype = ctypes.c_int
        lib.kao_mcmf.argtypes = [
            ctypes.c_int32, ctypes.c_int32,  # n_nodes n_arcs
            i32p, i32p, i32p, i32p,          # src dst cap cost
            ctypes.c_int32, ctypes.c_int32,  # s t
            i32p, i64p, i64p,                # out_arc_flow out_flow out_cost
        ]
        _MCMF_LIB = lib
    return _MCMF_LIB


def mcmf(src, dst, cap, cost, s: int, t: int, n_nodes: int):
    """Min-cost max-flow via the native kernel. Returns
    (total_flow, total_cost, per_arc_flow) or raises RuntimeError —
    rc=-1 for malformed input, rc=-2 when a negative-cost cycle is
    reachable (outside the successive-shortest-paths contract; the
    completion networks are DAG-layered so this never fires there)."""
    import numpy as np

    # range-check BEFORE the int32 cast: np.ascontiguousarray wraps
    # silently, and a wrapped cost would make a caller's bound
    # arithmetic (computed python-side with the unwrapped value)
    # quietly unsound — the callers all catch and fall back to an
    # exact LP, so raising here is the safe failure
    for name, arr in (("cap", np.asarray(cap)), ("cost", np.asarray(cost))):
        if arr.size and (
            int(arr.max(initial=0)) > np.iinfo(np.int32).max
            or int(arr.min(initial=0)) < np.iinfo(np.int32).min
        ):
            raise ValueError(f"{name} exceeds the kernel's int32 range")
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    cap = np.ascontiguousarray(cap, dtype=np.int32)
    cost = np.ascontiguousarray(cost, dtype=np.int32)
    n_arcs = src.size
    if not (dst.size == cap.size == cost.size == n_arcs):
        raise ValueError("arc arrays must have equal length")
    flow_out = np.zeros(n_arcs, dtype=np.int32)
    tf = ctypes.c_int64()
    tc = ctypes.c_int64()
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib = load_mcmf()
    rc = lib.kao_mcmf(
        ctypes.c_int32(n_nodes), ctypes.c_int32(n_arcs),
        src.ctypes.data_as(i32p), dst.ctypes.data_as(i32p),
        cap.ctypes.data_as(i32p), cost.ctypes.data_as(i32p),
        ctypes.c_int32(s), ctypes.c_int32(t),
        flow_out.ctypes.data_as(i32p),
        ctypes.byref(tf), ctypes.byref(tc),
    )
    if rc != 0:
        raise RuntimeError(f"kao_mcmf rejected the input (rc={rc})")
    return int(tf.value), int(tc.value), flow_out


# ---------------------------------------------------------------------------
# bundled lp_solve work-alike CLI (lp_cli.cpp)

_LP_SRC = Path(__file__).with_name("lp_cli.cpp")


def lp_cli_path() -> Path:
    digest = hashlib.sha256(_LP_SRC.read_bytes()).hexdigest()[:16]
    return _build_dir() / f"lp_cli_{digest}"


def build_lp_cli() -> Path:
    """Compile the bundled lp_solve-compatible CLI (LP-format parser +
    exact 0-1 branch-and-bound, ``lp_cli.cpp``) on first use."""
    return _compile(_LP_SRC, lp_cli_path(), ["-O2"])
