"""Build, load and count the hand-written CUDA kernels.

Every kernel source under ``csrc/`` has a plain C interface: each entry
point takes raw device pointers, the sizes and the stream, launches on
that stream, and returns ``cudaGetLastError()``. The sources are compiled
with ``nvcc`` at first use into shared libraries under ``_build/``
(content-hashed, so an edited source rebuilds) and loaded with
``ctypes``. ``build_all`` starts one ``nvcc`` per source at once.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so that no
``a - b*c`` in the accept arithmetic is contracted into an FMA — the
kernels then round exactly as the plain PyTorch versions do. Fast-math
is never on: ``expf`` and IEEE division keep the Metropolis test equal
to ``torch.exp`` on the card.

Each ported kernel is a :class:`Kernel`: its wrapper adds one to
``launches`` where it launches the kernel and nowhere else, so a run can
show which kernels the main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
SOURCES = ("score", "site", "exchange")
HEADERS = ("common.cuh",)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu", *HEADERS):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library is built; returns
    ``(process, tmp, target)`` or None."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing


def build_all() -> None:
    """Compile every kernel source, one ``nvcc`` per source, in parallel."""
    with _LOCK:
        jobs = {n: _start(n) for n in SOURCES}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib


P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint32
F = ctypes.c_float


class Kernel:
    """One hand-written kernel: where it lives, the TPU kernels it
    replaces (``"file:line function"`` each), its C entry point and its
    launch count."""

    def __init__(self, name: str, source: str, symbol: str,
                 replaces: tuple[str, ...], argtypes: list):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.replaces = replaces
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        """Launch on the current stream; raises if the launch failed."""
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name} ({self.symbol}) failed to launch: CUDA "
                f"error {err}"
            )
        self.launches += 1


def check(name: str, t: torch.Tensor, dtype: torch.dtype,
          shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` has this dtype and shape, lies on ``device``
    and is contiguous — what the kernel's indexing assumes."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_model(m) -> None:
    """Check the ``ModelArrays`` tables the sweep kernels read, once per
    model (the result is cached on it, as its host scalars are)."""
    if m.__dict__.get("_kernel_checked"):
        return
    P, R = m.a0.shape
    B1 = m.num_brokers + 1
    K1 = m.rack_lo.shape[0]
    dev = m.a0.device
    if R > 16:
        raise ValueError(f"the kernels take at most 16 replica slots, got {R}")
    check("a0", m.a0, torch.int32, (P, R), dev)
    check("rf", m.rf, torch.int32, (P,), dev)
    check("slot_valid", m.slot_valid, torch.bool, (P, R), dev)
    check("part_rack_hi", m.part_rack_hi, torch.int32, (P,), dev)
    check("w_lead", m.w_lead, torch.int32, (P, B1), dev)
    check("w_foll", m.w_foll, torch.int32, (P, B1), dev)
    check("rack_of", m.rack_of, torch.int32, (B1,), dev)
    check("rack_lo", m.rack_lo, torch.int32, (K1,), dev)
    check("rack_hi", m.rack_hi, torch.int32, (K1,), dev)
    object.__setattr__(m, "_kernel_checked", True)


# the C signatures: pointers, then ints/floats, then the stream (added
# by Kernel.__call__)
SCORE = Kernel(
    "B1 score", "score", "kao_score",
    ("kafka_assignment_optimizer_tpu/ops/score_pallas.py:55 _score_kernel",),
    [P] * 8 + [I] * 9 + [P] * 4 + [P],
)
SITE = Kernel(
    "B2+B3 site sweep", "site", "kao_site_sweep",
    ("kafka_assignment_optimizer_tpu/ops/propose_pallas.py:66 "
     "_propose_kernel",
     "kafka_assignment_optimizer_tpu/ops/thin_pallas.py:59 "
     "_site_finish_kernel"),
    [P] * 13 + [U, U, F, F] + [I] * 9 + [P] * 5 + [P],
)
EXCHANGE = Kernel(
    "B4+B5+B6 exchange sweep", "exchange", "kao_exchange_sweep",
    ("kafka_assignment_optimizer_tpu/ops/propose_pallas.py:424 "
     "_exchange_kernel",
     "kafka_assignment_optimizer_tpu/ops/thin_pallas.py:247 "
     "_exch_maps_kernel",
     "kafka_assignment_optimizer_tpu/ops/thin_pallas.py:277 "
     "_exch_finish_kernel"),
    [P] * 8 + [U] * 6 + [F, F] + [I] * 7 + [P] * 3 + [P],
)

KERNELS = (SCORE, SITE, EXCHANGE)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0
