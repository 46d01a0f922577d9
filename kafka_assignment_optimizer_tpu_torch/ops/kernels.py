"""Build, load and count the hand-written CUDA kernels.

Every kernel source under ``csrc/`` has a plain C interface: each entry
point takes raw device pointers, the sizes and the stream, launches on
that stream, and returns ``cudaGetLastError()``. The sources are compiled
with ``nvcc`` at first use into shared libraries under ``_build/``
(content-hashed, so an edited source rebuilds) and loaded with
``ctypes``. ``build_all`` starts one ``nvcc`` per source at once.
``KAO_COMPILE_CACHE`` (the service's ``--compile-cache DIR``) points the
libraries at another directory, which processes may share: a finished
build lands with ``os.replace``, so a second process sees all of a
library or none of it and builds its own. :func:`cache_stats` counts the
libraries this process loaded ready-built (hits) and built (misses).

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so that no
``a - b*c`` in the accept arithmetic is contracted into an FMA — the
kernels then round exactly as the plain PyTorch versions do. Fast-math
is never on: ``expf`` and IEEE division keep the Metropolis test equal
to ``torch.exp`` on the card.

Each ported kernel is a :class:`Kernel`: its wrapper adds one to
``launches`` where it launches the kernel and nowhere else, so a run can
show which kernels the main path went through.

Every kernel takes L lanes (1 to ``MAX_LANES``) in one launch: the model
tables of every lane (:class:`ModelTabs`, built once per model by
:func:`model_tabs`, lane stride 0 where the lanes share a table), the
bands and penalty scale among them, and for the sweeps each lane's sweep
key and temperature as device tensors (:func:`lane_values`). Every
per-lane value is read from device memory and none passes by value, so a
launch captured in a CUDA graph (``sweep``'s group graph) serves every
sweep and every model whose values are copied into the same buffers. A
single model is one lane. More lanes than one launch takes run as
launches of up to ``MAX_LANES`` lanes each (:func:`in_lane_groups`).
Launches made under :func:`recording` (a graph's warm-up and capture)
count into the recording instead; a graph's replay adds what it captured
(:func:`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .. import prng
from ..analysis import sanitize as _sanitize
from ..obs import flight as _flight
from ..solvers.tpu.arrays import lane_range

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
SOURCES = ("score", "site", "exchange")
HEADERS = ("common.cuh",)

# guards the bookkeeping below; never held while nvcc runs
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_CACHE = {"hits": 0, "misses": 0, "build_s": 0.0}
_BUILDING: dict[str, threading.Event] = {}  # a source's build in flight
_BUILT: set = set()  # the libraries this process built (its misses)


def build_dir() -> Path:
    """Where the libraries are built: ``KAO_COMPILE_CACHE`` when set (and
    not ``off``), else ``_build/`` beside the package."""
    want = os.environ.get("KAO_COMPILE_CACHE", "")
    if want and want.lower() not in ("off", "0", "none"):
        return Path(want)
    return BUILD_DIR


def cache_stats() -> dict:
    """The build directory and this process's traffic against it: hits
    (a library loaded ready-built), misses (an ``nvcc`` build) and the
    seconds the builds took. Never waits for a build in progress."""
    return {"dir": str(build_dir()), "enabled": True,
            "hits": _CACHE["hits"], "misses": _CACHE["misses"],
            "build_s": round(_CACHE["build_s"], 4)}


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
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library is built; returns
    ``(process, tmp, target, t0)`` or None (a hit)."""
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, job) -> None:
    proc, tmp, out, t0 = job
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    dt = time.perf_counter() - t0
    with _LOCK:
        _CACHE["misses"] += 1
        _CACHE["build_s"] += dt
        _BUILT.add(out)
    # a build inside a solve is that solve's compile time (obs.flight),
    # and the recompile sentinel's evidence (analysis.sanitize)
    _flight.note_compile(dt)
    _sanitize.note_compile(("kernel", out.name))


def _build(names) -> None:
    """Build the libraries of ``names`` not built yet, one ``nvcc`` per
    source, all at once, and wait for them. A source that another thread
    is building is waited for, never built twice in the process. The
    lock covers the bookkeeping only: nvcc runs with it released, so a
    thread that only reads the counters never waits for a build."""
    mine, theirs = [], []
    with _LOCK:
        for n in names:
            if n in _BUILDING:
                theirs.append(_BUILDING[n])
            elif not _target(n).exists():
                _BUILDING[n] = threading.Event()
                mine.append(n)
    try:
        jobs = {n: _start(n) for n in mine}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    finally:
        with _LOCK:
            done = [_BUILDING.pop(n) for n in mine]
        for ev in done:
            ev.set()
    for ev in theirs:
        ev.wait()


def build_all() -> None:
    """Compile every kernel source, one ``nvcc`` per source, in parallel."""
    _build(SOURCES)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
    if lib is not None:
        return lib
    _build([name])
    target = _target(name)
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if target not in _BUILT:
                _CACHE["hits"] += 1
            lib = ctypes.CDLL(str(target))
            _LIBS[name] = lib
        return lib


P = ctypes.c_void_p
I = ctypes.c_int

MAX_LANES = 64  # KAO_MAX_LANES in csrc/common.cuh

# the tables of common.cuh's ModelTabs, in its order: (ModelArrays field,
# ModelTabs field)
_TABLES = (("a0", "a0"), ("rf", "rf"), ("slot_valid", "valid"),
           ("part_rack_hi", "part_rack_hi"), ("w_lead", "w_lead"),
           ("w_foll", "w_foll"), ("rack_of", "rack_of"),
           ("rack_lo", "rack_lo"), ("rack_hi", "rack_hi"),
           ("broker_band", "broker_band"), ("leader_band", "leader_band"),
           ("lam", "lam"))


class ModelTabs(ctypes.Structure):
    """common.cuh's ModelTabs: each table's device pointer and its lane
    stride in elements."""

    _fields_ = [x for _f, c in _TABLES
                for x in ((c, ctypes.c_void_p), (c + "_s", ctypes.c_int64))]


# a thread's launch recording (recording()), or None: its launches count
# there, not in the kernels' counts
_TLS = threading.local()


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
        rec = getattr(_TLS, "rec", None)
        if rec is None:
            self.launches += 1
        else:
            rec[self.name] = rec.get(self.name, 0) + 1


@contextlib.contextmanager
def recording():
    """Count this thread's launches into the yielded dict (kernel name ->
    launches) instead of the kernels' counts: a CUDA graph's warm-up and
    capture, whose launches are no solve's work."""
    rec: dict = {}
    prev = getattr(_TLS, "rec", None)
    _TLS.rec = rec
    try:
        yield rec
    finally:
        _TLS.rec = prev


def add_launches(counts: dict) -> None:
    """Add a replayed CUDA graph's captured launches (kernel name ->
    launches) to the kernels' counts: what the card ran."""
    for k in KERNELS:
        k.launches += counts.get(k.name, 0)


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


def model_tabs(m) -> ModelTabs:
    """Check the tables of ``m`` (a single model, or a stacked one whose
    every table is ``[L, ...]`` with contiguous lanes at lane stride 0 or
    one lane's size) and return their :class:`ModelTabs`, once per model
    (cached on it, as its host scalars are)."""
    tabs = m.__dict__.get("_tabs")
    if tabs is not None:
        return tabs
    L = m.num_lanes
    P, R = m.a0.shape[-2:]
    B1 = m.num_brokers + 1
    K1 = m.rack_lo.shape[-1]
    dev = m.a0.device
    if R > 16:
        raise ValueError(f"the kernels take at most 16 replica slots, got {R}")
    if L > MAX_LANES:
        raise ValueError(f"a launch takes at most {MAX_LANES} lanes, got {L}")
    shapes = {"a0": (P, R), "rf": (P,), "slot_valid": (P, R),
              "part_rack_hi": (P,), "w_lead": (P, B1), "w_foll": (P, B1),
              "rack_of": (B1,), "rack_lo": (K1,), "rack_hi": (K1,),
              "broker_band": (2,), "leader_band": (2,), "lam": ()}
    dtypes = {"slot_valid": torch.bool, "lam": torch.float32}
    tabs = ModelTabs()
    # the penalty scale is one value a lane: [] or [1] (as from_numpy
    # lays a scalar out)
    shapes["lam"] = tuple(m.lam.shape[1:] if L else m.lam.shape)
    if shapes["lam"] not in ((), (1,)):
        raise ValueError(f"lam: shape {tuple(m.lam.shape)}, one value a "
                         "lane expected")
    for name, field in _TABLES:
        t = getattr(m, name)
        dtype = dtypes.get(name, torch.int32)
        if L:
            check(name, t[0], dtype, shapes[name], dev)
            if t.shape[0] != L or t.stride(0) not in (0, t[0].numel()):
                raise ValueError(f"{name}: lane axis {tuple(t.shape)} with "
                                 f"stride {t.stride(0)}")
            stride = t.stride(0)
        else:
            check(name, t, dtype, shapes[name], dev)
            stride = 0
        setattr(tabs, field, t.data_ptr())
        setattr(tabs, field + "_s", stride)
    object.__setattr__(m, "_tabs", tabs)
    return tabs


def lane_values(keys, temps, L: int, device) -> tuple:
    """A sweep launch's per-lane values as the kernels read them: ``(keys
    int64 [L, 2], temps float32 [L])`` on ``device``. Device tensors (a
    chunk's sweep keys and temperature table rows) pass through checked;
    host keys and temperatures (lists, arrays, floats) go to the device in
    one copy each, without waiting for the card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not isinstance(keys, torch.Tensor):
        keys = prng.to_device_keys(np.asarray(keys, np.uint32).reshape(L, 2),
                                   device)
    if not isinstance(temps, torch.Tensor):
        temps = torch.tensor(np.asarray(temps, np.float32).reshape(L))
        temps = (temps.pin_memory().to(device, non_blocking=True)
                 if device.type == "cuda" else temps.to(device))
    check("keys", keys, torch.int64, (L, 2), device)
    check("temps", temps, torch.float32, (L,), device)
    return keys, temps


def lane_count(m, L: int) -> None:
    """Raise unless a launch of ``L`` lanes fits the kernels and matches
    the model (a single model is one lane)."""
    if not 1 <= L <= MAX_LANES:
        raise ValueError(f"a launch takes 1 to {MAX_LANES} lanes, got {L}")
    if L != max(m.num_lanes, 1):
        raise ValueError(f"{L} lanes of state for a model of "
                         f"{max(m.num_lanes, 1)}")


def _cat_lanes(outs):
    """Concatenate the launches' outputs (tensors, or tuples of them) on
    the lane axis."""
    if isinstance(outs[0], tuple):
        return tuple(_cat_lanes(x) for x in zip(*outs))
    return torch.cat(outs)


def in_lane_groups(launch):
    """Wrap a kernel's ``launch(m, a, *args)``, whose every argument after
    the stacked model ``m`` has a leading lane axis (tensors, lists of
    keys or temperatures): more lanes than one launch takes run as
    launches of up to ``MAX_LANES`` lanes each, one a group of lanes,
    their outputs concatenated on the lane axis. A launch's lanes are
    independent, so the result is the one launch's."""
    @functools.wraps(launch)
    def run(m, a, *args):
        L = a.shape[0]
        if L <= MAX_LANES:
            return launch(m, a, *args)
        return _cat_lanes([
            launch(lane_range(m, lo, min(lo + MAX_LANES, L)),
                   *(x[lo:lo + MAX_LANES] for x in (a, *args)))
            for lo in range(0, L, MAX_LANES)])

    return run


def exchange_host_keys(key, parts: int) -> tuple:
    """The exchange kernel's draws of one lane's sweep key (made in its
    phase 0 on the card), from the same C code on the host, as
    ``exchange_cuda.host_keys`` returns them: ``(kbits, d, k_hi, k_lo)``
    (for the card tests)."""
    fn = library("exchange").kao_exchange_host_keys
    fn.argtypes = [ctypes.c_uint32, ctypes.c_uint32, I, P]
    fn.restype = None
    k = np.asarray(key, np.uint32).reshape(2)
    out = np.zeros(7, np.uint32)
    fn(int(k[0]), int(k[1]), int(parts), out.ctypes.data)
    return out[0:2].copy(), int(out[2]), out[3:5].copy(), out[5:7].copy()


# the C signatures: the tables, the sweeps' keys and temperatures, the lane
# count and the sizes, then the tensors, then the stream (added by
# Kernel.__call__)
SCORE = Kernel(
    "B1 score", "score", "kao_score",
    ("kafka_assignment_optimizer_tpu/ops/score_pallas.py:55 _score_kernel",),
    [P] + [I] * 6 + [P] * 5 + [P],
)
SITE = Kernel(
    "B2+B3 site sweep", "site", "kao_site_sweep",
    ("kafka_assignment_optimizer_tpu/ops/propose_pallas.py:66 "
     "_propose_kernel",
     "kafka_assignment_optimizer_tpu/ops/thin_pallas.py:59 "
     "_site_finish_kernel"),
    [P, P, P] + [I] * 6 + [P] * 9 + [P],
)
EXCHANGE = Kernel(
    "B4+B5+B6 exchange sweep", "exchange", "kao_exchange_sweep",
    ("kafka_assignment_optimizer_tpu/ops/propose_pallas.py:424 "
     "_exchange_kernel",
     "kafka_assignment_optimizer_tpu/ops/thin_pallas.py:247 "
     "_exch_maps_kernel",
     "kafka_assignment_optimizer_tpu/ops/thin_pallas.py:277 "
     "_exch_finish_kernel"),
    [P, P, P] + [I] * 5 + [P] * 5 + [P],
)

KERNELS = (SCORE, SITE, EXCHANGE)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0
