"""The entry points' device choice and the kernel build cache.

The counterpart of the reference package's ``utils.platform``. There,
:func:`pin_platform` makes ``JAX_PLATFORMS`` authoritative and
:func:`ensure_backend` initializes a JAX backend; here the choice is the
solve device: the card (``cuda``) unless the caller asks for ``cpu``,
and never a silent move to the CPU. The reference's persistent XLA
compile cache becomes the kernels' build directory
(``ops.kernels.build_dir``, ``KAO_COMPILE_CACHE``), whose hits and misses
:func:`compile_cache_stats` reports under the reference's keys.
"""

from __future__ import annotations

import os


def pin_platform(device: str | None = None) -> str:
    """The entry point's device: ``"cuda"`` unless ``device`` is
    ``"cpu"``. Raises ``RuntimeError`` when the card is asked for (or
    defaulted to) and absent. Returns the device type."""
    from ..solvers.tpu.engine import resolve_device

    return resolve_device(device).type


def ensure_backend(device: str | None = None) -> str:
    """The platform name a solve on ``device`` reports: ``"gpu"`` for the
    card, ``"cpu"`` otherwise (the reference returns its JAX backend's
    platform). Raises like :func:`pin_platform`."""
    from ..solvers.tpu.engine import resolve_device

    return "gpu" if resolve_device(device).type == "cuda" else "cpu"


def compile_cache_dir() -> str | None:
    """The kernels' build directory (``KAO_COMPILE_CACHE`` when set)."""
    from ..ops.kernels import build_dir

    return str(build_dir())


def set_compile_cache(path: str | None) -> None:
    """Point the kernel builds at ``path`` (the service's
    ``--compile-cache DIR``): several processes may share it."""
    if path:
        os.makedirs(path, exist_ok=True)
        os.environ["KAO_COMPILE_CACHE"] = path


def compile_cache_stats() -> dict:
    """The build directory and this process's traffic against it, under
    the reference's keys: ``hits`` (a kernel library loaded ready-built,
    by an earlier process or another worker sharing the directory) and
    ``misses`` (an ``nvcc`` build this process ran)."""
    from ..ops.kernels import cache_stats

    st = cache_stats()
    return {"dir": st["dir"], "enabled": st["enabled"],
            "hits": st["hits"], "misses": st["misses"]}
