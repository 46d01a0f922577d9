"""Counter-based random numbers: threefry2x32, as the reference draws them.

The reference sweep draws all of its randomness outside its kernels with
``jax.random`` under the default configuration (``threefry2x32``, with
``jax_threefry_partitionable`` on): one ``split`` per sweep, one ``bits``
tensor per proposal stage, and two ``randint`` calls for the exchange
pairing. This module reproduces those functions bit for bit, so that the
port replays the reference's trajectories exactly and the tests can
compare whole runs.

Keys are numpy ``uint32[2]`` arrays and live on the host: deriving a key
is two 32-bit words of arithmetic, and scalars drawn from keys (the
exchange stride) are needed on the host anyway. Host draws run on Python
ints, a word at a time (every host draw of the program is a word or
two); ``bits`` for a large shape runs on the device when given one.

Arithmetic is masked to 32 bits (``& 0xFFFFFFFF``), on torch int64
tensors on a device (torch has no unsigned 32-bit shifts on every
device), so that one code path serves Python ints and tensors alike.
The returned bits are int64 values in ``[0, 2**32)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def _threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 (20 rounds) of the count pair ``(x0, x1)`` under key
    ``(k0, k1)``. ``x0``/``x1`` are Python ints or torch int64 tensors of
    values in ``[0, 2**32)``; returns the two output words likewise."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in (_ROT0 if i % 2 == 0 else _ROT1):
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _key_words(key) -> tuple[int, int]:
    k = np.asarray(key, dtype=np.uint32)
    if k.shape != (2,):
        raise ValueError(f"a key is uint32[2], got shape {k.shape}")
    return int(k[0]), int(k[1])


def _hash(key, shape, device=None):
    """The two output words at the flat 64-bit counters of ``shape``: numpy
    int64 arrays when ``device`` is None, else torch tensors on it."""
    k0, k1 = _key_words(key)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if device is None:
        out = np.array([_threefry2x32(k0, k1, c >> 32, c & _MASK)
                        for c in range(n)], dtype=np.int64).reshape(n, 2)
        return out[:, 0].reshape(shape), out[:, 1].reshape(shape)
    c = torch.arange(n, dtype=torch.int64, device=device)
    o0, o1 = _threefry2x32(k0, k1, c >> 32, c & _MASK)
    return o0.reshape(shape), o1.reshape(shape)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    return np.array([0, int(seed) & _MASK], dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` -> ``uint32[num, 2]``."""
    o0, o1 = _hash(key, (num,))
    return np.stack([o0, o1], axis=1).astype(np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    k0, k1 = _key_words(key)
    o0, o1 = _threefry2x32(k0, k1, 0, int(data) & _MASK)
    return np.array([o0, o1], dtype=np.uint32)


def bits(key, shape, device=None):
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    ``[0, 2**32)``: a numpy array when ``device`` is None, else a torch
    tensor computed on ``device``."""
    o0, o1 = _hash(key, shape, device)
    return o0 ^ o1


def randint(key, shape, minval: int, maxval: int, device=None):
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 scalar
    bounds: int32 values, a numpy array when ``device`` is None, else a
    torch tensor computed on ``device``. Every product wraps at 32 bits,
    as the reference's uint32 arithmetic does."""
    k1, k2 = split(key)
    higher = bits(k1, shape, device)
    lower = bits(k2, shape, device)
    minval, maxval = int(minval), int(maxval)
    span = 1 if maxval <= minval else (maxval - minval) & _MASK
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = (((higher % span) * multiplier) & _MASK) + lower % span
    out = minval + (offset & _MASK) % span
    if device is None:
        return out.astype(np.int32)
    return out.to(torch.int32)


def _hash_rows(keys: torch.Tensor, n: int):
    """The two output words at flat counters ``0..n-1`` under each row of
    ``keys`` (int64 ``[N, 2]`` of uint32 values, on a device): ``[N, n]``
    each."""
    c = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    return _threefry2x32(keys[:, :1], keys[:, 1:], c >> 32, c & _MASK)


def split_rows(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of every row of ``keys`` (int64 ``[N, 2]``):
    int64 ``[N, num, 2]``, on the keys' device."""
    o0, o1 = _hash_rows(keys, num)
    return torch.stack([o0, o1], dim=-1)


def bits_rows(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` for every row of ``keys``
    (int64 ``[N, 2]``): int64 ``[N, *shape]`` of values in
    ``[0, 2**32)``, on the keys' device."""
    shape = tuple(int(s) for s in shape)
    o0, o1 = _hash_rows(keys, math.prod(shape))
    return (o0 ^ o1).reshape(keys.shape[0], *shape)
