"""Counter-based random numbers: threefry2x32, as the reference draws them.

The reference sweep draws all of its randomness outside its kernels with
``jax.random`` under the default configuration (``threefry2x32``, with
``jax_threefry_partitionable`` on): one ``split`` per sweep, one ``bits``
tensor per proposal stage, and two ``randint`` calls for the exchange
pairing. This module reproduces those functions bit for bit, so that the
port replays the reference's trajectories exactly and the tests can
compare whole runs.

A key is a numpy ``uint32[2]`` array on the host, or an int64 tensor
``[2]`` of its two words on a device (a device key). Host draws run on
Python ints, a word at a time; ``bits`` for a large shape runs on the
device when given one. Every function here also takes a device key and
then draws on the key's device with no host read: ``split``, ``bits``
and ``randint`` (whose bounds may be device scalars too), so a chunk
step whose keys live on the card (a captured group, ``sweep``) splits
its sweep keys and draws its exchange and compound strides there.

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


def is_device_key(key) -> bool:
    """Whether ``key`` is a device key (a tensor), not a host array."""
    return isinstance(key, torch.Tensor)


def to_device_keys(keys, device) -> torch.Tensor:
    """Host keys ``uint32[..., 2]`` as device keys (int64 words) on
    ``device``: one copy, from pinned memory and without waiting on the
    card when ``device`` is a card. A device key passes through."""
    if is_device_key(keys):
        return keys
    host = torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64))
    device = torch.device(device)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def to_host_keys(keys) -> np.ndarray:
    """Device keys as host ``uint32[..., 2]`` (a device read); host keys
    pass through."""
    if not is_device_key(keys):
        return keys
    return keys.cpu().numpy().astype(np.uint32)


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


def split(key, num: int = 2):
    """``jax.random.split(key, num)`` -> ``uint32[num, 2]`` (device keys
    ``[num, 2]`` for a device key)."""
    if is_device_key(key):
        return split_rows(key.reshape(1, 2), num)[0]
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
    tensor computed on ``device`` (a device key draws on its own
    device)."""
    if is_device_key(key):
        return bits_rows(key.reshape(1, 2), shape)[0]
    o0, o1 = _hash(key, shape, device)
    return o0 ^ o1


def randint(key, shape, minval, maxval, device=None):
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 scalar
    bounds: int32 values, a numpy array when ``device`` is None, else a
    torch tensor computed on ``device``. Every product wraps at 32 bits,
    as the reference's uint32 arithmetic does. A device key draws on its
    device, and its bounds may be device scalars (int64 tensors)."""
    k1, k2 = split(key)
    higher = bits(k1, shape, device)
    lower = bits(k2, shape, device)
    if isinstance(minval, torch.Tensor) or isinstance(maxval, torch.Tensor):
        span = torch.where(torch.as_tensor(maxval <= minval),
                           1, (maxval - minval) & _MASK)
    else:
        minval, maxval = int(minval), int(maxval)
        span = 1 if maxval <= minval else (maxval - minval) & _MASK
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = (((higher % span) * multiplier) & _MASK) + lower % span
    out = minval + (offset & _MASK) % span
    if device is None and not isinstance(out, torch.Tensor):
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


def split_chain(keys, n: int):
    """``n`` successive splits of every key row of ``keys`` (``[rows,
    2]``), as the sweep engine splits a lane's key once a sweep: the
    sweep keys ``[n, rows, 2]`` and the keys after the ``n`` splits, in
    the keys' own form. Host keys split on the host (Python ints) into
    host keys; device keys split on their device (no host read) into
    device keys."""
    if is_device_key(keys):
        subs = []
        for _ in range(n):
            ks = split_rows(keys)
            keys = ks[:, 0]
            subs.append(ks[:, 1])
        if not subs:
            return keys.new_zeros((0, *keys.shape)), keys
        return torch.stack(subs), keys
    keys = np.array(keys, dtype=np.uint32).reshape(-1, 2)
    subs = np.zeros((n, *keys.shape), np.uint32)
    for i in range(n):
        for j in range(keys.shape[0]):
            keys[j], subs[i, j] = split(keys[j])
    return subs, keys
