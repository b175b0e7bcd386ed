"""Threefry-2x32 draws, bit-exact to ``jax.random`` with partitionable
threefry: the stream the benchmark keys both sides with and the stream the
reference tracer draws from.

Frozen copy of ``ptx_torch/core/rng.py`` at commit 4da45c6 (``threefry2x32``,
``PRNGKey``, ``fold``, ``uniform_many``, ``uniform``, ``sample_square``), so
that a later change to the port's generator cannot move the yardstick.
``dtype`` casts a draw after it is made (the lower-precision control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, on uint32 values held in Python ints or
    int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + k1) & _M
    x2 = (x2 + k2) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x1, x2


def PRNGKey(seed: int) -> tuple[int, int]:
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit a 32-bit int")
    return (0, seed & _M)


def fold(key, *data) -> tuple[int, int]:
    """``jax.random.fold_in`` once per datum, in order."""
    for d in data:
        key = threefry2x32(key[0], key[1], 0, int(d) & _M)
    return key


def root_key(seed: int) -> tuple[int, int]:
    """The key of a run's ``--seed``, which may exceed 32 bits:
    ``fold(PRNGKey(seed mod 2**31), seed // 2**31)``."""
    return fold(PRNGKey(seed % 2 ** 31), seed // 2 ** 31)


def uniform_many(keys, shape, device, dtype=torch.float32) -> torch.Tensor:
    """``stack([uniform(k, shape) for k in keys])`` in one batched hash."""
    shape = tuple(shape)
    n = math.prod(shape)
    k = torch.tensor(keys, dtype=torch.int64, device=device).reshape(-1, 2)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k[:, 0:1], k[:, 1:2], idx >> 32, idx & _M)
    bits = b1 ^ b2
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return u.reshape((len(keys),) + shape).to(dtype)


def uniform(key, shape, device, minval: float = 0.0, maxval: float = 1.0,
            dtype=torch.float32) -> torch.Tensor:
    u = uniform_many([key], shape, device)[0]
    if (minval, maxval) != (0.0, 1.0):
        lo = torch.tensor(np.float32(minval), device=device)
        span = torch.tensor(np.float32(maxval) - np.float32(minval), device=device)
        u = torch.maximum(lo, u * span + lo)
    return u.to(dtype)


def sample_square(key, shape, device, dtype=torch.float32) -> torch.Tensor:
    """Uniform in [0, 1)² with shape ``shape + (2,)``: the pixel jitter."""
    return uniform(key, tuple(shape) + (2,), device, dtype=dtype)
