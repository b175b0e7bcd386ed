"""Counter-based random draws, bit-exact to ``jax.random`` (threefry2x32).

Port of the production samplers of ``ptx/core/rng.py``.  It reproduces
jax 0.9.0 with ``jax_threefry_partitionable=True`` (``jax/_src/prng.py``):

- a key is the pair ``(k1, k2)`` of uint32 words; ``PRNGKey(seed)`` is
  ``(0, seed mod 2**32)`` for a 32-bit seed;
- ``fold(key, d)`` (= ``jax.random.fold_in``) hashes the counter pair
  ``(0, d)`` under ``key``;
- ``uniform(key, shape)`` hashes the counter pairs ``(i >> 32, i mod
  2**32)`` for the flat index ``i`` of every element, xors the two output
  words, keeps the top 23 bits as the mantissa of a float in [1, 2) and
  subtracts 1.

Keys are tiny host values (Python ints), so folding costs no device
launches; draws run on the device the caller names.  uint32 arithmetic
is written on int64 tensors (or Python ints) masked with ``0xFFFFFFFF``:
the same code serves both.
"""

from __future__ import annotations

import math

import torch

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher, 20 rounds (jax ``_threefry2x32_lowering``).

    Arguments are uint32 values held in Python ints or int64 tensors
    (broadcasting); returns the two output words the same way."""
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
    """``jax.random.PRNGKey`` for a 32-bit seed (jax's default int width)."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit a 32-bit int")
    return (0, seed & _M)


def fold(key, *data) -> tuple[int, int]:
    """``jax.random.fold_in`` applied once per datum, in order."""
    for d in data:
        key = threefry2x32(key[0], key[1], 0, int(d) & _M)
    return key


def _bits_to_unit_float(bits):
    """uint32 bits → float32 in [0, 1): jax's mantissa trick."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1))."""
    return uniform_many([key], shape, device)[0]


def sample_square(key, shape, device) -> torch.Tensor:
    """Uniform in [0, 1)² with shape ``shape + (2,)``: the in-pixel
    anti-aliasing jitter (``ptx.core.rng.sample_square``)."""
    return uniform(key, tuple(shape) + (2,), device)


def uniform_many(keys, shape, device) -> torch.Tensor:
    """``stack([uniform(k, shape) for k in keys])`` in one batched hash —
    the port of ``trace_rays``'s vmapped per-phase draws."""
    shape = tuple(shape)
    n = math.prod(shape)
    k = torch.tensor(keys, dtype=torch.int64, device=device).reshape(-1, 2)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k[:, 0:1], k[:, 1:2], idx >> 32, idx & _M)
    return _bits_to_unit_float(b1 ^ b2).reshape((len(keys),) + shape)
