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

- ``split(key, n)`` (= ``jax.random.split``) hashes the counter pairs
  ``(0, i)``: its i-th key is ``fold(key, i)``;
- ``normal`` is ``√2 · erfinv(u)`` of a uniform ``u`` on (-1, 1), as
  ``jax.random.normal`` computes it; ``torch.erfinv`` is not XLA's
  polynomial, so it agrees to a few float32 ulps, not bit for bit.

Keys are tiny host values (Python ints), so folding costs no device
launches; draws run on the device the caller names.  uint32 arithmetic
is written on int64 tensors (or Python ints) masked with ``0xFFFFFFFF``:
the same code serves both.  On a CUDA device :func:`uniform_many`, and so
every draw of a shape, is the rng kernel (:mod:`ptx_torch.ops.rng_kernel`:
one launch, the keys in its arguments); the int64 route is its plain
version and runs on the CPU.

:class:`ReferenceLCG` and :func:`lcg_stream` are the reference's own
generator (path-trace.h:21-54), for single-threaded parity tests of
scalar sampling logic: ``v = 214013·v + 2531011`` over 64 bits, the high
32 bits returned, the seed XORed with 0x12476242; a draw maps to a float
as ``(x - min) / (max - min) · (hi - lo) + lo`` (vector3d.h:14-34).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ptx_torch.ops import rng_kernel

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


def split(key, n: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, n)`` as ``n`` keys."""
    return [tuple(k) for k in pixel_keys(key, n, "cpu").tolist()]


def pixel_keys(base_key, n: int, device) -> torch.Tensor:
    """One key per flattened ray (the JAX ``pixel_keys``): ``jax.random.
    split(base_key, n)`` as an (n, 2) int64 tensor of the keys' uint32
    words on ``device``."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return torch.stack(threefry2x32(base_key[0], base_key[1], idx >> 32, idx & _M), dim=-1)


def uniform(key, shape, device, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` (float32 in
    [minval, maxval))."""
    u = uniform_many([key], shape, device)[0]
    if (minval, maxval) == (0.0, 1.0):
        return u
    lo = torch.tensor(np.float32(minval), device=device)
    span = torch.tensor(np.float32(maxval) - np.float32(minval), device=device)
    return torch.maximum(lo, u * span + lo)


def normal(key, shape, device) -> torch.Tensor:
    """``jax.random.normal(key, shape)``: ``√2 · erfinv(u)``, ``u`` uniform
    on (-1, 1) from the same bits (module docstring on the agreement)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, device, minval=lo, maxval=1.0)
    return torch.tensor(np.float32(np.sqrt(2.0)), device=device) * torch.erfinv(u)


def sample_unit_ball(key, shape, device) -> torch.Tensor:
    """Uniform in the unit ball, ``shape + (3,)``: a normal direction times
    a cube-root radius, as ``ptx.core.rng.sample_unit_ball`` draws it (the
    exact distribution of the reference's cube rejection, vector3d.h:163-185)."""
    kd, kr = split(key)
    d = normal(kd, tuple(shape) + (3,), device)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)
    r = uniform(kr, shape, device) ** (1.0 / 3.0)
    return d * r[..., None]


def sample_square(key, shape, device) -> torch.Tensor:
    """Uniform in [0, 1)² with shape ``shape + (2,)``: the in-pixel
    anti-aliasing jitter (``ptx.core.rng.sample_square``)."""
    return uniform(key, tuple(shape) + (2,), device)


def uniform_many(keys, shape, device) -> torch.Tensor:
    """``stack([uniform(k, shape) for k in keys])`` in one batched hash —
    the port of ``trace_rays``'s vmapped per-phase draws.  On a CUDA
    device the rng kernel; on the CPU the int64 hash, its plain version."""
    device = torch.device(device)
    if device.type != "cpu":
        return rng_kernel.uniform_many(keys, shape, device)
    return uniform_many_reference(keys, shape, device)


def uniform_many_reference(keys, shape, device) -> torch.Tensor:
    """The rng kernel's plain version: :func:`uniform_many`'s hash on int64
    tensors on ``device`` (some 180 launches on a card)."""
    shape = tuple(shape)
    n = math.prod(shape)
    k = torch.tensor(keys, dtype=torch.int64, device=device).reshape(-1, 2)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k[:, 0:1], k[:, 1:2], idx >> 32, idx & _M)
    return _bits_to_unit_float(b1 ^ b2).reshape((len(keys),) + shape)


class ReferenceLCG:
    """Bit-exact clone of the reference ``DefaultRandomEngine`` (module
    docstring)."""

    MIN = 0
    MAX = 0xFFFFFFFF

    def __init__(self, seed: int = 0):
        self.seed(seed)

    def seed(self, value: int) -> None:
        self.v = np.uint64(value ^ 0x12476242)

    def __call__(self) -> int:
        with np.errstate(over="ignore"):
            self.v = np.uint64(214013) * self.v + np.uint64(2531011)
        return int(self.v >> np.uint64(32))

    def discard(self, count: int) -> None:
        for _ in range(count):
            self()

    def uniform(self, lo: float = 0.0, hi: float = 1.0) -> float:
        """One draw in [lo, hi], in float32 as ``uniform_real_distribution<float>``."""
        r = np.float32(self())
        r = np.float32(r / np.float32(self.MAX))
        return float(np.float32(r * np.float32(hi - lo) + np.float32(lo)))


def lcg_stream(seed: int, count: int) -> np.ndarray:
    """The first ``count`` raw draws of ``ReferenceLCG(seed)`` (uint32)."""
    out = np.empty(count, dtype=np.uint32)
    v = np.uint64(seed ^ 0x12476242)
    a, c = np.uint64(214013), np.uint64(2531011)
    with np.errstate(over="ignore"):
        for i in range(count):
            v = a * v + c
            out[i] = np.uint32(v >> np.uint64(32))
    return out
