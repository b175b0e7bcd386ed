"""The rng kernel: :func:`ptx_torch.core.rng.uniform_many` on a CUDA device.

A hand-written CUDA kernel in ``ptx_torch/csrc/rng_kernel.cu`` (the draw in
``rng_lane.cuh``).  It replaces no TPU kernel: the JAX package draws with
``jax.random``, whose threefry XLA fuses on the TPU.  Its plain version is
:func:`ptx_torch.core.rng.uniform_many_reference`, the same hash on int64
tensors, which ``rng.uniform_many`` runs on the CPU, and only there; the
kernel gives the same bits.

- Bound on this card by integer operations: about 76 int32 operations a
  uniform (20 rounds of add, rotate and xor, 10 key adds, the counter, the
  mantissa).  An SM dispatches at most 128 of them a clock: four schedulers
  of one 32-lane instruction each, the adds also as ``IMAD`` on the FMA
  pipe beside the 64 lanes of the integer pipe (the kernel outruns 64 a
  clock).  A demo train step's phase draws, 4 × (2·4,194,304 +
  4·1,398,101 + 11·262,144) = 67.46 M uniforms, are 5.1 G operations:
  0.15 ms at 128 × 132 SMs × 1.98 GHz, against 0.08 ms for their 270 MB
  of output at 3.35 TB/s.
- One launch draws up to ``CAPACITY`` keys, whose words travel in the
  launch's arguments: no device tensor of keys, no host-to-device copy, no
  synchronise.  A call with more keys launches once per ``CAPACITY``.

:func:`uniform_many` launches on CUDA tensors or raises.  ``LAUNCHES``
counts the launches, and each is also the recorder's counter
``rng_kernel_launches`` (:func:`ptx_torch.utils.profiling.count`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ptx_torch.ops import _build
from ptx_torch.ops._build import _raise_on, _stream
from ptx_torch.utils import profiling

CAPACITY = 64           # keys a launch (csrc/rng_kernel.cu kMaxKeys)
BLOCK = 256             # threads a block (the kernel's launch bound: at most 256)
_M = 0xFFFFFFFF

LAUNCHES = 0


def key_chunks(keys):
    """The launches of a call: for each run of up to ``CAPACITY`` keys, the
    index of its first key and its uint32 words, ``k1`` then ``k2`` a key."""
    words = []
    for k1, k2 in keys:
        words += (int(k1) & _M, int(k2) & _M)
    return [(s, words[2 * s:2 * (s + CAPACITY)]) for s in range(0, len(keys), CAPACITY)]


def uniform_many(keys, shape, device) -> torch.Tensor:
    """The float32 uniforms of ``keys`` over ``shape``, stacked: a
    ``(len(keys),) + shape`` tensor on the CUDA ``device``, drawn by the
    kernel (one launch per ``CAPACITY`` keys)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"rng kernel: no kernel for {device}")
    shape = tuple(shape)
    out = torch.empty((len(keys),) + shape, dtype=torch.float32, device=device)
    if out.numel():
        launch(_build.library(), keys, math.prod(shape), out, _stream(out.device))
    return out


def launch(lib, keys, n, out, stream) -> None:
    """Fill the contiguous float32 ``out``, ``len(keys)`` rows of ``n``, with
    one call of ``lib.ptx_uniform_many`` a chunk of :func:`key_chunks`, each
    given its chunk's words and its first row's address."""
    global LAUNCHES
    for start, words in key_chunks(keys):
        err = lib.ptx_uniform_many((ctypes.c_uint32 * len(words))(*words), len(words) // 2,
                                   n, out.data_ptr() + 4 * start * n, BLOCK, stream)
        _raise_on(err, lib, "rng kernel")
        LAUNCHES += 1
        profiling.count("rng_kernel_launches", 1)

