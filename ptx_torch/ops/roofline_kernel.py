"""The roofline kernels K10 and K11: the card's FP32 and HBM ceilings.

Ports of the two Pallas TPU kernels of ``tools/roofline.py`` as
hand-written CUDA kernels in ``ptx_torch/csrc/roofline_kernel.cu``;
``python -m ptx_torch.roofline`` times them.

- K10, :func:`fma_chain`, replaces ``measure_vpu_peak`` (``pallas_call``
  at ``tools/roofline.py:69``): per element, ``reps`` passes of a 256-step
  chain ``x ← x + x·x·c``.  Bound on this card by operations: three
  separately rounded float32 operations a step (the kernels are built with
  ``-fmad=false``), at most 33.5 T a second on an H100 SXM, half the
  published 67 TFLOP/s, which counts a fused multiply-add as two.  It equals
  :func:`fma_chain_reference` bit for bit.
- K11, :func:`copy_plus_one`, replaces ``measure_hbm_bw_pallas``
  (``pallas_call`` at ``tools/roofline.py:127``): ``o = x + 1``.  Bound by
  bytes: each element read once and written once, at 3.35 TB/s.  It equals
  :func:`copy_plus_one_reference` bit for bit.

Each wrapper launches its kernel on CUDA tensors (or raises), and runs its
plain version on CPU tensors, and only on those.  Two counters hold the
kernels' launches (``FMA_LAUNCHES`` K10's, ``COPY_LAUNCHES`` K11's),
``REFERENCE_CALLS`` the plain versions' runs.
"""

from __future__ import annotations

import torch

from ptx_torch.ops import _build
from ptx_torch.ops._build import _check_inputs, _raise_on, _stream

STEPS = 256            # the TPU kernel's K: chain steps a pass (csrc/roofline_kernel.cu kSteps)
C_DEFAULT = 1e-9       # the TPU kernel's c
BLOCK = 256            # threads a block, both kernels (K11's launch bound: at most 256)

FMA_LAUNCHES = 0
COPY_LAUNCHES = 0
REFERENCE_CALLS = 0


def fma_chain_reference(x, reps: int, c: float = C_DEFAULT):
    """K10's plain version: ``reps`` × ``STEPS`` steps of ``x + x * x * c``,
    each operation a float32 tensor operation, rounded on its own."""
    c = torch.tensor(c, dtype=torch.float32, device=x.device)
    for _ in range(reps * STEPS):
        x = x + x * x * c
    return x


def copy_plus_one_reference(x):
    """K11's plain version: ``x + 1``."""
    return x + 1.0


def fma_chain(x, reps: int, c: float = C_DEFAULT, out=None):
    """K10: the chain on a float32 tensor; the kernel on a CUDA tensor, the
    plain version on a CPU one.  ``out`` optionally gives the output
    (contiguous, of ``x``'s shape)."""
    global FMA_LAUNCHES, REFERENCE_CALLS
    if x.device.type == "cpu":
        REFERENCE_CALLS += 1
        return _into(out, fma_chain_reference(x, reps, c))
    out = _checked("fma-chain kernel (K10)", x, out)
    if reps < 0:
        raise ValueError(f"fma-chain kernel (K10): reps must be >= 0, got {reps}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"fma-chain kernel (K10): {x.numel()} elements exceed an int")
    lib = _build.library()
    err = lib.ptx_fma_chain(x.data_ptr(), out.data_ptr(), x.numel(), reps, c, BLOCK,
                            _stream(x.device))
    _raise_on(err, lib, "fma-chain kernel (K10)")
    FMA_LAUNCHES += 1
    return out


def copy_plus_one(x, out=None):
    """K11: ``x + 1`` of a float32 tensor; the kernel on a CUDA tensor (both
    pointers 16-byte aligned), the plain version on a CPU one.  ``out``
    optionally gives the output."""
    global COPY_LAUNCHES, REFERENCE_CALLS
    if x.device.type == "cpu":
        REFERENCE_CALLS += 1
        return _into(out, copy_plus_one_reference(x))
    out = _checked("copy kernel (K11)", x, out)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("copy kernel (K11): input and output must be 16-byte aligned "
                         "(its float4 loads and stores)")
    lib = _build.library()
    err = lib.ptx_copy_plus_one(x.data_ptr(), out.data_ptr(), x.numel(), BLOCK,
                                _stream(x.device))
    _raise_on(err, lib, "copy kernel (K11)")
    COPY_LAUNCHES += 1
    return out


def _checked(kernel, x, out):
    """``out`` (allocated when None), after the checks both kernels need."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for {x.device}")
    if x.numel() == 0:
        raise ValueError(f"{kernel}: empty input")
    if out is None:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    _check_inputs(kernel, x.device, {"x": (x, x.shape, torch.float32),
                                     "out": (out, x.shape, torch.float32)})
    return out


def _into(out, value):
    """``value``, copied into ``out`` where one is given (the CPU route)."""
    return value if out is None else out.copy_(value)
