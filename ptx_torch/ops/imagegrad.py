"""Image-texture gather whose backward is the histogram kernel K3.

Port of ``ptx/ops/imagegrad.py``.  ``img[yi, xi]`` is a nearest-texel
gather; its transpose adds each lane's cotangent into its texel.  The JAX
package wrote that transpose as a Pallas TPU kernel (``_build_hist`` /
``_hist_kernel``, ``ptx/ops/imagegrad.py:91``, one-hot MXU matrices with a
hi/lo bf16 split).  Here it is ``ptx_torch/csrc/image_hist_kernel.cu``:

- :func:`image_gather` is the gather as an autograd Function: its forward
  is the plain masked gather (the JAX package leaves it to XLA too), its
  backward :class:`HistKernel`;
- :class:`HistKernel` launches K3 on CUDA tensors (or raises) and runs
  :func:`hist_reference`, the plain version, on CPU tensors only;
- ``LAUNCHES`` and ``REFERENCE_CALLS`` count the kernel's launches and the
  plain version's calls.

The banded kernel of the JAX module for images too large for its VMEM
(``_build_banded_hist``, K8) is not ported yet: K3's global-atomic path
takes every image here.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = 0
REFERENCE_CALLS = 0


def hist_reference(yi, xi, inb, ct, shape):
    """``d_img (H, W, C)``: ``ct (N, C)`` added into texel ``(yi, xi)`` of
    every lane with ``inb``, in plain PyTorch."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    out = torch.zeros(shape, dtype=ct.dtype, device=ct.device)
    return out.index_put_((yi, xi), torch.where(inb[:, None], ct, 0.0),
                          accumulate=True)


class HistKernel:
    """K3's wrapper: ``hist(yi, xi, inb, ct, shape)`` with flat int64
    ``yi``/``xi`` (already clipped into the image), bool ``inb`` and ``ct``
    (N, C) float32 → ``d_img`` (H, W, C)."""

    used_shared = None           # whether the last launch took the shared path

    def __call__(self, yi, xi, inb, ct, shape):
        if ct.device.type == "cpu":
            return hist_reference(yi, xi, inb, ct, shape)
        if ct.device.type != "cuda":
            raise ValueError(f"image histogram kernel: no kernel for {ct.device}")
        return self.launch(yi, xi, inb, ct, shape)

    def launch(self, yi, xi, inb, ct, shape):
        global LAUNCHES
        from ptx_torch.ops import _build
        from ptx_torch.ops.bounce_kernel import (_check_inputs, _ptr, _raise_on,
                                                 _stream)

        N, C = ct.shape
        H, W, C_img = shape
        device = ct.device
        _check_inputs("image histogram kernel", device, {
            "yi": (yi, (N,), torch.int64), "xi": (xi, (N,), torch.int64),
            "inb": (inb, (N,), torch.bool), "ct": (ct, (N, C_img), torch.float32)})
        if N == 0:
            raise ValueError("image histogram kernel: no lanes")
        lib = _build.library()
        out = torch.zeros(shape, dtype=torch.float32, device=device)
        used = ctypes.c_int(0)
        err = lib.ptx_image_hist(_ptr(yi), _ptr(xi), _ptr(inb), _ptr(ct), N, H, W,
                                 C, _ptr(out), ctypes.byref(used), _stream(device))
        _raise_on(err, lib, "image histogram kernel")
        HistKernel.used_shared = bool(used.value)
        LAUNCHES += 1
        return out


hist = HistKernel()


class _ImageGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, xi, yi, inb):
        ctx.save_for_backward(xi, yi, inb)
        ctx.shape = tuple(img.shape)
        return torch.where(inb[..., None], img[yi, xi], 0.0)

    @staticmethod
    def backward(ctx, ct):
        xi, yi, inb = ctx.saved_tensors
        C = ctx.shape[-1]
        d_img = hist(yi.reshape(-1), xi.reshape(-1), inb.reshape(-1),
                     ct.reshape(-1, C).contiguous(), ctx.shape)
        return d_img, None, None, None


def image_gather(img, xi, yi, inb):
    """Bounds-masked nearest gather ``where(inb, img[yi, xi], 0)``.

    ``img`` (H, W, C) float32; ``xi``/``yi`` int64 of any shape, already
    clipped into range by the caller; ``inb`` marks lanes whose unclipped
    index was inside.  Differentiable in ``img`` only, through K3."""
    return _ImageGather.apply(img, xi, yi, inb)
