"""Image-texture gather whose backward is the histogram kernel K3 or K8.

Port of ``ptx/ops/imagegrad.py``.  ``img[yi, xi]`` is a nearest-texel
gather; its transpose adds each lane's cotangent into its texel.  The JAX
package wrote that transpose as two Pallas TPU kernels; here they are
``ptx_torch/csrc/image_hist_kernel.cu``:

- :func:`image_gather` is the gather as an autograd Function: its forward
  is the plain masked gather (the JAX package leaves it to XLA too), its
  backward :func:`hist`;
- :func:`hist` routes by image size, as ``image_gather._bwd`` does
  (``ptx/ops/imagegrad.py:324-384``): K3 (:class:`HistKernel`, the port of
  ``_build_hist``, :91) where the image fits one block's shared memory,
  K8 (:class:`BandedHistKernel`, the port of ``_build_banded_hist``,
  :218, as one pass of device-memory atomics) for every larger image;
- each wrapper launches its kernel on CUDA tensors (or raises) and runs
  :func:`hist_reference`, the plain version of both, on CPU tensors
  only; ``LAUNCHES`` (K3), ``BandedHistKernel.LAUNCHES`` (K8) and
  ``REFERENCE_CALLS`` count them.

``PTX_IMG_GRAD_COARSE=k`` (k > 1, read once at import) swaps the exact
transpose of a K8-sized image for the JAX package's coarse estimator
(``imagegrad.py:343-373``): the histogram at k×k-coarsened resolution
through K3, each coarse bin's total spread evenly over its texels.  Unlike
the JAX version, a bin is divided by its in-image texel count, not k², so
the per-bin totals stay exact where k divides neither H nor W.
"""

from __future__ import annotations

import os

import torch

LAUNCHES = 0
REFERENCE_CALLS = 0

K3_MAX_BYTES = 232_448        # a block's opt-in shared memory on Hopper (227 KB)
COARSE = int(os.environ.get("PTX_IMG_GRAD_COARSE", "0"))


def hist_reference(yi, xi, inb, ct, shape):
    """``d_img (H, W, C)``: ``ct (N, C)`` added into texel ``(yi, xi)`` of
    every lane with ``inb``, in plain PyTorch."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    out = torch.zeros(shape, dtype=ct.dtype, device=ct.device)
    return out.index_put_((yi, xi), torch.where(inb[:, None], ct, 0.0),
                          accumulate=True)


def _check(kernel, yi, xi, inb, ct, shape):
    from ptx_torch.ops.bounce_kernel import _check_inputs

    N = ct.shape[0]
    _check_inputs(kernel, ct.device, {
        "yi": (yi, (N,), torch.int64), "xi": (xi, (N,), torch.int64),
        "inb": (inb, (N,), torch.bool), "ct": (ct, (N, shape[2]), torch.float32)})
    if N == 0:
        raise ValueError(f"{kernel}: no lanes")


class HistKernel:
    """K3's wrapper: ``hist(yi, xi, inb, ct, shape)`` with flat int64
    ``yi``/``xi`` (already clipped into the image), bool ``inb`` and ``ct``
    (N, C) float32 → ``d_img`` (H, W, C), for images of at most
    ``K3_MAX_BYTES``."""

    def __call__(self, yi, xi, inb, ct, shape):
        if ct.device.type == "cpu":
            return hist_reference(yi, xi, inb, ct, shape)
        if ct.device.type != "cuda":
            raise ValueError(f"image histogram kernel: no kernel for {ct.device}")
        return self.launch(yi, xi, inb, ct, shape)

    def launch(self, yi, xi, inb, ct, shape):
        global LAUNCHES
        from ptx_torch.ops import _build
        from ptx_torch.ops.bounce_kernel import _ptr, _raise_on, _stream

        _check("image histogram kernel", yi, xi, inb, ct, shape)
        lib = _build.library()
        out = torch.zeros(shape, dtype=torch.float32, device=ct.device)
        H, W, C = shape
        err = lib.ptx_image_hist(_ptr(yi), _ptr(xi), _ptr(inb), _ptr(ct), ct.shape[0],
                                 H, W, C, _ptr(out), _stream(ct.device))
        _raise_on(err, lib, "image histogram kernel")
        LAUNCHES += 1
        return out


class BandedHistKernel:
    """K8's wrapper: :class:`HistKernel`'s call for images of any size
    below 2³¹ floats and at most 4 channels.  One launch adds each lane
    into the zero-filled output with device-memory atomics: no lane sort
    (the JAX package sorts outside Pallas, ``imagegrad.py:229-256``, because
    a TPU kernel has no scatter-add)."""

    LAUNCHES = 0

    def __call__(self, yi, xi, inb, ct, shape):
        if ct.device.type == "cpu":
            return hist_reference(yi, xi, inb, ct, shape)
        if ct.device.type != "cuda":
            raise ValueError(f"atomic histogram kernel: no kernel for {ct.device}")
        return self.launch(yi, xi, inb, ct, shape)

    def launch(self, yi, xi, inb, ct, shape):
        from ptx_torch.ops import _build
        from ptx_torch.ops.bounce_kernel import _ptr, _raise_on, _stream

        H, W, C = shape
        if H * W * C >= 1 << 31:
            raise ValueError(f"atomic histogram kernel: an image of {H * W * C} floats "
                             "(2^31 or more) overflows the kernel's int32 offsets")
        if C > 4:
            raise ValueError(f"atomic histogram kernel: {C} channels (at most 4)")
        _check("atomic histogram kernel", yi, xi, inb, ct, shape)
        lib = _build.library()
        out = torch.zeros(shape, dtype=torch.float32, device=ct.device)
        err = lib.ptx_image_hist_atomic(_ptr(yi), _ptr(xi), _ptr(inb), _ptr(ct),
                                        ct.shape[0], H, W, C, _ptr(out), _stream(ct.device))
        _raise_on(err, lib, "atomic histogram kernel")
        BandedHistKernel.LAUNCHES += 1
        return out


k3 = HistKernel()
k8 = BandedHistKernel()


def fits_k3(shape) -> bool:
    return shape[0] * shape[1] * shape[2] * 4 <= K3_MAX_BYTES


def coarse_hist(yi, xi, inb, ct, shape, k):
    """The coarse estimator: the histogram of the k×k-coarsened image
    through K3, each coarse bin divided by its in-image texel count and
    spread over those texels (per-bin totals exact)."""
    H, W, C = shape
    Hc, Wc = -(-H // k), -(-W // k)
    g = k3(yi // k, xi // k, inb, ct, (Hc, Wc, C))
    dev = ct.device
    ny = torch.clamp(H - k * torch.arange(Hc, device=dev), max=k)
    nx = torch.clamp(W - k * torch.arange(Wc, device=dev), max=k)
    g = g / (ny[:, None] * nx[None, :]).to(g.dtype)[..., None]
    return g.repeat_interleave(k, dim=0).repeat_interleave(k, dim=1)[:H, :W]


def hist(yi, xi, inb, ct, shape):
    """The gather's transpose ``d_img`` (H, W, C), routed by image size:
    K3 where the image fits one block's shared memory; past that the coarse
    estimator when ``PTX_IMG_GRAD_COARSE`` asks for it and the coarse image
    fits K3, else K8."""
    if fits_k3(shape):
        return k3(yi, xi, inb, ct, shape)
    H, W, C = shape
    if COARSE > 1 and fits_k3((-(-H // COARSE), -(-W // COARSE), C)):
        return coarse_hist(yi, xi, inb, ct, shape, COARSE)
    return k8(yi, xi, inb, ct, shape)


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
    index was inside.  Differentiable in ``img`` only, through K3 or K8."""
    return _ImageGather.apply(img, xi, yi, inb)
