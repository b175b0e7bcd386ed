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
- K3 has two regimes, which :func:`k3_plan` picks from the lanes per image
  entry: with few, one pass of warp-merged device-memory atomics; with
  many, the sums privatised in shared memory, one copy of the image a
  block, each flushed once;
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

import contextlib
import functools
import os

import torch

from ptx_torch.ops import _build
from ptx_torch.ops._build import _check_inputs, _ptr, _raise_on, _stream
from ptx_torch.utils import profiling

LAUNCHES = 0
REFERENCE_CALLS = 0

K3_MAX_BYTES = 232_448        # a block's opt-in shared memory on Hopper (227 KB)
# K3's plan (k3_plan), fixed from measurements on an NVIDIA H100 (the
# figures are in csrc/image_hist_kernel.cu's header comment)
K3_PRIVATE_LANES = 1024       # lanes per image entry from which the sums are privatised
K3_BLOCKS_PER_SM = 4          # the most blocks an SM, either regime (2,048 threads)
K3_SM_SMEM = 233_472          # an SM's shared memory on Hopper (228 KB), 1 KB a block reserved
_K3_THREADS = 512             # csrc/image_hist_kernel.cu kThreads
COARSE = int(os.environ.get("PTX_IMG_GRAD_COARSE", "0"))


def hist_reference(yi, xi, inb, ct, shape):
    """``d_img (H, W, C)``: ``ct (N, C)`` added into texel ``(yi, xi)`` of
    every lane with ``inb``, in plain PyTorch."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    out = torch.zeros(shape, dtype=ct.dtype, device=ct.device)
    return out.index_put_((yi, xi), torch.where(inb[:, None], ct, 0.0),
                          accumulate=True)


# The reordered-sum rule K3 and K8 are held to: ten times the largest
# reading of the float64 rule (4.45e-5: K3's direct regime forced onto
# config 4's 8×8 checker at a step's 4,194,304 lanes, ~65,536 device-memory
# atomics a texel; the routed regimes read ≤ 1e-6)
HIST_REL = 5e-4
HIST_WORST = {"ratio": 0.0, "where": "none"}   # the process's largest K3 / K8 reading
_U32 = 2.0 ** -24                # float32 unit roundoff


def _hist_bound_ok(name, got, yi, xi, inb, ct, shape):
    """K3 / K8 against ``hist_reference`` run in float64: every texel within
    ``min(2·n·2⁻²⁴, HIST_REL)·Σ|ct|`` of it, n the texel's lanes with a
    nonzero ct (the reordered-sum bound where it is the tighter; else a
    limit that does not grow with n, so a step's millions of lanes on one
    texel still check the sum to ``HIST_REL`` of its magnitude; the form
    of K7's backward's rule).  Returns (max|k − p|, the largest
    |k − p| / Σ|ct|), and keeps the process's largest ratio in
    ``HIST_WORST``."""
    ct64 = ct.double()
    want = hist_reference(yi, xi, inb, ct64, shape)
    mag = hist_reference(yi, xi, inb, ct64.abs(), shape)
    n = hist_reference(yi, xi, inb, (ct != 0).double(), shape)
    err = (got.double() - want).abs()
    bad = err > torch.clamp(2 * n * _U32, max=HIST_REL) * mag
    if not bool(torch.isfinite(got).all()) or bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} texels more than min(2·n·2⁻²⁴, "
                             f"{HIST_REL:g})·Σ|ct| off the float64 sum (or not finite)")
    ratio = float((err / mag)[mag > 0].max()) if bool((mag > 0).any()) else 0.0
    if ratio > HIST_WORST["ratio"]:
        HIST_WORST.update(ratio=ratio, where=name)
    return float(err.max()), ratio


def _check(kernel, yi, xi, inb, ct, shape):
    N = ct.shape[0]
    _check_inputs(kernel, ct.device, {
        "yi": (yi, (N,), torch.int64), "xi": (xi, (N,), torch.int64),
        "inb": (inb, (N,), torch.bool), "ct": (ct, (N, shape[2]), torch.float32)})
    if N == 0:
        raise ValueError(f"{kernel}: no lanes")


@functools.lru_cache(maxsize=256)
def k3_plan(N, shape, sms):
    """K3's launch for ``N`` lanes on an ``(H, W, C)`` image on a card of
    ``sms`` SMs: ``(private, blocks)``.  Fewer than ``K3_PRIVATE_LANES``
    lanes per image entry take the direct regime, ``private`` 0; more the
    private regime, ``private`` 1, one copy of the image a block.  A block
    takes 512 lanes, and an SM at most ``K3_BLOCKS_PER_SM`` blocks, fewer
    where the private copies leave no room in its shared memory."""
    H, W, C = shape
    private = int(N >= K3_PRIVATE_LANES * H * W * C)
    per_sm = K3_BLOCKS_PER_SM
    if private:
        per_sm = max(1, min(per_sm, K3_SM_SMEM // (H * W * C * 4 + 1024)))
    return private, min(-(-N // _K3_THREADS), per_sm * sms)


@functools.lru_cache(maxsize=None)
def _sms(index):
    """The SM count of card ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


class HistKernel:
    """K3's wrapper: ``hist(yi, xi, inb, ct, shape)`` with flat int64
    ``yi``/``xi`` (already clipped into the image), bool ``inb`` and ``ct``
    (N, C) float32 → ``d_img`` (H, W, C), for images of at most
    ``K3_MAX_BYTES``.  One call is one zero-fill and one launch, in the
    regime :func:`k3_plan` picks (``launch(..., plan=)`` forces one)."""

    def __call__(self, yi, xi, inb, ct, shape):
        if ct.device.type == "cpu":
            return hist_reference(yi, xi, inb, ct, shape)
        if ct.device.type != "cuda":
            raise ValueError(f"image histogram kernel: no kernel for {ct.device}")
        return self.launch(yi, xi, inb, ct, shape)

    def launch(self, yi, xi, inb, ct, shape, plan=None):
        global LAUNCHES
        _check("image histogram kernel", yi, xi, inb, ct, shape)
        lib = _build.library()
        dev = ct.device
        N = ct.shape[0]
        private, blocks = plan or k3_plan(N, tuple(shape), _sms(dev.index))
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        err = lib.ptx_image_hist(_ptr(yi), _ptr(xi), _ptr(inb), _ptr(ct), N, *shape,
                                 _ptr(out), private, blocks, _stream(dev))
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


_transpose_span = None          # the span the transposes run in (transposes_in)


@contextlib.contextmanager
def transposes_in(name):
    """Run every gather transpose of the block in the port's span ``name``
    (the unfused replay's surface textures: ``tex_hist``)."""
    global _transpose_span
    saved, _transpose_span = _transpose_span, name
    try:
        yield
    finally:
        _transpose_span = saved


class _ImageGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, xi, yi, inb):
        ctx.save_for_backward(xi, yi, inb)
        ctx.shape = tuple(img.shape)
        return torch.where(inb[..., None], img[yi, xi], 0.0)

    backward_span = "sky_hist"     # the span of its backward (profiling.spanned)

    @staticmethod
    def backward(ctx, ct):
        xi, yi, inb = ctx.saved_tensors
        C = ctx.shape[-1]
        with (profiling.span(_transpose_span) if _transpose_span is not None
              else contextlib.nullcontext()):
            d_img = hist(yi.reshape(-1), xi.reshape(-1), inb.reshape(-1),
                         ct.reshape(-1, C).contiguous(), ctx.shape)
        return d_img, None, None, None


def image_gather(img, xi, yi, inb):
    """Bounds-masked nearest gather ``where(inb, img[yi, xi], 0)``.

    ``img`` (H, W, C) float32; ``xi``/``yi`` int64 of any shape, already
    clipped into range by the caller; ``inb`` marks lanes whose unclipped
    index was inside.  Differentiable in ``img`` only, through K3 or K8."""
    return _ImageGather.apply(img, xi, yi, inb)
