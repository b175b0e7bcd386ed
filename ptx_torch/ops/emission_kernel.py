"""The fused emission kernel K7: one dynamic emissive chain plus the
constant emissive rows, evaluated in one launch, differentiated in one.

Port of ``ptx/ops/emission_kernel.py`` ``build_emission_fn`` (:98), a
Pallas TPU kernel with a custom VJP (``bwd2``, :346-388), as the
hand-written CUDA kernels of ``ptx_torch/csrc/emission_kernel.cu``.

- :func:`parse_chain` and :func:`supported`: eligibility, the JAX
  package's chain-shape rule on the texture ``.spec``: exactly one dynamic
  emissive chain ``[xform] → [mul] → spherical | mirror → image`` (no
  alpha).  The TPU kernel's image-size limit was its VMEM's; the CUDA
  kernel reads the image from device memory and has none.
- :class:`EmissionKernel` is K7's wrapper, a drop-in for
  ``material_fn.eval_emissive``: ``em(params, pos, mid) -> (N, 3)``,
  differentiable in ``const``, ``factor`` and the image through
  :class:`_Emission`.  On CUDA tensors its forward is one launch
  (:meth:`EmissionKernel.launch`, reading the scene through pointers into
  the params) that writes ``em`` and one int32 bin a lane, and its backward
  one launch (:meth:`EmissionKernel.launch_bwd`): the combined histogram
  of the image bins and the const rows and the factor's reduction.  On CPU
  tensors, and only for those, the same Function runs the plain versions,
  :func:`lanes_reference` and :func:`backward_reference`.
- The bin (``csrc/emission_lane.cuh`` ``lane_bin``): ``y·W + x`` for a lane
  of the chain's material whose texel is in the image, ``-1`` for one whose
  texel is not, ``H·W + row`` (its constant emissive row) for any other.
  It is all the backward needs: the texel of a chain lane is read again
  from the image the forward read (saved for backward, so autograd refuses
  an image changed in place between the two).
- ``LAUNCHES`` and ``BWD_LAUNCHES`` count the kernels' launches,
  ``REFERENCE_CALLS`` the wrapper's calls on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ptx_torch.core import linalg
from ptx_torch.ops import _build, imagegrad
from ptx_torch.ops._build import _check_inputs, _ptr, _raise_on, _stream
from ptx_torch.shade.textures import _mirror_ball_uv, _spherical_uv

LAUNCHES = 0
BWD_LAUNCHES = 0
REFERENCE_CALLS = 0


def parse_chain(spec):
    """A texture ``.spec`` as ``(xform_idx | None, factor_idx | None,
    map_kind, img_id)``, or None when K7 does not take the chain."""
    xform = factor = kind = None
    node = spec
    while node is not None:
        tag = node[0]
        if tag == "xform" and kind is None and xform is None:
            xform, node = node[1], node[2]
        elif tag == "mul" and factor is None:
            factor, node = node[1], node[2]
        elif tag in ("spherical", "mirror") and kind is None:
            kind, node = tag, node[1]
        elif tag == "image" and kind is not None and not node[2]:
            return (xform, factor, kind, node[1])
        else:
            return None
    return None


def supported(material_fn) -> bool:
    """Exactly one dynamic emissive chain, of a shape K7 takes."""
    specs = material_fn.emissive_dynamic_specs
    return len(specs) == 1 and parse_chain(specs[0][1]) is not None


def _factor_row(kern, factor):
    return (factor[kern.factor_idx] if kern.factor_idx is not None
            else torch.ones(3, dtype=factor.dtype, device=factor.device))


def lanes_reference(kern, tex_xform, const, factor, img, pos, mid):
    """K7's forward, :meth:`EmissionKernel.launch`'s outputs, in plain
    PyTorch: ``em`` (N, 3) and the bin (N,) int32 (module docstring)."""
    with torch.no_grad():
        q = linalg.apply(tex_xform[kern.xform_idx], pos) if kern.xform_idx is not None else pos
        uv = (_mirror_ball_uv if kern.mirror else _spherical_uv)(q)
        H, W = img.shape[0], img.shape[1]
        x = uv[:, 0] - torch.floor(uv[:, 0])
        y = 1.0 - (uv[:, 1] - torch.floor(uv[:, 1]))
        xi, yi = torch.floor(x * W).to(torch.int64), torch.floor(y * H).to(torch.int64)
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi, yi = xi.clamp(0, W - 1), yi.clamp(0, H - 1)
        texel = torch.where(inb[:, None], img[yi, xi, :3], 0.0)
        row = kern.const_rows.to(torch.int64)[mid]
        chain = mid == kern.dyn_mi
        em = torch.where(chain[:, None], texel * _factor_row(kern, factor), const[row])
        bin_ = torch.where(chain, torch.where(inb, yi * W + xi, -1), H * W + row)
        return em, bin_.to(torch.int32)


def backward_reference(kern, ct, bin_, img, factor, const_shape, factor_shape):
    """K7's backward, :meth:`EmissionKernel.launch_bwd`'s outputs, in plain
    PyTorch: one histogram of the flat bins ``[0, H·W + R)`` by
    ``imagegrad.hist_reference`` (``ct·factor`` on the chain's in-bounds
    lanes, raw ``ct`` on the others), cut into ``d_img`` (H, W, C: zero past
    channel 3) and ``d_const`` (R, 3); and ``d_factor``, zero but for the
    chain's row, the sum of ``ct·texel`` over the chain's lanes (None when
    the chain has no factor)."""
    with torch.no_grad():
        H, W, C = img.shape
        HW, R = H * W, const_shape[0]
        b = bin_.to(torch.int64)
        chain = b < HW
        vals = torch.where(chain[:, None], ct * _factor_row(kern, factor), ct)
        flat = imagegrad.hist_reference(b.clamp(min=0), torch.zeros_like(b), b >= 0, vals,
                                        (HW + R, 1, 3))[:, 0]
        d_img = torch.zeros_like(img)
        d_img[..., :3] = flat[:HW].reshape(H, W, 3)
        d_factor = None
        if kern.factor_idx is not None:
            texel = torch.where((chain & (b >= 0))[:, None],
                                img.reshape(HW, C)[b.clamp(0, HW - 1), :3], 0.0)
            d_factor = torch.zeros(factor_shape, dtype=ct.dtype, device=ct.device)
            d_factor[kern.factor_idx] = (ct * texel).sum(0)
        return d_img, flat[HW:].reshape(const_shape), d_factor


class _Emission(torch.autograd.Function):
    """K7's forward and its backward; differentiable in ``const``,
    ``factor`` and the image (positions and the lookup transform reach the
    radiance only through nearest-texel indices).  CUDA tensors launch the
    kernels, CPU tensors run the plain versions."""

    @staticmethod
    def forward(ctx, kern, tex_xform, const, factor, img, pos, mid):
        fwd = (kern.launch if pos.device.type == "cuda"
               else lambda *a: lanes_reference(kern, *a))
        em, bin_ = fwd(tex_xform, const, factor, img, pos, mid)
        ctx.kern = kern
        ctx.shapes = (tuple(const.shape), tuple(factor.shape))
        ctx.save_for_backward(bin_, img, factor)
        return em

    @staticmethod
    def backward(ctx, ct):
        bin_, img, factor = ctx.saved_tensors
        kern = ctx.kern
        bwd = (kern.launch_bwd if ct.device.type == "cuda"
               else lambda *a: backward_reference(kern, *a))
        d_img, d_const, d_factor = bwd(ct.contiguous(), bin_, img, factor, *ctx.shapes)
        return None, None, d_const, d_factor, d_img, None, None


def bwd_plan(N, H, W):
    """The backward's regime for ``N`` lanes on an ``(H, W)`` image, as K3's
    plan (``imagegrad.k3_plan``) rules: 1 (the whole flat histogram in
    each block's shared memory) from ``imagegrad.K3_PRIVATE_LANES`` lanes
    per image entry on, else 0 (image bins in device memory, the const rows
    in shared memory).  :func:`bwd_regime` also asks whether 1 fits."""
    return int(N >= imagegrad.K3_PRIVATE_LANES * H * W * 3)


@functools.lru_cache(maxsize=None)
def private_fits(H, W, R, device_index):
    """Whether the backward's private regime (``H·W + R`` bins of 3 floats
    and the kernel's static shared memory) fits one block's shared memory
    on that card: the C entry's answer."""
    lib, fits = _build.library(), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.ptx_emission_backward_private_fits(H, W, R, ctypes.byref(fits))
    _raise_on(err, lib, "emission backward kernel")
    return bool(fits.value)


def bwd_regime(N, H, W, R, device):
    """The backward's regime on a CUDA ``device``: :func:`bwd_plan`'s, but 0
    where the private regime does not fit (:func:`private_fits`)."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    return int(bwd_plan(N, H, W) and private_fits(H, W, R, index))


class EmissionKernel:
    """K7 for one material table (``supported`` must hold):
    ``em(params, pos, mid)`` on flat ``pos`` (N, 3) and int64 ``mid`` (N,)
    returns the emissive slot (N, 3) as ``material_fn.eval_emissive``
    does."""

    def __init__(self, material_fn, device):
        (self.dyn_mi, spec), = material_fn.emissive_dynamic_specs
        self.xform_idx, self.factor_idx, kind, self.img_id = parse_chain(spec)
        self.mirror = kind == "mirror"
        self.const_rows = torch.as_tensor(material_fn.const_idx["emissive"],
                                          dtype=torch.int32, device=device)

    def __call__(self, params, pos, mid):
        global REFERENCE_CALLS
        if pos.device.type not in ("cpu", "cuda"):
            raise ValueError(f"emission kernel: no kernel for {pos.device}")
        if pos.device.type == "cpu":
            REFERENCE_CALLS += 1
        args = (params["tex_xform"], params["const"], params["factor"],
                params["images"][self.img_id], pos.contiguous(), mid.contiguous())
        if torch.is_grad_enabled() and any(x.requires_grad for x in args[1:4]):
            return _Emission.apply(self, *args)
        # nothing to differentiate (a render): the forward alone, no autograd node
        return (self.launch(*args) if pos.device.type == "cuda"
                else lanes_reference(self, *args))[0]

    @staticmethod
    def _row_ptr(table, idx, words):
        """The address of row ``idx`` of a contiguous table, 0 for None."""
        return 0 if idx is None else table.data_ptr() + 4 * words * idx

    def launch(self, tex_xform, const, factor, img, pos, mid):
        """One kernel launch on the current stream, no synchronisation:
        ``em`` (N, 3) and the bin (N,) int32 (module docstring).  The kernel
        reads the chain's transform and factor rows, the const table and
        the image in place."""
        global LAUNCHES
        N = pos.shape[0]
        device = pos.device
        H, W, C = img.shape
        _check_inputs("emission kernel", device, {
            "pos": (pos, (N, 3), torch.float32), "mid": (mid, (N,), torch.int64),
            "image": (img, (H, W, C), torch.float32),
            "const": (const, tuple(const.shape), torch.float32),
            "factor": (factor, tuple(factor.shape), torch.float32),
            "tex_xform": (tex_xform, tuple(tex_xform.shape), torch.float32)})
        if N == 0:
            raise ValueError("emission kernel: no lanes")
        lib = _build.library()
        em = torch.empty((N, 3), dtype=torch.float32, device=device)
        bin_ = torch.empty(N, dtype=torch.int32, device=device)
        p = _ptr
        err = lib.ptx_emission_forward(
            self._row_ptr(tex_xform, self.xform_idx, 12),
            self._row_ptr(factor, self.factor_idx, 3), p(const), p(self.const_rows),
            p(img), H, W, C, p(pos), p(mid), N, self.dyn_mi,
            int(self.mirror), p(em), p(bin_), _stream(device))
        _raise_on(err, lib, "emission kernel")
        LAUNCHES += 1
        return em, bin_

    def launch_bwd(self, ct, bin_, img, factor, const_shape, factor_shape, plan=None):
        """One cooperative launch on the current stream, no synchronisation:
        ``d_img`` (H, W, C), ``d_const`` ``const_shape`` and ``d_factor``
        ``factor_shape`` (None when the chain has no factor), each zero-filled
        by the kernel itself (:func:`backward_reference` is the plain
        version).  ``plan`` forces the regime (:func:`bwd_regime`)."""
        global BWD_LAUNCHES
        N = ct.shape[0]
        device = ct.device
        H, W, C = img.shape
        R = const_shape[0]
        _check_inputs("emission backward kernel", device, {
            "ct": (ct, (N, 3), torch.float32), "bin": (bin_, (N,), torch.int32),
            "image": (img, (H, W, C), torch.float32),
            "factor": (factor, factor_shape, torch.float32)})
        if N == 0:
            raise ValueError("emission backward kernel: no lanes")
        lib = _build.library()
        f32 = lambda s: torch.empty(s, dtype=torch.float32, device=device)
        d_img, d_const = f32((H, W, C)), f32(const_shape)
        d_factor = f32(factor_shape) if self.factor_idx is not None else None
        private = bwd_regime(N, H, W, R, device) if plan is None else plan
        err = lib.ptx_emission_backward(
            _ptr(ct), _ptr(bin_), N, _ptr(img), H, W, C, R,
            self._row_ptr(factor, self.factor_idx, 3), _ptr(d_img), _ptr(d_const),
            0 if d_factor is None else _ptr(d_factor),
            0 if d_factor is None else d_factor.numel(), 3 * (self.factor_idx or 0),
            private, _stream(device))
        _raise_on(err, lib, "emission backward kernel")
        BWD_LAUNCHES += 1
        return d_img, d_const, d_factor
