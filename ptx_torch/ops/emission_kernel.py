"""The fused emission kernel K7: one dynamic emissive chain plus the
constant emissive rows, evaluated in one launch.

Port of ``ptx/ops/emission_kernel.py`` ``build_emission_fn`` (:98), a
Pallas TPU kernel, as the hand-written CUDA kernel
``ptx_torch/csrc/emission_kernel.cu``.

- :func:`parse_chain` and :func:`supported`: eligibility, the JAX
  package's chain-shape rule on the texture ``.spec``: exactly one dynamic
  emissive chain ``[xform] → [mul] → spherical | mirror → image`` (no
  alpha).  The TPU kernel's image-size limit was its VMEM's; the CUDA
  kernel reads the image from device memory and has none.
- :class:`EmissionKernel` is K7's wrapper, a drop-in for
  ``material_fn.eval_emissive``: ``em(params, pos, mid) -> (N, 3)``.  On
  CUDA tensors it launches the kernel through :class:`_Emission`, whose
  backward is one histogram launch (K3, or K8 past K3's shared memory)
  over the image bins ``[0, H) × [0, W)`` and the const rows ``[H, H+R) ×
  {0}`` together, and a plain reduction for the factor
  (``emission_kernel.py:346-388``).  On CPU tensors, and only for those,
  it runs the plain version, ``eval_emissive`` differentiated by autograd.
  ``LAUNCHES`` and ``REFERENCE_CALLS`` count the two.
- :func:`lanes_reference` is the kernel's raw outputs (``em`` and the
  backward's residuals) in plain PyTorch, the chain written out.
"""

from __future__ import annotations

import torch

LAUNCHES = 0
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


def lanes_reference(kern, tex_xform, const, factor, img, pos, mid):
    """K7's raw outputs, :meth:`EmissionKernel.launch`'s, in plain PyTorch:
    ``em`` (N, 3), ``texel`` (N, 3), ``xi``, ``yi``, ``flags`` and ``row``
    (int32)."""
    from ptx_torch.core import linalg
    from ptx_torch.shade.textures import _mirror_ball_uv, _spherical_uv

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
        f = (factor[kern.factor_idx] if kern.factor_idx is not None
             else torch.ones(3, device=pos.device))
        row = kern.const_rows.to(torch.int64)[mid]
        sel = mid == kern.dyn_mi
        em = torch.where(sel[:, None], texel * f, const[row])
        flags = sel.to(torch.int32) | (inb.to(torch.int32) << 1)
        i32 = lambda a: a.to(torch.int32)
        return em, texel, i32(xi), i32(yi), flags, i32(row)


class _Emission(torch.autograd.Function):
    """K7's forward and its backward; differentiable in ``const``,
    ``factor`` and the image (positions and the lookup transform reach the
    radiance only through nearest-texel indices)."""

    @staticmethod
    def forward(ctx, kern, tex_xform, const, factor, img, pos, mid):
        em, texel, xi, yi, flags, row = kern.launch(tex_xform, const, factor, img,
                                                    pos, mid)
        ctx.kern = kern
        ctx.shapes = (tuple(const.shape), tuple(factor.shape), tuple(img.shape))
        ctx.save_for_backward(texel, xi, yi, flags, row, factor)
        return em

    @staticmethod
    def backward(ctx, ct):
        from ptx_torch.ops import imagegrad

        texel, xi, yi, flags, row, factor = ctx.saved_tensors
        kern = ctx.kern
        (R, _), f_shape, (H, W, _) = ctx.shapes
        sel = (flags & 1).bool()
        inb = (flags & 2).bool()
        ct = ct.contiguous()
        f = (factor[kern.factor_idx] if kern.factor_idx is not None
             else torch.ones(3, dtype=ct.dtype, device=ct.device))
        # one histogram: image bins take ct·factor on selected in-bounds
        # lanes, const row bins [H, H+R) at x = 0 raw ct on the others
        y = torch.where(sel, yi, H + row).to(torch.int64)
        x = torch.where(sel, xi, 0).to(torch.int64)
        vals = torch.where(sel[:, None], ct * f, ct)
        out = imagegrad.hist(y, x, ~sel | inb, vals, (H + R, W, 3))
        d_img = torch.cat([out[:H], out.new_zeros((H, W, 1))], dim=-1)
        d_const = out[H:, 0, :]
        d_factor = None
        if kern.factor_idx is not None:
            d_factor = torch.zeros(f_shape, dtype=ct.dtype, device=ct.device)
            d_factor[kern.factor_idx] = torch.where(sel[:, None], ct * texel, 0.0).sum(0)
        return None, None, d_const, d_factor, d_img, None, None


class EmissionKernel:
    """K7 for one material table (``supported`` must hold):
    ``em(params, pos, mid)`` on flat ``pos`` (N, 3) and int64 ``mid`` (N,)
    returns the emissive slot (N, 3) as ``material_fn.eval_emissive``
    does."""

    def __init__(self, material_fn, device):
        self.table = material_fn
        (self.dyn_mi, spec), = material_fn.emissive_dynamic_specs
        self.xform_idx, self.factor_idx, kind, self.img_id = parse_chain(spec)
        self.mirror = kind == "mirror"
        self.const_rows = torch.as_tensor(material_fn.const_idx["emissive"],
                                          dtype=torch.int32, device=device)

    def __call__(self, params, pos, mid):
        global REFERENCE_CALLS
        if pos.device.type == "cpu":
            REFERENCE_CALLS += 1
            return self.table.eval_emissive(params, pos, mid)
        if pos.device.type != "cuda":
            raise ValueError(f"emission kernel: no kernel for {pos.device}")
        return _Emission.apply(self, params["tex_xform"], params["const"], params["factor"],
                               params["images"][self.img_id], pos.contiguous(),
                               mid.contiguous())

    def pack(self, tex_xform, const, factor):
        """The kernel's parameter vector: xform (12), factor (3), the const
        emissive rows (M × 3); no autograd."""
        with torch.no_grad():
            dev = const.device
            xf = (tex_xform[self.xform_idx].reshape(12) if self.xform_idx is not None
                  else torch.zeros(12, device=dev))
            fc = (factor[self.factor_idx] if self.factor_idx is not None
                  else torch.ones(3, device=dev))
            rows = const[self.const_rows.to(torch.int64)].reshape(-1)
            return torch.cat([xf, fc, rows]).to(torch.float32).contiguous()

    def launch(self, tex_xform, const, factor, img, pos, mid):
        """One kernel launch on the current stream, no synchronisation:
        ``em`` (N, 3) and the backward's residuals ``texel`` (N, 3), ``xi``,
        ``yi`` (clipped into the image), ``flags`` (bit 0: the lane's
        material is the chain's, bit 1: in bounds) and the lane's const
        row id, all int32."""
        global LAUNCHES
        from ptx_torch.ops import _build
        from ptx_torch.ops.bounce_kernel import _check_inputs, _ptr, _raise_on, _stream

        N = pos.shape[0]
        device = pos.device
        H, W, C = img.shape
        _check_inputs("emission kernel", device, {
            "pos": (pos, (N, 3), torch.float32), "mid": (mid, (N,), torch.int64),
            "image": (img, (H, W, C), torch.float32)})
        if N == 0:
            raise ValueError("emission kernel: no lanes")
        lib = _build.library()
        pp = self.pack(tex_xform, const, factor)
        f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=device)
        i32 = lambda: torch.empty(N, dtype=torch.int32, device=device)
        em, texel = f32(N, 3), f32(N, 3)
        xi, yi, flags, row = i32(), i32(), i32(), i32()
        p = _ptr
        err = lib.ptx_emission_forward(
            p(pp), p(self.const_rows), self.const_rows.numel(), p(img), H, W, C, p(pos),
            p(mid), N, self.dyn_mi, int(self.xform_idx is not None), int(self.mirror),
            p(em), p(texel), p(xi), p(yi), p(flags), p(row), _stream(device))
        _raise_on(err, lib, "emission kernel")
        LAUNCHES += 1
        return em, texel, xi, yi, flags, row
