"""The sky bank: a ``trace_rays`` call's emission, where every dynamic
emitter of the scene is one terminal sky chain, as one hand-written CUDA
kernel pair.

It replaces no TPU kernel: the JAX package evaluates the mat-sum and the
sky-select in plain ``jnp``, which XLA fuses on the TPU.  In PyTorch that
route (:func:`reference`) is ~270 launches a ``trace_rays`` call forward
and ~140 backward, the largest host span of the demo's cells.  The kernels
are ``sky_bank_*_kernel`` in ``ptx_torch/csrc/emission_kernel.cu`` beside
K7, their lane arithmetic ``csrc/sky_bank_lane.cuh``.

- :func:`supported`: the scene's structure decides, at ``compile_scene``:
  exactly one dynamic emissive chain, of a material that is terminal
  (reflect ≡ transmit ≡ 0), of a shape K7's
  :func:`~ptx_torch.ops.emission_kernel.parse_chain` takes, and at most
  ``MAX_MATERIALS`` materials.  The demo's and config 4's skies qualify; a
  constant sky (S1) has no chain and keeps ``eval_emissive``.
- :class:`SkyBank` is the wrapper: ``bank(params, saved)`` returns the
  per-phase contributions of ``trace._emission``.  On CUDA tensors the
  forward is one launch a call (every phase's records by pointer) and the
  backward two (:class:`_SkyBank`): the cotangents of every record's
  throughput, of the const table, the factor and the sky image.  On CPU
  tensors, and only there, it runs :func:`reference`.
- ``LAUNCHES`` and ``BWD_LAUNCHES`` count the launches, and each is also
  the recorder's counter ``sky_bank_launches``
  (:func:`ptx_torch.utils.profiling.count`).
"""

from __future__ import annotations

import ctypes

import torch

from ptx_torch.ops import emission_kernel
from ptx_torch.utils import profiling

MAX_MATERIALS = 8       # csrc/sky_bank_lane.cuh kMaxMats
MAX_PHASES = 8          # csrc/emission_kernel.cu kMaxPhases
SUMS = 3 * (MAX_MATERIALS + 1)      # a backward block's partial sums (kSums)
BLOCKS_PER_SM = 4       # the backward's most blocks an SM (2,048 threads of 512)

LAUNCHES = 0
BWD_LAUNCHES = 0


def supported(material_fn) -> bool:
    """One dynamic emissive chain, terminal, of a shape K7 takes, on at most
    ``MAX_MATERIALS`` materials."""
    specs = material_fn.emissive_dynamic_specs
    term = {mi for mi, _ in material_fn.terminal_dynamic_emissive}
    return (len(specs) == 1 and specs[0][0] in term
            and emission_kernel.parse_chain(specs[0][1]) is not None
            and material_fn.n_materials <= MAX_MATERIALS)


def reference(table, params, saved):
    """The plain version, in PyTorch: mat-sum + sky-select over each phase's
    records ``saved[pi] = (pos, thr, mid, live, orig)``.  Emission is a
    constant per non-terminal material, so sum the live throughput per
    material and multiply by its emissive row once; the terminal chains
    (:func:`~ptx_torch.integrate.trace.select_add`) add theirs."""
    from ptx_torch.integrate.trace import select_add

    term_chains = table.terminal_dynamic_emissive
    term_mis = {mi for mi, _ in term_chains}
    out = []
    for pos, thr, mid, live, _ in saved:
        em_rows = params["const"][table.const_rows("emissive", thr.device)]
        contrib = torch.zeros(thr.shape[1:], dtype=torch.float32, device=thr.device)
        for m in range(table.n_materials):
            if m in term_mis:
                continue
            wsum = torch.where((live & (mid == m))[..., None], thr, 0.0).sum(dim=0)
            contrib = contrib + wsum * em_rows[m]
        out.append(select_add(contrib, params, pos, thr, mid, live, term_chains))
    return out


class _SkyBank(torch.autograd.Function):
    """The kernels' forward and backward over one call's phases; inputs
    ``(bank, tex_xform, const, factor, img, pos0, thr0, mid0, live0, pos1,
    ...)``, one contribution a phase out.  Differentiable in
    each phase's throughput, ``const``, ``factor`` and the image (positions
    and the lookup transform reach the radiance only through nearest-texel
    indices)."""

    @staticmethod
    def forward(ctx, bank, tex_xform, const, factor, img, *flat):
        outs, sel = bank.launch(tex_xform, const, factor, img, flat)
        ctx.bank = bank
        # the backward reads no position: the forward's texels stand for them
        ctx.save_for_backward(const, factor, img, sel,
                              *[x for k, x in enumerate(flat) if k % 4])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cts):
        const, factor, img, sel, *rest = ctx.saved_tensors
        flat = []
        for k in range(0, len(rest), 3):
            flat += [None, *rest[k:k + 3]]
        d_thr, d_const, d_factor, d_img = ctx.bank.launch_bwd(
            [c.contiguous() for c in cts], const, factor, img, sel, flat)
        grads = [None, None, d_const, d_factor, d_img]
        for d in d_thr:
            grads += [None, d, None, None]
        return tuple(grads)


class SkyBank:
    """The sky bank for one material table (:func:`supported` must hold):
    ``bank(params, saved)`` returns ``trace._emission``'s per-phase
    contributions, (Bp, 3) each."""

    def __init__(self, material_fn):
        self.table = material_fn
        (self.sky, spec), = material_fn.emissive_dynamic_specs
        self.xform_idx, self.factor_idx, kind, self.img_id = emission_kernel.parse_chain(spec)
        self.mirror = kind == "mirror"

    def __call__(self, params, saved):
        device = saved[0][1].device
        if device.type == "cpu":
            return reference(self.table, params, saved)
        if device.type != "cuda":
            raise ValueError(f"sky bank: no kernel for {device}")
        args = (params["tex_xform"], params["const"], params["factor"],
                params["images"][self.img_id])
        flat = [x for pos, thr, mid, live, _ in saved for x in (pos, thr, mid, live)]
        if torch.is_grad_enabled() and any(x.requires_grad for x in args[1:] + tuple(flat)):
            return list(_SkyBank.apply(self, *args, *flat))
        # nothing to differentiate (a render): the forward alone, no autograd node
        return self.launch(*args, flat)[0]

    @staticmethod
    def _phases(flat, extra):
        """The C entry's phase arrays: 6 pointers (pos, or 0 where None,
        thr, mid, live, and ``extra``'s two a phase) and 2 sizes (nb, Bp) a
        phase."""
        n = len(flat) // 4
        if not 1 <= n <= MAX_PHASES:
            raise ValueError(f"sky bank: {n} phases (1 to {MAX_PHASES})")
        ptrs, dims = [], []
        for k in range(n):
            pos, thr, mid, live = flat[4 * k:4 * k + 4]
            ptrs += [0 if pos is None else pos.data_ptr(), thr.data_ptr(), mid.data_ptr(),
                     live.data_ptr(), *extra[k]]
            dims += thr.shape[:2]
        return (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int64 * len(dims))(*dims)

    def _check(self, kernel, device, tensors, flat):
        from ptx_torch.ops.bounce_kernel import _check_inputs

        for k in range(len(flat) // 4):
            pos, thr, mid, live = flat[4 * k:4 * k + 4]
            shape = tuple(thr.shape[:2])
            tensors.update({f"thr{k}": (thr, shape + (3,), torch.float32),
                            f"mid{k}": (mid, shape, torch.int64),
                            f"live{k}": (live, shape, torch.bool)})
            if pos is not None:
                tensors[f"pos{k}"] = (pos, shape + (3,), torch.float32)
        _check_inputs(kernel, device, tensors)

    def launch(self, tex_xform, const, factor, img, flat):
        """One kernel launch on the current stream, no synchronisation:
        each phase's contribution (Bp, 3) and the int32 (lanes, 2) of the
        picked records and their texels, which the backward reads."""
        global LAUNCHES
        from ptx_torch.ops import _build
        from ptx_torch.ops.bounce_kernel import _ptr, _raise_on, _stream

        device = flat[1].device
        H, W, C = img.shape
        self._check("sky bank", device, {
            "image": (img, (H, W, C), torch.float32),
            "const": (const, tuple(const.shape), torch.float32),
            "factor": (factor, tuple(factor.shape), torch.float32),
            "tex_xform": (tex_xform, tuple(tex_xform.shape), torch.float32)}, flat)
        outs = [torch.empty((thr.shape[1], 3), dtype=torch.float32, device=device)
                for thr in flat[1::4]]
        sel = torch.empty((sum(o.shape[0] for o in outs), 2), dtype=torch.int32, device=device)
        ptrs, dims = self._phases(flat, [(0, _ptr(o)) for o in outs])
        lib = _build.library()
        row = emission_kernel.EmissionKernel._row_ptr
        err = lib.ptx_sky_bank_forward(
            len(outs), ptrs, dims, row(tex_xform, self.xform_idx, 12),
            row(factor, self.factor_idx, 3), _ptr(const),
            _ptr(self.table.const_rows("emissive", device)),
            self.table.n_materials, self.sky, _ptr(img), H, W, C, int(self.mirror),
            _ptr(sel), _stream(device))
        _raise_on(err, lib, "sky bank")
        LAUNCHES += 1
        profiling.count("sky_bank_launches", 1)
        return outs, sel

    def launch_bwd(self, cts, const, factor, img, sel, flat):
        """Two launches on the current stream, no synchronisation: each
        phase's ``d_thr`` (nb, Bp, 3), ``d_const``, ``d_factor`` (None where
        the chain has no factor) and ``d_img``, each written whole by the
        kernels."""
        global BWD_LAUNCHES
        from ptx_torch.ops import _build
        from ptx_torch.ops.bounce_kernel import _check_inputs, _ptr, _raise_on, _stream
        from ptx_torch.ops.imagegrad import _sms

        device = flat[1].device
        H, W, C = img.shape
        lanes = sel.shape[0]
        self._check("sky bank backward", device, {
            "sel": (sel, (lanes, 2), torch.int32),
            "image": (img, (H, W, C), torch.float32),
            "factor": (factor, tuple(factor.shape), torch.float32)}, flat)
        _check_inputs("sky bank backward", device, {
            f"ct{k}": (c, (thr.shape[1], 3), torch.float32)
            for k, (c, thr) in enumerate(zip(cts, flat[1::4]))})
        f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=device)
        d_thr = [f32(*thr.shape) for thr in flat[1::4]]
        d_const, d_img = f32(*const.shape), f32(H, W, C)
        d_factor = f32(*factor.shape) if self.factor_idx is not None else None
        max_blocks = BLOCKS_PER_SM * _sms(device.index)
        partial = f32(max_blocks * SUMS)
        ptrs, dims = self._phases(flat, [(_ptr(c), _ptr(d)) for c, d in zip(cts, d_thr)])
        lib = _build.library()
        row = emission_kernel.EmissionKernel._row_ptr
        err = lib.ptx_sky_bank_backward(
            len(d_thr), ptrs, dims, row(factor, self.factor_idx, 3), _ptr(const),
            _ptr(self.table.const_rows("emissive", device)),
            self.table.n_materials, self.sky, const.shape[0], _ptr(img), H, W, C, _ptr(sel),
            _ptr(d_img), _ptr(d_const), 0 if d_factor is None else _ptr(d_factor),
            0 if d_factor is None else d_factor.numel(), 3 * (self.factor_idx or 0),
            _ptr(partial), max_blocks, _stream(device))
        _raise_on(err, lib, "sky bank backward")
        BWD_LAUNCHES += 2
        profiling.count("sky_bank_launches", 2)
        return d_thr, d_const, d_factor, d_img
