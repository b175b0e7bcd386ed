"""The fused bounce kernel (K1): first hit + shade + scatter in one launch.

Port of ``ptx/ops/bounce_kernel.py:236 build_bounce_kernel`` (the Pallas
TPU kernel with ``fasthit_kernel.hit_fold`` and ``shade_lane_math``) as a
hand-written CUDA kernel, ``ptx_torch/csrc/bounce_kernel.cu``.

- :class:`BounceKernel` is the wrapper a compiled scene calls once per
  bounce.  For CUDA tensors it launches the kernel (or raises); for CPU
  tensors, and only for those, it runs :func:`bounce_reference`.
- :func:`bounce_reference` is the kernel's plain PyTorch version: the
  port's plain live bounce (``trace._bounce_live``) on the dense first
  hit, with the same signature and output dict.  The CPU tests use it,
  and ``chip_smoke.py`` holds the kernel against it on the card.
- ``LAUNCHES`` counts kernel launches and ``REFERENCE_CALLS`` calls of
  the plain version (every plain bounce of the port goes through it), so
  a run can show which one it went through.

The scene reaches the kernel as one small float32 buffer, packed once
per scene by :func:`pack_scene`: per-leaf records, leaf geometry,
material scalars and the CSG tape as a postfix program.  One generic
kernel serves every eligible scene; nothing is generated per scene.
"""

from __future__ import annotations

import ctypes

import torch

from ptx_torch.geom import tape
from ptx_torch.geom.fasthit import collect_leaves, leaf_affine, plane_inv_mag
from ptx_torch.integrate import trace
from ptx_torch.shade.materials import mean3

LAUNCHES = 0
REFERENCE_CALLS = 0

# scene buffer layout — must match ptx_torch/csrc/bounce_kernel.cu
_LEAF_STRIDE = 5     # kind (0 sphere, 1 plane), geo offset, has_xform, material, parity
_MAT_STRIDE = 9      # rfl0 rfl1 rfl2 scatter_f tr0 tr1 tr2 transmit_reflect_f ior
_OP_UNION, _OP_INTERSECTION, _OP_DIFFERENCE = -1, -2, -3
_MAX_STACK = 32      # kMaxStack in the kernel
_MAX_SCENE_BYTES = 48 * 1024   # dynamic shared memory without opt-in


def tape_program(plan, leaf_pos) -> list[int]:
    """The CSG tape as a postfix program over leaf indices: ``k >= 0``
    pushes leaf ``k``'s membership; a negative op pops two entries and
    pushes their union, intersection or difference.  n-ary nodes become
    left folds, as in ``fasthit._bits_at``."""
    prog = []
    code = {"union": _OP_UNION, "intersection": _OP_INTERSECTION,
            "difference": _OP_DIFFERENCE}

    def emit(node):
        if isinstance(node, tape._LeafPlan):
            prog.append(leaf_pos[id(node)])
            return
        emit(node.children[0])
        for c in node.children[1:]:
            emit(c)
            prog.append(code[node.op])

    emit(plan)
    return prog


def _stack_depth(prog) -> int:
    depth = peak = 0
    for op in prog:
        depth += 1 if op >= 0 else -1
        peak = max(peak, depth)
    return peak


def pack_scene(plan, table, params):
    """The kernel's scene buffer (float32, on the params' device) and its
    layout ``(L, mat_off, tape_off, tape_len)``.

    Words: ``L`` leaf records of 5; per-leaf geometry (sphere ``cx cy cz
    r``, plane ``nx ny nz d inv_mag``, then ``W⁻¹`` (12, row-major) and
    ``W⁻ᵀ`` (9) when transformed) — the Pallas kernel's packing; ``M``
    material rows of 9; the tape program.  Small integers are stored as
    exact float values."""
    leaves = collect_leaves(plan)
    L = len(leaves)
    leaf_pos = {id(lf): i for i, (lf, _) in enumerate(leaves)}
    prog = tape_program(plan, leaf_pos)
    if _stack_depth(prog) > _MAX_STACK:
        raise NotImplementedError(
            f"CSG tape needs a stack of {_stack_depth(prog)} > {_MAX_STACK}")
    device = params["const"].device
    f32 = lambda xs: torch.as_tensor(xs, dtype=torch.float32, device=device)

    geo, records = [], []
    off = L * _LEAF_STRIDE
    for lf, parity in leaves:
        if lf.kind == "sphere":
            g = [params["sphere_center"][lf.index],
                 params["sphere_radius"][lf.index][None]]
        else:
            n = params["plane_normal"][lf.index]
            g = [n, params["plane_d"][lf.index][None], plane_inv_mag(n)[None]]
        xf = leaf_affine(lf, params)
        if xf is not None:
            g += [xf[0].reshape(-1), xf[1].reshape(-1)]
        g = torch.cat(g)
        records.append([0.0 if lf.kind == "sphere" else 1.0, float(off),
                        float(xf is not None), float(lf.mat_id), parity])
        geo.append(g)
        off += g.numel()
    mat_off = off

    const = params["const"]
    idx = {s: torch.as_tensor(v, device=device)
           for s, v in table.const_idx.items()}
    mat = torch.cat([const[idx["reflect"]], mean3(const[idx["scatter"]])[:, None],
                     const[idx["transmit"]],
                     mean3(const[idx["transmit_reflect"]])[:, None],
                     params["ior"][:, None]], dim=1)
    buf = torch.cat([f32(records).reshape(-1), *geo, mat.reshape(-1),
                     f32(prog)]).contiguous()
    if buf.numel() * 4 > _MAX_SCENE_BYTES:
        raise NotImplementedError(f"scene buffer of {buf.numel() * 4} bytes "
                                  "exceeds the kernel's shared memory")
    layout = (L, mat_off, mat_off + mat.numel(), len(prog))
    return buf, layout


class BounceKernel:
    """K1 for one compiled scene.

    ``bounce(params, o, d, thr, strength, alive, u_coin, u3, in_depth)``
    on flat (B, 3) / (B,) tensors returns the dict of the JAX package's
    ``bounce_fn``: ``t``, ``o2``, ``d2``, ``thr2``, ``strength2``,
    ``hit``, ``entering``, ``take_transmit``, ``scatter_alive``,
    ``alive2``, ``evt``, ``mat_id``, ``u_sel``.  The kernel reads the scene
    buffer packed from ``scene.params`` at construction (forward render;
    the training slice will repack per step), so on CUDA ``params`` must
    be that dict."""

    def __init__(self, scene):
        self.scene = scene
        self.buf, self.layout = pack_scene(scene.plan, scene.material_fn,
                                           scene.params)
        self.leaf_mat = torch.tensor(
            [lf.mat_id for lf, _ in collect_leaves(scene.plan)],
            dtype=torch.int64, device=scene.device)

    def __call__(self, params, o, d, thr, strength, alive, u_coin, u3,
                 in_depth: bool):
        if o.device.type == "cpu":
            return bounce_reference(self.scene, params, o, d, thr, strength,
                                    alive, u_coin, u3, in_depth)
        if o.device.type != "cuda":
            raise ValueError(f"bounce kernel: no kernel for {o.device}")
        if params is not self.scene.params:
            raise ValueError("the bounce kernel reads the scene buffer packed "
                             "from scene.params; pass that dict")
        raw = self.launch(o, d, thr, strength, alive, u_coin, u3, in_depth)
        flags, evt = raw.pop("flags"), raw["evt"]
        L = self.layout[0]
        leaf = torch.where(evt >= L, evt - L, evt).to(torch.int64)
        bit = lambda k: ((flags >> k) & 1).to(torch.bool)
        hit = bit(0)
        return dict(raw, hit=hit, entering=bit(1), take_transmit=bit(2),
                    scatter_alive=bit(3), alive2=bit(4),
                    mat_id=torch.where(hit, self.leaf_mat[leaf], 0))

    def launch(self, o, d, thr, strength, alive, u_coin, u3, in_depth):
        """One kernel launch on the current stream, no synchronisation:
        the raw outputs ``t, o2, d2, thr2, strength2, u_sel``, ``evt``
        (int32) and ``flags`` (int32 bits: hit, entering, take_transmit,
        scatter_alive, alive2)."""
        global LAUNCHES
        B = o.shape[0]
        device = self.buf.device
        expect = {"o": (o, (B, 3), torch.float32), "d": (d, (B, 3), torch.float32),
                  "thr": (thr, (B, 3), torch.float32),
                  "strength": (strength, (B,), torch.float32),
                  "alive": (alive, (B,), torch.bool),
                  "u_coin": (u_coin, (B,), torch.float32),
                  "u3": (u3, (B, 3), torch.float32)}
        for name, (x, shape, dtype) in expect.items():
            if (x.device != device or x.dtype != dtype
                    or tuple(x.shape) != shape or not x.is_contiguous()):
                raise ValueError(
                    f"bounce kernel: {name} must be a contiguous {dtype} "
                    f"tensor of shape {shape} on {device}; got {x.dtype} "
                    f"{tuple(x.shape)} on {x.device}")
        if B == 0:
            raise ValueError("bounce kernel: empty wavefront")

        from ptx_torch.ops import _build
        lib = _build.library()
        empty = lambda *s, dtype=torch.float32: torch.empty(
            s, dtype=dtype, device=device)
        t, st2 = empty(B), empty(B)
        o2, d2, thr2, u_sel = empty(B, 3), empty(B, 3), empty(B, 3), empty(B, 3)
        flags, evt = empty(B, dtype=torch.int32), empty(B, dtype=torch.int32)
        L, mat_off, tape_off, tape_len = self.layout
        p = lambda x: ctypes.c_void_p(x.data_ptr())
        err = lib.ptx_bounce_forward(
            p(self.buf), self.buf.numel(), L, mat_off, tape_off, tape_len,
            p(o), p(d), p(thr), p(strength), p(alive), p(u_coin), p(u3),
            int(bool(in_depth)), B,
            p(t), p(o2), p(d2), p(thr2), p(st2), p(flags), p(evt), p(u_sel),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
        if err:
            raise RuntimeError(f"bounce kernel launch failed: CUDA error {err} "
                               f"({lib.ptx_cuda_error_name(err).decode()})")
        LAUNCHES += 1
        return {"t": t, "o2": o2, "d2": d2, "thr2": thr2, "strength2": st2,
                "u_sel": u_sel, "evt": evt, "flags": flags}


def bounce_reference(scene, params, o, d, thr, strength, alive, u_coin, u3,
                     in_depth: bool):
    """The kernel's plain PyTorch version, on any device: the dense first
    hit + ``trace._bounce_live``, returning the kernel's output dict."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    (o2, d2, thr2, st2, alive2), dec = trace._bounce_live(
        scene.hit_fn, scene.material_fn, params, o, d, thr, strength, alive,
        in_depth, u_coin, u3)
    return dict(dec, o2=o2, d2=d2, thr2=thr2, strength2=st2, alive2=alive2)
