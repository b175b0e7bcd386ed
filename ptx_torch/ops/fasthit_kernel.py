"""The hit-only kernel K4: the CSG first hit of a wavefront, one launch.

Port of ``ptx/ops/fasthit_kernel.py`` ``build_hit_kernel`` (:233), a
Pallas TPU kernel, as the hand-written CUDA kernel
``ptx_torch/csrc/fasthit_kernel.cu``, which runs the fold K1 runs
(``csrc/hit_fold.cuh``, the walk in time order) and writes the first-hit
dict itself: a call is one launch.

- :class:`HitKernel` is K4's wrapper: ``hit(params, o, d, packed=None)``
  returns the dict of the dense first hit.  On CUDA tensors it launches
  the kernel (or raises); on CPU tensors, and only for those, it runs the
  plain version, the dense hit
  :class:`~ptx_torch.geom.fasthit.DenseHit`.  ``LAUNCHES`` and
  ``REFERENCE_CALLS`` count the two.
- :func:`pack_geometry` is the kernel's scene buffer: leaf records,
  geometry and the CSG tape, no material scalars (on a scene with
  textured slots those are per-lane values).  K1's buffer
  (``bounce_kernel.pack_scene``) is this one with the material rows
  appended.

``t`` and the normal reach autograd through
:class:`~ptx_torch.geom.fasthit.HitReplay` on both devices, as the JAX
package's custom VJP (``ptx/ops/fasthit_kernel.py:317-362``) does: the
forward is the kernel's (on the CPU the plain version's, without
history), the backward autograd of the hit replay
(``ptx_torch.geom.hitreplay``) at the frozen decisions.  Where no input
needs a gradient (the manual bounce's forward) nothing is recorded.
"""

from __future__ import annotations

import torch

from ptx_torch.geom import hitreplay, tape
from ptx_torch.geom.fasthit import collect_leaves, hit_dict, leaf_affine, plane_inv_mag
from ptx_torch.ops import _build
from ptx_torch.ops._build import _check_inputs, _ptr, _raise_on, _stream

LAUNCHES = 0
REFERENCE_CALLS = 0

# scene buffer layout — must match ptx_torch/csrc/hit_fold.cuh
LEAF_STRIDE = 5      # kind (0 sphere, 1 plane), geo offset, has_xform, material, parity
_OP_UNION, _OP_INTERSECTION, _OP_DIFFERENCE = -1, -2, -3
_MAX_STACK = 32      # the tape's deepest stack (the kernels' fold: 32 bits a register)
MAX_SCENE_BYTES = 48 * 1024   # dynamic shared memory without opt-in


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


def stack_below_top(plan) -> int:
    """The stack slots below the top that the kernels' fold
    (``csrc/hit_fold.cuh`` ``first_hit_walk``) keeps for ``plan``'s tape.
    The fold forms each leaf's bits where the tape pushes it, walking the
    leaves from L - 1 down to 0: this checks that the tape pushes them in
    that order (``collect_leaves`` reverses the tape's depth-first order)."""
    leaves = collect_leaves(plan)
    prog = tape_program(plan, {id(lf): i for i, (lf, _) in enumerate(leaves)})
    if [op for op in prog if op >= 0] != list(range(len(leaves) - 1, -1, -1)):
        raise NotImplementedError("the CSG tape does not push its leaves in descending "
                                  "order, as the kernels' fold walks them")
    return _stack_depth(prog) - 1


def pack_geometry(plan, params):
    """The hit kernels' scene buffer (float32, on the params' device) and
    its layout ``(L, tape_off, tape_len)``.

    Words: ``L`` leaf records of 5; per-leaf geometry (sphere ``cx cy cz
    r``, plane ``nx ny nz d inv_mag``, then ``W⁻¹`` (12, row-major) and
    ``W⁻ᵀ`` (9) when transformed) — the Pallas kernel's packing; the tape
    program.  Small integers are stored as exact float values."""
    leaves = collect_leaves(plan)
    L = len(leaves)
    leaf_pos = {id(lf): i for i, (lf, _) in enumerate(leaves)}
    prog = tape_program(plan, leaf_pos)
    if _stack_depth(prog) > _MAX_STACK:
        raise NotImplementedError(
            f"CSG tape needs a stack of {_stack_depth(prog)} > {_MAX_STACK}")
    device = params["sphere_center"].device
    f32 = lambda xs: torch.as_tensor(xs, dtype=torch.float32, device=device)

    geo, records = [], []
    off = L * LEAF_STRIDE
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
    buf = torch.cat([f32(records).reshape(-1), *geo, f32(prog)])
    return buf, (L, off, len(prog))


class HitKernel:
    """K4 for one scene plan: ``hit(params, o, d, packed=None)`` on flat
    (B, 3) rays returns ``t`` (0 on a miss), the signed ``normal`` (B, 3;
    meaningful on hit lanes), ``mat_id``, ``entering``, ``hit`` and
    ``_evt`` (int32), as ``plain`` — the dense first hit — does.  On CUDA
    the kernel reads the scene buffer ``packed`` (:meth:`pack` of these
    params), packed here when it is not given; ``trace_rays`` packs once
    per call.  ``t`` and ``normal`` differentiate through the hit replay
    (module docstring)."""

    def __init__(self, plan, plain, params):
        self.plan, self.plain = plan, plain
        self.layout = pack_geometry(plan, params)[1]
        self.replay = hitreplay.build_hit_replay(collect_leaves(plan))
        stack_below_top(plan)                   # the fold's leaf order, checked

    def pack(self, params):
        """The kernel's scene buffer from ``params`` (no autograd)."""
        with torch.no_grad():
            buf, _ = pack_geometry(self.plan, params)
        if buf.numel() * 4 > MAX_SCENE_BYTES:
            raise NotImplementedError(f"scene buffer of {buf.numel() * 4} bytes "
                                      "exceeds the kernel's shared memory")
        return buf.contiguous()

    def __call__(self, params, o, d, packed=None):
        global REFERENCE_CALLS
        if o.device.type == "cpu":
            REFERENCE_CALLS += 1
            with torch.no_grad():
                out = self.plain(params, o, d)
        elif o.device.type != "cuda":
            raise ValueError(f"hit kernel: no kernel for {o.device}")
        else:
            out = self.launch(self.pack(params) if packed is None else packed, o, d)
        return hit_dict(self.replay, params, o, d, out["t"], out["normal"], out["hit"],
                        out["entering"], out["_evt"], out["mat_id"])

    def launch(self, buf, o, d):
        """One kernel launch on the current stream, no synchronisation: the
        dense hit's dict, ``t`` (B,; 0 on a miss), ``normal`` (B, 3),
        ``mat_id`` (int64; 0 on a miss), ``entering`` and ``hit`` (bool),
        ``_evt`` (int32; 0 on a miss), all written by the kernel."""
        global LAUNCHES
        B = o.shape[0]
        device = buf.device
        _check_inputs("hit kernel", device, {
            "o": (o, (B, 3), torch.float32), "d": (d, (B, 3), torch.float32),
            "packed": (buf, (buf.numel(),), torch.float32)})
        if B == 0:
            raise ValueError("hit kernel: empty wavefront")
        lib = _build.library()
        out = {"t": torch.empty(B, dtype=torch.float32, device=device),
               "normal": torch.empty((B, 3), dtype=torch.float32, device=device),
               "mat_id": torch.empty(B, dtype=torch.int64, device=device),
               "entering": torch.empty(B, dtype=torch.bool, device=device),
               "hit": torch.empty(B, dtype=torch.bool, device=device),
               "_evt": torch.empty(B, dtype=torch.int32, device=device)}
        L, tape_off, tape_len = self.layout
        err = lib.ptx_first_hit(_ptr(buf), buf.numel(), L, tape_off, tape_len, _ptr(o),
                                _ptr(d), B, *(_ptr(x) for x in out.values()),
                                _stream(device))
        _raise_on(err, lib, "hit kernel")
        LAUNCHES += 1
        return out
