"""Direct (sort-free) CSG first hit — port of the dense path of
``ptx/geom/fasthit.py``.

Every leaf contributes its two boundary times, giving 2L candidates.
Root membership just before (``t0 < t <= t1``) and just after
(``t0 <= t < t1``) each candidate folds through the boolean CSG tape; a
candidate where the two differ is a boundary of the root solid, and the
first hit is the minimum such boundary with ``t >= EPS``.  The JAX
module's docstring proves this equals the reference's span walk.

This dense form materializes the (2L, L, B) membership tensors.  It is
the plain PyTorch version of the hit-only kernel K4 and of the hit half
of the fused bounce kernel K1 (``ptx_torch/csrc/hit_fold.cuh``), which
fold the same candidates as 64-bit masks per ray.  The candidate-blocked,
union-sweep and megasweep strategies of the JAX module are not ported yet
(ROADMAP Queue 1 #8).
"""

from __future__ import annotations

import torch

from ptx_torch.core import linalg
from ptx_torch.core.constants import EPS, MAX_VALUE
from ptx_torch.geom import tape

PAD_T = 3e20                 # "no boundary" sentinel, above MAX_VALUE
DENSE_L_MAX = 64             # the JAX package's dense-path limit


def collect_leaves(plan):
    """Flatten the tape to (leaf, difference-parity) pairs in REVERSED
    depth-first order.  The order is the coincident-boundary tie-break:
    when two leaves share a boundary at exactly the same ``t`` (the demo's
    diffuse sphere and emissive core share centre and radius), the first
    minimum in this order wins, which reproduces the reference's union
    merge (``ptx/geom/fasthit.py:collect_leaves`` traces it).  A leaf under
    the B side of an odd number of differences has parity −1."""
    leaves = []

    def walk(node, parity):
        if isinstance(node, tape._LeafPlan):
            leaves.append((node, parity))
        elif node.op == "difference":
            walk(node.children[0], parity)
            walk(node.children[1], -parity)
        else:
            for c in node.children:
                walk(c, parity)

    walk(plan, 1.0)
    leaves.reverse()
    return leaves


def leaf_affine(lf, params):
    """World→object affine ``W⁻¹`` (3, 4) and normal map ``W⁻ᵀ`` (3, 3) of
    a transformed leaf, or ``None``.  Shared by the plain hit and the
    kernel's scene packing, so both see the same rounded values."""
    if not lf.xform_chain:
        return None
    w = params["xform"][lf.xform_chain[0]]
    for i in lf.xform_chain[1:]:
        w = linalg.compose(w, params["xform"][i])
    w_inv = linalg.inverse(w)
    return w_inv, w_inv[:, :3].T


def plane_inv_mag(n):
    """1 / |n| of a plane normal, guarded as in the JAX package."""
    return 1.0 / torch.sqrt(torch.clamp(n[0] * n[0] + n[1] * n[1] + n[2] * n[2],
                                        min=1e-30))


def _leaf_intervals(leaves, params, ox, oy, oz, dx, dy, dz):
    """Per-leaf boundary intervals and boundary normals, leaf-major.

    Returns ``(t0, t1, n0, n1)``: ``t0``/``t1`` (L, B) with ``PAD_T``
    where the leaf is missed, ``n0``/``n1`` 3-tuples of (L, B) outward
    normals at the start/end boundary (unsigned)."""
    t0s, t1s = [], []
    n0c, n1c = ([], [], []), ([], [], [])
    for lf, _p in leaves:
        lox, loy, loz, ldx, ldy, ldz = ox, oy, oz, dx, dy, dz
        xf = leaf_affine(lf, params)
        if xf is not None:
            A, tv = xf[0][:, :3], xf[0][:, 3]
            lox = A[0, 0] * ox + A[0, 1] * oy + A[0, 2] * oz + tv[0]
            loy = A[1, 0] * ox + A[1, 1] * oy + A[1, 2] * oz + tv[1]
            loz = A[2, 0] * ox + A[2, 1] * oy + A[2, 2] * oz + tv[2]
            ldx = A[0, 0] * dx + A[0, 1] * dy + A[0, 2] * dz
            ldy = A[1, 0] * dx + A[1, 1] * dy + A[1, 2] * dz
            ldz = A[2, 0] * dx + A[2, 1] * dy + A[2, 2] * dz

        if lf.kind == "sphere":
            c = params["sphere_center"][lf.index]
            r = params["sphere_radius"][lf.index]
            ocx, ocy, ocz = lox - c[0], loy - c[1], loz - c[2]
            a = ldx * ldx + ldy * ldy + ldz * ldz
            b = ocx * ldx + ocy * ldy + ocz * ldz
            cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
            disc = b * b - a * cc
            ok = (disc > EPS) & (a != 0.0)
            sq = torch.sqrt(torch.where(ok, disc, 1.0))
            sa = torch.where(a == 0.0, 1.0, a)
            t0 = (-b - sq) / sa
            t1 = (-b + sq) / sa
            inv_r = 1.0 / torch.where(r == 0.0, 1.0, r)
            n0 = ((ocx + t0 * ldx) * inv_r, (ocy + t0 * ldy) * inv_r,
                  (ocz + t0 * ldz) * inv_r)
            n1 = ((ocx + t1 * ldx) * inv_r, (ocy + t1 * ldy) * inv_r,
                  (ocz + t1 * ldz) * inv_r)
        else:
            n = params["plane_normal"][lf.index]
            dplane = params["plane_d"][lf.index]
            inv_mag = plane_inv_mag(n)
            divisor = ldx * n[0] + ldy * n[1] + ldz * n[2]
            numer = -dplane - (lox * n[0] + loy * n[1] + loz * n[2])
            flat = torch.abs(divisor) < EPS * EPS
            t = numer / torch.where(flat, 1.0, divisor)
            degenerate = flat | (torch.abs(t) >= MAX_VALUE)
            on_boundary = torch.abs(numer) < EPS * EPS
            entering_half = divisor < 0.0
            full = degenerate & on_boundary
            ok = ~(degenerate & ~on_boundary)
            t0 = torch.where(full, -MAX_VALUE,
                             torch.where(entering_half, t, -MAX_VALUE))
            t1 = torch.where(full, MAX_VALUE,
                             torch.where(entering_half, MAX_VALUE, t))
            one = torch.ones_like(t)
            n0 = n1 = (n[0] * inv_mag * one, n[1] * inv_mag * one,
                       n[2] * inv_mag * one)

        if xf is not None:
            nrm = xf[1]

            def push(nx, ny, nz):
                wx = nrm[0, 0] * nx + nrm[0, 1] * ny + nrm[0, 2] * nz
                wy = nrm[1, 0] * nx + nrm[1, 1] * ny + nrm[1, 2] * nz
                wz = nrm[2, 0] * nx + nrm[2, 1] * ny + nrm[2, 2] * nz
                mag = torch.sqrt(wx * wx + wy * wy + wz * wz)
                inv = 1.0 / torch.where(mag == 0.0, 1.0, mag)
                return wx * inv, wy * inv, wz * inv
            n0, n1 = push(*n0), push(*n1)

        t0s.append(torch.where(ok, t0, PAD_T))
        t1s.append(torch.where(ok, t1, PAD_T))
        for lst, v in zip(n0c, n0):
            lst.append(v)
        for lst, v in zip(n1c, n1):
            lst.append(v)
    st = lambda xs: torch.stack(xs, dim=0)
    return (st(t0s), st(t1s), tuple(st(c) for c in n0c),
            tuple(st(c) for c in n1c))


def _bits_at(node, leaf_pos, bits):
    """Fold the boolean CSG tape over per-leaf membership bits
    ``(..., L, B)`` → ``(..., B)``."""
    if isinstance(node, tape._LeafPlan):
        return bits[..., leaf_pos[id(node)], :]
    kids = [_bits_at(c, leaf_pos, bits) for c in node.children]
    out = kids[0]
    if node.op == "union":
        for k in kids[1:]:
            out = out | k
    elif node.op == "intersection":
        for k in kids[1:]:
            out = out & k
    else:
        out = out & ~kids[1]
    return out


def compile_fast_hit(plan):
    """``hit_fn(params, origin, direction) -> dict`` for flat (B, 3) rays:
    ``t`` (0 on miss), signed ``normal`` (B, 3), ``mat_id``, ``entering``,
    ``hit`` and ``_evt``, the winning event index (leaf ``k`` start = k,
    end = L + k) — the dict ``ptx.geom.fasthit.compile_fast_hit`` returns."""
    leaves = collect_leaves(plan)
    L = len(leaves)
    if L > DENSE_L_MAX:
        raise NotImplementedError(
            f"{L} leaves: the port has only the dense first hit (L <= "
            f"{DENSE_L_MAX}); the blocked and sweep paths are ROADMAP "
            "Queue 1 #8")
    parity_list = [p for _, p in leaves]
    mats_list = [lf.mat_id for lf, _ in leaves]
    leaf_pos = {id(lf): i for i, (lf, _) in enumerate(leaves)}

    def hit_fn(params, origin, direction):
        device = origin.device
        parity = torch.tensor(parity_list, dtype=torch.float32, device=device)
        mat_ids = torch.tensor(mats_list, dtype=torch.int64, device=device)
        ox, oy, oz = origin.unbind(-1)
        dx, dy, dz = direction.unbind(-1)
        t0, t1, (n0x, n0y, n0z), (n1x, n1y, n1z) = _leaf_intervals(
            leaves, params, ox, oy, oz, dx, dy, dz)

        t_evt = torch.cat([t0, t1], dim=0)                  # (2L, B)
        ts = t_evt[:, None, :]
        lo, hi = t0[None], t1[None]                          # (1, L, B)
        after = (lo <= ts) & (ts < hi)                       # (2L, L, B)
        before = (lo < ts) & (ts <= hi)
        root_after = _bits_at(plan, leaf_pos, after)         # (2L, B)
        root_before = _bits_at(plan, leaf_pos, before)
        candidate = (root_after != root_before) & (t_evt >= EPS)

        # first minimum wins ties: the leaf-order tie-break
        idx = torch.argmin(torch.where(candidate, t_evt, PAD_T), dim=0)
        take = lambda a: a.gather(0, idx[None])[0]
        t_hit = take(t_evt)
        hit = candidate.any(dim=0) & ~(t_hit >= MAX_VALUE)
        entering = take(root_after)

        leaf_idx = idx % L
        sign = parity[leaf_idx] * torch.where(entering, 1.0, -1.0)
        normal = torch.stack([take(torch.cat([n0x, n1x])) * sign,
                              take(torch.cat([n0y, n1y])) * sign,
                              take(torch.cat([n0z, n1z])) * sign], dim=-1)
        return {
            "t": torch.where(hit, t_hit, 0.0),
            "normal": normal,
            "mat_id": torch.where(hit, mat_ids[leaf_idx], 0),
            "entering": entering,
            "hit": hit,
            "_evt": torch.where(hit, idx, 0).to(torch.int32),
        }

    return hit_fn
