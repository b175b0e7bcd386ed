"""Differentiable selected-boundary recompute ("hit replay").

Port of ``ptx/geom/hitreplay.py``.  Given the decisions of a first hit —
the winning event ``evt`` (leaf ``k`` start = k, end = L + k), ``entering``
and ``hit`` — recompute the differentiable ``t`` and world-space normal of
exactly that boundary: one per-lane row gather plus one dual-formula
(sphere | plane) evaluation, O(1) leaf work per lane.  The backward of a
bounce replays through this instead of the 2L·L candidate fold.

The JAX module fetches the row with ``tableops.table_lookup_aug``, a
one-hot MXU gather for the TPU; here it is a plain row gather.

Row layout (R = 26):
  sphere: [cx cy cz r  0        W(12) N(9)]
  plane:  [nx ny nz d  inv_mag  W(12) N(9)]
W = world→object affine (identity when untransformed), N = A^{-T}.
"""

from __future__ import annotations

import torch

from ptx_torch.core import linalg
from ptx_torch.core.constants import EPS, MAX_VALUE

ROW = 26


class LeafRows:
    """``rows(params)`` → the differentiable (L, 26) packed rows of
    ``leaves`` (the (leaf, parity) list of
    :func:`ptx_torch.geom.fasthit.collect_leaves`).

    Group-batched as in the JAX package: leaves of one kind and transform
    chain length pack through one gather and one concatenation for the
    whole group, then one row permutation restores leaf order, so a pack
    costs a few launches whatever L is.  The index tensors are built once
    per device."""

    def __init__(self, leaves):
        self.leaves = leaves
        groups: dict = {}
        for i, (lf, _p) in enumerate(leaves):
            groups.setdefault((lf.kind, len(lf.xform_chain)), []).append(i)
        self.groups = [(kind, clen, idxs, [leaves[i][0].index for i in idxs],
                        [leaves[i][0].xform_chain for i in idxs])
                       for (kind, clen), idxs in groups.items()]
        order = [i for _, _, idxs, _, _ in self.groups for i in idxs]
        self.inv = [0] * len(leaves)
        for pos, i in enumerate(order):
            self.inv[i] = pos
        self._dev: dict = {}

    def _indices(self, device, dtype):
        key = (device, dtype)
        if key not in self._dev:
            t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
            eye_tail = torch.cat([torch.eye(3, 4, dtype=dtype, device=device).reshape(-1),
                                  torch.eye(3, dtype=dtype, device=device).reshape(-1)])
            self._dev[key] = (eye_tail, [(t(gi), t(ch) if clen else None)
                                         for _, clen, _, gi, ch in self.groups],
                              t(self.inv))
        return self._dev[key]

    def __call__(self, params):
        center = params["sphere_center"]
        eye_tail, idx, inv = self._indices(center.device, center.dtype)
        parts = []
        for (kind, clen, idxs, _, _), (gi, ch) in zip(self.groups, idx):
            if kind == "sphere":
                r = params["sphere_radius"][gi][:, None]
                head = torch.cat([params["sphere_center"][gi], r, torch.zeros_like(r)], 1)
            else:
                n = params["plane_normal"][gi]
                inv_mag = 1.0 / torch.sqrt(torch.clamp((n * n).sum(1, keepdim=True),
                                                       min=1e-30))
                head = torch.cat([n, params["plane_d"][gi][:, None], inv_mag], 1)
            if ch is None:
                tail = eye_tail.expand(len(idxs), 21)
            else:
                w = params["xform"][ch[:, 0]]
                for j in range(1, clen):
                    w = linalg.compose(w, params["xform"][ch[:, j]])
                w_inv = linalg.inverse(w)
                tail = torch.cat([w_inv.reshape(-1, 12),
                                  w_inv[:, :, :3].transpose(1, 2).reshape(-1, 9)], 1)
            parts.append(torch.cat([head, tail], 1))
        return torch.cat(parts)[inv]


def leaf_rows(leaves, params):
    """Differentiable (L, 26) packed rows for ``leaves`` (see :class:`LeafRows`)."""
    return LeafRows(leaves)(params)


def recompute_flat(rows, sph, par, ox, oy, oz, dx, dy, dz, evt):
    """``(t_sel, wx, wy, wz, parity)`` per lane for the boundary ``evt``:
    ``rows`` (L, 26) from :func:`leaf_rows`, ``sph`` (L,) bool and ``par``
    (L,) float32 per leaf."""
    L = rows.shape[0]
    evt = evt.to(torch.int64)
    leaf = torch.where(evt >= L, evt - L, evt)
    is_start = evt < L
    # index_select, not rows[leaf]: its transpose is index_add_, where that
    # of rows[leaf] sorts the lanes and walks each leaf's duplicates serially
    # (a few leaves, millions of lanes)
    row = rows.index_select(0, leaf)
    sph, par = sph[leaf], par[leaf]
    w, nrm = row[:, 5:17], row[:, 17:26]
    lox = w[:, 0] * ox + w[:, 1] * oy + w[:, 2] * oz + w[:, 3]
    loy = w[:, 4] * ox + w[:, 5] * oy + w[:, 6] * oz + w[:, 7]
    loz = w[:, 8] * ox + w[:, 9] * oy + w[:, 10] * oz + w[:, 11]
    ldx = w[:, 0] * dx + w[:, 1] * dy + w[:, 2] * dz
    ldy = w[:, 4] * dx + w[:, 5] * dy + w[:, 6] * dz
    ldz = w[:, 8] * dx + w[:, 9] * dy + w[:, 10] * dz

    # sphere formula
    ocx, ocy, ocz = lox - row[:, 0], loy - row[:, 1], loz - row[:, 2]
    r = row[:, 3]
    a = ldx * ldx + ldy * ldy + ldz * ldz
    b = ocx * ldx + ocy * ldy + ocz * ldz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc_raw = b * b - a * cc
    # lanes whose leaf is a plane run this branch on nonsense values, and
    # sqrt'(0) = inf would NaN the where-cotangent
    sq = torch.sqrt(torch.where(disc_raw > 1e-12, disc_raw, 1.0))
    sa = torch.where(a == 0.0, 1.0, a)
    t_s = torch.where(is_start, (-b - sq) / sa, (-b + sq) / sa)
    inv_r = 1.0 / torch.where(r == 0.0, 1.0, r)
    snx = (ocx + t_s * ldx) * inv_r
    sny = (ocy + t_s * ldy) * inv_r
    snz = (ocz + t_s * ldz) * inv_r

    # plane formula
    pn0, pn1, pn2, pd, pim = row[:, 0], row[:, 1], row[:, 2], row[:, 3], row[:, 4]
    divisor = ldx * pn0 + ldy * pn1 + ldz * pn2
    numer = -pd - (lox * pn0 + loy * pn1 + loz * pn2)
    t_p = numer / torch.where(torch.abs(divisor) < EPS * EPS, 1.0, divisor)

    t_sel = torch.where(sph, t_s, t_p)
    nx0 = torch.where(sph, snx, pn0 * pim)
    ny0 = torch.where(sph, sny, pn1 * pim)
    nz0 = torch.where(sph, snz, pn2 * pim)
    # ±MAX sentinel boundaries carry no useful gradient: pin them
    t_sel = torch.where(torch.abs(t_sel) >= MAX_VALUE, t_sel.detach(), t_sel)

    wx = nrm[:, 0] * nx0 + nrm[:, 1] * ny0 + nrm[:, 2] * nz0
    wy = nrm[:, 3] * nx0 + nrm[:, 4] * ny0 + nrm[:, 5] * nz0
    wz = nrm[:, 6] * nx0 + nrm[:, 7] * ny0 + nrm[:, 8] * nz0
    mag = torch.sqrt(wx * wx + wy * wy + wz * wz)
    inv = 1.0 / torch.where(mag == 0.0, 1.0, mag)
    return t_sel, wx * inv, wy * inv, wz * inv, par


def build_hit_replay(leaves):
    """``replay(params, origin, direction, evt, entering, hit)`` →
    ``(t, normal)`` equal to the live hit's masked outputs; lanes with
    ``hit`` False give t = 0 and the unit placeholder normal (0, 0, 1)."""
    sph_list = [lf.kind == "sphere" for lf, _ in leaves]
    par_list = [p for _, p in leaves]
    rows = LeafRows(leaves)
    dev: dict = {}      # (device, dtype) -> (sph, par), copied there once

    def replay(params, origin, direction, evt, entering, hit):
        key = (origin.device, origin.dtype)
        if key not in dev:
            dev[key] = (torch.tensor(sph_list, device=origin.device),
                        torch.tensor(par_list, dtype=origin.dtype, device=origin.device))
        sph, par = dev[key]
        t, nx, ny, nz, p = recompute_flat(
            rows(params), sph, par, *origin.unbind(-1),
            *direction.unbind(-1), evt)
        sign = p * torch.where(entering, 1.0, -1.0)
        # miss lanes get a CONSTANT unit placeholder, not the zero vector:
        # normalize/refract downstream have infinite slopes at n = 0, and a
        # zero cotangent times an infinite partial is NaN; the placeholder
        # is parameter-independent, so it adds exactly zero gradient
        normal = torch.stack([torch.where(hit, nx * sign, 0.0),
                              torch.where(hit, ny * sign, 0.0),
                              torch.where(hit, nz * sign, 1.0)], dim=-1)
        return torch.where(hit, t, 0.0), normal

    return replay
