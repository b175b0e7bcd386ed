"""Direct (sort-free) CSG first hit — port of ``ptx/geom/fasthit.py``.

Every leaf contributes its two boundary times, giving 2L candidates.
Root membership just before (``t0 < t <= t1``) and just after
(``t0 <= t < t1``) each candidate folds through the boolean CSG tape; a
candidate where the two differ is a boundary of the root solid, and the
first hit is the minimum such boundary with ``t >= EPS``.  The JAX
module's docstring proves this equals the reference's span walk.

The plain hits (:class:`PlainHit`: they read the params and pack
nothing), which ``ptx_torch.integrate.trace.compile_fast_hit`` picks
among as the JAX function does (:399-412):

- :class:`DenseHit`, the dense fold up to 64 leaves: it materializes the
  (2L, L, B) membership tensors and is the plain version of the hit-only
  kernel K4 and of K1's hit (``ptx_torch/csrc/hit_fold.cuh``);
- :class:`BlockedHit`, the candidate-blocked scan, above 64 leaves;
- :class:`UnionSweepHit`, the union sweep of a union of small groups in
  ``fixpoint``, ``sort`` or ``kernel`` mode (the last with the
  sweep-select kernel K9), whose gadgets' coverage comes from a local
  membership fold.  The sweep's ``mega`` mode is K5's plain version,
  ``ptx_torch.ops.megasweep.SweepHit``.

:class:`HitReplay` carries the hits' ``t`` and normal to autograd, for
these and for the kernels' hits alike.
"""

from __future__ import annotations

import numpy as np
import torch

from ptx_torch.core import linalg
from ptx_torch.core.constants import EPS, MAX_VALUE
from ptx_torch.geom import hitreplay, tape
from ptx_torch.ops import sweep_kernel

PAD_T = 3e20                 # "no boundary" sentinel, above MAX_VALUE
NEG = -3e20                  # end of an invalid sweep interval: extends no chain
GEO_KEYS = ("sphere_center", "sphere_radius", "plane_normal", "plane_d", "xform")


def tape_is_union_only(plan) -> bool:
    """True iff every internal node of the tape is a union."""
    if isinstance(plan, tape._LeafPlan):
        return True
    return plan.op == "union" and all(tape_is_union_only(c) for c in plan.children)


def union_decompose(plan):
    """The maximal top-level union operands ("groups"): leaves and
    non-union-rooted subtrees (gadgets)."""
    groups = []

    def walk(node):
        if not isinstance(node, tape._LeafPlan) and node.op == "union":
            for c in node.children:
                walk(c)
        else:
            groups.append(node)

    walk(plan)
    return groups


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


def _leaf_intervals(leaves, params, ox, oy, oz, dx, dy, dz, with_normals=True):
    """Per-leaf boundary intervals and boundary normals, leaf-major.

    Returns ``(t0, t1, n0, n1)``: ``t0``/``t1`` (L, B) with ``PAD_T``
    where the leaf is missed, ``n0``/``n1`` 3-tuples of (L, B) outward
    normals at the start/end boundary (unsigned); ``(t0, t1)`` without
    ``with_normals``."""
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
            t0s.append(torch.where(ok, t0, PAD_T))
            t1s.append(torch.where(ok, t1, PAD_T))
            if not with_normals:
                continue
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
            t0s.append(torch.where(ok, t0, PAD_T))
            t1s.append(torch.where(ok, t1, PAD_T))
            if not with_normals:
                continue
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

        for lst, v in zip(n0c, n0):
            lst.append(v)
        for lst, v in zip(n1c, n1):
            lst.append(v)
    st = lambda xs: torch.stack(xs, dim=0)
    if not with_normals:
        return st(t0s), st(t1s)
    return (st(t0s), st(t1s), tuple(st(c) for c in n0c),
            tuple(st(c) for c in n1c))


def _leaf_intervals_grouped(leaves, params, ox, oy, oz, dx, dy, dz):
    """(L, B) boundary intervals without normals, batched by group
    (``ptx/geom/fasthit.py:272-357``): the untransformed spheres as one
    gathered broadcast, the untransformed planes as another, transformed
    leaves one at a time.  Each expression is :func:`_leaf_intervals`'s in
    its operation order (planes elementwise, where the JAX package uses a
    matrix product), so the values are that function's, bit for bit; rows
    in leaf order."""
    idx_s, idx_p, idx_o = [], [], []
    for i, (lf, _p) in enumerate(leaves):
        (idx_o if lf.xform_chain else idx_s if lf.kind == "sphere" else idx_p).append(i)
    dev = ox.device
    rows = lambda idx: torch.tensor(idx, dtype=torch.int64, device=dev)
    index = lambda idx: rows([leaves[i][0].index for i in idx])
    t0 = ox.new_empty((len(leaves), ox.shape[0]))
    t1 = torch.empty_like(t0)
    if idx_s:
        gi = index(idx_s)
        c, r = params["sphere_center"][gi], params["sphere_radius"][gi]
        ocx, ocy, ocz = ox[None] - c[:, 0:1], oy[None] - c[:, 1:2], oz[None] - c[:, 2:3]
        a = (dx * dx + dy * dy + dz * dz)[None]
        b = ocx * dx[None] + ocy * dy[None] + ocz * dz[None]
        cc = ocx * ocx + ocy * ocy + ocz * ocz - (r * r)[:, None]
        disc = b * b - a * cc
        ok = (disc > EPS) & (a != 0.0)
        sq = torch.sqrt(torch.where(ok, disc, 1.0))
        sa = torch.where(a == 0.0, 1.0, a)
        t0.index_copy_(0, rows(idx_s), torch.where(ok, (-b - sq) / sa, PAD_T))
        t1.index_copy_(0, rows(idx_s), torch.where(ok, (-b + sq) / sa, PAD_T))
    if idx_p:
        gi = index(idx_p)
        n, dplane = params["plane_normal"][gi], params["plane_d"][gi]
        nx, ny, nz = n[:, 0:1], n[:, 1:2], n[:, 2:3]
        divisor = dx[None] * nx + dy[None] * ny + dz[None] * nz
        numer = -dplane[:, None] - (ox[None] * nx + oy[None] * ny + oz[None] * nz)
        flat = torch.abs(divisor) < EPS * EPS
        t = numer / torch.where(flat, 1.0, divisor)
        degenerate = flat | (torch.abs(t) >= MAX_VALUE)
        on_boundary = torch.abs(numer) < EPS * EPS
        entering_half = divisor < 0.0
        full = degenerate & on_boundary
        ok = ~(degenerate & ~on_boundary)
        t0.index_copy_(0, rows(idx_p), torch.where(ok, torch.where(
            full, -MAX_VALUE, torch.where(entering_half, t, -MAX_VALUE)), PAD_T))
        t1.index_copy_(0, rows(idx_p), torch.where(ok, torch.where(
            full, MAX_VALUE, torch.where(entering_half, MAX_VALUE, t)), PAD_T))
    if idx_o:
        o0, o1 = _leaf_intervals([leaves[i] for i in idx_o], params, ox, oy, oz, dx, dy, dz,
                                 with_normals=False)
        t0.index_copy_(0, rows(idx_o), o0)
        t1.index_copy_(0, rows(idx_o), o1)
    return t0, t1


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


class PlainHit:
    """A first hit in plain PyTorch, on every device, as the JAX package
    leaves its hits to XLA: it reads the params, so it packs nothing for a
    ``trace_rays`` call (:meth:`pack` is None)."""

    def pack(self, params):
        return None


class DenseHit(PlainHit):
    """The dense fold (up to 64 leaves): ``hit(params, origin, direction)``
    on flat (B, 3) rays returns ``t`` (0 on miss), signed ``normal`` (B,
    3), ``mat_id``, ``entering``, ``hit`` and ``_evt``, the winning event
    index (leaf ``k`` start = k, end = L + k) — the dict
    ``ptx.geom.fasthit.compile_fast_hit`` returns.  It materializes the
    (2L, L, B) membership tensors; the plain version of K4 and of K1's hit
    (``ptx_torch/csrc/hit_fold.cuh``)."""

    def __init__(self, plan, leaves):
        self.plan, self.leaves = plan, leaves
        self.parity_list = [p for _, p in leaves]
        self.mats_list = [lf.mat_id for lf, _ in leaves]
        self.leaf_pos = {id(lf): i for i, (lf, _) in enumerate(leaves)}

    def __call__(self, params, origin, direction):
        L = len(self.leaves)
        device = origin.device
        parity = torch.tensor(self.parity_list, dtype=torch.float32, device=device)
        mat_ids = torch.tensor(self.mats_list, dtype=torch.int64, device=device)
        ox, oy, oz = origin.unbind(-1)
        dx, dy, dz = direction.unbind(-1)
        t0, t1, (n0x, n0y, n0z), (n1x, n1y, n1z) = _leaf_intervals(
            self.leaves, params, ox, oy, oz, dx, dy, dz)

        t_evt = torch.cat([t0, t1], dim=0)                  # (2L, B)
        ts = t_evt[:, None, :]
        lo, hi = t0[None], t1[None]                          # (1, L, B)
        after = (lo <= ts) & (ts < hi)                       # (2L, L, B)
        before = (lo < ts) & (ts <= hi)
        root_after = _bits_at(self.plan, self.leaf_pos, after)    # (2L, B)
        root_before = _bits_at(self.plan, self.leaf_pos, before)
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



# ---------------------------------------------------------------------------
# the hit replay's autograd, the union sweep, the candidate-blocked scan
# ---------------------------------------------------------------------------

class HitReplay(torch.autograd.Function):
    """Forward: a hit's ``t`` / normal as a kernel or a plain version
    computed them, without history (K4, K5's hit mode, the sweeps);
    backward: autograd of the hit replay
    (:func:`~ptx_torch.geom.hitreplay.build_hit_replay`) at the frozen
    decisions ``(evt, entering, hit)`` — the JAX ``_mega_replay`` custom
    VJP (``ptx/geom/fasthit.py:575-597``) and K4's ``hit_bwd``
    (``ptx/ops/fasthit_kernel.py:351-360``).

    ``apply(replay, evt, entering, hit, kt, kn, o, d, *geo)`` with ``geo``
    the params of ``GEO_KEYS``; returns ``(t, normal)``."""

    @staticmethod
    def forward(ctx, replay, evt, entering, hit, kt, kn, o, d, *geo):
        ctx.replay = replay
        ctx.save_for_backward(evt, entering, hit, o, d, *geo)
        return kt.clone(), kn.clone()

    @staticmethod
    def backward(ctx, ct_t, ct_n):
        evt, entering, hit, o, d, *geo = ctx.saved_tensors
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(True) for x in (o, d, *geo)]
            t, n = ctx.replay(dict(zip(GEO_KEYS, xs[2:])), xs[0], xs[1], evt, entering, hit)
            grads = torch.autograd.grad((t, n), xs, (ct_t, ct_n), allow_unused=True)
        return (None,) * 6 + tuple(grads)


def hit_dict(replay, params, o, d, t, normal, flags_hit, entering, evt, mat):
    """The first-hit dict, ``t`` / normal through :class:`HitReplay` when
    autograd would reach the geometry or the rays."""
    geo = [params[k] for k in GEO_KEYS]
    if torch.is_grad_enabled() and any(x.requires_grad for x in (*geo, o, d)):
        t, normal = HitReplay.apply(replay, evt, entering, flags_hit, t, normal, o, d, *geo)
    return {"t": t, "normal": normal, "mat_id": mat, "entering": entering,
            "hit": flags_hit, "_evt": evt}


def _selected(replay, mats, params, o, d, evt, entering, hit):
    """The hit dict of a selected event (``evt``, ``entering``, ``hit``):
    ``t`` and the normal from the replay, without history here (autograd
    reaches them through :class:`HitReplay`)."""
    L = mats.numel()
    with torch.no_grad():
        t, normal = replay(params, o, d, evt, entering, hit)
    leaf = torch.where(evt >= L, evt - L, evt).to(torch.int64)
    return hit_dict(replay, params, o, d, t, normal, hit, entering, evt,
                    torch.where(hit, mats[leaf], 0))


class UnionSweepHit(PlainHit):
    """The union sweep in ``fixpoint``, ``sort`` or ``kernel`` mode, on
    any union of small groups (the port of ``_compile_union_sweep``,
    ``ptx/geom/fasthit.py:715-1022``, without ``mega``).

    Root membership is interval coverage over the pooled *group*
    intervals: a leaf group gives its leaf interval; gadgets are batched by
    structure class, and one (G, 2m, m, B) local membership fold per class
    gives each gadget's boundaries, whose sorted, de-duplicated entry and
    exit events pair by rank into coverage intervals.  From the
    valid-masked (S, B) intervals ``(s, e)`` (:meth:`intervals`),
    :meth:`select` finds the first boundary at or past EPS:

    - ``fixpoint``: sort-free, the minimum start when no valid interval
      starts below EPS, else the exit of the chain through EPS, the fixed
      point of ``E <- max(E, max{e : s <= E})``; ``last_passes`` holds the
      passes of the last call (the loop stops when ``E`` stops changing,
      one host synchronisation a pass);
    - ``sort``: a stable sort by ``s``, the exclusive prefix max and the
      break minima: K9's plain version,
      :func:`~ptx_torch.ops.sweep_kernel.sweep_select_reference`;
    - ``kernel``: K9 (:func:`~ptx_torch.ops.sweep_kernel.sweep_select`):
      ``sort=True`` on the unsorted intervals where
      :func:`~ptx_torch.ops.sweep_kernel.sort_inside` says so, else the
      same stable sort, then ``sort=False``.

    All three read the same intervals and give the same outputs bit for
    bit.  The payload is the least leaf whose raw ``t0`` (then ``t1``)
    equals the boundary; selection is without gradient, and ``t`` and the
    normal come from the hit replay through :class:`HitReplay`."""

    def __init__(self, plan, leaves, mode: str):
        if mode not in ("fixpoint", "sort", "kernel"):
            raise ValueError(f"union sweep: no {mode!r} mode")
        self.plan, self.leaves, self.mode = plan, leaves, mode
        self.L = len(leaves)
        self.replay = hitreplay.build_hit_replay(leaves)
        self.mat_list = [lf.mat_id for lf, _ in leaves]
        self.last_passes = 0
        leaf_pos = {id(lf): i for i, (lf, _) in enumerate(leaves)}

        def sig(node, local_pos):
            if isinstance(node, tape._LeafPlan):
                return ("L", local_pos[id(node)])
            return (node.op, tuple(sig(c, local_pos) for c in node.children))

        leaf_rows, classes = [], {}     # structure signature -> [plan, local_pos, rows]
        for g in union_decompose(plan):
            if isinstance(g, tape._LeafPlan):
                leaf_rows.append(leaf_pos[id(g)])
                continue
            sub = collect_leaves(g)
            local_pos = {id(lf): j for j, (lf, _) in enumerate(sub)}
            cls = classes.setdefault(sig(g, local_pos), [g, local_pos, []])
            cls[2].append([leaf_pos[id(lf)] for lf, _ in sub])
        self.leaf_rows = leaf_rows
        self.classes = [(g, pos, np.array(rows, np.int64)) for g, pos, rows in classes.values()]

    def intervals(self, params, origin, direction):
        """``(t0, t1, s, e)``: the raw (L, B) leaf intervals and the
        valid-masked (S, B) coverage intervals (``s = PAD_T``, ``e = NEG``
        where an interval is empty or ends before EPS), without history."""
        with torch.no_grad():
            t0, t1 = _leaf_intervals_grouped(self.leaves, params, *origin.unbind(-1),
                                             *direction.unbind(-1))
            B = t0.shape[1]
            dev = t0.device
            parts_s, parts_e = [], []
            if self.leaf_rows:
                r = torch.tensor(self.leaf_rows, device=dev)
                parts_s.append(t0[r])
                parts_e.append(t1[r])
            for gplan, local_pos, rows in self.classes:
                G, m = rows.shape
                r = torch.as_tensor(rows.reshape(-1), device=dev)
                gt0, gt1 = t0[r].reshape(G, m, B), t1[r].reshape(G, m, B)
                ev = torch.cat([gt0, gt1], dim=1)                    # (G, 2m, B)
                ts = ev[:, :, None, :]
                after = (gt0[:, None] <= ts) & (ts < gt1[:, None])   # (G, 2m, m, B)
                before = (gt0[:, None] < ts) & (ts <= gt1[:, None])
                ra = _bits_at(gplan, local_pos, after)               # (G, 2m, B)
                bnd = ra != _bits_at(gplan, local_pos, before)
                del after, before
                srt = lambda a: torch.sort(a, dim=1).values
                # coincident events classify alike: drop adjacent-equal
                # duplicates, re-sort to restore the rank pairing
                dedup = lambda a: srt(torch.cat(
                    [a[:, :1], torch.where(a[:, 1:] == a[:, :-1], PAD_T, a[:, 1:])], dim=1))
                parts_s.append(dedup(srt(torch.where(bnd & ra, ev, PAD_T)))[:, :m]
                               .reshape(G * m, B))
                parts_e.append(dedup(srt(torch.where(bnd & ~ra, ev, PAD_T)))[:, :m]
                               .reshape(G * m, B))
            s, e = torch.cat(parts_s), torch.cat(parts_e)
            valid = (s < e) & (e >= EPS)
            return t0, t1, torch.where(valid, s, PAD_T), torch.where(valid, e, NEG)

    def select(self, t0, t1, s, e):
        """``(t_star, entering, m_start, m_end, found)`` in this sweep's
        mode (class docstring)."""
        L = self.L
        with torch.no_grad():
            if self.mode == "sort":
                return sweep_kernel.sweep_select_reference(s, e, t0, t1, L, EPS, sort=True)
            if self.mode == "kernel":
                if sweep_kernel.sort_inside(s.shape[0]):
                    return sweep_kernel.sweep_select(s, e, t0, t1, L, EPS, sort=True)
                s_s, idx = torch.sort(s, dim=0, stable=True)
                return sweep_kernel.sweep_select(s_s.contiguous(), e.gather(0, idx), t0, t1,
                                                 L, EPS, sort=False)
            below = s < EPS
            has_below = below.any(0)
            E = torch.where(below, e, NEG).amax(0)
            passes = 0
            while True:
                En = torch.maximum(E, torch.where(s <= E[None], e, NEG).amax(0))
                passes += 1
                if torch.equal(En, E):
                    break
                E = En
            self.last_passes = passes
            t_star = torch.where(has_below, E, s.amin(0))
            return (t_star, ~has_below, *sweep_kernel.payload_match(t0, t1, t_star, L),
                    t_star < sweep_kernel.FOUND)

    def __call__(self, params, origin, direction):
        """The first-hit dict from the selection (``ptx/geom/fasthit.py:
        1000-1022``): ``evt`` from the payload matches, ``t`` and the normal
        from the hit replay at those decisions."""
        L = self.L
        t_star, entering, m_start, m_end, found = self.select(
            *self.intervals(params, origin, direction))
        hit = found & ~(t_star >= MAX_VALUE)
        use_start = m_start < L
        leaf = torch.where(use_start, m_start, torch.clamp(m_end, max=L - 1)).to(torch.int64)
        evt = torch.where(hit, torch.where(use_start, leaf, L + leaf), 0).to(torch.int32)
        mats = torch.tensor(self.mat_list, dtype=torch.int64, device=origin.device)
        return _selected(self.replay, mats, params, origin, direction, evt, entering, hit)


class BlockedHit(PlainHit):
    """The candidate-blocked first hit (``_compile_blocked_hit``,
    ``ptx/geom/fasthit.py:480-568``), for tapes of more than 64 leaves that
    are no union of small groups: the 2L boundary events are scanned in
    blocks of ``block`` with a running first minimum, each block folding a
    (block, L, B) membership tensor through the tape — the dense fold's
    decisions at O(block·L·B) memory.  Selection is without gradient; ``t``
    and the normal come from the hit replay through :class:`HitReplay`.
    Plain PyTorch on every device (XLA in the JAX package)."""

    def __init__(self, plan, leaves, block: int):
        self.plan, self.leaves, self.block = plan, leaves, block
        self.replay = hitreplay.build_hit_replay(leaves)
        self.mat_list = [lf.mat_id for lf, _ in leaves]
        self.leaf_pos = {id(lf): i for i, (lf, _) in enumerate(leaves)}

    def __call__(self, params, origin, direction):
        C = self.block
        with torch.no_grad():
            t0, t1 = _leaf_intervals_grouped(self.leaves, params, *origin.unbind(-1),
                                             *direction.unbind(-1))
            B = t0.shape[1]
            t_evt = torch.cat([t0, t1])                              # (2L, B)
            pad = -t_evt.shape[0] % C
            if pad:
                t_evt = torch.cat([t_evt, t_evt.new_full((pad, B), PAD_T)])
            lo, hi = t0[None], t1[None]                              # (1, L, B)
            best_t = t0.new_full((B,), PAD_T)
            best_i = torch.zeros(B, dtype=torch.int64, device=t0.device)
            entering = torch.zeros(B, dtype=torch.bool, device=t0.device)
            any_c = torch.zeros_like(entering)
            for k in range(t_evt.shape[0] // C):
                blk = t_evt[k * C:(k + 1) * C]                       # (C, B)
                ts = blk[:, None]
                ra = _bits_at(self.plan, self.leaf_pos, (lo <= ts) & (ts < hi))
                rb = _bits_at(self.plan, self.leaf_pos, (lo < ts) & (ts <= hi))
                cand = (ra != rb) & (blk >= EPS)
                tm = torch.where(cand, blk, PAD_T)
                loc = torch.argmin(tm, dim=0)                        # first minimum
                bt = tm.gather(0, loc[None])[0]
                better = bt < best_t
                best_t = torch.where(better, bt, best_t)
                best_i = torch.where(better, k * C + loc, best_i)
                entering = torch.where(better, ra.gather(0, loc[None])[0], entering)
                any_c |= cand.any(0)
            hit = any_c & ~(best_t >= MAX_VALUE)
            evt = torch.where(hit, best_i, 0).to(torch.int32)
        mats = torch.tensor(self.mat_list, dtype=torch.int64, device=origin.device)
        return _selected(self.replay, mats, params, origin, direction, evt, entering, hit)
