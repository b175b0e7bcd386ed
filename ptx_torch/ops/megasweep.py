"""The megasweep K5: the union-sweep first hit of large scenes, with the
fused bounce (hit + shade + scatter) in the same launch.

Port of ``ptx/ops/megasweep.py`` ``build_mega_sweep`` (:589), a Pallas TPU
kernel, as the hand-written CUDA kernel ``ptx_torch/csrc/megasweep_kernel.cu``.

A tape is *mega-eligible* (:func:`mega_eligible`) when it is a union of
groups, each a sphere or plane leaf or a small CSG gadget over spheres and
planes whose coverage compiles to at most ``SLOT_MAX`` interval slots
(:func:`_slot_algebra`).  Root membership is then interval coverage, and
the first hit is sort-free:

- every row of a packed table (:class:`MegaLayout`) gives one raw leaf
  interval: leaf-group spheres (Morton-ordered, in clusters of
  ``CLUSTER`` rows), gadget members member-major, planes;
- a gadget's coverage is a set of slots ``[s, e)``, each a max / min
  expression over its members' ``t0`` / ``t1`` and ``±MAX_VALUE``;
- ``valid = (s < e) & (e >= EPS)``; with ``has_below`` (a valid interval
  starts below EPS) the first boundary is the chain exit, the fixpoint of
  ``E <- max(E, max{e : s <= E})`` from ``max{e : s < EPS}``; else the
  minimum start, an entry;
- the payload is the smallest leaf id whose RAW ``t0`` (then ``t1``)
  equals that time bitwise, and the replay forward of its row gives
  ``t`` and the normal.

Culling: the bounding sphere of every cluster of rows (and of every
cluster of a gadget class's solids) is computed from the live params on
every :meth:`MegaLayout.bounds` call; a group of ``CULL_LANES`` rays none
of which meets a bound skips the cluster, whose rows then read as misses
(``PAD``), which is what they are for those rays, so the outputs do not
change.

- :func:`megasweep_reference` is K5's plain PyTorch version, over
  ``(rows, B)`` tensors; on the CPU it is the port's sweep first hit.
- :class:`MegaSweepKernel` is K5's wrapper (hit mode and bounce mode):
  its checks, its allocations and one launch; in bounce mode the kernel
  writes the fused bounce's decisions itself.  The kernel keeps each
  lane's valid coverage intervals and listed rows in shared memory up to
  the capacities ``LIST_CAPS`` (a launch argument: a lane past one takes
  the recompute route, with the same bits).  For CUDA tensors it launches
  the kernel or raises; the plain versions run only on CPU tensors.
  ``MegaSweepKernel.LAUNCHES`` / ``REFERENCE_CALLS`` count the two.
- The sweep's ``mega`` mode as a compiled scene holds it:
  :class:`SweepHit`, the plain version as a first hit (what
  ``compile_fast_hit`` in :mod:`ptx_torch.integrate.trace` picks on a
  mega-eligible tape); :class:`MegaHit`, K5's hit mode on it;
  :class:`MegaBounce` (:func:`compile_mega_bounce`), K5's fused bounce.
"""

from __future__ import annotations

import numpy as np
import torch

from ptx_torch.core import linalg
from ptx_torch.core.constants import EPS, MAX_VALUE
from ptx_torch.geom import hitreplay, tape
from ptx_torch.geom.fasthit import PlainHit, collect_leaves, hit_dict, union_decompose
from ptx_torch.ops import _build
from ptx_torch.ops._build import _check_inputs, _ptr, _raise_on, _stream
from ptx_torch.ops.bounce_kernel import bounce_reference
from ptx_torch.shade.materials import BOUNCE_ROW

PAD_T = 3e20                 # a missed row: "no boundary"
NEG = -3e20
CLUSTER = 64                 # rows (or gadgets) per cull cluster — kClusterShift in the kernel
CULL_LANES = 32              # rays per cull test: one warp
SLOT_MAX = 8                 # algebra slots per gadget before the tape is ineligible
MAX_MEMBERS = 12             # leaves per gadget
MAX_SMEM = 232448            # shared memory one block may opt in to (227 KB)
# K5's per-lane lists (valid coverage intervals, listed rows), sized from
# the stress scenes' counts on the card (chip_smoke.py D2): at most 17
# intervals (p99.9 12) and 53 rows a lane over every bounce of S1's and
# S2's chunks; a lane past one takes the recompute route
LIST_CAPS = (12, 56)
_PROG = {"neg": -1, "pos": -2, "max": -3, "min": -4}

REFERENCE_CALLS = 0


def _morton(xyz):
    """(N, 3) centres → Morton codes (spatial sort keys)."""
    xyz = np.asarray(xyz, np.float64)
    lo = xyz.min(axis=0)
    span = np.maximum(xyz.max(axis=0) - lo, 1e-6)
    q = np.clip(((xyz - lo) / span * 1023).astype(np.uint32), 0, 1023)
    code = np.zeros(len(xyz), np.uint64)
    for b in range(10):
        for a in range(3):
            code |= ((q[:, a].astype(np.uint64) >> b) & 1) << (3 * b + a)
    return code


# ---------------------------------------------------------------------------
# compile-time gadget analysis: slot algebra + bound expressions
# ---------------------------------------------------------------------------

def _slot_algebra(node, local_pos):
    """Gadget tape → slots ``[(s_expr, e_expr)]`` whose union is the
    gadget's coverage, exact for the half-open membership ``s <= t < e``:
    ``∩`` pairs ``[max s, min e)``, ``∪`` concatenates, ``A − B`` is ``A ∩
    comp(B)`` with per-slot complements ``{[-MAX, s), [e, MAX)}``.  Exprs:
    ``("t0", j) | ("t1", j) | ("neg",) | ("pos",) | ("max" | "min", a, b)``.
    None when an expansion exceeds ``SLOT_MAX``."""
    def inter(A, B):
        return [(("max", sa, sb), ("min", ea, eb)) for (sa, ea) in A for (sb, eb) in B]

    def comp(B):
        out = [(("neg",), ("pos",))]
        for (sb, eb) in B:
            out = inter(out, [(("neg",), sb), (eb, ("pos",))])
            if len(out) > SLOT_MAX:
                return None
        return out

    def walk(n):
        if isinstance(n, tape._LeafPlan):
            j = local_pos[id(n)]
            return [(("t0", j), ("t1", j))]
        kids = [walk(c) for c in n.children]
        if any(k is None for k in kids):
            return None
        if n.op == "union":
            out = [s for k in kids for s in k]
        elif n.op == "intersection":
            out = kids[0]
            for k in kids[1:]:
                out = inter(out, k)
                if len(out) > SLOT_MAX:
                    return None
        else:
            cb = comp(kids[1])
            if cb is None:
                return None
            out = inter(kids[0], cb)
        return out if len(out) <= SLOT_MAX else None

    return walk(node)


def _bound_expr(node, local_pos):
    """Bounding-sphere expression of a gadget's solid: ``("leaf", j) |
    ("enclose", [children]) | None`` (unbounded).  bound(∩) = any bounded
    child, bound(∪) = enclosure of all, bound(A − B) = bound(A)."""
    if isinstance(node, tape._LeafPlan):
        return ("leaf", local_pos[id(node)]) if node.kind == "sphere" else None
    kids = [_bound_expr(c, local_pos) for c in node.children]
    if node.op == "intersection":
        return next((k for k in kids if k is not None), None)
    if node.op == "difference":
        return kids[0]
    if any(k is None for k in kids):
        return None
    return ("enclose", kids)


def _bound_leaf_list(bexpr):
    """The sphere members a bound expression encloses, or None."""
    if bexpr is None:
        return None
    out = []

    def walk(e):
        if e[0] == "leaf":
            out.append(e[1])
        else:
            for c in e[1]:
                walk(c)

    walk(bexpr)
    return out


def mega_eligible(plan, leaves) -> bool:
    """Every leaf a sphere or plane (transformed or not), every gadget of
    the union at most ``MAX_MEMBERS`` leaves and ``SLOT_MAX`` slots."""
    if not all(lf.kind in ("sphere", "plane") for lf, _ in leaves):
        return False
    for g in union_decompose(plan):
        if isinstance(g, tape._LeafPlan):
            continue
        sub = collect_leaves(g)
        if len(sub) > MAX_MEMBERS:
            return False
        if _slot_algebra(g, {id(lf): j for j, (lf, _) in enumerate(sub)}) is None:
            return False
    return True


def _rebase(ex, member_row0):
    """``("t0", j)`` → ``("t0row", member_row0[j])``: absolute row bases."""
    tag = ex[0]
    if tag in ("t0", "t1"):
        return (tag + "row", member_row0[ex[1]])
    if tag in ("max", "min"):
        return (tag, _rebase(ex[1], member_row0), _rebase(ex[2], member_row0))
    return ex


def _max_t0(ex):
    """The members whose ``t0`` a slot start reaches through max alone: if
    one of them misses (``t0`` PAD, the largest value there is), the start
    is PAD and the slot is empty."""
    if ex[0] == "t0":
        return {ex[1]}
    if ex[0] == "max":
        return _max_t0(ex[1]) | _max_t0(ex[2])
    return set()


def _anchor(slots):
    """A member every slot's start reaches through max (:func:`_max_t0`),
    or −1: where it misses, the gadget covers nothing and the kernel skips
    its programs."""
    common = set.intersection(*(_max_t0(s) for s, _ in slots)) if slots else set()
    return min(common, default=-1)


def _postfix(ex, out):
    """A slot expression as the kernel's postfix program: ``2j`` / ``2j + 1``
    push member j's ``t0`` / ``t1``; ``-1`` / ``-2`` push ∓MAX_VALUE; ``-3``
    / ``-4`` pop two and push their max / min.  Returns the stack depth."""
    tag = ex[0]
    if tag in ("t0", "t1"):
        out.append(2 * ex[1] + (tag == "t1"))
        return 1
    if tag in ("neg", "pos"):
        out.append(_PROG[tag])
        return 1
    da = _postfix(ex[1], out)
    db = _postfix(ex[2], out)
    out.append(_PROG[tag])
    return max(da, db + 1)


# ---------------------------------------------------------------------------
# the row layout
# ---------------------------------------------------------------------------

class MegaLayout:
    """The compile-time row layout of ``build_mega_sweep`` (``ptx/ops/
    megasweep.py:630-811``) for a mega-eligible tape.

    Rows: leaf-group spheres (Morton order when ``params_ref`` is given),
    then per gadget class its sphere members member-major (member ``j`` of
    gadget ``g`` at row ``member_row0[j] + g``), padded to a multiple of 8
    (``ns`` sphere rows); then plane members member-major and leaf-group
    planes, padded to 8; ``Lp = max(8, ns + npl)``.  Per row: ``lid`` (the
    leaf position in :func:`~ptx_torch.geom.fasthit.collect_leaves` order,
    ``Lp + 1`` on a pad row), ``cov`` (1 on leaf-group rows: they are
    coverage intervals themselves), material, parity, kind (1 sphere).

    Cull flags: one per sphere cluster (``CLUSTER`` rows), then per class
    one per cluster of ``CLUSTER`` gadgets (its solids' bound)."""

    def __init__(self, plan, leaves, params_ref=None):
        self.leaves = leaves
        L = self.L = len(leaves)
        leaf_pos = {id(lf): i for i, (lf, _) in enumerate(leaves)}
        self.xform = any(lf.xform_chain for lf, _ in leaves)

        def world_center(lf):
            """Compile-time world centre, for the cluster assignment only
            (bounds are recomputed from the live params)."""
            c = np.asarray(params_ref["sphere_center"][lf.index].cpu(), np.float64)
            if lf.xform_chain:
                xf = params_ref["xform"].cpu().double()
                w = xf[lf.xform_chain[0]]
                for j in lf.xform_chain[1:]:
                    w = linalg.compose(w, xf[j])
                w = w.numpy()
                c = w[:, :3] @ c + w[:, 3]
            return c

        def sig(node, lp):
            if isinstance(node, tape._LeafPlan):
                return ("L", node.kind, lp[id(node)])
            return (node.op, tuple(sig(c, lp) for c in node.children))

        lg_s, lg_p, classes = [], [], {}
        for g in union_decompose(plan):
            if isinstance(g, tape._LeafPlan):
                (lg_s if g.kind == "sphere" else lg_p).append(leaf_pos[id(g)])
            else:
                sub = collect_leaves(g)
                lp = {id(lf): j for j, (lf, _) in enumerate(sub)}
                key = sig(g, lp)
                if key not in classes:
                    classes[key] = [g, lp, []]
                classes[key][2].append([leaf_pos[id(lf)] for lf, _ in sub])
        if lg_s and params_ref is not None:
            order = np.argsort(_morton(np.stack([world_center(leaves[i][0]) for i in lg_s])),
                               kind="stable")
            lg_s = [lg_s[int(o)] for o in order]

        sphere_rows = [(i, 1.0) for i in lg_s]          # (leaf position, cov)
        self.classes = []
        for rep, lp, gads in classes.values():
            sub = collect_leaves(rep)
            G = len(gads)
            slots = _slot_algebra(rep, lp)
            assert slots is not None, "a mega-ineligible tape reached the layout"
            if params_ref is not None:
                anchor = next((j for j, (lf, _) in enumerate(sub) if lf.kind == "sphere"), None)
                if anchor is not None:
                    order = np.argsort(_morton(np.stack(
                        [world_center(leaves[g[anchor]][0]) for g in gads])), kind="stable")
                    gads = [gads[int(o)] for o in order]
            self.classes.append({"sub": sub, "gads": gads, "m": len(sub), "G": G,
                                 "Gp": -(-G // 8) * 8, "slots": slots,
                                 "bexpr": _bound_expr(rep, lp), "member_row0": {}})
        for cm in self.classes:
            for j, (lf, _) in enumerate(cm["sub"]):
                if lf.kind == "sphere":
                    cm["member_row0"][j] = len(sphere_rows)
                    sphere_rows += [(cm["gads"][g][j] if g < cm["G"] else None, 0.0)
                                    for g in range(cm["Gp"])]
        ns = self.ns = -(-len(sphere_rows) // 8) * 8
        sphere_rows += [(None, 0.0)] * (ns - len(sphere_rows))
        plane_rows = []
        for cm in self.classes:
            for j, (lf, _) in enumerate(cm["sub"]):
                if lf.kind == "plane":
                    cm["member_row0"][j] = ns + len(plane_rows)
                    plane_rows += [(cm["gads"][g][j] if g < cm["G"] else None, 0.0)
                                   for g in range(cm["Gp"])]
        plane_rows += [(i, 1.0) for i in lg_p]
        npl = self.npl = -(-len(plane_rows) // 8) * 8
        plane_rows += [(None, 0.0)] * (npl - len(plane_rows))
        Lp = self.Lp = max(8, ns + npl)
        rows = sphere_rows + plane_rows + [(None, 0.0)] * (Lp - ns - npl)

        for cm in self.classes:
            cm["slots_abs"] = [(_rebase(s, cm["member_row0"]), _rebase(e, cm["member_row0"]))
                               for s, e in cm["slots"]]

        pos = [p for p, _ in rows]
        self.lid = np.array([p if p is not None else Lp + 1 for p in pos], np.float32)
        self.cov = np.array([c for _, c in rows], np.float32)
        self.mat = np.array([leaves[p][0].mat_id if p is not None else 0 for p in pos],
                            np.float32)
        self.par = np.array([leaves[p][1] if p is not None else 1.0 for p in pos], np.float32)
        self.kind = np.array([float(p is not None and leaves[p][0].kind == "sphere")
                              for p in pos], np.float32)
        # pad rows read leaf 0's geometry (their lid masks them)
        self.row_pos = np.array([p if p is not None else 0 for p in pos], np.int64)
        self.row_src = np.array([leaves[p][0].index if p is not None else 0 for p in pos],
                                np.int64)
        self.sphere_real = np.array([p is not None for p, _ in sphere_rows], bool)
        self.row_of_lid = np.zeros(L, np.int64)
        for r, p in enumerate(pos):
            if p is not None:
                self.row_of_lid[p] = r

        self.n_s_clusters = -(-ns // CLUSTER)
        flags = self.n_s_clusters
        for cm in self.classes:
            cm["solid_f0"], cm["n_cl"] = flags, -(-cm["Gp"] // CLUSTER)
            flags += cm["n_cl"]
            cm["bound_leaves"] = _bound_leaf_list(cm["bexpr"])
            if cm["bound_leaves"] is not None:
                cm["bpos"] = np.array([[g[j] for j in cm["bound_leaves"]] for g in cm["gads"]],
                                      np.int64)
        self.n_flags = flags
        self.cols = ((26, 27, 28, 29, 30) if self.xform else (4, 5, 6, 7, 8))
        self.tw = 32 if self.xform else 16
        self._dev: dict = {}

    # -- runtime tables ------------------------------------------------------

    def _static(self, device):
        if device not in self._dev:
            t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device)
            self._dev[device] = {
                "meta": t(np.stack([self.lid, self.cov, self.mat, self.par, self.kind], 1)),
                "row_pos": t(self.row_pos, torch.int64),
                "row_src": t(self.row_src, torch.int64),
                "sphere_real": t(self.sphere_real, torch.bool),
                "row_of_lid": t(np.append(self.row_of_lid, 0), torch.int64),
                "rows": hitreplay.LeafRows(self.leaves) if self.xform else None,
            }
        return self._dev[device]

    def table(self, params):
        """The packed ``(Lp, 16)`` table ``[p0 p1 p2 p3 lid cov mat par kind
        0…]`` (sphere ``cx cy cz r``, plane ``nx ny nz d``), or with a
        transformed leaf the ``(Lp, 32)`` one: the 26-word replay row of
        :mod:`~ptx_torch.geom.hitreplay` (``W⁻¹`` and ``W⁻ᵀ``, identity when
        untransformed), then ``lid cov mat par kind 0``.  No autograd."""
        st = self._static(params["sphere_center"].device)
        with torch.no_grad():
            if self.xform:
                head = st["rows"](params)[st["row_pos"]]
                tail = 1
            else:
                src = st["row_src"]
                ns, npl = self.ns, self.npl
                parts = []
                if ns:
                    parts.append(torch.cat([params["sphere_center"][src[:ns]],
                                            params["sphere_radius"][src[:ns]][:, None]], 1))
                if npl:
                    s = src[ns:ns + npl]
                    parts.append(torch.cat([params["plane_normal"][s],
                                            params["plane_d"][s][:, None]], 1))
                head = torch.cat(parts)
                if head.shape[0] < self.Lp:
                    head = torch.cat([head, head.new_zeros((self.Lp - head.shape[0], 4))])
                tail = 7
            return torch.cat([head, st["meta"], head.new_zeros((self.Lp, tail))],
                             1).contiguous()

    def bounds(self, params):
        """(n_flags, 4) cull bounds from the live params: per sphere
        cluster the enclosing sphere of its real rows, per class cluster of
        the gadgets' solid bounds; a radius of −1 marks an unbounded class
        (always active).  World-space when the table is transformed."""
        st = self._static(params["sphere_center"].device)
        with torch.no_grad():
            if self.xform:
                wb = _leaf_world_bounds(self.leaves, params)
                c, r = wb[0][st["row_pos"][:self.ns]], wb[1][st["row_pos"][:self.ns]]
            else:
                src = st["row_src"][:self.ns]
                wb = None
                c = params["sphere_center"][src]
                r = params["sphere_radius"][src].abs()
            bc, br = _cluster_bounds(c, r, st["sphere_real"], CLUSTER)
            out = [torch.cat([bc, br[:, None]], 1)]
            for cm in self.classes:
                if cm["bound_leaves"] is None:
                    row = c.new_tensor([0.0, 0.0, 0.0, -1.0])
                    out.append(row.expand(cm["n_cl"], 4))
                else:
                    bcc, brc = _class_solid_bounds(cm, self.leaves, params, wb)
                    out.append(torch.cat([bcc, brc[:, None]], 1))
            return torch.cat(out).contiguous()

    def kernel_meta(self):
        """The kernel's int table: ``row_of_lid`` (L), then at ``cls_off =
        L`` one offset per class to its header ``G, Gp, m, n_slots,
        solid_f0, anchor`` (:func:`_anchor`), ``member_row0[m], (s_off,
        s_len, e_off, e_len) per slot``, then the slot programs
        (:func:`_postfix`).  Returns ``(table, cls_off, n_mt, n_stk)``: the
        gadget scratch the kernel keeps a lane, two member columns per
        member of the largest gadget and the deepest program's stack below
        its top."""
        meta = [int(r) for r in self.row_of_lid]
        cls_off = len(meta)
        meta += [0] * len(self.classes)
        progs = []
        headers = []
        depth = 1
        for cm in self.classes:
            h = [cm["G"], cm["Gp"], cm["m"], len(cm["slots"]), cm["solid_f0"],
                 _anchor(cm["slots"])]
            h += [cm["member_row0"][j] for j in range(cm["m"])]
            slot_progs = []
            for s, e in cm["slots"]:
                ps, pe = [], []
                depth = max(depth, _postfix(s, ps), _postfix(e, pe))
                slot_progs.append((ps, pe))
            headers.append((h, slot_progs))
        off = len(meta)
        for ci, (h, slot_progs) in enumerate(headers):
            meta[cls_off + ci] = off
            off += len(h) + 4 * len(slot_progs)
        for h, slot_progs in headers:
            meta += h
            prog_base = off + sum(len(a) + len(b) for a, b in progs)
            for ps, pe in slot_progs:
                meta += [prog_base, len(ps), prog_base + len(ps), len(pe)]
                prog_base += len(ps) + len(pe)
            progs += slot_progs
        for ps, pe in progs:
            meta += ps + pe
        n_mt = 2 * max((cm["m"] for cm in self.classes), default=0)
        return np.array(meta, np.int32), cls_off, n_mt, depth - 1


# ---------------------------------------------------------------------------
# runtime bounds (from the live params, no gradient)
# ---------------------------------------------------------------------------

def _cluster_bounds(centers, radii, real_mask, ck):
    """(n, 3) / (n,) rows → per cluster of ``ck`` the enclosing (nC, 3) +
    (nC,) of its real rows; an empty cluster gets radius 0 far away."""
    n = centers.shape[0]
    nC = -(-n // ck)
    pad = nC * ck - n
    if pad:
        centers = torch.cat([centers, centers.new_zeros((pad, 3))])
        radii = torch.cat([radii, radii.new_zeros((pad,))])
        real_mask = torch.cat([real_mask, real_mask.new_zeros((pad,))])
    cm = centers.reshape(nC, ck, 3)
    rm = radii.reshape(nC, ck)
    mask = real_mask.reshape(nC, ck)
    big = 1e19
    lo = torch.where(mask[..., None], cm, big).amin(1)
    hi = torch.where(mask[..., None], cm, -big).amax(1)
    bc = 0.5 * (lo + hi)
    dist = torch.sqrt(((cm - bc[:, None, :]) ** 2).sum(-1))
    br = torch.where(mask, dist + rm, 0.0).amax(1)
    any_real = mask.any(1)
    return torch.where(any_real[:, None], bc, 1e19), torch.where(any_real, br, 0.0)


def _leaf_world_bounds(leaves, params):
    """World bounding spheres per leaf position: an untransformed sphere
    ``(c, |r|)``, a transformed one ``(W·c, |r|·‖W_lin‖_F)`` (the Frobenius
    norm bounds the spectral one: conservative), a plane radius 0 far
    away (plane rows are never culled)."""
    c_all = params["sphere_center"].new_full((len(leaves), 3), 1e19)
    r_all = params["sphere_center"].new_zeros((len(leaves),))
    dev = c_all.device
    plain = [i for i, (lf, _) in enumerate(leaves) if lf.kind == "sphere" and not lf.xform_chain]
    if plain:
        gi = torch.tensor([leaves[i][0].index for i in plain], device=dev)
        c_all[plain] = params["sphere_center"][gi]
        r_all[plain] = params["sphere_radius"][gi].abs()
    groups: dict = {}
    for i, (lf, _) in enumerate(leaves):
        if lf.kind == "sphere" and lf.xform_chain:
            groups.setdefault(len(lf.xform_chain), []).append(i)
    for clen, idxs in groups.items():
        gi = torch.tensor([leaves[i][0].index for i in idxs], device=dev)
        ch = torch.tensor([leaves[i][0].xform_chain for i in idxs], device=dev)
        w = params["xform"][ch[:, 0]]
        for j in range(1, clen):
            w = linalg.compose(w, params["xform"][ch[:, j]])
        lin, tv = w[:, :, :3], w[:, :, 3]
        c_all[idxs] = torch.einsum("nij,nj->ni", lin, params["sphere_center"][gi]) + tv
        r_all[idxs] = (params["sphere_radius"][gi].abs()
                       * torch.sqrt((lin * lin).sum((1, 2))))
    return c_all, r_all


def _class_solid_bounds(cm, leaves, params, world_bounds=None):
    """A gadget class's cluster bounds (n_cl, 3) + (n_cl,): per gadget the
    enclosing sphere of its bound members, then :func:`_cluster_bounds`
    over clusters of ``CLUSTER`` gadgets (the bounds half of the JAX
    ``_class_solid_flags``; the per-ray test is the kernel's)."""
    G, Gp = cm["G"], cm["Gp"]
    dev = params["sphere_center"].device
    pos = torch.as_tensor(cm["bpos"], device=dev)               # (G, nb) leaf positions
    if world_bounds is not None:
        c = world_bounds[0][pos.reshape(-1)].reshape(G, -1, 3)
        r = world_bounds[1][pos.reshape(-1)].reshape(G, -1)
    else:
        idx = torch.as_tensor([[leaves[p][0].index for p in row] for row in cm["bpos"]],
                              device=dev)
        c = params["sphere_center"][idx.reshape(-1)].reshape(G, -1, 3)
        r = params["sphere_radius"][idx.reshape(-1)].abs().reshape(G, -1)
    lo = (c - r[..., None]).amin(1)
    hi = (c + r[..., None]).amax(1)
    bc = 0.5 * (lo + hi)
    br = 0.5 * torch.sqrt(((hi - lo) ** 2).sum(-1))
    if Gp > G:
        bc = torch.cat([bc, bc.new_full((Gp - G, 3), 1e19)])
        br = torch.cat([br, br.new_zeros((Gp - G,))])
    mask = torch.arange(Gp, device=dev) < G
    return _cluster_bounds(bc, br, mask, CLUSTER)


def block_hits(bnd, o, d, group=CULL_LANES):
    """Per bound and per group of ``group`` rays, whether any ray of the
    group meets the bound sphere (``disc > 0``, exit ``>= EPS``) — the cull
    test; a bound of radius < 0 is always met.  → (n_flags, ceil(B/group))."""
    a = (d * d).sum(-1)
    oc = o[None] - bnd[:, None, :3]
    bq = (oc * d[None]).sum(-1)
    cc = (oc * oc).sum(-1) - (bnd[:, 3] * bnd[:, 3])[:, None]
    disc = bq * bq - a * cc
    t1 = (-bq + torch.sqrt(torch.clamp(disc, min=0.0))) / torch.where(a == 0.0, 1.0, a)
    act = ((disc > 0.0) & (t1 >= EPS) & (a != 0.0)) | (bnd[:, 3] < 0.0)[:, None]
    pad = (-o.shape[0]) % group
    if pad:
        act = torch.cat([act, act.new_zeros((act.shape[0], pad))], 1)
    return act.reshape(act.shape[0], -1, group).any(-1)


# ---------------------------------------------------------------------------
# K5's plain version
# ---------------------------------------------------------------------------

def megasweep_reference(layout: MegaLayout, params, o, d, *, cull=False):
    """K5 in hit mode, plain PyTorch over ``(rows, B)`` tensors, in the
    kernel's operation order; on any device and dtype (float64 for the
    adjudicator).  ``cull`` applies the cull test per group of
    ``CULL_LANES`` rays (the outputs must not change).  Returns ``t``
    (t_star on hit lanes, else 0), ``normal`` (B, 3; (0, 0, 1) on a miss),
    ``mat_id``, ``entering``, ``hit``, ``_evt`` (int32: leaf k's start k,
    end L + k, 0 on a miss) and ``t_star``, ``found``."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    lay = layout
    L, Lp, ns, npl = lay.L, lay.Lp, lay.ns, lay.npl
    C_LID, C_COV, C_MAT, C_PAR, C_KIND = lay.cols
    dt = o.dtype
    tbl = lay.table(params).to(dt)
    B = o.shape[0]
    ox, oy, oz = (x[None] for x in o.unbind(-1))
    dx, dy, dz = (x[None] for x in d.unbind(-1))
    noid = float(Lp + 1)
    col = lambda rows, j: tbl[rows, j:j + 1]

    def row_ray(rows):
        if not lay.xform:
            a = dx * dx + dy * dy + dz * dz
            return ox, oy, oz, dx, dy, dz, a
        w = [col(rows, 5 + j) for j in range(12)]
        lox = w[0] * ox + w[1] * oy + w[2] * oz + w[3]
        loy = w[4] * ox + w[5] * oy + w[6] * oz + w[7]
        loz = w[8] * ox + w[9] * oy + w[10] * oz + w[11]
        ldx = w[0] * dx + w[1] * dy + w[2] * dz
        ldy = w[4] * dx + w[5] * dy + w[6] * dz
        ldz = w[8] * dx + w[9] * dy + w[10] * dz
        return lox, loy, loz, ldx, ldy, ldz, ldx * ldx + ldy * ldy + ldz * ldz

    t0 = torch.full((Lp, B), PAD_T, dtype=dt, device=o.device)
    t1 = torch.full((Lp, B), PAD_T, dtype=dt, device=o.device)
    if ns:
        rows = slice(0, ns)
        rox, roy, roz, rdx, rdy, rdz, ra = row_ray(rows)
        sa = torch.where(ra == 0.0, 1.0, ra)
        ocx, ocy, ocz = rox - col(rows, 0), roy - col(rows, 1), roz - col(rows, 2)
        r = col(rows, 3)
        b = ocx * rdx + ocy * rdy + ocz * rdz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = b * b - ra * cc
        ok = (disc > EPS) & (ra != 0.0) & (col(rows, C_LID) < noid)
        sq = torch.sqrt(torch.where(ok, disc, 1.0))
        t0[:ns] = torch.where(ok, (-b - sq) / sa, PAD_T)
        t1[:ns] = torch.where(ok, (-b + sq) / sa, PAD_T)
    if npl:
        rows = slice(ns, ns + npl)
        rox, roy, roz, rdx, rdy, rdz, _ = row_ray(rows)
        nx, ny, nz, dp = (col(rows, j) for j in range(4))
        divisor = nx * rdx + ny * rdy + nz * rdz
        numer = -dp - (nx * rox + ny * roy + nz * roz)
        small = torch.abs(divisor) < EPS * EPS
        t = numer / torch.where(small, 1.0, divisor)
        degen = small | (torch.abs(t) >= MAX_VALUE)
        on_b = torch.abs(numer) < EPS * EPS
        ent = divisor < 0.0
        full = degen & on_b
        ok = ~(degen & ~on_b) & (col(rows, C_LID) < noid)
        t0[ns:ns + npl] = torch.where(ok, torch.where(full | ~ent, -MAX_VALUE, t), PAD_T)
        t1[ns:ns + npl] = torch.where(ok, torch.where(full | ent, MAX_VALUE, t), PAD_T)

    if cull:
        flags = block_hits(lay.bounds(params).to(dt), o, d)
        grp = torch.arange(B, device=o.device) // CULL_LANES
        if ns:
            fs = flags[torch.arange(ns, device=o.device) // CLUSTER][:, grp]
            t0[:ns] = torch.where(fs, t0[:ns], PAD_T)
            t1[:ns] = torch.where(fs, t1[:ns], PAD_T)

    s_parts, e_parts = [], []
    cov = tbl[:, C_COV:C_COV + 1] > 0.5
    val = cov & (t0 < t1) & (t1 >= EPS)
    s_parts.append(torch.where(val, t0, PAD_T))
    e_parts.append(torch.where(val, t1, NEG))
    for cm in lay.classes:
        Gp = cm["Gp"]

        def ev(ex):
            tag = ex[0]
            if tag == "t0row":
                return t0[ex[1]:ex[1] + Gp]
            if tag == "t1row":
                return t1[ex[1]:ex[1] + Gp]
            if tag in ("neg", "pos"):
                return torch.full((Gp, B), -MAX_VALUE if tag == "neg" else MAX_VALUE,
                                  dtype=dt, device=o.device)
            f = torch.maximum if tag == "max" else torch.minimum
            return f(ev(ex[1]), ev(ex[2]))

        if cull:
            fg = flags[cm["solid_f0"] + torch.arange(Gp, device=o.device) // CLUSTER][:, grp]
        for s_ex, e_ex in cm["slots_abs"]:
            cs, ce = ev(s_ex), ev(e_ex)
            if cull:
                cs, ce = torch.where(fg, cs, PAD_T), torch.where(fg, ce, PAD_T)
            vc = (cs < ce) & (ce >= EPS)
            s_parts.append(torch.where(vc, cs, PAD_T))
            e_parts.append(torch.where(vc, ce, NEG))
    S, E_ = torch.cat(s_parts), torch.cat(e_parts)

    below = S < EPS
    has_below = below.any(0)
    t_entry = S.amin(0)
    E = torch.where(below, E_, NEG).amax(0)
    while True:
        En = torch.maximum(E, torch.where(S <= E[None], E_, NEG).amax(0))
        if bool((En == E).all()):
            break
        E = En
    t_star = torch.where(has_below, E, t_entry)
    entering = ~has_below
    found = t_star < 2e20
    hit = found & ~(t_star >= MAX_VALUE)

    lid = tbl[:, C_LID:C_LID + 1]
    m_start = torch.where(t0 == t_star[None], lid, noid).amin(0)
    m_end = torch.where(t1 == t_star[None], lid, noid).amin(0)
    chosen = torch.where(m_start < noid, m_start, m_end)
    st = lay._static(o.device)
    row = st["row_of_lid"][torch.where(hit, chosen, float(L)).to(torch.int64)]
    p = tbl[row]                                            # (B, tw)
    rw = lambda j: p[:, j]
    ox, oy, oz, dx, dy, dz = (x[0] for x in (ox, oy, oz, dx, dy, dz))
    p0, p1, p2, p3 = rw(0), rw(1), rw(2), rw(3)
    is_sph = rw(C_KIND) > 0.5
    inv_r = 1.0 / torch.where(p3 == 0.0, 1.0, p3)
    if lay.xform:
        lox = rw(5) * ox + rw(6) * oy + rw(7) * oz + rw(8)
        loy = rw(9) * ox + rw(10) * oy + rw(11) * oz + rw(12)
        loz = rw(13) * ox + rw(14) * oy + rw(15) * oz + rw(16)
        ldx = rw(5) * dx + rw(6) * dy + rw(7) * dz
        ldy = rw(9) * dx + rw(10) * dy + rw(11) * dz
        ldz = rw(13) * dx + rw(14) * dy + rw(15) * dz
        snx = (lox - p0 + t_star * ldx) * inv_r
        sny = (loy - p1 + t_star * ldy) * inv_r
        snz = (loz - p2 + t_star * ldz) * inv_r
        pim = rw(4)
        ex = torch.where(is_sph, snx, p0 * pim)
        ey = torch.where(is_sph, sny, p1 * pim)
        ez = torch.where(is_sph, snz, p2 * pim)
        nx0 = rw(17) * ex + rw(18) * ey + rw(19) * ez
        ny0 = rw(20) * ex + rw(21) * ey + rw(22) * ez
        nz0 = rw(23) * ex + rw(24) * ey + rw(25) * ez
    else:
        snx = (ox - p0 + t_star * dx) * inv_r
        sny = (oy - p1 + t_star * dy) * inv_r
        snz = (oz - p2 + t_star * dz) * inv_r
        pim = 1.0 / torch.sqrt(torch.clamp(p0 * p0 + p1 * p1 + p2 * p2, min=1e-30))
        nx0 = torch.where(is_sph, snx, p0 * pim)
        ny0 = torch.where(is_sph, sny, p1 * pim)
        nz0 = torch.where(is_sph, snz, p2 * pim)
    mag = torch.sqrt(nx0 * nx0 + ny0 * ny0 + nz0 * nz0)
    inv_m = 1.0 / torch.where(mag == 0.0, 1.0, mag)
    sign = rw(C_PAR) * torch.where(entering, 1.0, -1.0) * inv_m
    normal = torch.stack([torch.where(hit, nx0 * sign, 0.0), torch.where(hit, ny0 * sign, 0.0),
                          torch.where(hit, nz0 * sign, 1.0)], -1)

    ms = torch.where(m_start >= noid, float(L), m_start).to(torch.int64)
    me = torch.where(m_end >= noid, float(L), m_end).to(torch.int64)
    use_start = ms < L
    leaf = torch.where(use_start, ms, torch.clamp(me, max=L - 1))
    evt = torch.where(hit, torch.where(use_start, leaf, L + leaf), 0).to(torch.int32)
    return {"t": torch.where(hit, t_star, 0.0), "normal": normal,
            "mat_id": torch.where(hit, rw(C_MAT).to(torch.int64), 0),
            "entering": entering, "hit": hit, "_evt": evt, "t_star": t_star, "found": found}


# ---------------------------------------------------------------------------
# K5's wrapper
# ---------------------------------------------------------------------------

class MegaSweepKernel:
    """K5 for one layout.  :meth:`pack` builds the kernel's scene from the
    live params (table, the material scalars of bounce mode, the cull
    bounds) and :meth:`launch` runs one launch on the current stream, hit
    mode or (with the carry inputs) bounce mode."""

    LAUNCHES = 0

    def __init__(self, layout: MegaLayout, material_table=None):
        self.layout = layout
        self.material_table = material_table
        self._meta: dict = {}
        self._cap_cache: dict = {}

    def meta(self, device):
        """``(int table on device, cls_off, n_mt, n_stk)``: :meth:`MegaLayout.kernel_meta`."""
        if device not in self._meta:
            meta, *rest = self.layout.kernel_meta()
            self._meta[device] = (torch.as_tensor(meta, device=device), *rest)
        return self._meta[device]

    def pack(self, params):
        """``(scene, mat_off, bnd_off)``: one float32 vector ``[table |
        material rows (M, 9) | bounds (n_flags, 4)]`` (no autograd); the
        material rows are the material table's ``BOUNCE_ROW`` layout."""
        with torch.no_grad():
            tbl = self.layout.table(params).reshape(-1)
            mats = (self.material_table.rows(params, BOUNCE_ROW).reshape(-1)
                    if self.material_table is not None else tbl.new_zeros(0))
            bnd = self.layout.bounds(params).reshape(-1)
            return (torch.cat([tbl, mats, bnd]).contiguous(), tbl.numel(),
                    tbl.numel() + mats.numel())

    def launch(self, packed, o, d, *, cull=True, carry=None, in_depth=True, stats=False,
               caps=LIST_CAPS):
        """One launch, no synchronisation.  Hit mode (``carry`` None):
        ``t``, ``normal``, ``flags`` (int32 bits: hit, entering), ``evt``,
        ``mat``.  Bounce mode, ``carry = (thr, strength, alive, u_coin,
        u3)``: the fused bounce's dict, ``t``, ``o2``, ``d2``, ``thr2``,
        ``strength2``, ``hit``, ``entering``, ``take_transmit``,
        ``scatter_alive``, ``alive2`` (bool), ``evt`` (int32), ``mat_id``
        (int64), ``u_sel``.  ``caps`` are the capacities of a lane's lists
        (coverage intervals, rows; none where the scene leaves no room in
        shared memory): a lane past one takes the recompute route for that
        step, with the same bits.  ``stats`` adds ``stats`` (B, 6)
        int32: the lane's fixpoint passes, its warp's active cull flags,
        its coverage intervals and rows listed (counted past a capacity),
        the member rows of its culled gadgets that pass 1 evaluates, and
        the bits hit, coverage list over, row list over."""
        scene, mat_off, bnd_off = packed
        lay = self.layout
        B = o.shape[0]
        device = scene.device
        expect = {"o": (o, (B, 3), torch.float32), "d": (d, (B, 3), torch.float32),
                  "scene": (scene, (scene.numel(),), torch.float32)}
        if carry is not None:
            thr, strength, alive, u_coin, u3 = carry
            expect.update({"thr": (thr, (B, 3), torch.float32),
                           "strength": (strength, (B,), torch.float32),
                           "alive": (alive, (B,), torch.bool),
                           "u_coin": (u_coin, (B,), torch.float32),
                           "u3": (u3, (B, 3), torch.float32)})
        _check_inputs("megasweep kernel", device, expect)
        if B == 0:
            raise ValueError("megasweep kernel: empty wavefront")
        meta, cls_off, n_mt, n_stk = self.meta(device)
        lib = _build.library()
        cov_cap, row_cap = self._caps(lib, scene.numel(), meta.numel(), n_mt, n_stk, caps)
        empty = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device=device)
        out = {"t": empty(B), "evt": empty(B, dtype=torch.int32)}
        if carry is None:
            out.update(normal=empty(B, 3), flags=empty(B, dtype=torch.int32),
                       mat=empty(B, dtype=torch.int32))
        else:
            out.update(o2=empty(B, 3), d2=empty(B, 3), thr2=empty(B, 3), strength2=empty(B),
                       u_sel=empty(B, 3))
            out.update((k, empty(B, dtype=torch.bool)) for k in _BOUNCE_BITS)
            out["mat_id"] = empty(B, dtype=torch.int64)
        if stats:
            out["stats"] = empty(B, 6, dtype=torch.int32)
        p = lambda k: _ptr(out[k]) if k in out else None          # None: a null pointer
        c = (lambda i: _ptr(carry[i])) if carry is not None else (lambda i: None)
        err = lib.ptx_megasweep(
            _ptr(scene), scene.numel(), _ptr(meta), meta.numel(), lay.L, lay.Lp, lay.ns,
            lay.ns + lay.npl, lay.tw, lay.n_flags, mat_off, bnd_off, cls_off,
            len(lay.classes), int(bool(cull)), cov_cap, row_cap, n_mt, n_stk,
            _ptr(o), _ptr(d), B, c(0), c(1), c(2), c(3), c(4), int(bool(in_depth)),
            *(p(k) for k in _OUT_ORDER), _stream(device))
        _raise_on(err, lib, "megasweep kernel")
        MegaSweepKernel.LAUNCHES += 1
        return out

    def _caps(self, lib, scene_words, meta_words, n_mt, n_stk, caps):
        """The list capacities a launch uses: ``caps``, or none (every lane
        on the recompute route) where a block's shared memory would pass
        ``MAX_SMEM`` with them; cached per scene size."""
        key = (scene_words, caps)
        if key not in self._cap_cache:
            lay = self.layout
            smem = lambda cc, rc: lib.ptx_megasweep_smem(
                scene_words, lay.Lp, lay.tw, meta_words, lay.n_flags, cc, rc, n_mt, n_stk)
            if smem(0, 0) > MAX_SMEM:
                raise NotImplementedError(f"megasweep kernel: a scene of {smem(0, 0)} bytes "
                                          f"exceeds a block's {MAX_SMEM} bytes of shared memory")
            self._cap_cache[key] = caps if smem(*caps) <= MAX_SMEM else (0, 0)
        return self._cap_cache[key]


# bounce mode's decision outputs (bool), and the order of the C entry
# point's output pointers
_BOUNCE_BITS = ("hit", "entering", "take_transmit", "scatter_alive", "alive2")
_OUT_ORDER = ("t", "normal", "flags", "evt", "mat", "o2", "d2", "thr2", "strength2", "u_sel",
              *_BOUNCE_BITS, "mat_id", "stats")


# ---------------------------------------------------------------------------
# the sweep's mega mode: K5's plain version as a hit, K5's hit and bounce
# wrappers
# ---------------------------------------------------------------------------

class SweepHit(PlainHit):
    """The union-sweep first hit in ``mega`` mode, on a mega-eligible tape:
    K5's plain version :func:`megasweep_reference` in hit mode (on any
    device), the port of the JAX sweep's ``hit_fn``; :class:`MegaHit` is
    its kernel."""

    def __init__(self, plan, leaves, params_ref=None):
        self.layout = MegaLayout(plan, leaves, params_ref)
        self.replay = hitreplay.build_hit_replay(leaves)

    def __call__(self, params, origin, direction, cull=False):
        with torch.no_grad():
            r = megasweep_reference(self.layout, params, origin, direction, cull=cull)
        return hit_dict(self.replay, params, origin, direction, r["t"], r["normal"],
                        r["hit"], r["entering"], r["_evt"], r["mat_id"])


class MegaHit:
    """K5 in hit mode for one compiled scene, the port of the JAX
    ``_compile_mega_sweep`` (``ptx/geom/fasthit.py:600-653``; the kernel
    builds ``evt`` from its matches as :626-629 does):
    ``hit(params, o, d, packed=None)`` returns the first-hit dict.  CUDA
    tensors launch the kernel (reading ``packed``, :meth:`pack` of these
    params, packed here when not given); CPU tensors, and only those, run
    the plain version ``sweep``."""

    def __init__(self, sweep: SweepHit):
        self.sweep = sweep
        self.kernel = MegaSweepKernel(sweep.layout)

    def pack(self, params):
        """K5's hit-mode scene (:meth:`MegaSweepKernel.pack`)."""
        return self.kernel.pack(params)

    def __call__(self, params, o, d, packed=None):
        if o.device.type == "cpu":
            return self.sweep(params, o, d)
        if o.device.type != "cuda":
            raise ValueError(f"megasweep kernel: no kernel for {o.device}")
        raw = self.kernel.launch(self.pack(params) if packed is None else packed, o, d)
        fl = raw["flags"]
        return hit_dict(self.sweep.replay, params, o, d, raw["t"], raw["normal"],
                        (fl & 1).to(torch.bool), (fl & 2).to(torch.bool), raw["evt"],
                        raw["mat"].to(torch.int64))


class MegaBounce:
    """K5 in bounce mode (hit + shade + scatter in one launch) with the
    fused bounce contract of K1's wrapper
    (:class:`~ptx_torch.ops.bounce_kernel.BounceKernel`): CUDA tensors
    launch the kernel, CPU tensors run the plain bounce
    (``bounce_reference``: the port's plain shading on ``scene.plain_hit_fn``,
    the sweep)."""

    def __init__(self, scene):
        self.scene = scene
        self.kernel = MegaSweepKernel(scene.plain_hit_fn.layout, scene.material_fn)

    def pack(self, params):
        """K5's bounce-mode scene (:meth:`MegaSweepKernel.pack`: the table,
        the material rows and the cull bounds)."""
        return self.kernel.pack(params)

    def __call__(self, params, o, d, thr, strength, alive, u_coin, u3, in_depth: bool,
                 packed=None, cull=True):
        if o.device.type == "cpu":
            return bounce_reference(self.scene, params, o, d, thr, strength, alive, u_coin,
                                    u3, in_depth)
        if o.device.type != "cuda":
            raise ValueError(f"megasweep kernel: no kernel for {o.device}")
        return self.kernel.launch(self.pack(params) if packed is None else packed, o, d,
                                  carry=(thr, strength, alive, u_coin, u3),
                                  in_depth=in_depth, cull=cull)


def compile_mega_bounce(scene):
    """K5's fused bounce for a compiled scene whose ``plain_hit_fn`` is the
    ``mega`` sweep (``ptx/geom/fasthit.py:656-712``); the caller checks that
    every non-emissive slot is Constant.  None when the scene has no such
    sweep."""
    return MegaBounce(scene) if isinstance(scene.plain_hit_fn, SweepHit) else None
