"""The plain reference path tracer: the whole forward, and by autograd the
gradients, of what the port's ``trace_rays``, ``render_rows`` and
``make_train_step`` compute, in plain PyTorch.

It imports nothing of the port.  Its arithmetic is a frozen copy of the
port's plain versions at commit 4da45c6 (``ptx_torch/core/linalg.py``,
``ptx_torch/geom/fasthit.py``'s leaf intervals, ``ptx_torch/integrate/
{camera,trace}.py``'s camera, bounce, scatter sampler, compaction and
emission, ``ptx_torch/shade/textures.py``'s equirect lookup), written in
the same operation order, so that float32 runs round alike and the image
and gradients the port's kernels produce can be held to it closely.  The
first hit is computed here in two ways of its own, both giving the CSG
semantics of the reference renderer's span walk: the membership fold over
all 2L boundary events (any tree), and on a union of leaves a fixpoint
over the covering intervals (the first boundary where the union's
membership changes).  Decisions (which boundary, which branch) are made
without autograd; the hit distance and normal are then recomputed from
the selected boundary with autograd, which gives the derivative the port's
decision-frozen replay computes.  Gathers from the parameters are
``index_select``: the transpose of advanced indexing sorts its indices,
which takes seconds at a step's 4.19 M lanes onto a few rows.

``dtype`` runs the whole tracer in another precision: the control.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import rng
from benchmark.reference.scene import SLOTS, RefScene

EPS = 1e-3
MAX_VALUE = 1e20
PAD_T = 3e20
COMPACT_SCHEDULE = ((2, 3), (6, 16))
COMPACT_MIN_BATCH = 16384
HIT_LANES = 1 << 18             # lanes a hit selection takes at once


# --------------------------------------------------------------------------
# vector helpers
# --------------------------------------------------------------------------

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def vnorm(v):
    mag2 = dot(v, v)
    safe = torch.sqrt(torch.where(mag2 == 0.0, 1.0, mag2))
    return torch.where(mag2 == 0.0, 0.0, safe)


def normalize(v):
    mag2 = dot(v, v)
    return v / torch.sqrt(torch.where(mag2 == 0.0, 1.0, mag2))[..., None]


def reflect(d, n):
    n = normalize(n)
    return d - (2.0 * dot(d, n))[..., None] * n


def clip01(x):
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _refract_terms(d, eta, n):
    n_unit = normalize(n)
    i = normalize(d)
    idn = dot(i, n_unit)
    arg = 1.0 - eta * eta * (1.0 - idn * idn)
    base_ok = ((eta > EPS) & (eta < 1.0 / EPS) & (dot(n, n) > 0.0) & (dot(d, d) > 0.0))
    return n_unit, i, idn, arg, base_ok


def refract_strength(d, eta, n):
    _, _, _, arg, base_ok = _refract_terms(d, eta, n)
    ok = base_ok & (arg > 0.0)
    return torch.where(ok, torch.sqrt(torch.sqrt(torch.where(ok, arg, 1.0))), 0.0)


def refract(d, eta, n):
    n_unit, i, idn, arg, base_ok = _refract_terms(d, eta, n)
    ok = base_ok & (arg >= 0.0)
    safe_arg = torch.where(ok, torch.clamp(arg, min=1e-20), 1.0)
    t = eta[..., None] * i - (eta * idn + torch.sqrt(safe_arg))[..., None] * n_unit
    return torch.where(ok[..., None], normalize(t), torch.zeros_like(t))


def mean3(v):
    return (v[..., 0] + v[..., 1] + v[..., 2]) / 3.0


# --------------------------------------------------------------------------
# camera
# --------------------------------------------------------------------------

def sample_rays(scene: RefScene, key, ys, xs, spp, device, dtype):
    """Jittered primary rays ``(spp, len(ys), len(xs), 3)`` of the
    reference demo camera (screen = pixel size, distance 2·min(W, H))."""
    w, h = scene.width, scene.height
    ys = torch.as_tensor(ys, dtype=torch.float32, device=device).to(dtype)
    xs = torch.as_tensor(xs, dtype=torch.float32, device=device).to(dtype)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    shape = (spp,) + tuple(py.shape)
    jitter = rng.sample_square(key, shape, device, dtype=dtype)
    px = px.expand(shape) + jitter[..., 0]
    py = py.expand(shape) + jitter[..., 1]
    x = 2.0 * px / w - 1.0
    y = 1.0 - 2.0 * py / h
    direction = torch.stack([x * float(w), y * float(h),
                             torch.full_like(x, -2.0 * min(w, h))], dim=-1)
    return torch.zeros_like(direction), direction


# --------------------------------------------------------------------------
# the first hit
# --------------------------------------------------------------------------

class _Leaves:
    """Index tables of the scene's leaves on the device."""

    def __init__(self, scene: RefScene, device, dtype):
        L = len(scene.leaves)
        lt = lambda xs, dt: torch.tensor(xs, dtype=dt, device=device)
        self.L = L
        self.sph_pos = lt([i for i, lf in enumerate(scene.leaves) if lf.kind == "sphere"],
                          torch.int64)
        self.pl_pos = lt([i for i, lf in enumerate(scene.leaves) if lf.kind == "plane"],
                         torch.int64)
        self.sph_row = lt([lf.index for lf in scene.leaves if lf.kind == "sphere"], torch.int64)
        self.pl_row = lt([lf.index for lf in scene.leaves if lf.kind == "plane"], torch.int64)
        self.is_sphere = lt([lf.kind == "sphere" for lf in scene.leaves], torch.bool)
        self.row = lt([lf.index for lf in scene.leaves], torch.int64)
        self.mat = lt([lf.mat for lf in scene.leaves], torch.int64)
        self.parity = lt([lf.parity for lf in scene.leaves], torch.float32).to(dtype)


def _sphere_t(c, r, ox, oy, oz, dx, dy, dz):
    """(t0, t1, ok, (ocx, ocy, ocz)) of spheres ``c``/``r`` broadcast
    against the rays."""
    ocx, ocy, ocz = ox - c[..., 0], oy - c[..., 1], oz - c[..., 2]
    a = dx * dx + dy * dy + dz * dz
    b = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - a * cc
    ok = (disc > EPS) & (a != 0.0)
    sq = torch.sqrt(torch.where(ok, disc, 1.0))
    sa = torch.where(a == 0.0, 1.0, a)
    return (-b - sq) / sa, (-b + sq) / sa, ok, (ocx, ocy, ocz)


def _plane_t(n, dpl, ox, oy, oz, dx, dy, dz):
    """(t, divisor, numer, flat) of planes ``n``/``dpl`` against the rays."""
    divisor = dx * n[..., 0] + dy * n[..., 1] + dz * n[..., 2]
    numer = -dpl - (ox * n[..., 0] + oy * n[..., 1] + oz * n[..., 2])
    flat = torch.abs(divisor) < EPS * EPS
    return numer / torch.where(flat, 1.0, divisor), divisor, numer, flat


def _intervals(lv: _Leaves, P, o, d):
    """Every leaf's boundary interval ``(t0, t1)``, each (L, B), PAD_T
    where the ray misses the leaf."""
    ox, oy, oz = (x[None] for x in o.unbind(-1))
    dx, dy, dz = (x[None] for x in d.unbind(-1))
    t0 = o.new_empty((lv.L, o.shape[0]))
    t1 = torch.empty_like(t0)
    if lv.sph_pos.numel():
        c = P["sphere_center"][lv.sph_row][:, None, :]
        r = P["sphere_radius"][lv.sph_row][:, None]
        a0, a1, ok, _ = _sphere_t(c, r, ox, oy, oz, dx, dy, dz)
        t0.index_copy_(0, lv.sph_pos, torch.where(ok, a0, PAD_T))
        t1.index_copy_(0, lv.sph_pos, torch.where(ok, a1, PAD_T))
    if lv.pl_pos.numel():
        n = P["plane_normal"][lv.pl_row][:, None, :]
        dpl = P["plane_d"][lv.pl_row][:, None]
        t, divisor, numer, flat = _plane_t(n, dpl, ox, oy, oz, dx, dy, dz)
        degenerate = flat | (torch.abs(t) >= MAX_VALUE)
        on_boundary = torch.abs(numer) < EPS * EPS
        entering_half = divisor < 0.0
        full = degenerate & on_boundary
        ok = ~(degenerate & ~on_boundary)
        t0.index_copy_(0, lv.pl_pos, torch.where(ok, torch.where(
            full, -MAX_VALUE, torch.where(entering_half, t, -MAX_VALUE)), PAD_T))
        t1.index_copy_(0, lv.pl_pos, torch.where(ok, torch.where(
            full, MAX_VALUE, torch.where(entering_half, MAX_VALUE, t)), PAD_T))
    return t0, t1


def _fold(tree, bits):
    """The CSG tree over per-leaf membership bits (..., L, B) → (..., B)."""
    if tree[0] == "leaf":
        return bits[..., tree[1], :]
    kids = [_fold(k, bits) for k in tree[1]]
    out = kids[0]
    for k in kids[1:]:
        out = (out | k if tree[0] == "union" else out & k if tree[0] == "intersection"
               else out & ~k)
    return out


def _select_dense(scene, t0, t1):
    """The first boundary at or past EPS by the membership fold: the event
    (leaf k's start = k, end = L + k) at which the root's membership just
    before and just after differ, the first one in event order among
    equal distances."""
    L = t0.shape[0]
    t_evt = torch.cat([t0, t1])
    ts = t_evt[:, None, :]
    after = (t0[None] <= ts) & (ts < t1[None])
    before = (t0[None] < ts) & (ts <= t1[None])
    root_after = _fold(scene.tree, after)
    cand = (root_after != _fold(scene.tree, before)) & (t_evt >= EPS)
    idx = torch.argmin(torch.where(cand, t_evt, PAD_T), dim=0)
    t_hit = t_evt.gather(0, idx[None])[0]
    hit = cand.any(dim=0) & ~(t_hit >= MAX_VALUE)
    entering = root_after.gather(0, idx[None])[0]
    return idx % L, idx >= L, hit, entering


def _select_union(t0, t1):
    """The same boundary on a union of leaves: where the intervals that
    cover the point just past EPS end (their covering fixpoint), else the
    first start at or past EPS; among equal distances the first event in
    event order."""
    E = torch.full_like(t0[0], EPS)
    for _ in range(t0.shape[0] + 1):
        cov = (t0 <= E[None]) & (E[None] < t1)
        nxt = torch.maximum(E, torch.where(cov, t1, -PAD_T).amax(dim=0))
        if torch.equal(nxt, E):
            break
        E = nxt
    else:
        raise RuntimeError("the covering fixpoint did not converge")
    inside = E > EPS
    first = torch.where((t0 < t1) & (t0 >= EPS), t0, PAD_T).amin(dim=0)
    T = torch.where(inside, E, first)
    hit = T < MAX_VALUE
    at = torch.cat([t0 == T[None], t1 == T[None]])
    idx = torch.argmax(at.to(torch.uint8), dim=0)
    idx = torch.where(hit, idx, 0)
    L = t0.shape[0]
    return idx % L, idx >= L, hit, ~inside


def first_hit(scene: RefScene, lv: _Leaves, P, o, d):
    """``(t, normal, mat_id, entering, hit)`` of rays (B, 3); ``t`` and
    ``normal`` carry autograd to the geometry and the rays."""
    with torch.no_grad():
        sel = []
        for a in range(0, o.shape[0], HIT_LANES):
            oc, dc = o[a:a + HIT_LANES].detach(), d[a:a + HIT_LANES].detach()
            t0, t1 = _intervals(lv, P, oc, dc)
            sel.append(_select_union(t0, t1) if scene.flat_union
                       else _select_dense(scene, t0, t1))
        leaf, is_end, hit, entering = (torch.cat(x) for x in zip(*sel))
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    sph = lv.is_sphere[leaf]
    row = lv.row[leaf]
    ns = P["sphere_radius"].shape[0]
    npl = P["plane_d"].shape[0]
    t = torch.zeros_like(ox)
    nrm = torch.zeros_like(o)
    if ns:
        srow = torch.where(sph, row, 0)
        c = P["sphere_center"].index_select(0, srow)
        r = P["sphere_radius"].index_select(0, srow)
        a0, a1, _, (ocx, ocy, ocz) = _sphere_t(c, r, ox, oy, oz, dx, dy, dz)
        ts = torch.where(is_end, a1, a0)
        inv_r = 1.0 / torch.where(r == 0.0, 1.0, r)
        ns_ = torch.stack([(ocx + ts * dx) * inv_r, (ocy + ts * dy) * inv_r,
                           (ocz + ts * dz) * inv_r], dim=-1)
        t = torch.where(sph, ts, t)
        nrm = torch.where(sph[:, None], ns_, nrm)
    if npl:
        prow = torch.where(sph, 0, row)
        n = P["plane_normal"].index_select(0, prow)
        dpl = P["plane_d"].index_select(0, prow)
        tp, _, _, _ = _plane_t(n, dpl, ox, oy, oz, dx, dy, dz)
        inv_mag = 1.0 / torch.sqrt(torch.clamp(
            n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1] + n[:, 2] * n[:, 2], min=1e-30))
        t = torch.where(sph, t, tp)
        nrm = torch.where(sph[:, None], nrm, n * inv_mag[:, None])
    sign = lv.parity[leaf] * torch.where(entering, 1.0, -1.0).to(o.dtype)
    return (torch.where(hit, t, 0.0), nrm * sign[:, None],
            torch.where(hit, lv.mat[leaf], 0), entering, hit)


# --------------------------------------------------------------------------
# materials and emission chains
# --------------------------------------------------------------------------

def material(scene: RefScene, P, mat_id):
    """Constant slots of each lane's material (the dynamic emissive rows
    read zero; the bounce reads no emission)."""
    const = P["const"]
    rows = torch.cat([const[torch.as_tensor(scene.slot_row[s], device=const.device)]
                      for s in SLOTS] + [P["ior"][:, None]], dim=1)
    row = rows.index_select(0, mat_id)
    out = {s: row[:, 3 * i:3 * i + 3] for i, s in enumerate(SLOTS)}
    out["scatter_f"] = mean3(out["scatter"])
    out["transmit_reflect_f"] = mean3(out["transmit_reflect"])
    out["ior"] = row[:, 15]
    return out


def _spherical_uv(v):
    zero = (v == 0.0).all(dim=-1)
    n = normalize(v)
    theta = torch.atan2(n[..., 1], n[..., 0])
    phi = torch.asin(torch.clamp(n[..., 2], -1.0, 1.0))
    u = torch.where(zero, 0.0, theta * 0.5 / math.pi + 0.5)
    w = torch.where(zero, 0.0, phi / (math.pi / 2.0) * 0.5 + 0.5)
    return torch.stack([u, w, torch.zeros_like(u)], dim=-1)


def eval_chain(chain, P, pos):
    kind = chain[0]
    if kind == "xform":
        A = P["tex_xform"][chain[1]]
        moved = torch.einsum("...ij,...j->...i", A[:, :3], pos) + A[:, 3]
        return eval_chain(chain[2], P, moved)
    if kind == "mul":
        return eval_chain(chain[2], P, pos) * P["factor"][chain[1]]
    if kind == "spherical":
        return eval_chain(chain[1], P, _spherical_uv(pos))
    img = P["images"][chain[1]]
    h, w = img.shape[0], img.shape[1]
    x = pos[..., 0] - torch.floor(pos[..., 0])
    y = 1.0 - (pos[..., 1] - torch.floor(pos[..., 1]))
    xi = torch.floor(x * w).to(torch.int64)
    yi = torch.floor(y * h).to(torch.int64)
    inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    flat = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(-1)
    texel = img.reshape(h * w, -1).index_select(0, flat).reshape(yi.shape + (-1,))[..., :3]
    return torch.where(inb[..., None], texel, 0.0)


# --------------------------------------------------------------------------
# one bounce
# --------------------------------------------------------------------------

def sample_scatter_dir(direction, normal, scatter_c, u3):
    """The zero-rejection scatter draw (``(dir, ok)``); the accepted point
    carries no gradient, the direction does through its bias."""
    reflected = reflect(direction, normal)
    sc = clip01(scatter_c)
    specular = sc <= EPS
    bias = (1.0 / torch.where(specular, 1.0, sc) - 1.0)[..., None] * reflected
    m2 = dot(normal, normal)
    m = torch.sqrt(torch.where(m2 == 0.0, 1.0, m2))
    nhat = normal / m[..., None]
    c = (EPS - dot(normal, bias)) / m
    feasible = c < 1.0
    cc = torch.clamp(c, -1.0, 1.0)
    g_cc = cc - cc * cc * cc * (1.0 / 3.0)
    G = g_cc + u3[..., 0] * (2.0 / 3.0 - g_cc)
    arg = torch.clamp(-1.5 * G, -1.0, 1.0)
    z = 2.0 * torch.cos(torch.acos(arg) * (1.0 / 3.0) - 2.0 * math.pi / 3.0)
    z = torch.minimum(torch.maximum(z, cc), torch.ones_like(z))
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0) * u3[..., 1])
    phi = 2.0 * math.pi * u3[..., 2]
    x, y = r * torch.cos(phi), r * torch.sin(phi)
    nx, ny, nz = nhat.unbind(-1)
    s = torch.where(nz >= 0.0, 1.0, -1.0).to(nz.dtype)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    e1 = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    e2 = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    u = (x[..., None] * e1 + y[..., None] * e2 + z[..., None] * nhat).detach()
    out = torch.where(specular[..., None], reflected, normalize(u + bias))
    return out, specular | feasible


def bounce(scene, lv, P, o, d, thr, strength, alive, in_depth, u_coin, u3):
    """One wavefront bounce → (carry, (hit position, mat_id, hit))."""
    t, normal, mat_id, entering, hit = first_hit(scene, lv, P, o, d)
    pos = o + t[:, None] * d
    m = material(scene, P, mat_id)
    cont = alive & hit & in_depth & (strength >= EPS)
    rel_ior = torch.where(entering, 1.0 / m["ior"], m["ior"])
    trc = clip01(m["transmit_reflect_f"])
    refract_factor = trc * refract_strength(d, rel_ior, normal)
    refr_dir = refract(d, rel_ior, normal)
    refr_ok = (refract_factor > EPS) & (refr_dir != 0.0).any(dim=-1)
    p_transmit = torch.where(refr_ok, refract_factor, 0.0)
    take_transmit = (u_coin < p_transmit) & cont
    add_factor = 1.0 - p_transmit
    scatter_alive = cont & ~take_transmit & (add_factor >= EPS)
    scat_dir, scat_ok = sample_scatter_dir(d, normal, m["scatter_f"], u3)
    sc = clip01(m["scatter_f"])
    factor = 1.0 - (1.0 - dot(scat_dir, normal)) * sc
    scatter_alive = scatter_alive & scat_ok
    new_alive = take_transmit | scatter_alive
    tt = take_transmit[:, None]
    new_dir = torch.where(tt, refr_dir, scat_dir)
    tint = torch.where(tt, m["transmit"], factor[:, None] * m["reflect"])
    new_thr = thr * tint
    vcount = torch.floor(10000.0 * strength * add_factor * sc)
    fanout = torch.where((sc <= EPS) | (vcount < 1.0), 1.0, vcount)
    tr_strength = strength * refract_factor * vnorm(m["transmit"])
    sc_strength = strength / fanout * add_factor * factor * vnorm(m["reflect"])
    new_strength = torch.where(take_transmit, tr_strength, sc_strength).detach()
    na = new_alive[:, None]
    carry = (torch.where(na, pos, o), torch.where(na, new_dir, d),
             torch.where(na, new_thr, thr), torch.where(new_alive, new_strength, strength),
             new_alive)
    return carry, (pos.detach(), mat_id, alive & hit)


# --------------------------------------------------------------------------
# compaction, emission, the trace
# --------------------------------------------------------------------------

def compact(carry, orig, cap, keys):
    """Each wavefront's live lanes to its front; above ``cap`` live,
    systematic resampling with a random phase (from the wavefront's key)
    keeps ``cap`` of them and scales their throughput by n/cap.  Carry
    tensors are (C, B, ...), one row a wavefront."""
    o, d, thr, strength, alive = carry
    alive_i = alive.to(torch.int64)
    n = alive_i.sum(dim=1)
    n_safe = torch.clamp(n, min=1)
    ncap = torch.clamp(n_safe, max=cap)
    ranks = torch.cumsum(alive_i, dim=1)
    u = rng.uniform_many(keys, (), o.device)
    off = torch.floor(u * n_safe.to(torch.float32)).to(torch.int64)
    off = torch.minimum(torch.clamp(off, min=0), n_safe - 1)
    lo = torch.div((ranks - 1) * ncap[:, None] + off[:, None], n_safe[:, None],
                   rounding_mode="floor")
    hi = torch.div(ranks * ncap[:, None] + off[:, None], n_safe[:, None],
                   rounding_mode="floor")
    keep = alive & (hi > lo)
    w = torch.where(n > cap, n_safe.to(torch.float32) / cap, 1.0).to(thr.dtype)
    src = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)[:, :cap]
    take = lambda x: x.gather(1, src[..., None].expand(-1, -1, 3))
    new_alive = (torch.arange(cap, device=o.device)[None] < ncap[:, None]) & alive.gather(1, src)
    dz = torch.where(new_alive, 0.0, -1.0).to(d.dtype)
    d2 = take(d)
    new = (take(o), torch.stack([d2[..., 0], d2[..., 1], d2[..., 2] + dz], dim=-1),
           torch.where(new_alive[..., None], take(thr * w[:, None, None]), 0.0),
           torch.where(new_alive, strength.gather(1, src), 0.0), new_alive)
    return new, torch.where(new_alive, orig.gather(1, src), torch.iinfo(torch.int64).max)


def _emission(scene: RefScene, P, rows):
    """Each phase's banked radiance per lane from its records ``(pos, thr,
    mat_id, live)`` (nb, Bp).  With a terminal chain (the sky): constant
    emitters summed per material, and each chain evaluated on the first
    record per lane that reaches it with a nonzero throughput; without
    one, every record's constant emission weighted by its throughput."""
    pos, thr, mid, live = rows
    term = {mi for mi, _ in scene.terminal_chains}
    em_rows = P["const"][torch.as_tensor(scene.slot_row["emissive"], device=thr.device)]
    if not term:
        em = em_rows.index_select(0, mid.reshape(-1)).reshape(mid.shape + (3,))
        return torch.where(live[..., None], thr * em, 0.0).sum(dim=0)
    contrib = torch.zeros(thr.shape[1:], dtype=thr.dtype, device=thr.device)
    for m in range(scene.n_materials):
        if m in term:
            continue
        wsum = torch.where((live & (mid == m))[..., None], thr, 0.0).sum(dim=0)
        contrib = contrib + wsum * em_rows[m]
    thr_nz = thr.abs().sum(dim=-1) > 0.0
    for mi, chain in scene.terminal_chains:
        is_sel = live & (mid == mi) & thr_nz
        first = torch.argmax(is_sel.to(torch.uint8), dim=0)
        pick = lambda a: a.gather(0, first[None, :, None].expand(1, -1, 3))[0]
        em = eval_chain(chain, P, pick(pos))
        contrib = contrib + torch.where(is_sel.any(dim=0)[:, None], pick(thr) * em, 0.0)
    return contrib


def trace(scene: RefScene, P, origin, direction, keys, depth, dtype=torch.float32):
    """Radiance ``(C, ..., 3)`` of ``C`` wavefronts ``origin``/``direction``
    ``(C, ..., 3)``, wavefront ``c`` keyed ``keys[c]``: one path per ray,
    up to ``depth`` bounces plus the primary hit, each wavefront's live
    lanes compacted between phases where it holds 16,384 rays or more.
    The wavefronts are independent; they are batched to save launches."""
    shape = origin.shape[:-1]
    C = shape[0]
    o = origin.reshape(C, -1, 3)
    d = direction.reshape(C, -1, 3)
    B, dev = o.shape[1], o.device
    lv = _Leaves(scene, dev, dtype)
    carry = (o, d, torch.ones((C, B, 3), dtype=dtype, device=dev),
             torch.ones((C, B), dtype=dtype, device=dev),
             torch.ones((C, B), dtype=torch.bool, device=dev))
    phases = [(0, 1)]
    if B >= COMPACT_MIN_BATCH and depth >= 8:
        phases += [(s, dv) for s, dv in COMPACT_SCHEDULE if s <= depth and B // dv >= 1]
    orig = torch.arange(B, dtype=torch.int64, device=dev).expand(C, B)
    base = (torch.arange(C, dtype=torch.int64, device=dev) * B)[:, None]
    radiance = torch.zeros((C * B, 3), dtype=dtype, device=dev)
    for pi, (start, div) in enumerate(phases):
        end = phases[pi + 1][0] if pi + 1 < len(phases) else depth + 1
        if pi > 0:
            carry, orig = compact(carry, orig, B // div,
                                  [rng.fold(k, 0x00C0, pi) for k in keys])
        width, nb = B // div, end - start
        kbs = [rng.fold(k, b) for k in keys for b in range(start, end)]
        u_coins = rng.uniform_many([rng.fold(k, 1) for k in kbs], (width,), dev,
                                   dtype).reshape(C, nb, width)
        u3s = rng.uniform_many([rng.fold(k, 2) for k in kbs], (width, 3), dev,
                               dtype).reshape(C, nb, width, 3)
        flat = tuple(x.reshape((C * width,) + x.shape[2:]) for x in carry)
        recs = []
        for b in range(start, end):
            thr_in = flat[2]
            flat, (pos, mid, live) = bounce(
                scene, lv, P, *flat, b < depth, u_coins[:, b - start].reshape(-1),
                u3s[:, b - start].reshape(-1, 3))
            recs.append((pos, thr_in, mid, live))
        carry = tuple(x.reshape((C, width) + x.shape[1:]) for x in flat)
        contrib = _emission(scene, P, tuple(torch.stack(x) for x in zip(*recs)))
        if pi == 0:
            radiance = radiance + contrib
        else:
            valid = (orig < B).reshape(-1)
            idx = (base + torch.where(orig < B, orig, B - 1)).reshape(-1)
            radiance = radiance.index_add(0, idx, torch.where(valid[:, None], contrib, 0.0))
    return radiance.reshape(shape + (3,))


# --------------------------------------------------------------------------
# the entries the benchmark judges
# --------------------------------------------------------------------------

def render_rows(scene, P, key, y0, rows, spp_chunk, n_chunks, depth, device,
                dtype=torch.float32):
    """A full-width row band at ``n_chunks · spp_chunk`` samples, chunk
    ``i`` keyed ``fold(key, i·spp_chunk, y0)`` (the CLI's band)."""
    keys = [rng.fold(key, i * spp_chunk, y0) for i in range(n_chunks)]
    with torch.no_grad():
        rays = [sample_rays(scene, k, range(y0, y0 + rows), range(scene.width),
                            spp_chunk, device, dtype) for k in keys]
        rad = trace(scene, P, torch.stack([o for o, _ in rays]),
                    torch.stack([d for _, d in rays]), keys, depth, dtype)
    acc = torch.zeros((rows, scene.width, 3), dtype=dtype, device=device)
    for i in range(n_chunks):
        acc = acc + rad[i].mean(dim=0)
    return acc / n_chunks


def leaves_of(P):
    """The parameter tensors, one per table and one per image, by name."""
    out = {k: v for k, v in P.items() if k != "images"}
    out.update({f"images.{i}": im for i, im in enumerate(P["images"])})
    return out


def with_leaves(P, leaves):
    out = {k: leaves[k] for k in P if k != "images"}
    out["images"] = [leaves[f"images.{i}"] for i in range(len(P["images"]))]
    return out


def train_step(scene, P, target, key, spp, depth, learning_rate, device,
               dtype=torch.float32):
    """One gradient step on the whole frame: the mean squared error of the
    ``spp``-sample image keyed ``fold(key, 0, 0)`` against ``target``;
    returns ``(new params, loss, gradients by leaf)``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in leaves_of(P).items()}
    k = rng.fold(key, 0, 0)
    o, d = sample_rays(scene, k, range(scene.height), range(scene.width), spp, device, dtype)
    with torch.enable_grad():
        img = trace(scene, with_leaves(P, leaves), o[None], d[None], [k], depth,
                    dtype)[0].mean(dim=0)
        loss = torch.mean((img - target.to(dtype)) ** 2)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
    g = {n: (torch.zeros_like(leaves[n]) if x is None else x) for n, x in zip(names, grads)}
    new = {n: (leaves[n] - learning_rate * g[n]).detach() for n in names}
    return with_leaves(P, new), loss.detach(), g
