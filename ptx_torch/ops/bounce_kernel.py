"""The fused bounce kernels: K1 (first hit + shade + scatter, forward) and
K2 (the decision-frozen replay VJP, backward), one launch each per bounce.

Port of ``ptx/ops/bounce_kernel.py``: ``build_bounce_kernel`` (:236) and
``build_bounce_bwd_kernel`` (:578), Pallas TPU kernels, as hand-written CUDA
kernels, ``ptx_torch/csrc/bounce_kernel.cu`` and ``bounce_bwd_kernel.cu``.

- :class:`BounceKernel` is K1's wrapper, called once per bounce;
  :func:`bounce_reference` its plain PyTorch version (the port's plain
  live bounce on the dense first hit).  The kernel reads the scene from
  one small float32 buffer, :func:`pack_scene`, which ``trace_rays`` packs
  once per call from the params it is given.
- :class:`BounceBwdKernel` is K2's wrapper, called once per bounce by the
  manual bounce VJP (``trace.ManualBounce``) on the scene vector of
  :func:`pack_bwd`, which ``trace_rays`` packs once per call.  The kernel
  returns per-lane d(o, d, thr) and ``d_packed``, that vector's cotangent
  (the per-leaf sums of the row cotangents, and per material the sums of
  its leaves' material cotangents); autograd maps the bounces' sum to the
  params once per call.  Its plain versions: ``BounceBwdKernel.reference``
  (autograd through :func:`replay_lane_math`, the lanes of
  :func:`bounce_bwd_lanes_reference`, and :func:`fold_packed`) and, for the
  whole bounce, :func:`bounce_bwd_reference` (autograd through
  ``trace._bounce_replay`` to the params).
- For CUDA tensors a wrapper launches its kernel or raises; for CPU
  tensors, and only for those, it runs the plain version.  ``LAUNCHES`` /
  ``REFERENCE_CALLS`` (K1) and ``BounceBwdKernel.LAUNCHES`` /
  ``BWD_REFERENCE_CALLS`` (K2) count launches and plain calls, so a run
  can show which way it went.
"""

from __future__ import annotations

import ctypes

import torch

from ptx_torch.core import linalg
from ptx_torch.geom import hitreplay
from ptx_torch.geom.fasthit import collect_leaves
from ptx_torch.integrate import trace
from ptx_torch.ops.fasthit_kernel import MAX_SCENE_BYTES, pack_geometry
from ptx_torch.shade.materials import mean3

LAUNCHES = 0
REFERENCE_CALLS = 0
BWD_REFERENCE_CALLS = 0

# material rows appended to K4's scene buffer — must match
# ptx_torch/csrc/bounce_kernel.cu
_MAT_STRIDE = 9      # rfl0 rfl1 rfl2 scatter_f tr0 tr1 tr2 transmit_reflect_f ior


def material_rows(table, params):
    """(M, 9) per material ``reflect₃, mean(scatter), transmit₃,
    mean(transmit_reflect), ior``: the scalars the fused bounce kernels
    (K1, K5) shade with (``csrc/shade_lane.cuh``)."""
    const = params["const"]
    idx = {s: torch.as_tensor(v, device=const.device)
           for s, v in table.const_idx.items()}
    return torch.cat([const[idx["reflect"]], mean3(const[idx["scatter"]])[:, None],
                      const[idx["transmit"]],
                      mean3(const[idx["transmit_reflect"]])[:, None],
                      params["ior"][:, None]], dim=1)


def pack_scene(plan, table, params):
    """K1's scene buffer (float32, on the params' device) and its layout
    ``(L, mat_off, tape_off, tape_len)``: K4's buffer
    (:func:`~ptx_torch.ops.fasthit_kernel.pack_geometry`: leaf records,
    geometry, the CSG tape), then ``M`` material rows of 9."""
    buf, (L, tape_off, tape_len) = pack_geometry(plan, params)
    buf = torch.cat([buf, material_rows(table, params).reshape(-1)]).contiguous()
    if buf.numel() * 4 > MAX_SCENE_BYTES:
        raise NotImplementedError(f"scene buffer of {buf.numel() * 4} bytes "
                                  "exceeds the kernel's shared memory")
    return buf, (L, tape_off + tape_len, tape_off, tape_len)


def _check_inputs(kernel, device, expect):
    for name, (x, shape, dtype) in expect.items():
        if (x.device != device or x.dtype != dtype
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"{kernel}: {name} must be a contiguous {dtype} tensor of shape "
                f"{shape} on {device}; got {x.dtype} {tuple(x.shape)} on {x.device}")


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err, lib, kernel):
    if err:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({lib.ptx_cuda_error_name(err).decode()})")


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


class BounceKernel:
    """K1 for one compiled scene.

    ``bounce(params, o, d, thr, strength, alive, u_coin, u3, in_depth,
    packed=None)`` on flat (B, 3) / (B,) tensors returns the dict of the
    JAX package's ``bounce_fn``: ``t``, ``o2``, ``d2``, ``thr2``,
    ``strength2``, ``hit``, ``entering``, ``take_transmit``,
    ``scatter_alive``, ``alive2``, ``evt``, ``mat_id``, ``u_sel``.  On CUDA
    the kernel reads the scene buffer ``packed`` (:meth:`pack` of these
    ``params``), packed here when it is not given: ``trace_rays`` packs
    once per call and hands the buffer to every bounce."""

    def __init__(self, scene):
        self.scene = scene
        self.layout = pack_scene(scene.plan, scene.material_fn, scene.params)[1]
        self.leaf_mat = torch.tensor(
            [lf.mat_id for lf, _ in collect_leaves(scene.plan)],
            dtype=torch.int64, device=scene.device)

    def pack(self, params):
        """The kernel's scene buffer from ``params`` (no autograd)."""
        with torch.no_grad():
            buf, layout = pack_scene(self.scene.plan, self.scene.material_fn, params)
        assert layout == self.layout
        return buf

    def __call__(self, params, o, d, thr, strength, alive, u_coin, u3,
                 in_depth: bool, packed=None):
        if o.device.type == "cpu":
            return bounce_reference(self.scene, params, o, d, thr, strength,
                                    alive, u_coin, u3, in_depth)
        if o.device.type != "cuda":
            raise ValueError(f"bounce kernel: no kernel for {o.device}")
        if packed is None:
            packed = self.pack(params)
        raw = self.launch(packed, o, d, thr, strength, alive, u_coin, u3, in_depth)
        flags, evt = raw.pop("flags"), raw["evt"]
        L = self.layout[0]
        leaf = torch.where(evt >= L, evt - L, evt).to(torch.int64)
        bit = lambda k: ((flags >> k) & 1).to(torch.bool)
        hit = bit(0)
        return dict(raw, hit=hit, entering=bit(1), take_transmit=bit(2),
                    scatter_alive=bit(3), alive2=bit(4),
                    mat_id=torch.where(hit, self.leaf_mat[leaf], 0))

    def launch(self, buf, o, d, thr, strength, alive, u_coin, u3, in_depth):
        """One kernel launch on the current stream, no synchronisation:
        the raw outputs ``t, o2, d2, thr2, strength2, u_sel``, ``evt``
        (int32) and ``flags`` (int32 bits: hit, entering, take_transmit,
        scatter_alive, alive2)."""
        global LAUNCHES
        B = o.shape[0]
        device = buf.device
        _check_inputs("bounce kernel", device, {
            "o": (o, (B, 3), torch.float32), "d": (d, (B, 3), torch.float32),
            "thr": (thr, (B, 3), torch.float32),
            "strength": (strength, (B,), torch.float32),
            "alive": (alive, (B,), torch.bool),
            "u_coin": (u_coin, (B,), torch.float32),
            "u3": (u3, (B, 3), torch.float32)})
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
        p = _ptr
        err = lib.ptx_bounce_forward(
            p(buf), buf.numel(), L, mat_off, tape_off, tape_len,
            p(o), p(d), p(thr), p(strength), p(alive), p(u_coin), p(u3),
            int(bool(in_depth)), B,
            p(t), p(o2), p(d2), p(thr2), p(st2), p(flags), p(evt), p(u_sel),
            _stream(device))
        _raise_on(err, lib, "bounce kernel")
        LAUNCHES += 1
        return {"t": t, "o2": o2, "d2": d2, "thr2": thr2, "strength2": st2,
                "u_sel": u_sel, "evt": evt, "flags": flags}


def bounce_reference(scene, params, o, d, thr, strength, alive, u_coin, u3,
                     in_depth: bool, packed=None):
    """K1's plain PyTorch version, on any device: the dense first hit +
    ``trace._bounce_live``, returning the kernel's output dict (``packed``
    is ignored: the plain version reads ``params``)."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    (o2, d2, thr2, st2, alive2), dec = trace._bounce_live(
        scene.plain_hit_fn, scene.material_fn, params, o, d, thr, strength, alive,
        in_depth, u_coin, u3)
    return dict(dec, o2=o2, d2=d2, thr2=thr2, strength2=st2, alive2=alive2)


# ---------------------------------------------------------------------------
# K2: the replay backward
# ---------------------------------------------------------------------------

_ROW = hitreplay.ROW          # 26 leaf-row columns
_BMAT_STRIDE = 8             # reflect3 scatter_f transmit3 ior
_COLS = _ROW + _BMAT_STRIDE
_MAX_BWD_BLOCKS = 1024       # K2's grid: at most this many blocks of 128 lanes
_MAX_SMEM = 48 * 1024        # dynamic shared memory without opt-in


def pack_bwd(leaf_rows, table, params):
    """K2's scene vector: the (L, 26) hit-replay rows, then per material
    ``reflect₃, mean(scatter), transmit₃, ior`` (``ptx/ops/bounce_kernel.py``
    ``pack_bwd``); ``leaf_rows`` is the scene's
    :class:`~ptx_torch.geom.hitreplay.LeafRows`.  Differentiable: its VJP
    maps the kernel's per-leaf sums back to the params."""
    return torch.cat([leaf_rows(params).reshape(-1),
                      bwd_material_rows(table, params).reshape(-1)])


def bwd_material_rows(table, params):
    """(M, 8) per material ``reflect₃, mean(scatter), transmit₃, ior``: the
    material scalars the replay backward differentiates."""
    const = params["const"]
    idx = {s: torch.as_tensor(table.const_idx[s], device=const.device)
           for s in ("reflect", "scatter", "transmit")}
    return torch.cat([const[idx["reflect"]], mean3(const[idx["scatter"]])[:, None],
                      const[idx["transmit"]], params["ior"][:, None]], dim=1)


def _normalize_cols(x, y, z):
    m2 = x * x + y * y + z * z
    s = torch.sqrt(torch.where(m2 == 0.0, 1.0, m2))
    return x / s, y / s, z / s


def replay_lane_math(row, sph, par, ms, o, d, thr, *, is_start, hit,
                     entering, take_transmit, scatter_alive, u_sel):
    """Per-lane decision-frozen replay: the selected-boundary recompute
    (``hitreplay.recompute_flat``) and the differentiable part of
    ``trace._bounce_replay`` on per-lane columns — the function K2
    differentiates by hand (``csrc/replay_lane.cuh``); port of
    ``ptx/ops/bounce_kernel.py:440``.

    ``row`` (B, 26) and ``ms`` (B, 8) are the lane's leaf row and material
    scalars, ``sph`` / ``par`` its leaf's kind and parity; ``o``, ``d``,
    ``thr``, ``u_sel`` (B, 3); the flags (B,) bool.  Returns ``(o2, d2,
    thr2)``, each (B, 3)."""
    from ptx_torch.core.constants import EPS, MAX_VALUE

    col = lambda a, i: a[:, i]
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    w = [col(row, 5 + i) for i in range(12)]
    nrm = [col(row, 17 + i) for i in range(9)]
    lox = w[0] * ox + w[1] * oy + w[2] * oz + w[3]
    loy = w[4] * ox + w[5] * oy + w[6] * oz + w[7]
    loz = w[8] * ox + w[9] * oy + w[10] * oz + w[11]
    ldx = w[0] * dx + w[1] * dy + w[2] * dz
    ldy = w[4] * dx + w[5] * dy + w[6] * dz
    ldz = w[8] * dx + w[9] * dy + w[10] * dz

    ocx, ocy, ocz = lox - row[:, 0], loy - row[:, 1], loz - row[:, 2]
    r = row[:, 3]
    a = ldx * ldx + ldy * ldy + ldz * ldz
    b = ocx * ldx + ocy * ldy + ocz * ldz
    cc2 = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc_raw = b * b - a * cc2
    sq = torch.sqrt(torch.where(disc_raw > 1e-12, disc_raw, 1.0))
    sa = torch.where(a == 0.0, 1.0, a)
    t_s = torch.where(is_start, (-b - sq) / sa, (-b + sq) / sa)
    inv_r = 1.0 / torch.where(r == 0.0, 1.0, r)
    snx, sny, snz = ((ocx + t_s * ldx) * inv_r, (ocy + t_s * ldy) * inv_r,
                     (ocz + t_s * ldz) * inv_r)

    pn0, pn1, pn2, pd, pim = (row[:, i] for i in range(5))
    divisor = ldx * pn0 + ldy * pn1 + ldz * pn2
    numer = -pd - (lox * pn0 + loy * pn1 + loz * pn2)
    t_p = numer / torch.where(torch.abs(divisor) < EPS * EPS, 1.0, divisor)

    t_sel = torch.where(sph, t_s, t_p)
    nx0 = torch.where(sph, snx, pn0 * pim)
    ny0 = torch.where(sph, sny, pn1 * pim)
    nz0 = torch.where(sph, snz, pn2 * pim)
    t_sel = torch.where(torch.abs(t_sel) >= MAX_VALUE, t_sel.detach(), t_sel)
    wx = nrm[0] * nx0 + nrm[1] * ny0 + nrm[2] * nz0
    wy = nrm[3] * nx0 + nrm[4] * ny0 + nrm[5] * nz0
    wz = nrm[6] * nx0 + nrm[7] * ny0 + nrm[8] * nz0
    mag = torch.sqrt(wx * wx + wy * wy + wz * wz)
    inv = 1.0 / torch.where(mag == 0.0, 1.0, mag)
    sign = par * torch.where(entering, 1.0, -1.0)
    t = torch.where(hit, t_sel, 0.0)
    nx = torch.where(hit, wx * inv * sign, 0.0)
    ny = torch.where(hit, wy * inv * sign, 0.0)
    nz = torch.where(hit, wz * inv * sign, 1.0)     # unit placeholder

    pos = o + t[:, None] * d
    ior = ms[:, 7]
    rel = torch.where(entering, 1.0 / ior, ior)
    nux, nuy, nuz = _normalize_cols(nx, ny, nz)
    ix, iy, iz = _normalize_cols(dx, dy, dz)
    idn = ix * nux + iy * nuy + iz * nuz
    arg = 1.0 - rel * rel * (1.0 - idn * idn)
    rd_ok = ((rel > EPS) & (rel < 1.0 / EPS) & (nx * nx + ny * ny + nz * nz > 0.0)
             & (dx * dx + dy * dy + dz * dz > 0.0) & (arg >= 0.0))
    # the 1e-20 floor, not only the rd_ok guard: rd_ok admits arg == 0
    # (grazing refraction), which filler lanes reach exactly, and
    # sqrt'(0) = inf would NaN d(ior) even under a zero cotangent
    kk = rel * idn + torch.sqrt(torch.where(rd_ok, torch.clamp(arg, min=1e-20), 1.0))
    rd = torch.stack(_normalize_cols(rel * ix - kk * nux, rel * iy - kk * nuy,
                                     rel * iz - kk * nuz), dim=-1)
    rd = torch.where(rd_ok[:, None], rd, 0.0)

    nu = torch.stack([nux, nuy, nuz], dim=-1)
    n = torch.stack([nx, ny, nz], dim=-1)
    two_idn = 2.0 * (dx * nux + dy * nuy + dz * nuz)
    ref = d - two_idn[:, None] * nu
    sc = linalg.clip01(ms[:, 3])
    specular = sc <= EPS
    bias_s = 1.0 / torch.where(specular, 1.0, sc) - 1.0
    sd = torch.stack(_normalize_cols(*(u_sel + bias_s[:, None] * ref).unbind(-1)), -1)
    scd = torch.where(specular[:, None], ref, sd)
    factor = 1.0 - (1.0 - (scd * n).sum(-1)) * sc

    tt = take_transmit[:, None]
    na = (take_transmit | scatter_alive)[:, None]
    nd = torch.where(tt, rd, scd)
    bt = torch.where(tt, ms[:, 4:7], factor[:, None] * ms[:, 0:3])
    return (torch.where(na, pos, o), torch.where(na, nd, d),
            torch.where(na, thr * bt, thr))


def _lane_scene(packed, aux, evt):
    """Per-lane (row (B, 26), ms (B, 8), sph, par, leaf, is_start) from the
    packed vector and the (L, 3) leaf aux (kind, parity, material)."""
    L = aux.shape[0]
    evt = evt.to(torch.int64)
    leaf = torch.where(evt >= L, evt - L, evt)
    rows = packed[:L * _ROW].reshape(L, _ROW)
    mats = packed[L * _ROW:].reshape(-1, _BMAT_STRIDE)
    a = aux[leaf]
    return (rows[leaf], mats[a[:, 2].to(torch.int64)], a[:, 0] != 0, a[:, 1],
            leaf, evt < L)


def bounce_bwd_lanes_reference(packed, aux, o, d, thr, dec, ct_o2, ct_d2, ct_thr2):
    """K2's raw outputs in plain PyTorch: autograd through
    :func:`replay_lane_math`.  Returns ``(d_o, d_d, d_thr, acc, acc_abs)``
    with ``acc`` (L, 34) the per-leaf sums of the lanes' row and material
    cotangents and ``acc_abs`` the same sums of their absolute values (the
    scale a reordered float sum is compared at)."""
    row, ms, sph, par, leaf, is_start = _lane_scene(packed, aux, dec["evt"])
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in (row, ms, o, d, thr)]
        outs = replay_lane_math(
            xs[0], sph, par, xs[1], *xs[2:], is_start=is_start, hit=dec["hit"],
            entering=dec["entering"], take_transmit=dec["take_transmit"],
            scatter_alive=dec["scatter_alive"], u_sel=dec["u_sel"])
        g_row, g_ms, d_o, d_d, d_thr = torch.autograd.grad(
            outs, xs, (ct_o2, ct_d2, ct_thr2))
    lane = torch.cat([g_row, g_ms], dim=1)
    L = aux.shape[0]
    acc = lane.new_zeros((L, _COLS)).index_add_(0, leaf, lane)
    acc_abs = lane.new_zeros((L, _COLS)).index_add_(0, leaf, lane.abs())
    return d_o, d_d, d_thr, acc, acc_abs


def bounce_bwd_reference(scene, params, o, d, thr, dec, ct_o2, ct_d2, ct_thr2):
    """The whole replay backward of a bounce in plain PyTorch, on any
    device: autograd through ``trace._bounce_replay`` (``trace.replay_vjp``).
    Returns ``(d_o, d_d, d_thr, d_params)``, ``d_params`` a dict over
    ``scene.diff_keys``.  The reference K2's route is held against, end to
    end, through the params."""
    global BWD_REFERENCE_CALLS
    BWD_REFERENCE_CALLS += 1
    return trace.replay_vjp(scene, params, o, d, thr, dec, ct_o2, ct_d2, ct_thr2)


def fold_packed(acc, leaf_mat, n_materials):
    """``d_packed`` (L·26 + M·8,) from the (L, 34) per-leaf sums: the leaf
    rows' columns as they are, then per material the sum of its leaves'
    material columns in ascending leaf order (an exact 0 for a material
    without leaves).  The fold K2's second launch does on the card."""
    d_mat = acc.new_zeros((n_materials, _BMAT_STRIDE)).index_add_(0, leaf_mat, acc[:, _ROW:])
    return torch.cat([acc[:, :_ROW].reshape(-1), d_mat.reshape(-1)])


def fold_table(leaf_mat, n_materials):
    """K2's static fold table from the leaves' material ids: ``(start,
    order)``, material m's leaves in ascending order at
    ``order[start[m]:start[m + 1]]``."""
    order = sorted(range(len(leaf_mat)), key=lambda k: (leaf_mat[k], k))
    start = [0]
    for m in range(n_materials):
        start.append(start[-1] + list(leaf_mat).count(m))
    return start, order


def _count_pack_vjp(grad):
    BounceBwdKernel.PACK_VJPS += 1


class BounceBwdKernel:
    """K2 for one compiled scene.

    ``bwd(packed, o, d, thr, dec, ct_o2, ct_d2, ct_thr2)`` → ``(d_o, d_d,
    d_thr, d_packed)``: ``packed`` is :meth:`pack`'s scene vector and
    ``d_packed`` its cotangent from this bounce.  On CUDA that is the input
    checks and one K2 call (:meth:`launch`); on the CPU its plain version
    (:meth:`reference`).  ``trace_rays`` packs once per call with autograd
    history (``takes_packed``), so autograd sums the bounces' ``d_packed``
    and runs the packing's VJP once.  :meth:`params_grad` is that mapping
    for one ``d_packed``.  ``PACKS`` counts :meth:`pack` calls, ``PACK_VJPS``
    the backward passes through a packed vector with history."""

    LAUNCHES = 0
    PACKS = 0
    PACK_VJPS = 0
    takes_packed = True

    def __init__(self, scene):
        self.scene = scene
        self.leaves = collect_leaves(scene.plan)
        self.rows = hitreplay.LeafRows(self.leaves)
        self.n_materials = M = scene.material_fn.n_materials
        self.aux = torch.tensor(
            [[float(lf.kind == "sphere"), p, float(lf.mat_id)] for lf, p in self.leaves],
            dtype=torch.float32, device=scene.device)
        mats = [lf.mat_id for lf, _ in self.leaves]
        self.leaf_mat = torch.tensor(mats, dtype=torch.int64, device=scene.device)
        start, order = fold_table(mats, M)
        self.mat_start = torch.tensor(start, dtype=torch.int32, device=scene.device)
        self.mat_leaves = torch.tensor(order, dtype=torch.int32, device=scene.device)

    def pack(self, params):
        """:func:`pack_bwd` of ``params``, with their autograd history."""
        BounceBwdKernel.PACKS += 1
        packed = pack_bwd(self.rows, self.scene.material_fn, params)
        if packed.requires_grad:
            packed.register_hook(_count_pack_vjp)
        return packed

    def pack_leaves(self, params):
        """``(packed, leaves)``: :meth:`pack` of fresh leaf copies of the
        ``DIFF_KEYS`` tensors, with autograd history from them."""
        with torch.enable_grad():
            leaves = [params[k].detach().requires_grad_(True) for k in trace.DIFF_KEYS]
            return self.pack(dict(params, **dict(zip(trace.DIFF_KEYS, leaves)))), leaves

    def __call__(self, packed, o, d, thr, dec, ct_o2, ct_d2, ct_thr2):
        if o.device.type == "cpu":
            return self.reference(packed, o, d, thr, dec, ct_o2, ct_d2, ct_thr2)
        if o.device.type != "cuda":
            raise ValueError(f"bounce backward kernel: no kernel for {o.device}")
        return self.launch(packed, o, d, thr, dec, ct_o2, ct_d2, ct_thr2)

    def reference(self, packed, o, d, thr, dec, ct_o2, ct_d2, ct_thr2):
        """K2's plain version: :func:`bounce_bwd_lanes_reference`'s per-leaf
        sums, folded by :func:`fold_packed`."""
        global BWD_REFERENCE_CALLS
        BWD_REFERENCE_CALLS += 1
        d_o, d_d, d_thr, acc, _ = bounce_bwd_lanes_reference(
            packed, self.aux, o, d, thr, dec, ct_o2, ct_d2, ct_thr2)
        return d_o, d_d, d_thr, fold_packed(acc, self.leaf_mat, self.n_materials)

    def params_grad(self, packed, leaves, d_packed):
        """``d_params`` (a dict over ``DIFF_KEYS``) from one ``d_packed``:
        autograd of ``packed = pack_bwd(leaves)`` (:meth:`pack_leaves`)."""
        grads = torch.autograd.grad(packed, leaves, d_packed, allow_unused=True)
        return {k: (torch.zeros_like(x) if g is None else g)
                for k, x, g in zip(trace.DIFF_KEYS, leaves, grads)}

    def launch(self, packed, o, d, thr, dec, ct_o2, ct_d2, ct_thr2):
        """One K2 call on the current stream (its two launches), no
        synchronisation: ``(d_o, d_d, d_thr, d_packed)``."""
        B = o.shape[0]
        device = o.device
        L = self.aux.shape[0]
        f3 = lambda x: (x, (B, 3), torch.float32)
        expect = {"o": f3(o), "d": f3(d), "thr": f3(thr), "u_sel": f3(dec["u_sel"]),
                  "ct_o2": f3(ct_o2), "ct_d2": f3(ct_d2), "ct_thr2": f3(ct_thr2),
                  "evt": (dec["evt"], (B,), torch.int32),
                  "packed": (packed, (L * _ROW + self.n_materials * _BMAT_STRIDE,),
                             torch.float32)}
        for k in ("hit", "entering", "take_transmit", "scatter_alive"):
            expect[k] = (dec[k], (B,), torch.bool)
        _check_inputs("bounce backward kernel", device, expect)
        if B == 0:
            raise ValueError("bounce backward kernel: empty wavefront")

        from ptx_torch.ops import _build
        lib = _build.library()
        if lib.ptx_bounce_backward_smem(packed.numel(), L) > _MAX_SMEM:
            raise NotImplementedError(
                f"bounce backward kernel: a scene of {packed.numel()} words "
                "exceeds the kernel's shared memory")
        n_blocks = min(-(-B // 128), _MAX_BWD_BLOCKS)
        empty = lambda *s: torch.empty(s, dtype=torch.float32, device=device)
        d_o, d_d, d_thr = empty(B, 3), empty(B, 3), empty(B, 3)
        partial, d_packed = empty(n_blocks, L * _COLS), empty(packed.numel())
        p = _ptr
        err = lib.ptx_bounce_backward(
            p(packed), packed.numel(), L, p(self.aux), p(o), p(d), p(thr),
            p(dec["evt"]), p(dec["hit"]), p(dec["entering"]),
            p(dec["take_transmit"]), p(dec["scatter_alive"]), p(dec["u_sel"]),
            p(ct_o2), p(ct_d2), p(ct_thr2), B, p(d_o), p(d_d), p(d_thr),
            p(partial), n_blocks, p(self.mat_start), p(self.mat_leaves),
            self.n_materials, p(d_packed), _stream(device))
        _raise_on(err, lib, "bounce backward kernel")
        BounceBwdKernel.LAUNCHES += 1
        return d_o, d_d, d_thr, d_packed
