"""The plain bounce: the scatter samplers, one wavefront bounce in plain
PyTorch (:func:`_bounce_live`), its decision-frozen replay
(:func:`_bounce_replay`) and the replay's VJP, and sky-select.

Port of the shading half of ``ptx/integrate/trace.py``.  These are the
plain versions of the fused bounce kernels: K1's and K5's wrappers run
:func:`_bounce_live` on CPU tensors, K2's plain route is :func:`replay_vjp`,
and the sky bank's plain version ends in :func:`select_add`.  They are also
the bounce of the unfused route, which ``compile_scene``
(:mod:`ptx_torch.integrate.trace`) installs on a scene with a textured
non-emissive slot, under ``PTX_FUSED=0`` or ``PTX_PALLAS=0``, and on a
large scene off K5's fused bounce: :class:`UnfusedBounce` forward,
:class:`ReplayVJP` backward.

Every hit, bounce and backward object a compiled scene holds states what it
packs for a ``trace_rays`` call (``pack(params)``); the two here pack
nothing of their own: :class:`UnfusedBounce` packs its hit's buffer (None
for a plain hit), :class:`ReplayVJP` reads the params.
"""

from __future__ import annotations

import functools
import math

import torch

from ptx_torch.core import linalg, rng
from ptx_torch.core.constants import EPS
from ptx_torch.ops import imagegrad
from ptx_torch.utils import profiling

# The params a bounce is differentiable in: geometry, transforms, constant
# slots and ior.  On a scene with a textured non-emissive slot the replay
# also reads the texture params; otherwise those reach the radiance only
# through emission, which autograd differentiates.
DIFF_KEYS = ("sphere_center", "sphere_radius", "plane_normal", "plane_d",
             "xform", "const", "ior")
TEXTURE_KEYS = ("factor", "tex_xform", "images")


# ---------------------------------------------------------------------------
# scatter direction sampling
# ---------------------------------------------------------------------------

_ONE_THIRD = 1.0 / 3.0
_G1 = 2.0 / 3.0                 # g(1) of the cap-height CDF below
_TWO_PI_THIRDS = 2.0 * math.pi / 3.0
_TWO_PI = 2.0 * math.pi


def sample_scatter_dir(direction, normal, scatter_c, u3):
    """Exact (zero-rejection) reference scatter sampling, driven by three
    uniforms ``u3`` (..., 3) per lane.

    The reference rejection-samples the unit ball until ``u + bias``
    leaves the surface (path-trace.h:138-158); the accepted ``u`` is
    uniform over the ball cap ``{|u| ≤ 1, n̂·u > c}``, drawn here directly:
    the cap height by inverting ``g(z) = z − z³/3`` with the trigonometric
    cubic root, a uniform point on that disk, mapped through the Duff et
    al. 2017 orthonormal frame around ``n̂``.  For ``sc <= EPS`` the mirror
    direction is used.  Returns ``(dir, ok, u)``: ``ok`` is False where the
    cap is empty (the path is abandoned), ``u`` the accepted in-ball draw.
    """
    reflected = linalg.reflect(direction, normal)
    sc = linalg.clip01(scatter_c)
    specular = sc <= EPS
    safe_sc = torch.where(specular, 1.0, sc)
    bias = (1.0 / safe_sc - 1.0)[..., None] * reflected

    m2 = linalg.dot(normal, normal)
    m = torch.sqrt(torch.where(m2 == 0.0, 1.0, m2))
    nhat = normal / m[..., None]
    c = (EPS - linalg.dot(normal, bias)) / m
    feasible = c < 1.0
    cc = torch.clamp(c, -1.0, 1.0)

    g_cc = cc - cc * cc * cc * _ONE_THIRD
    G = g_cc + u3[..., 0] * (_G1 - g_cc)
    arg = torch.clamp(-1.5 * G, -1.0, 1.0)
    z = 2.0 * torch.cos(torch.acos(arg) * _ONE_THIRD - _TWO_PI_THIRDS)
    z = torch.minimum(torch.maximum(z, cc), torch.ones_like(z))
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0) * u3[..., 1])
    phi = _TWO_PI * u3[..., 2]
    x, y = r * torch.cos(phi), r * torch.sin(phi)

    nx, ny, nz = nhat.unbind(-1)
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    e1 = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    e2 = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    # the accepted draw carries no gradient (the JAX sampler stops it): the
    # direction is differentiated through ``bias`` at a fixed ``u``, as
    # the replay (:func:`_bounce_replay`) does from the saved ``u_sel``
    u = (x[..., None] * e1 + y[..., None] * e2 + z[..., None] * nhat).detach()

    out = torch.where(specular[..., None], reflected, linalg.normalize(u + bias))
    return out, specular | feasible, u


SCATTER_TRIES = 32              # the rejection sampler's candidates a lane


def sample_scatter_dir_rejection(key, direction, normal, scatter_c, return_raw=False):
    """The batched-rejection form of the scatter sampler
    (``ptx/integrate/trace.py:378``), the cross-check oracle of
    :func:`sample_scatter_dir`: ``SCATTER_TRIES`` cube draws a lane in
    [-1, 1)³ from ``key`` (the JAX package's draws bit for bit), the first
    one in the ball and above the surface wins (:func:`select_scatter_dir`).
    ``ok`` is False for an abandoned path (the reference's bailout)."""
    u = rng.uniform(key, tuple(direction.shape[:-1]) + (SCATTER_TRIES, 3),
                    direction.device, minval=-1.0, maxval=1.0)
    return select_scatter_dir(u, direction, normal, scatter_c, return_raw=return_raw)


def select_scatter_dir(u, direction, normal, scatter_c, return_raw=False):
    """The selection half of the reference's scatter sampler on pre-drawn
    cube uniforms ``u`` (..., T, 3) (``ptx/integrate/trace.py:395``).  The
    reference consumes one draw stream: its ball sampler skips draws
    outside the unit ball (vector3d.h:173-180) and its accept loop skips
    in-ball draws below the surface (path-trace.h:145-157), so it accepts
    the first draw that is both.  Returns ``(dir, ok)``, and the accepted
    raw draw as well with ``return_raw``; the selection carries no
    gradient, the direction does through the bias."""
    reflected = linalg.reflect(direction, normal)
    sc = linalg.clip01(scatter_c)
    specular = sc <= EPS
    bias = (1.0 / torch.where(specular, 1.0, sc) - 1.0)[..., None] * reflected

    in_ball = linalg.dot(u, u) <= 1.0
    cand = u + bias[..., None, :]
    ok_t = in_ball & (linalg.dot(normal[..., None, :], cand) > EPS)
    first = torch.argmax(ok_t.to(torch.uint8), dim=-1)          # the first True
    pick = lambda a: a.gather(-2, first[..., None, None].expand(
        first.shape + (1, 3)))[..., 0, :]
    out = torch.where(specular[..., None], reflected, linalg.normalize(pick(cand)))
    ok = specular | ok_t.any(dim=-1)
    return (out, ok, pick(u)) if return_raw else (out, ok)


# ---------------------------------------------------------------------------
# one bounce
# ---------------------------------------------------------------------------

def _virtual_fanout(strength, add_factor, sc):
    """The reference's scatter-child count ``int(10000·strength·addFactor·
    sc)``, clamped to ≥ 1 and 1 for specular (path-trace.h:130-136).  Each
    child's strength is divided by it, which ends diffuse chains the way
    the reference does (see the JAX function's docstring)."""
    vcount = torch.floor(10000.0 * strength * add_factor * sc)
    return torch.where((sc <= EPS) | (vcount < 1.0), 1.0, vcount)


def _bounce_live(hit_fn, material_fn, params, o, d, throughput, strength,
                 alive, in_depth: bool, u_coin, u3):
    """One wavefront bounce, plain PyTorch: first hit, material, the
    stochastic branch pick, the scatter draw, carry update.

    ``u_coin`` (B,) and ``u3`` (B, 3) are this bounce's uniforms.  Returns
    ``(carry, decisions)`` with ``carry = (o2, d2, thr2, strength2,
    alive2)`` and the decisions ``evt, hit, entering, mat_id,
    take_transmit, scatter_alive, u_sel, t``.
    """
    hit = hit_fn(params, o, d)
    pos = o + hit["t"][..., None] * d
    m = material_fn(params, pos, hit["mat_id"])

    # continuation gate (path-trace.h:105); the last bounce (in_depth
    # False) only records its hit for emission
    cont = alive & hit["hit"] & in_depth & (strength >= EPS)

    normal = hit["normal"]
    rel_ior = torch.where(hit["entering"], 1.0 / m["ior"], m["ior"])
    trc = linalg.clip01(m["transmit_reflect_f"])
    refract_factor = trc * linalg.refract_strength(d, rel_ior, normal)
    refr_dir = linalg.refract(d, rel_ior, normal)
    refr_ok = (refract_factor > EPS) & (refr_dir != 0.0).any(dim=-1)
    p_transmit = torch.where(refr_ok, refract_factor, 0.0)

    take_transmit = (u_coin < p_transmit) & cont
    add_factor = 1.0 - p_transmit
    # reference: the scatter branch is skipped when addFactor < eps
    scatter_alive = cont & ~take_transmit & (add_factor >= EPS)

    scat_dir, scat_ok, u_sel = sample_scatter_dir(d, normal, m["scatter_f"], u3)
    sc = linalg.clip01(m["scatter_f"])
    factor = 1.0 - (1.0 - linalg.dot(scat_dir, normal)) * sc
    scatter_alive = scatter_alive & scat_ok

    new_alive = take_transmit | scatter_alive
    tt = take_transmit[..., None]
    new_dir = torch.where(tt, refr_dir, scat_dir)
    branch_tint = torch.where(tt, m["transmit"], factor[..., None] * m["reflect"])
    new_throughput = throughput * branch_tint

    # strength: the reference's termination heuristic (path-trace.h:118,162)
    tr_strength = strength * refract_factor * linalg.norm(m["transmit"])
    sc_strength = (strength / _virtual_fanout(strength, add_factor, sc)
                   * add_factor * factor * linalg.norm(m["reflect"]))
    new_strength = torch.where(take_transmit, tr_strength, sc_strength)

    na = new_alive[..., None]
    carry = (torch.where(na, pos, o), torch.where(na, new_dir, d),
             torch.where(na, new_throughput, throughput),
             torch.where(new_alive, new_strength, strength), new_alive)
    decisions = {
        "evt": hit.get("_evt"),         # None for the span hit, which has no event
        "hit": hit["hit"],
        "entering": hit["entering"],
        "mat_id": hit["mat_id"],
        "take_transmit": take_transmit,
        "scatter_alive": scatter_alive,
        "u_sel": u_sel,
        "t": hit["t"],
    }
    return carry, decisions


def _bounce_replay(scene, params, o, d, throughput, dec):
    """Differentiable bounce replay: the math of :func:`_bounce_live` with
    every stochastic draw and discrete selection taken from ``dec``, and
    the first hit collapsed to the selected-boundary recompute
    (``scene.hit_replay_fn``), so no 2L·L candidate fold enters the
    backward.  Returns ``(o2, d2, throughput2)``.  Port of
    ``ptx/integrate/trace.py:594`` without its strength2 output: the
    termination heuristic is comparison-only, so it carries no gradient,
    and the forward carry comes from ``scene.bounce_fn``."""
    t, normal = scene.hit_replay_fn(params, o, d, dec["evt"], dec["entering"],
                                    dec["hit"])
    pos = o + t[..., None] * d
    m = scene.material_fn(params, pos, dec["mat_id"])

    rel_ior = torch.where(dec["entering"], 1.0 / m["ior"], m["ior"])
    refr_dir = linalg.refract(d, rel_ior, normal)
    take_transmit = dec["take_transmit"]

    # the scatter direction from the saved accepted draw u_sel
    reflected = linalg.reflect(d, normal)
    sc = linalg.clip01(m["scatter_f"])
    specular = sc <= EPS
    bias = (1.0 / torch.where(specular, 1.0, sc) - 1.0)[..., None] * reflected
    scat_dir = torch.where(specular[..., None], reflected,
                           linalg.normalize(dec["u_sel"] + bias))
    factor = 1.0 - (1.0 - linalg.dot(scat_dir, normal)) * sc

    new_alive = take_transmit | dec["scatter_alive"]
    tt = take_transmit[..., None]
    new_dir = torch.where(tt, refr_dir, scat_dir)
    branch_tint = torch.where(tt, m["transmit"], factor[..., None] * m["reflect"])
    new_throughput = throughput * branch_tint
    na = new_alive[..., None]
    return (torch.where(na, pos, o), torch.where(na, new_dir, d),
            torch.where(na, new_throughput, throughput))


_DEC_KEYS = ("t", "evt", "hit", "entering", "take_transmit", "scatter_alive",
             "u_sel", "mat_id")


class UnfusedBounce:
    """The bounce of a scene with a textured non-emissive slot, of a large
    scene off K5's fused bounce, or of any scene under ``PTX_FUSED=0`` or
    ``PTX_PALLAS=0``: plain-PyTorch :func:`_bounce_live`
    on ``scene.hit_fn`` (K4, K5's hit mode, or a hit of
    ``compile_fast_hit``, :mod:`ptx_torch.integrate.trace`), the production
    composition, as the JAX package leaves it to XLA.  Returns the dict of
    K1's wrapper; ``packed`` is the hit's scene buffer, which
    ``trace_rays`` packs once per call (:meth:`pack`)."""

    def __init__(self, scene):
        self.scene = scene

    def pack(self, params):
        """The hit's scene buffer (K4's, K5's hit mode's), or None where the
        hit reads the params (a plain hit)."""
        return self.scene.hit_fn.pack(params)

    @profiling.spanned("unfused_bounce")
    def __call__(self, params, o, d, thr, strength, alive, u_coin, u3, in_depth,
                 packed=None):
        profiling.count("unfused_bounces", 1)
        scene = self.scene
        hit_fn = (scene.hit_fn if packed is None
                  else functools.partial(scene.hit_fn, packed=packed))
        (o2, d2, thr2, st2, alive2), dec = _bounce_live(
            hit_fn, scene.material_fn, params, o, d, thr, strength, alive, in_depth,
            u_coin, u3)
        return dict(dec, o2=o2, d2=d2, thr2=thr2, strength2=st2, alive2=alive2)


def _diff_inputs(scene, params):
    """The tensors of ``scene.diff_keys`` in order, list entries (images)
    one by one: the explicit inputs autograd reaches the params through."""
    out = []
    for k in scene.diff_keys:
        v = params[k]
        out += list(v) if isinstance(v, list) else [v]
    return out


def _with_diff(scene, params, flat):
    """``params`` with the ``scene.diff_keys`` entries taken from ``flat``
    (the layout of :func:`_diff_inputs`)."""
    out, i = dict(params), 0
    for k in scene.diff_keys:
        if isinstance(params[k], list):
            out[k] = list(flat[i:i + len(params[k])])
            i += len(params[k])
        else:
            out[k] = flat[i]
            i += 1
    return out


@profiling.spanned("replay_vjp")
def replay_vjp(scene, params, o, d, thr, dec, ct_o2, ct_d2, ct_thr2):
    """The unfused bounce's backward: autograd of :func:`_bounce_replay`
    over ``(o, d, thr)`` and every param of ``scene.diff_keys`` (the JAX
    package's ``jax.vjp`` of ``_bounce_replay`` over the whole params,
    ``ptx/integrate/trace.py:723-732``).  Texture gathers' transposes
    reach K3 / K8, in the span ``tex_hist``.  Returns ``(d_o, d_d, d_thr,
    d_params)``, ``d_params`` a dict over ``scene.diff_keys`` (``images``
    a list)."""
    with torch.enable_grad():
        flat = [x.detach().requires_grad_(True) for x in _diff_inputs(scene, params)]
        xs = [x.detach().requires_grad_(True) for x in (o, d, thr)]
        outs = _bounce_replay(scene, _with_diff(scene, params, flat), *xs, dec)
        with imagegrad.transposes_in("tex_hist"):
            grads = torch.autograd.grad(outs, xs + flat, (ct_o2, ct_d2, ct_thr2),
                                        allow_unused=True)
    d_flat = [torch.zeros_like(x) if g is None else g for x, g in zip(flat, grads[3:])]
    d_params = _with_diff(scene, params, d_flat)
    return (*grads[:3], {k: d_params[k] for k in scene.diff_keys})



def select_add(contrib, params, pos, thr, mid, live, term_chains):
    """Sky-select: ``contrib`` plus, for each terminal chain, its emission
    times the throughput on the first record of a lane with (its material ∧
    live ∧ throughput ≠ 0) — at most one counts, as a terminal material
    zeroes throughput — evaluated on that record only."""
    if term_chains:
        thr_nz = thr.abs().sum(dim=-1) > 0.0
    for mi, fn in term_chains:
        is_sel = live & (mid == mi) & thr_nz                    # (nb, Bp)
        first = torch.argmax(is_sel.to(torch.uint8), dim=0)    # first True
        pick = lambda a: a.gather(0, first[None, :, None].expand(1, -1, 3))[0]
        em = fn(params, pick(pos))
        contrib = contrib + torch.where(is_sel.any(dim=0)[:, None],
                                        pick(thr) * em, 0.0)
    return contrib


class ReplayVJP:
    """The unfused bounce's backward for one compiled scene:
    ``bwd(params, o, d, thr, dec, ct_o2, ct_d2, ct_thr2)`` is
    :func:`replay_vjp` on the scene.  It reads the params, so it packs
    nothing (:meth:`pack` is None) and ``trace_rays`` hands it the params
    of ``scene.diff_keys``."""

    def __init__(self, scene):
        self.scene = scene

    def pack(self, params):
        return None

    def __call__(self, params, o, d, thr, dec, ct_o2, ct_d2, ct_thr2):
        return replay_vjp(self.scene, params, o, d, thr, dec, ct_o2, ct_d2, ct_thr2)
