"""The integrator: scene compilation + the wavefront bounce loop.

Port of the forward of ``ptx/integrate/trace.py``.  The reference's
per-ray recursion (``path-trace.h:59-165``) becomes a loop over bounces
carrying a wavefront ``(origin, dir, throughput, strength, alive)``; at
each hit exactly one continuation is sampled — transmit with probability
``refract_factor``, else scatter — which has the reference's expectation
(see the JAX module's docstring).  ``strength`` threads through as the
reference's termination heuristic, including the virtual fan-out
division.

Emission never feeds the continuation, so each bounce only records
``(pos, throughput, mat_id, live)`` and the radiance of a whole phase is
summed after its bounces: constant emitters by a per-material sum
("mat-sum"), terminal image chains such as the sky on the one lane per
path that reaches them ("sky-select").

Every bounce is one :class:`ManualBounce`, the port of the JAX package's
manual bounce VJP (``_make_manual_bounce``): its forward is
``scene.bounce_fn`` and its backward ``scene.bounce_bwd_fn``, the
decision-frozen replay.  ``compile_scene`` routes as the JAX package's
``_compile_scene_body`` does:

- at most 24 leaves, every non-emissive slot Constant: the fused bounce
  kernels K1 and K2 (:mod:`ptx_torch.ops.bounce_kernel`), one launch each
  per bounce; K2 returns the cotangent of its scene vector, which
  ``trace_rays`` packs once per call, so the params mapping runs once per
  call;
- more than 24 leaves: the hit is :func:`~ptx_torch.geom.fasthit.
  compile_fast_hit`'s — on a union of small groups the sweep, in the mode
  :func:`~ptx_torch.geom.fasthit.resolve_sweep_mode` picks (``mega``: K5 in
  hit mode, :class:`~ptx_torch.geom.fasthit.MegaHit`; ``kernel``: the sweep
  with the sweep-select kernel K9; ``fixpoint``, ``sort``: plain PyTorch),
  else the dense fold (up to 64 leaves) or the candidate-blocked scan.
  With every non-emissive slot Constant the bounce is K5's fused mega
  bounce (:class:`~ptx_torch.geom.fasthit.MegaBounce`) in ``mega`` mode
  unless ``PTX_MEGAB=0``, else :class:`UnfusedBounce` on the hit; the
  backward is the row-fed replay K6 (:mod:`ptx_torch.ops.replay_bwd`) on
  K2's scene vector, packed once per ``trace_rays`` call as for K2;
  ``tile_hint`` orders shallow image batches in 16×32-pixel tiles
  (:func:`trace_rays`).  Examples: the stress scenes,
  ``scenes/composed.json``;
- a textured non-emissive slot (BASELINE config 4): the unfused bounce,
  :class:`UnfusedBounce` — plain-PyTorch :func:`_bounce_live` on the
  hit (K4 up to 24 leaves) — and :func:`replay_vjp`, autograd of
  :func:`_bounce_replay` over every param the replay reads (spans
  ``unfused_bounce``, ``replay_vjp`` ⊃ ``tex_hist``; counter
  ``unfused_bounces``);
- emission: the fused emission kernel K7
  (:mod:`ptx_torch.ops.emission_kernel`) when a dynamic emissive chain is
  not terminal or ``PTX_EMK=1``, else mat-sum + sky-select in plain
  PyTorch.  Image gradients go through the histogram kernels K3 / K8
  (:mod:`ptx_torch.ops.imagegrad`).

Each kernel wrapper runs its plain version on CPU tensors, so the same
routing serves the CPU and the card; no branch of it reads the device.

The JAX package's routing knobs, read by ``compile_scene`` and
``trace_rays`` as it reads them:

- ``compile_scene(pallas=)``, else ``PTX_PALLAS`` ("1" / "0"): False is
  the JAX package's plain route, asked for explicitly: the plain hit
  (:func:`~ptx_torch.geom.fasthit.compile_fast_hit`'s, no K4 or K5), the
  unfused bounce with :func:`replay_vjp`, no K7 and no tile ordering;
  True is the kernel route on a CUDA device (it raises on any other);
  unset, the kernel route, whose wrappers run their plain versions on
  the CPU;
- ``PTX_FUSED=0`` keeps the hit kernel and drops the fused bounce and
  everything that needs it (``want_fused``, ``ptx/integrate/trace.py:185``):
  the unfused bounce with :func:`replay_vjp` (on K4 up to 24 leaves), no
  K6 and no K7;
- ``compile_scene(fast=False)``: no fast hit and no hit replay; the first
  hit is :func:`first_hit` of the span merge (``spans_fn``) and
  ``trace_rays`` differentiates the bounces by plain autograd;
- ``trace_rays(manual_vjp=False)``: plain autograd through
  :func:`_bounce_live` (the default where the scene has no hit replay) on
  whatever hit the scene has: the kernels' hits (K4, K5's hit mode) and
  the sweeps differentiate through their hit replay
  (:class:`~ptx_torch.geom.fasthit.HitReplay`), the dense hit and the
  span merge by autograd; ``trace_rays(remat=)`` (on by default, as in
  JAX) runs each bounce of that route under
  ``torch.utils.checkpoint``: the backward recomputes the bounce from its
  inputs, so a bounce keeps its inputs in place of its intermediates.
  The draws are functions of the key, so the recompute is bit-identical.
  ``remat`` changes nothing under the manual VJP, as in JAX;
  ``trace_rays(skysel=)``, else ``PTX_SKYSEL`` (on unless "0").
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any, Callable

import torch
import torch.utils.checkpoint

from ptx_torch.core import linalg, rng
from ptx_torch.core.constants import DEFAULT_RAY_DEPTH, EPS, MAX_VALUE
from ptx_torch.geom import hitreplay, tape
from ptx_torch.geom.fasthit import collect_leaves, compile_fast_hit
from ptx_torch.shade import materials as mats
from ptx_torch.shade import textures as tx
from ptx_torch.utils import profiling

# The hit kernels' limit: at most 24 leaves (48 candidates fit one 64-bit
# mask).  K1 also needs every non-emissive slot Constant (it reads material
# scalars from its scene buffer; emission is evaluated after the bounces),
# the JAX package's fused-bounce eligibility (ptx/integrate/trace.py:187-190).
KERNEL_MAX_LEAVES = 24
TILE_ORDERED = 0            # trace_rays calls that took the tile ordering
_NON_EMISSIVE = ("reflect", "scatter", "transmit", "transmit_reflect")

# The params a bounce is differentiable in: geometry, transforms, constant
# slots and ior.  On a scene with a textured non-emissive slot the replay
# also reads the texture params; otherwise those reach the radiance only
# through emission, which autograd differentiates.
DIFF_KEYS = ("sphere_center", "sphere_radius", "plane_normal", "plane_d",
             "xform", "const", "ior")
TEXTURE_KEYS = ("factor", "tex_xform", "images")


@dataclasses.dataclass(eq=False)
class CompiledScene:
    """A scene lowered to tensors + callables on one device.

    ``bounce_fn`` is the one bounce every wavefront step calls and
    ``bounce_bwd_fn`` its replay backward (module docstring).  ``hit_fn``
    is K4's wrapper for scenes of at most 24 leaves, ``plain_hit_fn`` the
    dense first hit (K4's and K1's plain versions read it).
    ``emission_fn`` is K7's wrapper or None; ``diff_keys`` the params
    ``ManualBounce`` passes to autograd; ``tile_hint`` (large scenes)
    turns on :func:`trace_rays`'s tile ordering.  Above 24 leaves
    ``plain_hit_fn`` is :func:`~ptx_torch.geom.fasthit.compile_fast_hit`'s
    hit and ``hit_fn`` K5's hit mode on it in ``mega`` mode, else that hit
    itself.  ``spans_fn`` is the span-merge evaluator
    (:func:`~ptx_torch.geom.tape.span_evaluator`); with ``fast=False``
    ``hit_fn``, ``hit_replay_fn`` and the bounces are None and the hit is
    ``first_hit(spans_fn(params, o, d))``."""
    params: dict
    plan: Any
    material_fn: mats.MaterialTable
    device: torch.device
    spans_fn: Callable          # (params, origin, dir) -> SpanList
    hit_fn: Callable = None     # (params, origin, dir) -> first-hit dict
    hit_replay_fn: Callable = None   # (params, o, d, evt, entering, hit) -> (t, normal)
    plain_hit_fn: Callable = None
    bounce_fn: Callable = None
    bounce_bwd_fn: Callable = None
    emission_fn: Callable = None
    diff_keys: tuple = DIFF_KEYS
    tile_hint: bool = False


def _want_emission_kernel(ordered, table) -> bool:
    """The JAX package's policy (ptx/integrate/trace.py:220-245): K7 when a
    dynamic emissive chain is not terminal; not when every one is (the sky
    enclosure: sky-select evaluates the chain on one lane per path);
    ``PTX_EMK=1`` forces it on, ``PTX_EMK=0`` off."""
    env = os.environ.get("PTX_EMK")
    if env is not None:
        return env == "1"
    term = {mi for mi, m in enumerate(ordered)
            if mats._const_zero(m.reflect) and mats._const_zero(m.transmit)}
    dyn = set(table.dynamic_slots["emissive"])
    return not (dyn and dyn <= term)


def _resolve_pallas(pallas, device) -> bool:
    """``pallas``, else ``PTX_PALLAS`` ("1" / "0"), else None (the default
    route); True needs a CUDA device."""
    if pallas is None and os.environ.get("PTX_PALLAS") is not None:
        pallas = os.environ["PTX_PALLAS"] == "1"
    if pallas and device.type != "cuda":
        raise ValueError(f"compile_scene(pallas=True) (or PTX_PALLAS=1) asks for the "
                         f"kernels, and no kernel runs on {device}")
    return pallas


def compile_scene(root, device, fast: bool = True, pallas: bool | None = None) -> CompiledScene:
    """Compile a scene tree for ``device`` (routing and the knobs ``fast``,
    ``pallas`` / ``PTX_PALLAS``, ``PTX_FUSED``: module docstring).  On a
    CUDA device every kernel wrapper launches its kernel or raises; there
    is no quiet fallback to a plain path."""
    from ptx_torch.geom.fasthit import MegaHit, SweepHit, compile_mega_bounce
    from ptx_torch.ops import emission_kernel
    from ptx_torch.ops.bounce_kernel import BounceBwdKernel, BounceKernel
    from ptx_torch.ops.fasthit_kernel import HitKernel
    from ptx_torch.ops.replay_bwd import RowFedReplayBwd

    device = torch.device(device)
    kernels = _resolve_pallas(pallas, device) is not False
    # the JAX want_fused (ptx/integrate/trace.py:185-186): the fused bounce,
    # K6 and K7 ride the kernel route unless PTX_FUSED=0
    fused = fast and kernels and os.environ.get("PTX_FUSED") != "0"
    cpu = torch.device("cpu")
    ordered, mat_ids = mats.assign_material_ids(root)
    geo_params, plan = tape.compile_geometry(root, mat_ids, cpu)
    compiler = tx.TextureCompiler()
    mat_params, table = mats.compile_material_table(ordered, compiler, cpu)
    n_leaves = len(collect_leaves(plan))
    small = n_leaves <= KERNEL_MAX_LEAVES
    dynamic = any(table.dynamic_slots[s] for s in _NON_EMISSIVE)
    params = dict(geo_params)
    params.update(mat_params)
    params.update(compiler.finalize(cpu))
    plain_hit = compile_fast_hit(plan, params) if fast else None
    mega = isinstance(plain_hit, SweepHit)
    params = {k: ([x.to(device) for x in v] if isinstance(v, list)
                  else v.to(device)) for k, v in params.items()}
    scene = CompiledScene(params=params, plan=plan, material_fn=table, device=device,
                          spans_fn=tape.span_evaluator(plan), plain_hit_fn=plain_hit,
                          tile_hint=fast and kernels and not small)
    if not fast:
        return scene
    if kernels and small:
        scene.hit_fn = HitKernel(plan, plain_hit, params)
    elif kernels and mega:
        scene.hit_fn = MegaHit(plain_hit)
    else:
        scene.hit_fn = plain_hit
    scene.hit_replay_fn = hitreplay.build_hit_replay(collect_leaves(plan))
    if dynamic or not fused:
        if dynamic:
            scene.diff_keys = DIFF_KEYS + TEXTURE_KEYS
        scene.bounce_fn = UnfusedBounce(scene)
        scene.bounce_bwd_fn = functools.partial(replay_vjp, scene)
    elif small:
        scene.bounce_fn, scene.bounce_bwd_fn = (BounceKernel(scene),
                                                BounceBwdKernel(scene))
    else:
        # PTX_MEGAB=0 keeps the unfused bounce on K5's hit mode
        # (ptx/integrate/trace.py:216)
        megab = mega and os.environ.get("PTX_MEGAB") != "0"
        scene.bounce_fn = compile_mega_bounce(scene) if megab else UnfusedBounce(scene)
        scene.bounce_bwd_fn = RowFedReplayBwd(scene)
    if fused and _want_emission_kernel(ordered, table) and emission_kernel.supported(table):
        scene.emission_fn = emission_kernel.EmissionKernel(table, device)
    return scene


# ---------------------------------------------------------------------------
# first hit of a span list
# ---------------------------------------------------------------------------

def first_hit(sl):
    """Resolve the span walk of path-trace.h:66-99 in one pass
    (``ptx/integrate/trace.py:260``).  Per span, in list order, the first
    of: ``t0 >= MAX_VALUE`` (escaped), ``t0 >= EPS`` (entry boundary),
    ``t1 >= MAX_VALUE`` (escaped), ``t1 >= EPS`` (exit boundary, normal
    negated); no span triggering is a miss.  Returns ``t`` (0 unless
    hit), ``normal``, ``mat_id`` (int64, 0 unless hit), ``entering`` and
    ``hit`` (False on a miss and on an escape)."""
    c1 = sl.t0 >= MAX_VALUE
    c2 = sl.t0 >= EPS
    c3 = sl.t1 >= MAX_VALUE
    c4 = sl.t1 >= EPS
    trigger = sl.valid & (c1 | c2 | c3 | c4)
    idx = torch.argmax(trigger.to(torch.uint8), dim=-1, keepdim=True)   # first trigger
    take = lambda a: a.gather(-1, idx)[..., 0]
    take3 = lambda a: a.gather(-2, idx[..., None].expand(idx.shape + (3,)))[..., 0, :]
    s_c1, s_c2, s_c3 = take(c1), take(c2), take(c3)
    escaped = s_c1 | (~s_c2 & s_c3)
    entering = ~s_c1 & s_c2
    hit = trigger.any(dim=-1) & ~escaped
    t = torch.where(entering, take(sl.t0), take(sl.t1))
    return {
        "t": torch.where(hit, t, 0.0),
        "normal": torch.where(entering[..., None], take3(sl.n0), -take3(sl.n1)),
        "mat_id": torch.where(hit, torch.where(entering, take(sl.m0), take(sl.m1)), 0),
        "entering": entering,
        "hit": hit,
    }


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


def _bounce_replay(scene: CompiledScene, params, o, d, throughput, dec):
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
    :func:`~ptx_torch.geom.fasthit.compile_fast_hit`), the production
    composition, as the JAX package leaves it to XLA.  Returns the dict of
    K1's wrapper; ``packed`` is the hit kernel's scene buffer, which
    ``trace_rays`` packs once per call (:meth:`pack`; None for a hit
    without one)."""

    def __init__(self, scene):
        self.scene = scene

    def pack(self, params):
        pack = getattr(self.scene.hit_fn, "pack", None)
        return pack(params) if pack is not None else None

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
    from ptx_torch.ops import imagegrad

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


def _takes_packed(scene):
    """Whether the scene's replay backward takes its packed scene vector
    (K2 and K6: ``BounceBwdKernel.takes_packed``) instead of the params."""
    return getattr(scene.bounce_bwd_fn, "takes_packed", False)


class ManualBounce(torch.autograd.Function):
    """One bounce with a decision-frozen replay backward (port of
    ``_make_manual_bounce``, ``ptx/integrate/trace.py:660``).

    ``apply(scene, params, packed, in_depth, o, d, thr, strength, alive,
    u_coin, u3, *diff)`` returns ``(o2, d2, thr2, strength2, alive2)`` and
    then the decisions ``_DEC_KEYS``.  The forward is ``scene.bounce_fn``
    (with the scene buffer ``packed``); it saves the carry and the
    decisions, not the uniforms (the replay reads the accepted draw
    ``u_sel``).  The backward is ``scene.bounce_bwd_fn`` on the cotangents
    of o2, d2 and thr2.  strength2, alive2 and the decisions are not
    differentiable.  ``diff`` are the scene inputs autograd reaches the
    params through: where the backward takes the packed scene vector (K2, K6,
    :func:`_takes_packed`), that one vector, packed once per ``trace_rays``
    call (None when no param needs a gradient), and the backward returns
    its cotangent; else ``_diff_inputs(scene, params)``, and the backward
    returns their cotangents."""

    @staticmethod
    def forward(ctx, scene, params, packed, in_depth, o, d, thr, strength, alive,
                u_coin, u3, *diff):
        kb = scene.bounce_fn(params, o, d, thr, strength, alive, u_coin, u3,
                             in_depth, packed=packed)
        dec = tuple(kb[k] for k in _DEC_KEYS)
        ctx.scene, ctx.params = scene, params
        ctx.save_for_backward(o, d, thr, *dec[1:], *diff)
        outs = (kb["o2"], kb["d2"], kb["thr2"], kb["strength2"], kb["alive2"]) + dec
        ctx.mark_non_differentiable(*outs[3:])
        return outs

    @staticmethod
    def backward(ctx, ct_o2, ct_d2, ct_thr2, *_):
        o, d, thr, *rest = ctx.saved_tensors
        n_dec = len(_DEC_KEYS) - 1
        dec = dict(zip(_DEC_KEYS[1:], rest[:n_dec]))
        scene = ctx.scene
        cts = (ct_o2.contiguous(), ct_d2.contiguous(), ct_thr2.contiguous())
        if _takes_packed(scene):
            packed = rest[n_dec]        # None: only the rays need a gradient
            vec = scene.bounce_bwd_fn.pack(ctx.params) if packed is None else packed
            d_o, d_d, d_thr, d_packed = scene.bounce_bwd_fn(vec.detach(), o, d, thr,
                                                            dec, *cts)
            return ((None,) * 4 + (d_o, d_d, d_thr) + (None,) * 4
                    + (None if packed is None else d_packed,))
        params = _with_diff(scene, ctx.params, rest[n_dec:])
        d_o, d_d, d_thr, d_params = scene.bounce_bwd_fn(params, o, d, thr, dec, *cts)
        return ((None,) * 4 + (d_o, d_d, d_thr) + (None,) * 4
                + tuple(_diff_inputs(scene, d_params)))


@profiling.spanned("replay_pack", backward="replay_pack_bwd")
def _replay_pack(scene, params):
    """The replay backward's packed scene vector for one ``trace_rays``
    call, with autograd history from ``params``, or None where the backward
    takes the params or no param needs a gradient."""
    if not (_takes_packed(scene) and torch.is_grad_enabled()
            and any(x.requires_grad for x in _diff_inputs(scene, params))):
        return None
    return scene.bounce_bwd_fn.pack(params)


@profiling.spanned("bounce", backward="bounce_bwd")
def _bounce(scene: CompiledScene, params, packed, packed_bwd, carry, in_depth, u_coin,
            u3):
    diff = (packed_bwd,) if _takes_packed(scene) else _diff_inputs(scene, params)
    outs = ManualBounce.apply(scene, params, packed, in_depth, *carry, u_coin, u3, *diff)
    return outs[:5], dict(zip(_DEC_KEYS, outs[5:]))


# ---------------------------------------------------------------------------
# dead-lane compaction
# ---------------------------------------------------------------------------

@profiling.spanned("compaction", backward="compaction_bwd")
def _compact_wavefront(carry, orig, cap: int, key=None, bounces: int = 1):
    """Pack live lanes into a ``cap``-wide wavefront.

    Live lanes go to the front in lane order.  If more than ``cap`` are
    alive, systematic resampling keeps exactly ``cap`` of them, evenly
    spaced with a random phase offset drawn from ``key``, and boosts their
    throughput by ``n/cap`` (unbiased; the offset keeps it unbiased per
    pixel — see the JAX function's docstring for the stripes it fixed).
    Tail rows past the kept count are dead fillers with ``orig`` set to a
    sentinel ≥ the original width.  ``orig`` maps lanes to the original
    wavefront (int64; the JAX version bitcasts it through f32).  ``bounces``:
    the bounces the new wavefront is traced through, the weight of its
    filler rows in :func:`~ptx_torch.utils.profiling.count_fillers`."""
    o, d, throughput, strength, alive = carry
    alive_i = alive.to(torch.int64)
    n = alive_i.sum()
    profiling.count_fillers(cap, bounces, n)
    n_safe = torch.clamp(n, min=1)
    ncap = torch.clamp(n_safe, max=cap)
    ranks = torch.cumsum(alive_i, dim=0)             # 1-based among alive
    if key is not None:
        u = rng.uniform(key, (), o.device)
        off = torch.floor(u * n_safe.to(torch.float32)).to(torch.int64)
        off = torch.minimum(torch.clamp(off, min=0), n_safe - 1)
    else:
        off = torch.zeros((), dtype=torch.int64, device=o.device)
    lo = torch.div((ranks - 1) * ncap + off, n_safe, rounding_mode="floor")
    hi = torch.div(ranks * ncap + off, n_safe, rounding_mode="floor")
    keep = alive & (hi > lo)                         # exactly min(n, cap)
    w = torch.where(n > cap, n_safe.to(torch.float32) / cap, 1.0)

    # kept lanes first, in lane order; the tail holds dropped lanes
    src = torch.argsort((~keep).to(torch.uint8), stable=True)[:cap]
    new_alive = (torch.arange(cap, device=o.device) < ncap) & alive[src]
    dz = torch.where(new_alive, 0.0, -1.0)           # fillers get a safe dir
    d2 = d[src]
    new_carry = (
        o[src],
        torch.stack([d2[:, 0], d2[:, 1], d2[:, 2] + dz], dim=-1),
        torch.where(new_alive[:, None], (throughput * w)[src], 0.0),
        torch.where(new_alive, strength[src], 0.0),
        new_alive,
    )
    sentinel = torch.iinfo(torch.int64).max
    return new_carry, torch.where(new_alive, orig[src], sentinel)


# Compaction schedule (start_bounce, width_divisor) and the batch size
# from which it is on: the JAX package's tuned defaults
# (ptx/integrate/trace.py:864-874).
_COMPACT_SCHEDULE = ((2, 3), (6, 16))
_COMPACT_MIN_BATCH = 16384


# ---------------------------------------------------------------------------
# trace_rays (forward)
# ---------------------------------------------------------------------------

@profiling.spanned("rng_draws")
def _phase_uniforms(key, start, end, width, device):
    """All of a phase's bounce uniforms in two batched draws — the values
    each bounce b would draw itself: ``u_coin = uniform(fold(key, b, 1),
    (width,))`` and ``u3 = uniform(fold(key, b, 2), (width, 3))``."""
    kbs = [rng.fold(key, b) for b in range(start, end)]
    u_coins = rng.uniform_many([rng.fold(k, 1) for k in kbs], (width,), device)
    u3s = rng.uniform_many([rng.fold(k, 2) for k in kbs], (width, 3), device)
    return u_coins, u3s


def _autograd_hit(scene, params, device):
    """The first hit plain autograd differentiates: the span merge where
    the scene has no fast hit, else ``scene.hit_fn`` — on a CUDA device a
    kernel's wrapper (K4, K5's hit mode) reads its scene buffer, packed
    here once for all bounces of the call."""
    if scene.hit_fn is None:
        return lambda params, o, d: first_hit(scene.spans_fn(params, o, d))
    pack = getattr(scene.hit_fn, "pack", None)
    if pack is None or device.type != "cuda":
        return scene.hit_fn
    return functools.partial(scene.hit_fn, packed=pack(params))


@profiling.spanned("trace_rays")
def trace_rays(scene: CompiledScene, params, origin, direction, key,
               depth: int = DEFAULT_RAY_DEPTH, compact: bool | None = None,
               skysel: bool | None = None, manual_vjp: bool | None = None,
               remat: bool = True):
    """Trace a wavefront of rays to radiance estimates ``(..., 3)``.

    One stochastic path per ray, up to ``depth`` bounces plus the primary
    hit.  ``key`` is a :mod:`ptx_torch.core.rng` key; draws match the JAX
    package's ``trace_rays`` bit for bit.

    ``compact``: dead-lane compaction between bounce phases; default on
    for flat batches of at least 16384 rays at depth ≥ 8.  ``skysel``:
    evaluate terminal dynamic-emissive chains (the sky) on one selected
    lane per path (exact; see :func:`_emission`); off when the scene has
    the emission kernel K7; default ``PTX_SKYSEL`` (on unless "0"), read
    at each call.  ``manual_vjp``: each bounce a :class:`ManualBounce`
    (the decision-frozen replay backward); False differentiates
    :func:`_bounce_live` by plain autograd (:func:`_autograd_hit`);
    default True where the scene has a fast hit and its replay
    (``ptx/integrate/trace.py:941-942``).  ``remat``: under
    ``manual_vjp=False``, each bounce runs under
    ``torch.utils.checkpoint`` and its backward recomputes it (the JAX
    ``jax.checkpoint`` of the bounce, ``trace.py:1000-1001``); no effect
    under the manual VJP.
    """
    if skysel is None:
        skysel = os.environ.get("PTX_SKYSEL", "1") != "0"
    if manual_vjp is None:
        manual_vjp = scene.hit_fn is not None and scene.hit_replay_fn is not None
    if manual_vjp and scene.hit_replay_fn is None:
        raise ValueError("trace_rays(manual_vjp=True) needs the hit replay, and a scene "
                         "compiled with fast=False has none")
    batch_shape = origin.shape[:-1]
    origin = origin.reshape(-1, 3)
    direction = direction.reshape(-1, 3)
    B = origin.shape[0]
    # Large-scene tile ordering (``trace.py:914-940``): a shallow (…, rows,
    # W) batch is permuted so that consecutive lanes form 16×32-pixel image
    # tiles, which keeps a cull group's rays together; the radiance is
    # permuted back.  Which lane draws which random numbers changes, so
    # the estimate changes on this path, as in the JAX package.
    tile_inv = None
    if (scene.tile_hint and depth <= 8 and len(batch_shape) >= 2
            and batch_shape[-2] % 16 == 0 and batch_shape[-1] % 32 == 0):
        rows_t, w_t = batch_shape[-2], batch_shape[-1]
        perm = torch.arange(B, device=origin.device).reshape(
            -1, rows_t // 16, 16, w_t // 32, 32).permute(0, 1, 3, 2, 4).reshape(-1)
        tile_inv = torch.argsort(perm)
        origin, direction = origin[perm], direction[perm]
        global TILE_ORDERED
        TILE_ORDERED += 1
    device = origin.device
    carry = (origin, direction,
             torch.ones((B, 3), dtype=torch.float32, device=device),
             torch.ones((B,), dtype=torch.float32, device=device),
             torch.ones((B,), dtype=torch.bool, device=device))

    if compact is None:
        compact = B >= _COMPACT_MIN_BATCH and depth >= 8
    phases = [(0, 1)]
    if compact:
        phases += [(s, dv) for s, dv in _COMPACT_SCHEDULE
                   if s <= depth and B // dv >= 1]

    # K1's, K4's or K5's scene buffer, packed once for all bounces of this
    # call (the plain versions on the CPU read params themselves; a hit
    # without a kernel buffer packs None)
    pack = getattr(scene.bounce_fn, "pack", None) if manual_vjp else None
    with profiling.span("scene_pack"):
        packed = pack(params) if pack is not None and device.type == "cuda" else None
    # K2's and K6's scene vector, packed once per call on every device with
    # autograd history: each bounce's backward returns its cotangent,
    # autograd sums them and runs the packing's VJP once
    packed_bwd = _replay_pack(scene, params) if manual_vjp else None
    if not manual_vjp:
        bounce_live = functools.partial(_bounce_live, _autograd_hit(scene, params, device),
                                        scene.material_fn, params)
        if remat and torch.is_grad_enabled():
            bounce_live = functools.partial(torch.utils.checkpoint.checkpoint, bounce_live,
                                            use_reentrant=False, preserve_rng_state=False)
    orig = torch.arange(B, dtype=torch.int64, device=device)
    saved = []                  # per phase: (pos, thr, mat_id, live, orig)
    for pi, (start, div) in enumerate(phases):
        end = phases[pi + 1][0] if pi + 1 < len(phases) else depth + 1
        if pi > 0:
            carry, orig = _compact_wavefront(carry, orig, B // div,
                                             key=rng.fold(key, 0x00C0, pi),
                                             bounces=end - start)
        profiling.count("lane_bounces", B // div * (end - start))
        u_coins, u3s = _phase_uniforms(key, start, end, B // div, device)
        rows = []
        for b in range(start, end):
            o, d, thr, _, alive = carry
            if manual_vjp:
                carry, dec = _bounce(scene, params, packed, packed_bwd, carry, b < depth,
                                     u_coins[b - start], u3s[b - start])
            else:
                (o2, d2, thr2, st2, alive2), dec = bounce_live(
                    *carry, b < depth, u_coins[b - start], u3s[b - start])
                # strength only feeds comparisons: no gradient (JAX stops it)
                carry = (o2, d2, thr2, st2.detach(), alive2)
            # the emission record: hit position (no gradient: emission is
            # piecewise constant in it through nearest-texel gathers), the
            # bounce's input throughput (its cotangent reaches thr
            # directly), its material, and whether the lane hit live
            rows.append(((o + dec["t"][:, None] * d).detach(), thr,
                         dec["mat_id"], alive & dec["hit"]))
        pos, thr, mid, live = (torch.stack(x) for x in zip(*rows))
        saved.append((pos, thr, mid, live, orig))

    radiance = torch.zeros((B, 3), dtype=torch.float32, device=device)
    for pi, ((*_, orig), contrib) in enumerate(zip(saved, _emission(scene, params,
                                                                    saved, skysel))):
        if pi == 0:
            radiance = radiance + contrib
        else:
            # kept lanes have distinct orig; filler rows add exact zeros
            valid = orig < B
            radiance.index_add_(0, torch.where(valid, orig, B - 1),
                                torch.where(valid[:, None], contrib, 0.0))
    if tile_inv is not None:
        radiance = radiance[tile_inv]
    return radiance.reshape(batch_shape + (3,))


@profiling.spanned("emission", backward="emission_bwd")
def _emission(scene, params, saved, skysel):
    """Radiance each phase banks per lane, from its (nb, Bp) bounce records
    ``saved[pi] = (pos, thr, mid, live, orig)`` (``trace.py:1098-1227``):

    - mat-sum (every dynamic emitter is terminal and handled by
      sky-select): emission is a constant per material, so sum the live
      throughput per material and multiply by that material's emissive row
      once;
    - otherwise evaluate the emissive slot once, on all phases' records
      concatenated in phase order: K7 when the scene has it (one launch per
      ``trace_rays`` call), else the material table;
    - sky-select (off with K7): a terminal material zeroes throughput, so at
      most one record per lane has (terminal material ∧ throughput ≠ 0); its
      chain is evaluated on that record only (first such bounce), phase by
      phase.
    """
    table = scene.material_fn
    term_chains = (table.terminal_dynamic_emissive
                   if skysel and scene.emission_fn is None else [])
    term_mis = {mi for mi, _ in term_chains}
    mat_sum = bool(term_chains) and set(table.dynamic_slots["emissive"]) <= term_mis
    ems = None
    if not mat_sum:
        em_eval = scene.emission_fn or (table.eval_emissive_base if term_chains
                                        else table.eval_emissive)
        em = em_eval(params, torch.cat([p.reshape(-1, 3) for p, *_ in saved]),
                     torch.cat([m.reshape(-1) for _, _, m, *_ in saved]))
        ems = em.split([m.numel() for _, _, m, *_ in saved])
    out = []
    for pi, (pos, thr, mid, live, _) in enumerate(saved):
        if mat_sum:
            em_rows = params["const"][table.const_rows("emissive", thr.device)]
            contrib = torch.zeros(thr.shape[1:], dtype=torch.float32,
                                  device=thr.device)
            for m in range(table.n_materials):
                if m in term_mis:
                    continue
                wsum = torch.where((live & (mid == m))[..., None], thr, 0.0).sum(dim=0)
                contrib = contrib + wsum * em_rows[m]
        else:
            em = ems[pi].reshape(thr.shape)
            contrib = torch.where(live[..., None], thr * em, 0.0).sum(dim=0)

        if term_chains:         # sky-select only (not with K7, nor with skysel off)
            thr_nz = thr.abs().sum(dim=-1) > 0.0
        for mi, fn in term_chains:
            is_sel = live & (mid == mi) & thr_nz                    # (nb, Bp)
            first = torch.argmax(is_sel.to(torch.uint8), dim=0)    # first True
            pick = lambda a: a.gather(0, first[None, :, None].expand(1, -1, 3))[0]
            em = fn(params, pick(pos))
            contrib = contrib + torch.where(is_sel.any(dim=0)[:, None],
                                            pick(thr) * em, 0.0)
        out.append(contrib)
    return out
