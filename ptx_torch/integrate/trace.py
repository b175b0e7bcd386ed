"""The integrator: scene compilation, its routing + the wavefront bounce
loop.

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
decision-frozen replay.  Every routing decision sits here:
``compile_scene`` routes as the JAX package's ``_compile_scene_body``
does, and :func:`compile_fast_hit` picks the plain hit:

- at most 24 leaves, every non-emissive slot Constant: the fused bounce
  kernels K1 and K2 (:mod:`ptx_torch.ops.bounce_kernel`), one launch each
  per bounce; K2 returns the cotangent of its scene vector, which
  ``trace_rays`` packs once per call, so the params mapping runs once per
  call;
- more than 24 leaves: the hit is :func:`compile_fast_hit`'s — on a union
  of small groups the sweep, in the mode :func:`resolve_sweep_mode` picks
  (``mega``: K5 in hit mode, :class:`~ptx_torch.ops.megasweep.MegaHit`;
  ``kernel``: the sweep with the sweep-select kernel K9; ``fixpoint``,
  ``sort``: plain PyTorch), else the dense fold (up to 64 leaves) or the
  candidate-blocked scan.  With every non-emissive slot Constant the
  bounce is K5's fused mega bounce
  (:class:`~ptx_torch.ops.megasweep.MegaBounce`) in ``mega`` mode unless
  ``PTX_MEGAB=0``, else the unfused bounce on the hit; the backward is
  the row-fed replay K6 (:mod:`ptx_torch.ops.replay_bwd`) on K2's scene
  vector, packed once per ``trace_rays`` call as for K2; ``tile_hint``
  orders shallow image batches in 16×32-pixel tiles (:func:`trace_rays`).
  Examples: the stress scenes, ``scenes/composed.json``;
- a textured non-emissive slot (BASELINE config 4): the unfused bounce
  of :mod:`ptx_torch.shade.bounce`, ``UnfusedBounce`` — plain-PyTorch
  ``_bounce_live`` on the hit (K4 up to 24 leaves) — and ``ReplayVJP``,
  autograd of ``_bounce_replay`` over every param the replay reads (spans
  ``unfused_bounce``, ``replay_vjp`` ⊃ ``tex_hist``; counter
  ``unfused_bounces``);
- emission: the fused emission kernel K7
  (:mod:`ptx_torch.ops.emission_kernel`) when a dynamic emissive chain is
  not terminal or ``PTX_EMK=1``, else mat-sum + sky-select: the sky bank
  (:mod:`ptx_torch.ops.sky_bank`, one kernel pair) where the scene's one
  dynamic emitter is a terminal chain K7's map takes (the demo's and
  config 4's skies), else plain PyTorch.  Image gradients go through the
  histogram kernels K3 / K8 (:mod:`ptx_torch.ops.imagegrad`) or the sky
  bank's backward.

Each kernel wrapper runs its plain version on CPU tensors, so the same
routing serves the CPU and the card; no branch of it reads the device.

The scene buffers: every hit, bounce and backward object that
``compile_scene`` installs has ``pack(params)``, what it reads for one
``trace_rays`` call, and ``trace_rays`` calls it once per call:

- ``scene.bounce_fn.pack``: K1's buffer, K5's scene, or (the unfused
  bounce) its hit's: K4's buffer, K5's hit-mode scene, or None for a
  plain hit, which reads the params; without autograd history.  A
  wrapper's plain version, on CPU tensors, reads the params and ignores
  the buffer;
- ``scene.bounce_bwd_fn.pack``: K2's and K6's scene vector, with autograd
  history, on every device (their plain versions read it too); None for
  the unfused bounce's ``ReplayVJP``, which reads the params.

The JAX package's routing knobs, read by ``compile_scene`` and
``trace_rays`` as it reads them:

- ``compile_scene(pallas=)``, else ``PTX_PALLAS`` ("1" / "0"): False is
  the JAX package's plain route, asked for explicitly: the plain hit
  (:func:`compile_fast_hit`'s, no K4 or K5), the unfused bounce with its
  replay VJP, no K7 and no tile ordering; True is the kernel route on a
  CUDA device (it raises on any other); unset, the kernel route, whose
  wrappers run their plain versions on the CPU;
- ``PTX_FUSED=0`` keeps the hit kernel and drops the fused bounce and
  everything that needs it (``want_fused``, ``ptx/integrate/trace.py:185``):
  the unfused bounce with its replay VJP (on K4 up to 24 leaves), no K6
  and no K7;
- ``compile_scene(fast=False)``: no fast hit and no hit replay; the first
  hit is :func:`~ptx_torch.geom.spans.first_hit` of the span merge
  (``spans_fn``) and ``trace_rays`` differentiates the bounces by plain
  autograd;
- ``trace_rays(manual_vjp=False)``: plain autograd through
  ``_bounce_live`` (the default where the scene has no hit replay) on
  whatever hit the scene has: the kernels' hits (K4, K5's hit mode) and
  the sweeps differentiate through their hit replay
  (:class:`~ptx_torch.geom.fasthit.HitReplay`), the dense hit and the
  span merge by autograd; ``trace_rays(remat=)`` (on by default, as in
  JAX) runs each bounce of that route under
  ``torch.utils.checkpoint``: the backward recomputes the bounce from its
  inputs, so a bounce keeps its inputs in place of its intermediates.
  The draws are functions of the key, so the recompute is bit-identical.
  ``remat`` changes nothing under the manual VJP, as in JAX;
  ``trace_rays(skysel=)``, else ``PTX_SKYSEL`` (on unless "0");
- ``compile_fast_hit(sweep_kernel=, sweep_mode=)``, else
  ``PTX_SWEEP_KERNEL=1`` / ``PTX_SWEEP_MODE``: the sweep's mode
  (:func:`resolve_sweep_mode`).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Callable

import torch
import torch.utils.checkpoint

from ptx_torch.core import rng
from ptx_torch.core.constants import DEFAULT_RAY_DEPTH
from ptx_torch.geom import fasthit, hitreplay, spans, tape
from ptx_torch.geom.fasthit import collect_leaves
from ptx_torch.ops import emission_kernel, megasweep, sky_bank
from ptx_torch.ops.bounce_kernel import BounceBwdKernel, BounceKernel
from ptx_torch.ops.fasthit_kernel import HitKernel
from ptx_torch.ops.replay_bwd import RowFedReplayBwd
from ptx_torch.shade import bounce as plain
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

# compile_fast_hit's routing (ptx/geom/fasthit.py:399-412)
DENSE_L_MAX = 64             # the JAX package's dense-path limit
SWEEP_L_MIN = 24             # union tapes above this many leaves take the sweep
SWEEP_GROUP_MAX = 12         # ... when every group has at most this many leaves
DEFAULT_CANDIDATE_BLOCK = 32  # events per block of the candidate-blocked scan
SWEEP_MODES = ("fixpoint", "sort", "kernel", "mega")


@dataclasses.dataclass(eq=False)
class CompiledScene:
    """A scene lowered to tensors + callables on one device.

    ``bounce_fn`` is the one bounce every wavefront step calls and
    ``bounce_bwd_fn`` its replay backward (module docstring).  ``hit_fn``
    is K4's wrapper for scenes of at most 24 leaves, ``plain_hit_fn`` the
    dense first hit (K4's and K1's plain versions read it).
    ``emission_fn`` is K7's wrapper or None, ``sky_bank`` the sky bank's
    (:class:`~ptx_torch.ops.sky_bank.SkyBank`) or None; ``diff_keys`` the params
    ``ManualBounce`` passes to autograd; ``tile_hint`` (large scenes)
    turns on :func:`trace_rays`'s tile ordering.  Above 24 leaves
    ``plain_hit_fn`` is :func:`compile_fast_hit`'s hit and ``hit_fn``
    K5's hit mode on it in ``mega`` mode, else that hit itself.
    ``spans_fn`` is the span-merge evaluator
    (:func:`~ptx_torch.geom.tape.span_evaluator`); with ``fast=False``
    ``hit_fn``, ``hit_replay_fn`` and the bounces are None and the hit is
    ``first_hit(spans_fn(params, o, d))``.  ``hit_fn``, ``bounce_fn``
    and ``bounce_bwd_fn`` each have ``pack`` (module docstring)."""
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
    sky_bank: Callable = None
    diff_keys: tuple = plain.DIFF_KEYS
    tile_hint: bool = False


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def resolve_sweep_mode(plan, leaves, sweep_kernel=None, sweep_mode=None) -> str:
    """The union sweep's mode, resolved as the JAX package does
    (``ptx/geom/fasthit.py:775-807``): an explicit ``sweep_mode``; else
    ``sweep_kernel`` (True: ``kernel``, False: ``sort``); else
    ``PTX_SWEEP_KERNEL=1`` (``kernel``); else ``PTX_SWEEP_MODE``; else
    ``mega`` on a mega-eligible tape and ``fixpoint`` on any other.  The
    JAX package takes ``mega`` by default on its accelerator only; the port
    routes alike on every device, so that the CPU runs the plain version of
    what the card runs.  ``mega`` on a tape that is not mega-eligible falls
    back to ``fixpoint``."""
    if sweep_kernel not in (None, True, False):
        raise ValueError(f"sweep_kernel must be True, False or None, not {sweep_kernel!r}: "
                         "the device of the tensors decides between K9 and its plain version")
    eligible = megasweep.mega_eligible(plan, leaves)
    if sweep_mode is None:
        if sweep_kernel is not None:
            sweep_mode = "kernel" if sweep_kernel else "sort"
        elif os.environ.get("PTX_SWEEP_KERNEL") == "1":
            sweep_mode = "kernel"
        else:
            sweep_mode = os.environ.get("PTX_SWEEP_MODE", "mega" if eligible else "fixpoint")
    if sweep_mode == "mega" and not eligible:
        sweep_mode = "fixpoint"
    if sweep_mode not in SWEEP_MODES:
        raise ValueError(f"unknown sweep mode {sweep_mode!r}; one of {SWEEP_MODES}")
    return sweep_mode


def compile_fast_hit(plan, params_ref=None, candidate_block: int | None = None,
                     sweep: bool | None = None, sweep_kernel: bool | None = None,
                     sweep_mode: str | None = None):
    """The plain first hit of ``plan`` (``ptx.geom.fasthit.compile_fast_hit``,
    :399-412): ``hit(params, origin, direction) -> dict`` for flat (B, 3)
    rays, the dict of :class:`~ptx_torch.geom.fasthit.DenseHit`.

    - a union of more than one group (a leaf or a gadget of at most 12
      leaves) with more than 24 leaves takes the union sweep, in the mode
      :func:`resolve_sweep_mode` picks: ``mega``, K5's plain version
      :class:`~ptx_torch.ops.megasweep.SweepHit`, on a mega-eligible tape;
      otherwise :class:`~ptx_torch.geom.fasthit.UnionSweepHit`
      (``fixpoint``, ``sort``, ``kernel``);
    - otherwise the dense fold up to 64 leaves
      (:class:`~ptx_torch.geom.fasthit.DenseHit`), above 64 leaves the
      candidate-blocked scan (:class:`~ptx_torch.geom.fasthit.BlockedHit`).

    ``sweep`` and ``candidate_block`` force a strategy
    (``candidate_block=0``: the dense fold), ``sweep_kernel`` and
    ``sweep_mode`` the sweep's mode; ``params_ref`` (the params at compile
    time) orders the megasweep's rows for culling only."""
    leaves = collect_leaves(plan)
    L = len(leaves)
    if sweep is None:
        groups = fasthit.union_decompose(plan)
        gmax = max(1 if isinstance(g, tape._LeafPlan) else len(collect_leaves(g))
                   for g in groups)
        sweep = (candidate_block is None and L > SWEEP_L_MIN and len(groups) > 1
                 and gmax <= SWEEP_GROUP_MAX)
    if sweep:
        mode = resolve_sweep_mode(plan, leaves, sweep_kernel, sweep_mode)
        if mode == "mega":
            return megasweep.SweepHit(plan, leaves, params_ref)
        return fasthit.UnionSweepHit(plan, leaves, mode)
    if candidate_block is None and L > DENSE_L_MAX:
        candidate_block = DEFAULT_CANDIDATE_BLOCK
    if candidate_block:
        return fasthit.BlockedHit(plan, leaves, candidate_block)
    return fasthit.DenseHit(plan, leaves)


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
    mega = isinstance(plain_hit, megasweep.SweepHit)
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
        scene.hit_fn = megasweep.MegaHit(plain_hit)
    else:
        scene.hit_fn = plain_hit
    scene.hit_replay_fn = hitreplay.build_hit_replay(collect_leaves(plan))
    if dynamic or not fused:
        if dynamic:
            scene.diff_keys = plain.DIFF_KEYS + plain.TEXTURE_KEYS
        scene.bounce_fn = plain.UnfusedBounce(scene)
        scene.bounce_bwd_fn = plain.ReplayVJP(scene)
    elif small:
        scene.bounce_fn, scene.bounce_bwd_fn = (BounceKernel(scene),
                                                BounceBwdKernel(scene))
    else:
        # PTX_MEGAB=0 keeps the unfused bounce on K5's hit mode
        # (ptx/integrate/trace.py:216)
        megab = mega and os.environ.get("PTX_MEGAB") != "0"
        scene.bounce_fn = (megasweep.compile_mega_bounce(scene) if megab
                           else plain.UnfusedBounce(scene))
        scene.bounce_bwd_fn = RowFedReplayBwd(scene)
    if fused and _want_emission_kernel(ordered, table) and emission_kernel.supported(table):
        scene.emission_fn = emission_kernel.EmissionKernel(table, device)
    elif kernels and sky_bank.supported(table):
        scene.sky_bank = sky_bank.SkyBank(table)
    return scene


# ---------------------------------------------------------------------------
# the manual bounce
# ---------------------------------------------------------------------------

class ManualBounce(torch.autograd.Function):
    """One bounce with a decision-frozen replay backward (port of
    ``_make_manual_bounce``, ``ptx/integrate/trace.py:660``).

    ``apply(scene, params, packed, vector, in_depth, o, d, thr, strength,
    alive, u_coin, u3, *diff)`` returns ``(o2, d2, thr2, strength2,
    alive2)`` and then the decisions ``_DEC_KEYS``.  The forward is
    ``scene.bounce_fn`` (with the scene buffer ``packed``); it saves the
    carry and the decisions, not the uniforms (the replay reads the
    accepted draw ``u_sel``).  The backward is ``scene.bounce_bwd_fn`` on
    the cotangents of o2, d2 and thr2.  strength2, alive2 and the
    decisions are not differentiable.  ``diff`` are the scene inputs
    autograd reaches the params through: with ``vector``, the backward's
    scene vector (``scene.bounce_bwd_fn.pack``: K2, K6), packed once per
    ``trace_rays`` call, and the backward returns its cotangent; else,
    with autograd on, ``_diff_inputs(scene, params)``, and the backward
    returns theirs where it reads the params (``pack`` is None), or nothing
    where no param needs a gradient (it packs its vector without history);
    with autograd off, none."""

    @staticmethod
    def forward(ctx, scene, params, packed, vector, in_depth, o, d, thr, strength, alive,
                u_coin, u3, *diff):
        kb = scene.bounce_fn(params, o, d, thr, strength, alive, u_coin, u3,
                             in_depth, packed=packed)
        dec = tuple(kb[k] for k in plain._DEC_KEYS)
        ctx.scene, ctx.params, ctx.vector = scene, params, vector
        ctx.save_for_backward(o, d, thr, *dec[1:], *diff)
        outs = (kb["o2"], kb["d2"], kb["thr2"], kb["strength2"], kb["alive2"]) + dec
        ctx.mark_non_differentiable(*outs[3:])
        return outs

    @staticmethod
    def backward(ctx, ct_o2, ct_d2, ct_thr2, *_):
        o, d, thr, *rest = ctx.saved_tensors
        n_dec = len(plain._DEC_KEYS) - 1
        dec = dict(zip(plain._DEC_KEYS[1:], rest[:n_dec]))
        diff = rest[n_dec:]
        scene = ctx.scene
        bwd = scene.bounce_bwd_fn
        cts = (ct_o2.contiguous(), ct_d2.contiguous(), ct_thr2.contiguous())
        # the call's vector; else, where the backward reads one, its vector
        # without history (only the rays need a gradient)
        vec = diff[0] if ctx.vector else bwd.pack(ctx.params)
        if vec is not None:
            d_o, d_d, d_thr, d_vec = bwd(vec.detach(), o, d, thr, dec, *cts)
            d_diff = (d_vec,) if ctx.vector else (None,) * len(diff)
        else:
            params = plain._with_diff(scene, ctx.params, diff)
            d_o, d_d, d_thr, d_params = bwd(params, o, d, thr, dec, *cts)
            d_diff = tuple(plain._diff_inputs(scene, d_params))
        return (None,) * 5 + (d_o, d_d, d_thr) + (None,) * 4 + d_diff


@profiling.spanned("replay_pack", backward="replay_pack_bwd")
def _replay_pack(scene, params):
    """The replay backward's packed scene vector for one ``trace_rays``
    call, with autograd history from ``params`` (``scene.bounce_bwd_fn.
    pack``), or None where the backward reads the params or no param needs
    a gradient."""
    if not (torch.is_grad_enabled()
            and any(x.requires_grad for x in plain._diff_inputs(scene, params))):
        return None
    return scene.bounce_bwd_fn.pack(params)


@profiling.spanned("bounce", backward="bounce_bwd")
def _bounce(scene: CompiledScene, params, packed, packed_bwd, carry, in_depth, u_coin,
            u3):
    # the scene inputs autograd reaches the params through: the call's
    # packed vector, else the params (none where nothing is differentiated)
    vector = packed_bwd is not None
    diff = ((packed_bwd,) if vector else
            plain._diff_inputs(scene, params) if torch.is_grad_enabled() else ())
    outs = ManualBounce.apply(scene, params, packed, vector, in_depth, *carry, u_coin, u3,
                              *diff)
    return outs[:5], dict(zip(plain._DEC_KEYS, outs[5:]))


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


def _autograd_hit(scene, params):
    """The first hit plain autograd differentiates: the span merge where
    the scene has no fast hit, else ``scene.hit_fn`` with its scene buffer
    (K4's, K5's hit mode's), packed here once for all bounces of the call
    (None for a plain hit)."""
    if scene.hit_fn is None:
        return lambda params, o, d: spans.first_hit(scene.spans_fn(params, o, d))
    packed = scene.hit_fn.pack(params)
    return scene.hit_fn if packed is None else functools.partial(scene.hit_fn, packed=packed)


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
    ``_bounce_live`` by plain autograd (:func:`_autograd_hit`);
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

    # the bounce's scene buffer (K1's, K5's, the hit kernel's), packed once
    # for all bounces of this call: scene.bounce_fn.pack (module docstring)
    with profiling.span("scene_pack"):
        packed = scene.bounce_fn.pack(params) if manual_vjp else None
    # K2's and K6's scene vector, packed once per call with autograd
    # history: each bounce's backward returns its cotangent, autograd sums
    # them and runs the packing's VJP once
    packed_bwd = _replay_pack(scene, params) if manual_vjp else None
    if not manual_vjp:
        bounce_live = functools.partial(plain._bounce_live, _autograd_hit(scene, params),
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

    - mat-sum + sky-select (every dynamic emitter is terminal, sky-select
      on): the sky bank where the scene has it (one launch a call forward,
      two backward), else its plain version
      :func:`~ptx_torch.ops.sky_bank.reference`;
    - otherwise evaluate the emissive slot once, on all phases' records
      concatenated in phase order: K7 when the scene has it (one launch per
      ``trace_rays`` call), else the material table; then sky-select (off
      with K7: :func:`~ptx_torch.shade.bounce.select_add`) adds the
      terminal chains on the one record per lane that reaches them.
    """
    table = scene.material_fn
    term_chains = (table.terminal_dynamic_emissive
                   if skysel and scene.emission_fn is None else [])
    term_mis = {mi for mi, _ in term_chains}
    if term_chains and set(table.dynamic_slots["emissive"]) <= term_mis:
        if scene.sky_bank is not None:
            return scene.sky_bank(params, saved)
        return sky_bank.reference(table, params, saved)
    em_eval = scene.emission_fn or (table.eval_emissive_base if term_chains
                                    else table.eval_emissive)
    ems = em_eval(params, torch.cat([p.reshape(-1, 3) for p, *_ in saved]),
                  torch.cat([m.reshape(-1) for _, _, m, *_ in saved])).split(
                      [m.numel() for _, _, m, *_ in saved])
    out = []
    for (pos, thr, mid, live, _), em in zip(saved, ems):
        contrib = torch.where(live[..., None], thr * em.reshape(thr.shape), 0.0).sum(dim=0)
        out.append(plain.select_add(contrib, params, pos, thr, mid, live, term_chains))
    return out

