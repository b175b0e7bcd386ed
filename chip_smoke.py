#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (ptx_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``ptx_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes the main paths
give it, drives every path through the entry points a user calls (the CLI
render, ``make_train_step``) at full size with exact launch counts, and
checks the results.  Any failed phase raises: the exit code is nonzero and
no result line is printed.  Without CUDA it exits 1 before doing anything.
Each phase prints its seconds.

Phases on the demo (K1, K2, K3; each raises on failure, none is caught):
1. device: name, and power limit as ``nvidia-smi`` reports it;
2. build: nvcc on every source in parallel, timed;
3. K1 vs plain, at every shape the main paths give K1: (a) three
   chained bounces of 65,536 primary rays (a 128-row band of the 512×512
   demo camera), each on the kernel's own carry; (b) the first chunk of
   the render's bands at rows 0 and 256 as the render runs them
   (``render_rows``, 65,536 rays at depth 16, compacted to 21,845 lanes
   from bounce 2 and to 4,096 from bounce 6), each of the 17 recorded
   kernel inputs fed to ``bounce_reference``.  Decisions must be equal
   except flips a float64 recompute puts at a near-tie; floats must agree
   within ``rtol 1e-5, atol 5e-6`` on agreeing lanes;
4. render slice: ``python -m ptx_torch render --demo demo --width 512
   --height 512 --spp 16 --depth 16`` through ``ptx_torch.cli.main``, with
   the launch counters zeroed just before; then a 16-row band at spp 2
   rendered with the kernel and with the plain bounce on the card, equal
   within ``rtol 1e-4, atol 1e-5`` except pixels whose paths hold an
   adjudicated flip;
5. K2 and K3 vs plain, on the inputs a render chunk gives them: forward +
   backward of ``radiance.sum()`` over the first 65,536-ray chunk of band
   256 (widths 65,536, 21,845 and 4,096, filler lanes included), every
   backward bounce's carry, decisions and cotangents recorded and fed to
   K2 and to its plain versions, every sky-select histogram's inputs to K3
   and ``hist_reference``; then K8 on a 512×1024×4 image (past K3's shared
   memory).  Tolerances: K2 per lane within ``rtol 1e-5, atol
   1e-6`` of the plain value, or within twice the plain value's error
   against a float64 recompute plus 1e-4 relative (the hand adjoint orders
   its float32 operations unlike autograd, and near-grazing lanes are
   ill-conditioned); ``d_packed`` (the cotangent of K2's scene vector)
   against the per-leaf sums folded onto the materials, the float64 fold
   as truth, at the scale of the folded sums of |term|; two launches the
   same bits; ``d_params`` (``d_packed`` through the packing's VJP) within
   1e-4 of each tensor's largest entry, or within twice the plain value's
   error against the float64 sums mapped to the params.  K3 and K8
   within the reordered-sum bound ``2·n·2⁻²⁴·Σ|ct|`` per texel (float
   atomics add in a varying order);
6. gradients, kernel path against plain path on the card: a 32-row band at
   spp 2 (32,768 rays, compaction on), depth 16, the gradient of the mean
   radiance with respect to every param tensor, the sky image included,
   within 1e-4 of each tensor's largest entry;
7. training slice: ``make_train_step`` on the demo at 512×512, spp 16,
   depth 16 (one 4,194,304-ray wavefront per step), target the port's
   render of the true params under another key, start from sphere radii
   ×1.05 and const row 0 lowered by 0.1; 3 steps with the counters zeroed
   just before; loss and grad norm finite; exact launch counts (K1 17 and
   K2 16 per step: the last bounce's carry feeds nothing, so autograd runs
   no backward for it; K2's scene vector packed once and its VJP run once
   per step; K3 3 per step, one per phase's sky-select evaluation) and no
   plain call; peak memory and seconds per step;
8. kernels at the training step's widths: one more step from the true
   params with every K1, K2 and K3 call's inputs recorded (4,194,304,
   1,398,101 and 262,144 lanes; the K2 grid's tile loop runs only here),
   each held against its plain version as in phases 3 and 5; K2's bare
   launch timed at 4,194,304 lanes beside its bound.

Path A, BASELINE config 4 (a checker-textured reflect slot: the unfused
bounce, plain-PyTorch shading on the hit-only kernel K4, the full-param
replay backward whose checker gather transposes through K3):
A1. K4 vs the dense hit on every bounce input of the first 65,536-ray
    chunk of band 256 (65,536 / 21,845 / 4,096 lanes, fillers included):
    decisions equal except float64-adjudicated near-ties, ``t`` and the
    normal (hit lanes) within ``rtol 1e-5, atol 5e-6``;
A2. ``python -m ptx_torch render --demo config4`` at 512², spp 16, d16:
    K4 1,088 (4 bands × 16 samples × 17 bounces), nothing else;
A3. 3 train steps at 512², spp 16, d16: K4 17 and K3 19 per step (16
    backward bounces each transpose the checker gather, 3 phases each
    the sky-select's), K1 = K2 = 0, no plain call;
A4. gradients, kernel path vs plain path as in phase 6, the checker image
    and the sky included.

Path B, the 1536×3072 probe (``make_world`` under
``procedural_sky_image(1536, 3072)``, as ``bench.py --sky 1536x3072``):
B1. 3 train steps: K1 17, K2 16 (one pack and one VJP), K8 3 per step
    (one per phase's sky-select gradient: the 75.5 MB image is past K3's
    shared memory), K3 = 0;
B2. every K8 output of those steps against ``hist_reference`` within the
    reordered-sum bound.

Path C, the fused emission kernel K7 (``PTX_EMK=1`` around
``compile_scene``, as tests/test_emission_kernel.py:26-30):
C1. the demo: one 65,536-ray chunk, K1 17 and K7 1 (``trace_rays``
    evaluates emission once, on all phases' records), nothing else; K7 vs
    ``eval_emissive`` on its inputs within ``rtol 1e-5, atol 1e-6``
    except lanes a float64 recompute puts within 1e-6 of a texel boundary;
C2. 3 train steps: K1 17, K2 16, K7 1 and K3 1 per step (K7's backward is
    one combined histogram of the sky image and the const rows); every K7
    call and histogram held against its plain version;
C3. gradients, kernel path vs plain path (``eval_emissive``);
C4, C5. a mirror-ball sky world (tests/test_emission_kernel.py:87-115):
    C1's chunk and C3's gradients.

Path D, the large scenes (K5, the megasweep: union-sweep first hit, in
bounce mode with shade and scatter; K6, the row-fed replay backward):
S1 ``stress_spheres(249)`` (256 leaves), S2 ``stress_gadgets(112)`` (268
leaves: lenses, bulbs, bites), S3 ``stress_spheres(249, transformed=True)``
(the 32-column table), S4 S1 under the 1536×3072 probe (K5 + K6 + K8):
D1. K5's and K6's registers and stack frame from nvcc's report;
D2. S1-S3: K5 on every bounce of one compacted 65,536-ray chunk (every
    4th row of the frame, depth 16: widths 65,536 / 21,845 / 4,096)
    against its plain version (the sweep + the plain shading) as phase 3
    holds K1, and cull on against cull off bit for bit; on S2 also K5's
    hit mode against ``megasweep_reference`` on the primary rays; the
    primary bounce's fixpoint passes per lane and active cull flags;
D3. S1, S2: every K6 call of that chunk's forward + backward against its
    plain versions as phase 5 holds K2; two launches the same bits;
D4. S1, S2: gradients, kernel path vs plain path, as phase 6;
D5. 3 ``make_train_step`` steps each on S1-S4 at 512², spp 16, d16: K5 17
    and K6 16 per step (S4 also K8 3), nothing else, no plain call;
D6. ``python -m ptx_torch render --scene scenes/composed.json`` (52 leaves,
    the spec's 512², spp 16, depth 8): K5 4 × 16 × 9 = 576 and the tile
    ordering in every ``trace_rays`` call;
D7. S1, S2 at 65,536 lanes: K5 (wrapper, bare launch, plain), K6
    (wrapper, bare launch, plain), and K6's bare launch at 4,194,304
    lanes (a D5 step's widest backward), each beside its bound.

Path E, the union sweep's other modes (K9, the sweep-select kernel; the
local membership fold; the candidate-blocked hit) on S1, S2 under
``PTX_SWEEP_MODE=kernel PTX_MEGAB=0`` (no K5), a bitten union (48 spheres
with four spherical bites each over the ground plane under the stress sky:
247 leaves, past the megasweep's slot algebra) under
``PTX_SWEEP_MODE=kernel`` and by default (the fixpoint sweep), and a carved
tape (a sphere intersected with a union of 64 spheres, the ground, the sky:
72 leaves, no union of small groups: the blocked hit); each with the
unfused bounce on its hit and K6:
E1. S1, S2, the bitten union in kernel mode: on every bounce of the D2
    chunk (65,536 / 21,845 / 4,096 lanes) each hit's intervals recomputed
    from its rays, K9 as called (``sort=False``, stable-sorted starts) and
    K9 ``sort=True`` (unsorted) against ``sweep_select_reference``: 0
    differing lanes in all five outputs; the whole hit equal to the
    ``fixpoint`` and ``sort`` modes' bit for bit; on S1 and S2 equal to K5's
    plain version except float64-adjudicated near-ties; the fixpoint's
    passes per bounce;
E2. gradients, kernel path vs plain path as phase 6: S2 (kernel mode, K9's
    plain version on the plain path), the bitten union (fixpoint), the
    carved tape (blocked);
E3. 3 ``make_train_step`` steps each at 512², spp 4, d16 (1,048,576 rays:
    the sweep holds (L, B) tensors per bounce): S1, S2 and the bitten union
    in kernel mode K9 17 and K6 16 per step; the bitten union by default and
    the carved tape K6 16; nothing else, no plain call; seconds per step,
    peak memory;
E4. ``render --scene scenes/composed.json`` under ``PTX_SWEEP_MODE=kernel
    PTX_MEGAB=0``: K9 4 × 16 × 9 = 576, K5 0, tile ordering in every call;
E5. S1, S2 at 65,536 lanes on E1's inputs: K9 (wrapper, bare launch with
    ``sort=False`` and ``sort=True``, plain) and, as context, the
    ``torch.sort`` of the starts, beside the bound from bytes.

Then:
9. a forward + backward chunk at the bench's shape (128 rows × 512, spp 1,
   depth 16, ``loss = radiance.mean()``): rays/s over the median of 10
   chunks between CUDA events, beside the forward alone;
10. timing per kernel at the main path's widths (65,536 lanes for K1-K4,
    a chunk's ~263 k emission records for K7, the probe's 4,194,304
    sky-select lanes for K8): the wrapper as the main path calls it and the
    plain version, each the median of 20 single calls between CUDA events;
    for K2 also the once-per-call pack + VJP and a step's sum (16 wrappers
    and one pack + VJP) beside 16 times the per-bounce params route; for K3
    and K8 also the library calls ``index_put_(accumulate=True)`` and
    ``index_add_`` on the flat (H·W, C) view, and K8's wrapper at most half
    of ``index_put_``'s time; the least time the card could take
    (``bound_ms``) from this run's inputs;
11. the JSON lines: the nine kernels (launches from the paths' train
    steps: the demo's for K1-K3, config 4's for K4, S1's for K5 and K6,
    C2's for K7, the probe's for K8, E3's S1 for K9), then the device.

Outputs (the rendered image, the nvcc report) go to ``build/chip_smoke/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")

W = H = 512
SPP, DEPTH = 16, 16
BAND_ROWS = 128                 # 128 × 512 = 65,536 rays: the CLI's chunk
DECISIONS = ("evt", "hit", "entering", "mat_id", "take_transmit",
             "scatter_alive", "alive2")
FLOATS = ("t", "o2", "d2", "thr2", "strength2")
TIE_REL = 1e-5                  # a near-tie: within 1e-5·max(1, |value|)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# flip adjudication (float64 recompute of the plain bounce on the CPU)
# ---------------------------------------------------------------------------

def _f64_cpu(params):
    return {k: ([x.double().cpu() for x in v] if isinstance(v, list)
                else v.double().cpu()) for k, v in params.items()}


def adjudicate(scene, inputs, out_k, out_p, lanes):
    """For lanes whose decisions differ between the kernel (``out_k``) and
    the plain bounce (``out_p``) on the same ``inputs``, return a bool per
    lane: True where a float64 recompute puts the flipped decision at a
    near-tie — two competing boundaries within ``TIE_REL·max(1, |t|)``, a
    boundary at EPS, or (same hit) the transmit coin, the strength or
    add-factor gate, or the scatter-cap bound within ``TIE_REL``.  That is
    the last-ulp class; anything else is a fault."""
    import torch
    from ptx_torch.core import linalg
    from ptx_torch.core.constants import EPS

    if lanes.numel() == 0:
        return torch.zeros(0, dtype=torch.bool)
    lanes = lanes.cpu()
    p64 = _f64_cpu(scene.params)
    o, d, _, st, _, uc, _, _ = inputs
    o, d = o.cpu()[lanes].double(), d.cpu()[lanes].double()
    st, uc = st.cpu()[lanes].double(), uc.cpu()[lanes].double()

    winner_tied = _winner_tied(scene, p64, o, d, lanes)
    n = lanes.numel()
    hit_class = torch.zeros(n, dtype=torch.bool)
    for k in ("evt", "hit", "entering", "mat_id"):
        hit_class |= (out_k[k] != out_p[k]).cpu()[lanes]
    hit_ok = winner_tied(out_k["evt"]) | winner_tied(out_p["evt"])

    # same hit: the shading gates, recomputed in float64
    hit = scene.plain_hit_fn(p64, o, d)
    m = scene.material_fn(p64, o + hit["t"][:, None] * d, hit["mat_id"])
    rel_ior = torch.where(hit["entering"], 1.0 / m["ior"], m["ior"])
    rf = (torch.clamp(m["transmit_reflect_f"], 0.0, 1.0)
          * linalg.refract_strength(d, rel_ior, hit["normal"]))
    refr_ok = (rf > EPS) & (linalg.refract(d, rel_ior, hit["normal"]) != 0).any(-1)
    p_tr = torch.where(refr_ok, rf, 0.0)
    sc = torch.clamp(m["scatter_f"], 0.0, 1.0)
    bias = (1.0 / torch.where(sc <= EPS, 1.0, sc) - 1.0)[:, None] * \
        linalg.reflect(d, hit["normal"])
    c = (EPS - linalg.dot(hit["normal"], bias)) / linalg.norm(hit["normal"])
    margins = torch.stack([(uc - p_tr).abs(), (st - EPS).abs(),
                           (1.0 - p_tr - EPS).abs(), (rf - EPS).abs(),
                           (c - 1.0).abs()])
    gate_ok = margins.min(dim=0).values <= TIE_REL
    return torch.where(hit_class, hit_ok, gate_ok)


def _winner_tied(scene, p64, o, d, lanes):
    """``tied(evt)``: per lane of ``lanes`` (rays ``o``, ``d`` already cut to
    them, float64 on the CPU), whether the winning event ``evt`` sits
    within ``TIE_REL·max(1, |t|)`` of EPS or of another finite boundary —
    but not exactly on it: exactly equal boundaries (the demo's coincident
    spheres) round identically in both versions, so a flip there breaks
    the leaf-order tie-break and is a fault."""
    import torch
    from ptx_torch.core.constants import EPS, MAX_VALUE
    from ptx_torch.geom import fasthit

    # every boundary time, in float64: (2L, n), event order of the kernel
    t0, t1, _, _ = fasthit._leaf_intervals(fasthit.collect_leaves(scene.plan),
                                           p64, *o.unbind(-1), *d.unbind(-1))
    t_evt = torch.cat([t0, t1])
    idx = torch.arange(lanes.numel())

    def tied(evt):
        e = evt.cpu()[lanes].long()
        te = t_evt[e, idx]
        tol = TIE_REL * torch.clamp(te.abs(), min=1.0)
        gap = (t_evt - te[None]).abs()
        near = (gap > 0) & (gap <= tol) & (t_evt.abs() < MAX_VALUE)
        return (te.abs() < MAX_VALUE) & (near.any(dim=0) | ((te - EPS).abs() <= tol))
    return tied


def compare_bounce(scene, inputs, out_k, out_p):
    """Kernel vs plain on one bounce: (flips, max_abs_err); raises on an
    unexplained flip or a float outside tolerance on agreeing lanes."""
    import torch

    differ = torch.zeros_like(out_k["hit"])
    for k in DECISIONS:
        differ |= out_k[k] != out_p[k]
    lanes = differ.nonzero().flatten()
    ok = adjudicate(scene, inputs, out_k, out_p, lanes)
    if not bool(ok.all()):
        bad = lanes.cpu()[~ok][:8].tolist()
        raise AssertionError(f"{int((~ok).sum())} unexplained decision flips, "
                             f"lanes {bad}")
    agree = ~differ
    max_err = 0.0
    for k in FLOATS + ("u_sel",):
        keep = agree & out_p["hit"] if k == "u_sel" else agree
        a, b = out_k[k][keep], out_p[k][keep]
        torch.testing.assert_close(a, b, rtol=1e-5, atol=5e-6, msg=lambda m: f"{k}: {m}")
        max_err = max(max_err, float((a - b).abs().max()) if a.numel() else 0.0)
    return int(lanes.numel()), max_err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s); device 0: {name}")
    log(smi)
    return name, smi


def phase_build():
    from ptx_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    dt = time.perf_counter() - t0
    with open(os.path.join(OUT, "nvcc_report.txt"), "w") as f:
        f.write(_build.BUILD_LOG)
    regs = [ln.strip() for ln in _build.BUILD_LOG.splitlines()
            if "registers" in ln or "spill" in ln]
    log(f"[2 build] {dt:.2f} s (nvcc and load); " + " | ".join(regs))
    return dt


def _primary_band(scene, key, y0, rows, spp=1):
    import torch
    from ptx_torch.integrate.camera import Camera, sample_rays

    o, d = sample_rays(Camera.reference_demo(W, H), key, range(y0, y0 + rows),
                       range(W), spp, scene.device)
    n = o.numel() // 3
    dev = scene.device
    return (o.reshape(-1, 3), d.reshape(-1, 3),
            torch.ones((n, 3), device=dev), torch.ones(n, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev))


def phase_kernel_vs_plain(scene):
    import torch
    from ptx_torch.core import rng
    from ptx_torch.ops.bounce_kernel import bounce_reference

    key = rng.fold(rng.PRNGKey(0), 0, 192)
    carry = _primary_band(scene, key, 192, BAND_ROWS)
    B = carry[0].shape[0]
    flips, max_err = 0, 0.0
    for b in range(3):
        kb = rng.fold(key, b)
        uc = rng.uniform(rng.fold(kb, 1), (B,), scene.device)
        u3 = rng.uniform(rng.fold(kb, 2), (B, 3), scene.device)
        inputs = (*carry, uc, u3, True)
        if b == 0:
            first_inputs = inputs
        out_k = scene.bounce_fn(scene.params, *inputs)
        out_p = bounce_reference(scene, scene.params, *inputs)
        torch.cuda.synchronize()
        f, e = compare_bounce(scene, inputs, out_k, out_p)
        flips, max_err = flips + f, max(max_err, e)
        log(f"[3 kernel vs plain] bounce {b}: B={B} alive={int(carry[4].sum())} "
            f"flips={f} max_abs_err={e:.3g}")
        carry = (out_k["o2"], out_k["d2"], out_k["thr2"], out_k["strength2"],
                 out_k["alive2"])
    return flips, max_err, first_inputs


def phase_compacted_chunks(scene):
    """K1 vs plain on the inputs the render itself gives the kernel: the
    first 65,536-ray chunk of two of the CLI's bands (same keys, same
    ``render_rows`` call), recorded bounce by bounce.  Compaction runs
    there (B ≥ 16,384, depth ≥ 8), so each chunk reaches the kernel at
    65,536, 21,845 and 4,096 lanes, with dead filler lanes.  Band 0 is
    mostly sky, so few lanes survive it; band 256 fills the 21,845-lane
    wavefront, through the resampling."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.integrate.render import render_rows
    from ptx_torch.ops.bounce_kernel import bounce_reference

    B = BAND_ROWS * W
    expect = [B] * 2 + [B // 3] * 4 + [B // 16] * (DEPTH + 1 - 6)
    flips, max_err = 0, 0.0
    for y0 in (0, 256):
        recorded = []
        sk = dataclasses.replace(scene, bounce_fn=_recording(scene.bounce_fn,
                                                             recorded))
        render_rows(sk, scene.params, Camera.reference_demo(W, H),
                    rng.PRNGKey(0), y0, BAND_ROWS, 1, 1, DEPTH)
        widths = [inputs[0].shape[0] for inputs, _ in recorded]
        if widths != expect:
            raise AssertionError(f"band {y0}: bounce widths {widths}, "
                                 f"expected {expect}")
        for b, (inputs, out_k) in enumerate(recorded):
            out_p = bounce_reference(scene, scene.params, *inputs)
            torch.cuda.synchronize()
            f, e = compare_bounce(scene, inputs, out_k, out_p)
            flips, max_err = flips + f, max(max_err, e)
            log(f"[3 kernel vs plain] band {y0} chunk 0 bounce {b}: "
                f"B={widths[b]} alive={int(inputs[4].sum())} flips={f} "
                f"max_abs_err={e:.3g}")
    return flips, max_err


def phase_slice(scene):
    import numpy as np
    import torch
    from ptx_torch import cli
    from ptx_torch.ops import bounce_kernel

    out = os.path.join(OUT, "smoke_demo")
    _reset_counters()
    t0 = time.perf_counter()
    frame = cli.main(["render", "--demo", "demo", "--width", str(W), "--height",
                      str(H), "--spp", str(SPP), "--depth", str(DEPTH),
                      "--device", "cuda", "--out", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counters()
    launches, plain = c["K1"], c["plain"]
    bands = -(-H // min(H, 2 ** 16 // W))     # the CLI's 65,536-ray bands
    expected = bands * SPP * (DEPTH + 1)
    rays = W * H * SPP * (DEPTH + 1)
    log(f"[4 slice] {W}x{H} spp {SPP} depth {DEPTH}: wall {wall:.3f} s incl. "
        f"scene compile and image writes, {rays / wall:.4g} rays/s; "
        f"K1 launches {launches} (expected {expected}), plain bounces {plain}; "
        f"image mean {float(frame.mean()):.6g}")
    if frame.shape != (H, W, 3) or not np.isfinite(frame).all():
        raise AssertionError("render is not a finite (H, W, 3) image")
    if not frame.mean() > 0:
        raise AssertionError("render is black")
    if c != _expect(K1=expected):
        raise AssertionError(f"render launches {c}: expected K1 {expected}, no "
                             "other kernel, no plain call")
    return launches, wall, rays / wall


def _recording(fn, log_list):
    def call(params, *inputs, packed=None):
        out = fn(params, *inputs, packed=packed)
        log_list.append((inputs, out))
        return out
    return call


def phase_band_vs_plain(scene):
    """A 16-row band at spp 2 (two 8,192-ray chunks, no compaction, so
    lane = pixel) through the kernel and through the plain bounce."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.integrate.render import render_rows
    from ptx_torch.ops.bounce_kernel import bounce_reference

    rows, y0 = 16, 248
    cam = Camera.reference_demo(W, H)
    key = rng.PRNGKey(0)
    log_k, log_p = [], []
    sk = dataclasses.replace(scene, bounce_fn=_recording(scene.bounce_fn, log_k))
    sp = dataclasses.replace(scene, bounce_fn=_recording(
        functools.partial(bounce_reference, scene), log_p))
    img_k = render_rows(sk, scene.params, cam, key, y0, rows, 1, 2, DEPTH)
    img_p = render_rows(sp, scene.params, cam, key, y0, rows, 1, 2, DEPTH)
    torch.cuda.synchronize()
    if not len(log_k) == len(log_p) == 2 * (DEPTH + 1):
        raise AssertionError(f"band: {len(log_k)} kernel and {len(log_p)} "
                             f"plain bounces, expected {2 * (DEPTH + 1)} each")

    pixel_flipped = torch.zeros(rows * W, dtype=torch.bool, device=scene.device)
    flips = 0
    for chunk in range(2):
        diverged = torch.zeros_like(pixel_flipped)
        for b in range(DEPTH + 1):
            (_, out_k), (inp_p, out_p) = (log_k[chunk * (DEPTH + 1) + b],
                                          log_p[chunk * (DEPTH + 1) + b])
            differ = torch.zeros_like(diverged)
            for k in DECISIONS:
                differ |= out_k[k] != out_p[k]
            first = differ & ~diverged   # this path's first divergence
            lanes = first.nonzero().flatten()
            ok = adjudicate(scene, inp_p, out_k, out_p, lanes)
            if not bool(ok.all()):
                raise AssertionError(f"band: {int((~ok).sum())} unexplained flips")
            flips += int(lanes.numel())
            diverged |= first
        pixel_flipped |= diverged
    keep = ~pixel_flipped.reshape(rows, W)
    torch.testing.assert_close(img_k[keep], img_p[keep], rtol=1e-4, atol=1e-5)
    log(f"[4 slice] band {rows}x{W} spp 2 kernel vs plain: {int(keep.sum())} "
        f"pixels equal within rtol 1e-4 atol 1e-5, {flips} adjudicated flips, "
        f"max abs diff {float((img_k - img_p).abs().max()):.3g}")
    return flips


def _time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` single calls, each between two CUDA events: the
    card's time for a call, or the host's where the host is slower."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _time_back_to_back_ms(fn, reps=20, warmup=3):
    """Mean of ``reps`` calls issued back to back between two CUDA events,
    with no wait between them: the device time per call where launches
    queue faster than they run, else the host's time per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def phase_timing(scene, inputs):
    """K1 as the main path calls it (the wrapper: launch and flag decode)
    against the plain bounce, both timed alike; the bare launch (no flag
    decode) is reported beside them under its own name."""
    from ptx_torch.ops import bounce_kernel

    buf = scene.bounce_fn.pack(scene.params)     # once per trace_rays call
    wrapped = lambda: scene.bounce_fn(scene.params, *inputs, packed=buf)
    plain = lambda: bounce_kernel.bounce_reference(scene, scene.params, *inputs)
    raw = lambda: scene.bounce_fn.launch(buf, *inputs)
    # plain, kernel, kernel, plain: two readings of each on one card
    p1 = _time_ms(plain)
    w1, d1 = _time_ms(wrapped), _time_back_to_back_ms(raw)
    w2, d2 = _time_ms(wrapped), _time_back_to_back_ms(raw)
    p2 = _time_ms(plain)
    log(f"[10 timing] K1: one bounce at B={inputs[0].shape[0]}: K1 wrapper (launch "
        f"+ flag decode, as the render calls it) {w1:.4f} / {w2:.4f} ms; plain "
        f"PyTorch {p1:.4f} / {p2:.4f} ms (each the median of 20 single calls "
        f"between CUDA events, 3 warm-up); K1 bare launch {d1:.4f} / "
        f"{d2:.4f} ms (mean of 20 launches back to back)")
    return min(w1, w2), min(p1, p2), min(d1, d2)


# ---------------------------------------------------------------------------
# the backward slice: K2, K3, gradients, the training step
# ---------------------------------------------------------------------------

U32 = 2.0 ** -24                # float32 unit roundoff
# SGD on every param, the sky image and its factor included: at the
# default 1e-2 (and at 1e-3) the loss grew from step to step on a small
# CPU rehearsal; 3e-4 keeps it near the start over three steps.
LR = 3e-4


def _leaf_params(params):
    """Fresh leaf copies of every param tensor, requiring grad."""
    return {k: ([x.detach().clone().requires_grad_(True) for x in v]
                if isinstance(v, list) else v.detach().clone().requires_grad_(True))
            for k, v in params.items()}


def _flat_grads(params):
    import torch

    out = {}
    for k, v in params.items():
        for i, x in enumerate(v if isinstance(v, list) else [v]):
            out[f"{k}[{i}]" if isinstance(v, list) else k] = (
                torch.zeros_like(x) if x.grad is None else x.grad)
    return out


def _close_f64(name, got, want, truth, scale=None):
    """Kernel ``got`` vs plain ``want``: within rtol 1e-5, atol 1e-6, or
    within twice the plain value's error against the float64 ``truth``
    plus 1e-4 of ``scale``; finite.  The default scale of an (n, 3) array
    is each row's largest |truth|: a direction or position cotangent's
    components mix through normalisations, so one that cancels to near 0
    carries the rounding of its row.  Returns (max|got − want|, a list of
    the elements off)."""
    import torch

    got, want, truth = (x.double() for x in (got, want, truth))
    if scale is None:
        scale = truth.abs().amax(dim=-1, keepdim=True).expand_as(truth)
    scale = scale.double()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: NaN or Inf")
    ok = torch.isclose(got, want, rtol=1e-5, atol=1e-6) | (
        (got - truth).abs() <= 2 * (want - truth).abs() + 1e-4 * scale + 1e-6)
    bad = [f"{name} at {tuple(i)}: kernel {float(got[tuple(i)]):.8g} plain "
           f"{float(want[tuple(i)]):.8g} float64 {float(truth[tuple(i)]):.8g} scale "
           f"{float(scale[tuple(i)]):.4g}" for i in (~ok).nonzero()[:4].tolist()]
    if bad:
        bad.insert(0, f"{name}: {int((~ok).sum())} elements off")
    return (float((got - want).abs().max()) if got.numel() else 0.0), bad


def _close_per_tensor(name, got, want, rel=1e-4, atol=1e-7):
    """Per param tensor: |got - want| <= rel · max|want| + atol, finite.
    Returns a list of the tensors off."""
    import torch

    offs = []
    for k in want:
        a, b = got[k], want[k]
        tol = rel * (float(b.abs().max()) if b.numel() else 0.0) + atol
        err = float((a - b).abs().max()) if b.numel() else 0.0
        if not bool(torch.isfinite(a).all()) or err > tol:
            offs.append(f"{name} {k}: max err {err:.4g} > {tol:.4g} (or not finite)")
    return offs


@contextlib.contextmanager
def _recording_hists(log_list, outputs=None):
    """While active, ``imagegrad.hist`` (the histogram routing, as the
    image gather's and K7's backward call it) logs each call's inputs, and
    its output into ``outputs`` when that list is given."""
    from ptx_torch.ops import imagegrad

    fn = imagegrad.hist

    def call(yi, xi, inb, ct, shape):
        log_list.append((yi, xi, inb, ct, shape))
        out = fn(yi, xi, inb, ct, shape)
        if outputs is not None:
            outputs.append(out)
        return out

    imagegrad.hist = call
    try:
        yield
    finally:
        imagegrad.hist = fn


class _RecordingBwd:
    """A replay backward wrapper (K2's or K6's) that logs each call's
    inputs; its other attributes are the wrapper's (``takes_packed``,
    ``pack``), so ``trace_rays`` routes as it would without it."""

    def __init__(self, kern, log_list):
        self.kern, self.log = kern, log_list

    def __getattr__(self, name):
        return getattr(self.kern, name)

    def __call__(self, scene_in, o, d, thr, dec, *cts):
        self.log.append((o, d, thr, dec, cts))
        return self.kern(scene_in, o, d, thr, dec, *cts)


def _recording_bwd(scene, log_list):
    """``scene`` with a replay backward that logs each call's inputs."""
    return dataclasses.replace(scene, bounce_bwd_fn=_RecordingBwd(scene.bounce_bwd_fn,
                                                                  log_list))


def _hist_bound_ok(name, got, yi, xi, inb, ct, shape):
    """K3 vs ``hist_reference``: within the reordered-sum bound
    ``2·n·u·Σ|ct|`` per texel (n lanes in the texel, u = 2⁻²⁴)."""
    import torch
    from ptx_torch.ops import imagegrad

    want = imagegrad.hist_reference(yi, xi, inb, ct, shape)
    mag = imagegrad.hist_reference(yi, xi, inb, ct.abs(), shape)
    n = imagegrad.hist_reference(yi, xi, inb, torch.ones_like(ct), shape)
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or bool((err > 2 * n * U32 * mag).any()):
        raise AssertionError(f"{name}: {int((err > 2 * n * U32 * mag).sum())} texels "
                             "outside the reordered-sum bound")
    return float(err.max())


def _check_k2(scene, recorded, tag, name="K2"):
    """K2 (or K6, ``name``) against its plain versions on each recorded
    backward bounce (the same saved carry, decisions and cotangents): per
    lane by :func:`_close_f64` against ``bounce_bwd_lanes_reference`` and
    its float64 recompute; K2's ``d_packed`` against those per-leaf sums
    folded onto the materials (``fold_packed``; K6's (L, 34) sums as they
    are), the float64 fold as truth, at the scale of the folded sums of
    |term|; ``d_params`` (``d_packed`` through the packing's VJP) by
    :func:`_close_f64` against ``bounce_bwd_reference`` (autograd through
    ``trace._bounce_replay``), the float64 sums mapped to the params as
    truth, at each tensor's largest entry; two launches the same bits.
    Returns max|k − p|."""
    import torch
    from ptx_torch.ops import bounce_kernel as bk

    kern = scene.bounce_bwd_fn
    if getattr(kern, "takes_packed", False):
        sums, sums_name = (lambda a: bk.fold_packed(a, kern.leaf_mat, kern.n_materials),
                           "d_packed")
    else:
        sums, sums_name = (lambda a: a), "per-leaf sums"
    err2, offs = 0.0, []
    for o_, d_, thr_, dec, cts in reversed(recorded):
        packed, leaves = kern.pack_leaves(scene.params)
        packed_d = packed.detach()
        got = kern.launch(packed_d, o_, d_, thr_, dec, *cts)
        again = kern.launch(packed_d, o_, d_, thr_, dec, *cts)
        ref_packed = bk.pack_bwd(kern.rows, scene.material_fn, scene.params).detach()
        ref = bk.bounce_bwd_lanes_reference(ref_packed, kern.aux, o_, d_, thr_, dec, *cts)
        ref64 = bk.bounce_bwd_lanes_reference(
            ref_packed.double(), kern.aux.double(), o_.double(), d_.double(),
            thr_.double(), dict(dec, u_sel=dec["u_sel"].double()),
            *(c.double() for c in cts))
        want_s, truth_s, scale_s = sums(ref[3]), sums(ref64[3]), sums(ref64[4])
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{tag}: two launches on the same inputs differ")
        Bw = o_.shape[0]
        checks = [_close_f64(f"{name} B={Bw} {n}", g, w, t) for n, g, w, t in
                  zip(("d_o", "d_d", "d_thr"), got[:3], ref[:3], ref64[:3])]
        checks.append(_close_f64(f"{name} B={Bw} {sums_name}", got[3], want_s, truth_s,
                                 scale_s))
        got_p = kern.params_grad(packed, leaves, got[3])
        want_p = bk.bounce_bwd_reference(scene, scene.params, o_, d_, thr_, dec, *cts)[3]
        truth_p = kern.params_grad(*kern.pack_leaves(scene.params), truth_s.float())
        for k, t in truth_p.items():
            if t.numel():
                checks.append(_close_f64(f"{name} B={Bw} d_params {k}", got_p[k], want_p[k],
                                         t, torch.full_like(t, float(t.abs().max()))))
        e = max(c[0] for c in checks[:4])
        for c in checks:
            offs += c[1]
        err2 = max(err2, e)
        lane_e = max(float((g - w).abs().max()) for g, w in zip(got[:3], ref[:3]))
        # relative to Σ|term|, floored at 1e-6 of the largest (entries whose
        # terms all round to ~0 have no meaningful relative error)
        floor = 1e-6 * float(scale_s.max()) + 1e-30
        sums_rel = float(((got[3] - want_s).abs() / scale_s.clamp(min=floor)).max())
        log(f"[{tag}] B={Bw} continuing="
            f"{int((dec['take_transmit'] | dec['scatter_alive']).sum())} max_abs_err "
            f"{e:.3g}: per lane {lane_e:.3g} (largest |d_o| "
            f"{float(ref64[0].abs().max()):.4g}, |d_d| {float(ref64[1].abs().max()):.4g}), "
            f"{sums_name} {float((got[3] - want_s).abs().max()):.3g} (at most "
            f"{sums_rel:.3g} of their Σ|term|), d_params max diff "
            f"{max(c[0] for c in checks[4:]):.3g}; two launches bit-identical; "
            "no NaN/Inf")
    if offs:
        raise AssertionError(f"{tag}: {name} outside tolerance:\n" + "\n".join(offs))
    return err2


def _check_hists(hists, tag, kernel="K3", n=3, outputs=None):
    """K3 (or K8) against ``hist_reference`` on each of the ``n`` recorded
    histograms: the recorded output where ``outputs`` is given, else a
    fresh call of the routing.  Returns max|k − p|."""
    from ptx_torch.ops import imagegrad

    if len(hists) != n:
        raise AssertionError(f"{tag}: {len(hists)} histograms, expected {n}")
    err = 0.0
    for i, (yi, xi, inb, ct, shape) in enumerate(hists):
        if kernel != ("K3" if imagegrad.fits_k3(shape) else "K8"):
            raise AssertionError(f"{tag}: a {tuple(shape)} image does not route to {kernel}")
        got = outputs[i] if outputs is not None else imagegrad.hist(yi, xi, inb, ct, shape)
        e = _hist_bound_ok(f"{kernel} N={yi.numel()}", got, yi, xi, inb, ct, shape)
        err = max(err, e)
        log(f"[{tag}] {tuple(shape)} N={yi.numel()} in bounds {int(inb.sum())} "
            f"max_abs_err {e:.3g}")
    return err


def _wavefront_widths(B, depth):
    """The widths ``trace_rays`` gives the bounces of a compacted B-ray
    wavefront: B for bounces 0-1, B // 3 for 2-5, B // 16 from 6 on."""
    return [B] * 2 + [B // 3] * 4 + [B // 16] * (depth + 1 - 6)


def phase_backward_kernels(scene):
    """K2 and K3 against their plain versions on the inputs the render's
    chunk gives them: the first 65,536-ray chunk of band 256 (the key
    ``render_rows`` gives it), forward + backward of the radiance sum."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera, sample_rays
    from ptx_torch.integrate.trace import trace_rays
    from ptx_torch.ops import imagegrad

    recorded, hists = [], []
    sk = _recording_bwd(scene, recorded)
    key = rng.fold(rng.PRNGKey(0), 0, 256)
    o, d = sample_rays(Camera.reference_demo(W, H), key, range(256, 256 + BAND_ROWS),
                       range(W), 1, scene.device)
    with _recording_hists(hists):
        trace_rays(sk, _leaf_params(scene.params), o, d, key, DEPTH).sum().backward()
        torch.cuda.synchronize()
    B = BAND_ROWS * W
    widths = sorted((r[0].shape[0] for r in recorded), reverse=True)
    if widths != _wavefront_widths(B, DEPTH - 1):
        raise AssertionError(f"K2 widths {widths}, expected "
                             f"{_wavefront_widths(B, DEPTH - 1)}")
    err2 = _check_k2(scene, recorded, "5 K2 vs plain")
    err3 = _check_hists(hists, "5 K3 vs plain")
    g = torch.Generator(device=scene.device).manual_seed(0)
    big = (512, 1024, 4)
    N = 1 << 20
    yi = torch.randint(0, big[0], (N,), device=scene.device, generator=g)
    xi = torch.randint(0, big[1], (N,), device=scene.device, generator=g)
    inb = torch.rand(N, device=scene.device, generator=g) < 0.95
    ct = torch.randn((N, 4), device=scene.device, generator=g)
    e8 = _check_hists([(yi, xi, inb, ct, big)], "5 K8 vs plain", "K8", 1)
    k2_in = next(r for r in recorded if r[0].shape[0] == B)
    k3_in = max(hists, key=lambda h: h[0].numel())      # phase 0's sky-select
    return err2, err3, e8, k2_in, k3_in


def _plain_scene(scene):
    """``scene`` with every kernel's plain version: the dense hit, the
    plain bounce and replay backward (K1's and K2's plain versions, the
    unfused composition on the dense hit) and ``eval_emissive``."""
    from ptx_torch.ops.bounce_kernel import bounce_bwd_reference, bounce_reference

    return dataclasses.replace(
        scene, hit_fn=scene.plain_hit_fn,
        bounce_fn=functools.partial(bounce_reference, scene),
        bounce_bwd_fn=functools.partial(bounce_bwd_reference, scene),
        emission_fn=scene.material_fn.eval_emissive if scene.emission_fn else None)


def phase_gradients(scene, tag="6 gradients", plain_cm=None):
    """Kernel path vs plain path on a compacted 32-row band at spp 2; the
    plain path runs every kernel's plain version, ``hist_reference`` for
    the histograms, and ``plain_cm`` (a context manager) around it where a
    kernel is reached through a module function."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera, sample_rays
    from ptx_torch.integrate.trace import trace_rays
    from ptx_torch.ops import imagegrad

    key = rng.fold(rng.PRNGKey(0), 0, 240)
    o, d = sample_rays(Camera.reference_demo(W, H), key, range(240, 272), range(W), 2,
                       scene.device)

    def grads(sc):
        p = _leaf_params(scene.params)
        trace_rays(sc, p, o, d, key, DEPTH).mean().backward()
        torch.cuda.synchronize()
        return _flat_grads(p)

    g_k = grads(scene)
    plain_hist = imagegrad.hist
    imagegrad.hist = imagegrad.hist_reference
    try:
        with plain_cm or contextlib.nullcontext():
            g_p = grads(_plain_scene(scene))
    finally:
        imagegrad.hist = plain_hist
    offs = _close_per_tensor(f"{tag}: gradients kernel vs plain", g_k, g_p)
    if offs:
        raise AssertionError("\n".join(offs))
    worst = max(float((g_k[k] - g_p[k]).abs().max()) if g_p[k].numel() else 0.0
                for k in g_p)
    images = ", ".join(f"|d {k}| {float(v.abs().sum()):.4g}" for k, v in g_k.items()
                       if k.startswith("images"))
    log(f"[{tag}] 32x{W} spp 2 depth {DEPTH} (32,768 rays, compacted): kernel "
        f"path vs plain path, {len(g_p)} param tensors incl. every image, max abs "
        f"diff {worst:.3g}; |d sphere_radius| {float(g_k['sphere_radius'].abs().sum()):.4g}"
        f", {images}")
    if not all(float(v.abs().sum()) > 0 for k, v in g_k.items() if k.startswith("images")):
        raise AssertionError(f"{tag}: an image got no gradient")
    return worst


def _reset_counters():
    from ptx_torch.ops import bounce_kernel as bk, emission_kernel as ek
    from ptx_torch.ops import fasthit_kernel as fk, imagegrad, megasweep, sweep_kernel
    from ptx_torch.ops.replay_bwd import RowFedReplayBwd

    bk.LAUNCHES = bk.REFERENCE_CALLS = bk.BWD_REFERENCE_CALLS = 0
    bk.BounceBwdKernel.LAUNCHES = bk.BounceBwdKernel.PACKS = 0
    bk.BounceBwdKernel.PACK_VJPS = 0
    imagegrad.LAUNCHES = imagegrad.REFERENCE_CALLS = 0
    imagegrad.BandedHistKernel.LAUNCHES = 0
    fk.LAUNCHES = fk.REFERENCE_CALLS = 0
    ek.LAUNCHES = ek.REFERENCE_CALLS = 0
    megasweep.MegaSweepKernel.LAUNCHES = megasweep.REFERENCE_CALLS = 0
    RowFedReplayBwd.LAUNCHES = 0
    sweep_kernel.LAUNCHES = sweep_kernel.REFERENCE_CALLS = 0


def _counters():
    from ptx_torch.ops import bounce_kernel as bk, emission_kernel as ek
    from ptx_torch.ops import fasthit_kernel as fk, imagegrad, megasweep, sweep_kernel
    from ptx_torch.ops.replay_bwd import RowFedReplayBwd

    return {"K1": bk.LAUNCHES, "K2": bk.BounceBwdKernel.LAUNCHES,
            "K2 packs": bk.BounceBwdKernel.PACKS,
            "K2 pack VJPs": bk.BounceBwdKernel.PACK_VJPS,
            "K3": imagegrad.LAUNCHES, "K4": fk.LAUNCHES,
            "K5": megasweep.MegaSweepKernel.LAUNCHES, "K6": RowFedReplayBwd.LAUNCHES,
            "K7": ek.LAUNCHES, "K8": imagegrad.BandedHistKernel.LAUNCHES,
            "K9": sweep_kernel.LAUNCHES,
            "plain": (bk.REFERENCE_CALLS + bk.BWD_REFERENCE_CALLS + imagegrad.REFERENCE_CALLS
                      + fk.REFERENCE_CALLS + ek.REFERENCE_CALLS + megasweep.REFERENCE_CALLS
                      + sweep_kernel.REFERENCE_CALLS)}


def _expect(steps=0, **per_kernel):
    """Exact launch counts: the given kernels, every other kernel 0, and
    no plain-version call; ``steps`` K2 train steps or backward passes,
    each packing K2's scene vector once and running its VJP once."""
    out = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "plain"), 0)
    out.update(per_kernel)
    out["K2 packs"] = out["K2 pack VJPs"] = steps
    return out


def phase_train(scene, tag, expect, recorder=None, spp=SPP):
    """3 ``make_train_step`` steps at full size (512², ``spp``, depth 16),
    the counters zeroed just before; ``expect`` the exact launch counts of
    the 3 steps; ``recorder`` an optional context manager held around the
    steps."""
    import math

    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.parallel.render import _local_render, make_train_step

    cam = Camera.reference_demo(W, H)
    with torch.no_grad():
        target = _local_render(scene, cam, DEPTH, spp, scene.params, rng.PRNGKey(1), 0, H)
    params = dict(scene.params)
    params["sphere_radius"] = scene.params["sphere_radius"] * 1.05
    const = scene.params["const"].clone()
    const[0] -= 0.1
    params["const"] = const
    step = make_train_step(scene, cam, spp=spp, depth=DEPTH, learning_rate=LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    with recorder or contextlib.nullcontext():
        _reset_counters()
        for i in range(3):
            t0 = time.perf_counter()
            new, loss = step(params, target, rng.fold(rng.PRNGKey(2), i))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            sq = 0.0
            for k in params:
                for a, b in zip(*(x if isinstance(x, list) else [x]
                                  for x in (params[k], new[k]))):
                    sq += float((((a - b) / LR) ** 2).sum())
            gnorm = math.sqrt(sq)
            log(f"[{tag}] step {i}: loss {float(loss):.6g} grad norm {gnorm:.6g} "
                f"{secs[-1]:.3f} s")
            if not (math.isfinite(float(loss)) and math.isfinite(gnorm) and gnorm > 0):
                raise AssertionError("train step: loss or gradient not finite")
            params = new
        c = _counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{tag}] {W}x{H} spp {spp} depth {DEPTH} ({W * H * spp:,} rays per step): "
        f"launches {c} (expected {expect}); peak memory {peak:.3f} GiB; "
        f"seconds per step {[round(x, 4) for x in secs]}")
    if c != expect:
        raise AssertionError(f"train launches {c}, expected {expect}")
    return c, secs, peak, target


def phase_train_kernels(scene, target):
    """K1, K2 and K3 against their plain versions on the inputs one
    ``make_train_step`` step gives them at full size: a step from the true
    params with every kernel call's inputs recorded.  K1 and K2 run there
    at 4,194,304, 1,398,101 and 262,144 lanes, where each K2 block walks
    many 128-lane tiles (its grid is capped at 1,024 blocks), and K3 on
    the sky-select rows of each phase.  The checks and tolerances are
    phase 3's for K1 and phase 5's for K2 and K3."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.ops.bounce_kernel import bounce_reference
    from ptx_torch.parallel.render import make_train_step

    fwd, bwd, hists = [], [], []
    sk = _recording_bwd(scene, bwd)
    sk = dataclasses.replace(sk, bounce_fn=_recording(scene.bounce_fn, fwd))
    step = make_train_step(sk, Camera.reference_demo(W, H), spp=SPP, depth=DEPTH,
                           learning_rate=LR)
    with _recording_hists(hists):
        step(scene.params, target, rng.PRNGKey(2))
        torch.cuda.synchronize()
    N = W * H * SPP
    widths = [inputs[0].shape[0] for inputs, _ in fwd]
    if widths != _wavefront_widths(N, DEPTH):
        raise AssertionError(f"train step: K1 widths {widths}, expected "
                             f"{_wavefront_widths(N, DEPTH)}")
    widths = sorted((r[0].shape[0] for r in bwd), reverse=True)
    if widths != _wavefront_widths(N, DEPTH - 1):
        raise AssertionError(f"train step: K2 widths {widths}, expected "
                             f"{_wavefront_widths(N, DEPTH - 1)}")
    flips, err1 = 0, 0.0
    while fwd:
        inputs, out_k = fwd.pop(0)
        with torch.no_grad():
            out_p = bounce_reference(scene, scene.params, *inputs)
        torch.cuda.synchronize()
        f, e = compare_bounce(scene, inputs, out_k, out_p)
        flips, err1 = flips + f, max(err1, e)
        log(f"[8 train-width K1 vs plain] bounce {DEPTH - len(fwd)}: B={inputs[0].shape[0]} "
            f"alive={int(inputs[4].sum())} flips={f} max_abs_err={e:.3g}")
        del inputs, out_k, out_p
    err2 = _check_k2(scene, bwd, "8 train-width K2 vs plain")
    err3 = _check_hists(hists, "8 train-width K3 vs plain")
    o, d, thr, dec, cts = next(r for r in bwd if r[0].shape[0] == N)
    kern = scene.bounce_bwd_fn
    packed = kern.pack(scene.params).detach()
    bare = [_time_back_to_back_ms(lambda: kern.launch(packed, o, d, thr, dec, *cts))
            for _ in range(2)]
    continuing = int((dec["take_transmit"] | dec["scatter_alive"]).sum())
    bound = bound_k2(N, continuing, packed.numel())
    log(f"[8 train-width timing] K2 bare launch at B={N} (continuing {continuing}): "
        f"{bare[0]:.4f} / {bare[1]:.4f} ms (mean of 20 back to back); bound "
        f"{bound[0]:.4g} ms ({bound[1]})")
    return flips, err1, err2, err3


def phase_fwd_bwd(scene):
    """Forward + backward of one bench-shaped chunk (128 rows × 512, spp 1,
    depth 16), and the forward alone: median seconds of 10 chunks."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera, sample_rays
    from ptx_torch.integrate.trace import trace_rays

    cam = Camera.reference_demo(W, H)
    rays = BAND_ROWS * W * (DEPTH + 1)

    def run(grad):
        times = []
        for i in range(12):
            key = rng.fold(rng.PRNGKey(0), i, 128)
            o, d = sample_rays(cam, key, range(128, 256), range(W), 1, scene.device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            if grad:
                p = _leaf_params(scene.params)
                trace_rays(scene, p, o, d, key, DEPTH).mean().backward()
            else:
                with torch.no_grad():
                    trace_rays(scene, scene.params, o, d, key, DEPTH)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        return statistics.median(times[2:])

    f1, fb1, fb2, f2 = run(False), run(True), run(True), run(False)
    log(f"[9 fwd+bwd] chunk 128x{W} spp 1 depth {DEPTH}: fwd+bwd {fb1:.4f} / "
        f"{fb2:.4f} s = {rays / fb1:.4g} / {rays / fb2:.4g} rays/s; forward alone "
        f"{f1:.4f} / {f2:.4f} s = {rays / f1:.4g} / {rays / f2:.4g} rays/s (median "
        f"of 10 chunks between CUDA events)")
    return rays / min(fb1, fb2), rays / min(f1, f2)


# The card's peaks (NVIDIA's data sheet, H100 SXM at 700 W): HBM bytes/s
# and float32 operations/s outside the tensor cores.
HBM_BPS = 3.35e12
F32_OPS = 67e12


def _bound(nbytes, ops):
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def bound_k1(B, L):
    """K1 at B lanes: reads o, d, thr, strength, alive, u_coin, u3 (57 B),
    writes t, o2, d2, thr2, strength2, flags, evt, u_sel (64 B); operations
    (estimate, every lane): ~25 per leaf interval, 2 compares per (event,
    leaf) pair of the membership fold, ~250 for shading and the scatter."""
    return _bound(121 * B, B * (25 * L + 4 * L * L + 250))


def bound_k2(B, continuing, sum_words):
    """K2 (and K6): reads o, d, thr, u_sel and three cotangents (21 floats,
    84 B), evt and four flags (8 B), writes d(o, d, thr) (36 B), plus the
    ``sum_words`` floats of the scene's sums (K2's ``d_packed``, L·26 +
    M·8; K6's (L, 34)); operations: ~450 per continuing lane (replay and
    reverse sweep) and its 34 adds into the per-leaf sums; other lanes
    copy."""
    return _bound(128 * B + 4 * sum_words, continuing * (450 + 34))


def bound_k3(yi, inb, ct, shape):
    """K3: reads yi, xi (int64), inb and C floats per lane, writes the
    image once; one add per channel of each in-bounds lane."""
    N, C = ct.shape
    texels = shape[0] * shape[1] * shape[2]
    return _bound((17 + 4 * C) * N + 4 * texels, C * int(inb.sum()))


def _library_hists(yi, xi, inb, ct, shape):
    """The two PyTorch calls that compute the gather's transpose:
    ``index_put_(accumulate=True)`` on the (H, W, C) image and
    ``index_add_`` on its flat (H·W, C) view (masked cotangents and flat
    indices made beforehand)."""
    import torch

    ct_m = torch.where(inb[:, None], ct, 0.0)
    flat = yi * shape[1] + xi
    put = lambda: torch.zeros(shape, device=ct.device).index_put_((yi, xi), ct_m,
                                                                  accumulate=True)
    add = lambda: torch.zeros((shape[0] * shape[1], shape[2]), device=ct.device).index_add_(
        0, flat, ct_m)
    return put, add


def phase_timing_backward(scene, k2_in, k3_in):
    """K2 and K3 as the main path calls them against their plain versions
    (K3 also against ``index_put_`` and ``index_add_``), in turns: plain,
    kernel, kernel, plain.  K2: the per-bounce wrapper as
    ``ManualBounce.backward`` calls it (input checks, allocations, the two
    launches), the once-per-call pack + VJP (``pack_bwd`` of the params with
    history, then its VJP on one ``d_packed``), and for a step's 16
    backward bounces 16 wrappers + one pack + VJP beside 16 times the
    per-bounce params route (launch, pack and VJP on every bounce, as the
    wrapper did before ``d_packed``)."""
    import torch
    from ptx_torch.ops import bounce_kernel as bk, imagegrad

    kern = scene.bounce_bwd_fn
    o, d, thr, dec, cts = k2_in
    packed = bk.pack_bwd(kern.rows, scene.material_fn, scene.params).detach()
    d_packed = kern(packed, o, d, thr, dec, *cts)[3]
    k2 = lambda: kern(packed, o, d, thr, dec, *cts)
    k2p = lambda: kern.reference(packed, o, d, thr, dec, *cts)
    k2_bare = lambda: kern.launch(packed, o, d, thr, dec, *cts)
    pack_vjp = lambda: kern.params_grad(*kern.pack_leaves(scene.params), d_packed)
    route = lambda: kern.params_grad(*kern.pack_leaves(scene.params),
                                     kern(packed, o, d, thr, dec, *cts)[3])
    whole = lambda: bk.bounce_bwd_reference(scene, scene.params, o, d, thr, dec, *cts)
    p1, a1 = _time_ms(k2p), _time_ms(whole)
    w1, w2 = _time_ms(k2), _time_ms(k2)
    v1, r1, r2, v2 = _time_ms(pack_vjp), _time_ms(route), _time_ms(route), _time_ms(pack_vjp)
    b1, b2 = _time_back_to_back_ms(k2_bare), _time_back_to_back_ms(k2_bare)
    a2, p2 = _time_ms(whole), _time_ms(k2p)
    n_bwd = DEPTH
    step_new, step_old = n_bwd * min(w1, w2) + min(v1, v2), n_bwd * min(r1, r2)
    yi, xi, inb, ct, shape = k3_in
    k3 = lambda: imagegrad.hist(yi, xi, inb, ct, shape)
    k3p = lambda: imagegrad.hist_reference(yi, xi, inb, ct, shape)
    put, add = _library_hists(yi, xi, inb, ct, shape)
    q1, l1, m1 = _time_ms(k3p), _time_ms(put), _time_ms(add)
    h1, h2 = _time_ms(k3), _time_ms(k3)
    m2, l2, q2 = _time_ms(add), _time_ms(put), _time_ms(k3p)
    log(f"[10 timing] K2 at B={o.shape[0]}: per-bounce wrapper (checks, allocations, "
        f"two launches) {w1:.4f} / {w2:.4f} ms; bare launch {b1:.4f} / {b2:.4f} ms (mean "
        f"of 20 back to back); plain (lanes + fold) {p1:.4f} / {p2:.4f} ms; whole-bounce "
        f"plain (autograd of the replay to the params) {a1:.4f} / {a2:.4f} ms")
    log(f"[10 timing] K2 pack + VJP once per trace_rays call {v1:.4f} / {v2:.4f} ms; "
        f"per-bounce params route (launch + pack + VJP) {r1:.4f} / {r2:.4f} ms; a step's "
        f"{n_bwd} backward bounces: {n_bwd} wrappers + one pack + VJP {step_new:.4f} ms, "
        f"{n_bwd} x the per-bounce params route {step_old:.4f} ms")
    log(f"[10 timing] K3 at N={yi.numel()} on {tuple(shape)}: wrapper {h1:.4f} / "
        f"{h2:.4f} ms; plain {q1:.4f} / {q2:.4f} ms; index_put_(accumulate=True) "
        f"{l1:.4f} / {l2:.4f} ms; index_add_ (flat) {m1:.4f} / {m2:.4f} ms (each the "
        f"median of 20 single calls)")
    continuing = int((dec["take_transmit"] | dec["scatter_alive"]).sum())
    return ((min(w1, w2), min(p1, p2), bound_k2(o.shape[0], continuing, packed.numel()),
             min(v1, v2), step_new, step_old),
            (min(h1, h2), min(q1, q2), min(l1, l2), bound_k3(yi, inb, ct, shape),
             min(m1, m2)))


# ---------------------------------------------------------------------------
# the small-scene paths: config 4 (unfused bounce, K4), the probe (K8), K7
# ---------------------------------------------------------------------------

HIT_DECISIONS = ("_evt", "hit", "entering", "mat_id")
PROBE = (1536, 3072)            # the reference-scale probe, bench.py --sky 1536x3072


@contextlib.contextmanager
def _swapped(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def _all(*cms):
    with contextlib.ExitStack() as stack:
        for cm in cms:
            stack.enter_context(cm)
        yield


class _RecordingHit:
    """A hit (K4's wrapper, or any ``hit_fn``), logging each call's rays
    and output."""

    def __init__(self, kern, log_list):
        self.kern, self.log = kern, log_list

    def pack(self, params):
        pack = getattr(self.kern, "pack", None)
        return pack(params) if pack is not None else None

    def __call__(self, params, o, d, packed=None):
        out = (self.kern(params, o, d) if packed is None
               else self.kern(params, o, d, packed=packed))
        self.log.append((o, d, out))
        return out


def _recording_em(kern, log_list):
    """K7's wrapper, logging each call's params, inputs and output."""
    def call(params, pos, mid):
        out = kern(params, pos, mid)
        log_list.append((params, pos, mid, out))
        return out
    return call


def compare_hit(scene, o, d, out_k, out_p, name="K4"):
    """K4 (or ``name``) vs the plain hit on one wavefront: (flips,
    max_abs_err); raises on a flip a float64 recompute does not put at a
    near-tie, or a float outside ``rtol 1e-5, atol 5e-6`` (the normal on hit
    lanes)."""
    import torch

    differ = torch.zeros_like(out_k["hit"])
    for k in HIT_DECISIONS:
        differ |= out_k[k] != out_p[k]
    lanes = differ.nonzero().flatten().cpu()
    if lanes.numel():
        p64 = _f64_cpu(scene.params)
        tied = _winner_tied(scene, p64, o.cpu()[lanes].double(), d.cpu()[lanes].double(),
                            lanes)
        ok = tied(out_k["_evt"]) | tied(out_p["_evt"])
        if not bool(ok.all()):
            raise AssertionError(f"{name}: {int((~ok).sum())} unexplained decision flips, "
                                 f"lanes {lanes[~ok][:8].tolist()}")
    max_err = 0.0
    for k, keep in (("t", ~differ), ("normal", ~differ & out_p["hit"])):
        a, b = out_k[k][keep], out_p[k][keep]
        torch.testing.assert_close(a, b, rtol=1e-5, atol=5e-6,
                                   msg=lambda m: f"{name} {k}: {m}")
        max_err = max(max_err, float((a - b).abs().max()) if a.numel() else 0.0)
    return int(lanes.numel()), max_err


def phase_k4_chunk(c4):
    """K4 vs the dense hit on every bounce input of the first 65,536-ray
    chunk of config 4's band 256 as ``render_rows`` runs it: widths 65,536,
    21,845 and 4,096, fillers included."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.integrate.render import render_rows

    rec = []
    with _swapped(c4, "hit_fn", _RecordingHit(c4.hit_fn, rec)):
        render_rows(c4, c4.params, Camera.reference_demo(W, H), rng.PRNGKey(0), 256,
                    BAND_ROWS, 1, 1, DEPTH)
    widths = [o.shape[0] for o, _, _ in rec]
    if widths != _wavefront_widths(BAND_ROWS * W, DEPTH):
        raise AssertionError(f"K4 widths {widths}")
    flips, err = 0, 0.0
    for b, (o, d, out_k) in enumerate(rec):
        out_p = c4.plain_hit_fn(c4.params, o, d)
        torch.cuda.synchronize()
        f, e = compare_hit(c4, o, d, out_k, out_p)
        flips, err = flips + f, max(err, e)
        log(f"[A1 K4 vs plain] config4 band 256 chunk 0 bounce {b}: B={o.shape[0]} "
            f"hit={int(out_k['hit'].sum())} flips={f} max_abs_err={e:.3g}")
    return flips, err, rec[0][:2]


def phase_render_cli(demo, tag, expect):
    """``python -m ptx_torch render --demo <demo>`` at 512², spp 16, d16
    through ``ptx_torch.cli.main``, the counters zeroed just before."""
    import numpy as np
    import torch
    from ptx_torch import cli

    _reset_counters()
    t0 = time.perf_counter()
    frame = cli.main(["render", "--demo", demo, "--width", str(W), "--height", str(H),
                      "--spp", str(SPP), "--depth", str(DEPTH), "--device", "cuda",
                      "--out", os.path.join(OUT, f"smoke_{demo}")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counters()
    rays = W * H * SPP * (DEPTH + 1)
    log(f"[{tag}] render --demo {demo} {W}x{H} spp {SPP} depth {DEPTH}: wall {wall:.3f} s "
        f"incl. scene compile and image writes, {rays / wall:.4g} rays/s; launches {c} "
        f"(expected {expect}); image mean {float(frame.mean()):.6g}")
    if frame.shape != (H, W, 3) or not np.isfinite(frame).all() or not frame.mean() > 0:
        raise AssertionError(f"{tag}: render is not a finite, non-black (H, W, 3) image")
    if c != expect:
        raise AssertionError(f"{tag}: render launches {c}, expected {expect}")
    return rays / wall


def _texel_boundary_lanes(kern, params, pos, tol=1e-6):
    """Lanes whose chain coordinates, recomputed in float64, lie within
    ``tol`` (in uv units) of a texel boundary: there a float32 rounding
    picks either texel."""
    import torch
    from ptx_torch.shade.textures import _mirror_ball_uv, _spherical_uv

    q = pos.double()
    if kern.xform_idx is not None:
        A = params["tex_xform"][kern.xform_idx].detach().double()
        q = q @ A[:, :3].T + A[:, 3]
    uv = (_mirror_ball_uv if kern.mirror else _spherical_uv)(q)
    img = params["images"][kern.img_id]
    x = (uv[:, 0] - torch.floor(uv[:, 0])) * img.shape[1]
    y = (1.0 - (uv[:, 1] - torch.floor(uv[:, 1]))) * img.shape[0]
    return (((x - torch.round(x)).abs() <= tol * img.shape[1])
            | ((y - torch.round(y)).abs() <= tol * img.shape[0]))


def _check_k7(scene, calls, tag):
    """K7 against ``eval_emissive`` on each recorded call's inputs: ``rtol
    1e-5, atol 1e-6`` except lanes of the chain's material whose texel a
    float64 recompute puts within 1e-6 of a boundary.  Returns (max|k − p|
    on the other lanes, the lanes off only by such a boundary)."""
    import torch

    kern = scene.emission_fn
    err, n_near = 0.0, 0
    for params, pos, mid, em_k in calls:
        with torch.no_grad():
            p = {k: ([x.detach() for x in v] if isinstance(v, list) else v.detach())
                 for k, v in params.items()}
            em_p = scene.material_fn.eval_emissive(p, pos, mid)
            near = _texel_boundary_lanes(kern, p, pos) & (mid == kern.dyn_mi)
        torch.cuda.synchronize()
        close = torch.isclose(em_k.detach(), em_p, rtol=1e-5, atol=1e-6).all(dim=-1)
        if not bool((close | near).all()):
            raise AssertionError(f"{tag}: K7 differs from eval_emissive on "
                                 f"{int((~(close | near)).sum())} lanes")
        e = float((em_k.detach() - em_p)[~near].abs().max())
        flips = int((~close & near).sum())
        err, n_near = max(err, e), n_near + flips
        log(f"[{tag}] N={pos.shape[0]} chain lanes {int((mid == kern.dyn_mi).sum())}, "
            f"{int(near.sum())} within 1e-6 of a texel boundary, {flips} of them off "
            f"(another texel); max_abs_err {e:.3g} elsewhere")
    return err, n_near


def phase_k7_chunk(scene, tag):
    """One 65,536-ray chunk (band 256 of the render, depth 16) with the
    counters zeroed: K1 17 and K7 once (``trace_rays`` evaluates emission
    once, on all phases' records), no histogram, no plain call; K7 held
    against ``eval_emissive`` on its inputs."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.integrate.render import render_rows

    calls = []
    with _swapped(scene, "emission_fn", _recording_em(scene.emission_fn, calls)):
        _reset_counters()
        with torch.no_grad():
            band = render_rows(scene, scene.params, Camera.reference_demo(W, H),
                               rng.PRNGKey(0), 256, BAND_ROWS, 1, 1, DEPTH)
        torch.cuda.synchronize()
        c = _counters()
    expect = _expect(K1=DEPTH + 1, K7=1)
    log(f"[{tag}] one chunk of {BAND_ROWS * W} rays: launches {c} (expected {expect}); "
        f"band mean {float(band.mean()):.6g}")
    if c != expect or not bool(torch.isfinite(band).all()):
        raise AssertionError(f"{tag}: chunk launches {c}, expected {expect}, or not finite")
    err, near = _check_k7(scene, calls, tag)
    _, pos, mid, _ = calls[0]
    return err, near, (pos, mid)


def phase_train_k7(scene):
    """3 train steps of the demo with K7: K1 17, K2 16, K7 1 and K3 1 per
    step (K7's backward: one combined histogram of the sky image and the
    const rows, (64 + R) × 128 × 3, inside K3's shared memory); every K7
    call and every histogram held against its plain version."""
    calls, hists, outs = [], [], []
    c, secs, peak, _ = phase_train(
        scene, "C2 K7 train", _expect(3, K1=3 * (DEPTH + 1), K2=3 * DEPTH, K7=3, K3=3),
        _all(_swapped(scene, "emission_fn", _recording_em(scene.emission_fn, calls)),
             _recording_hists(hists, outs)))
    err7, near = _check_k7(scene, calls, "C2 train-width K7 vs plain")
    err3 = _check_hists(hists, "C2 train-width K3 (K7 backward) vs plain", "K3", 3, outs)
    return c, secs, peak, err7, near, err3


def phase_probe(pb):
    """The 1536×3072 probe: 3 train steps of the demo under that sky, K1
    17, K2 16 and K8 3 per step (one per phase's sky-select gradient, the
    75.5 MB image past K3's shared memory), K3 0; every K8 call's output
    held against ``hist_reference`` within the reordered-sum bound."""
    hists, outs = [], []
    c, secs, peak, _ = phase_train(
        pb, "B1 probe train", _expect(3, K1=3 * (DEPTH + 1), K2=3 * DEPTH, K8=9),
        _recording_hists(hists, outs))
    err8 = _check_hists(hists, "B2 probe K8 vs plain", "K8", 9, outs)
    k8_in = max(hists, key=lambda h: h[0].numel())
    return c, secs, peak, err8, k8_in


def bound_k4(B, L):
    """K4 at B lanes: reads o, d (24 B), writes t, normal, flags, evt
    (24 B); operations (estimate): ~25 per leaf interval and 2 compares
    per (event, leaf) pair of the membership fold."""
    return _bound(48 * B, B * (25 * L + 4 * L * L))


def bound_k7(N, img):
    """K7 at N lanes: reads pos and mid (20 B) and the image once, writes
    em, texel, xi, yi, flags and row (40 B); ~90 operations a lane."""
    return _bound(60 * N + img.numel() * 4, 90 * N)


def phase_timing_small(c4, k4_in, pe, k7_in, k8_in):
    """K4, K7 and K8 as the main path calls them against their plain
    versions (K8 also against ``index_put_``), in turns: plain, kernel,
    kernel, plain."""
    import torch
    from ptx_torch.ops import imagegrad

    o, d = k4_in
    buf = c4.hit_fn.pack(c4.params)
    k4 = lambda: c4.hit_fn(c4.params, o, d, packed=buf)
    k4p = lambda: c4.plain_hit_fn(c4.params, o, d)
    p1, w1, w2, p2 = _time_ms(k4p), _time_ms(k4), _time_ms(k4), _time_ms(k4p)
    log(f"[10 timing] K4 at B={o.shape[0]} (wrapper: launch + decode) {w1:.4f} / "
        f"{w2:.4f} ms; plain dense hit {p1:.4f} / {p2:.4f} ms")
    k4_t = (min(w1, w2), min(p1, p2), bound_k4(o.shape[0], c4.hit_fn.layout[0]))

    pos, mid = k7_in
    kern = pe.emission_fn
    with torch.no_grad():
        k7 = lambda: kern(pe.params, pos, mid)
        k7p = lambda: pe.material_fn.eval_emissive(pe.params, pos, mid)
        q1, v1, v2, q2 = _time_ms(k7p), _time_ms(k7), _time_ms(k7), _time_ms(k7p)
    log(f"[10 timing] K7 at N={pos.shape[0]} (a chunk's concatenated records; wrapper: "
        f"pack + launch) {v1:.4f} / {v2:.4f} ms; plain eval_emissive {q1:.4f} / "
        f"{q2:.4f} ms")
    k7_t = (min(v1, v2), min(q1, q2), bound_k7(pos.shape[0], pe.params["images"][kern.img_id]))

    yi, xi, inb, ct, shape = k8_in
    k8 = lambda: imagegrad.hist(yi, xi, inb, ct, shape)
    k8p = lambda: imagegrad.hist_reference(yi, xi, inb, ct, shape)
    put, add = _library_hists(yi, xi, inb, ct, shape)
    r1, l1, m1 = _time_ms(k8p), _time_ms(put), _time_ms(add)
    h1, h2 = _time_ms(k8), _time_ms(k8)
    m2, l2, r2 = _time_ms(add), _time_ms(put), _time_ms(k8p)
    log(f"[10 timing] K8 at N={yi.numel()} on {tuple(shape)} (wrapper: zero-fill + "
        f"launch) {h1:.4f} / {h2:.4f} ms; plain {r1:.4f} / {r2:.4f} ms; "
        f"index_put_(accumulate=True) {l1:.4f} / {l2:.4f} ms; index_add_ (flat) "
        f"{m1:.4f} / {m2:.4f} ms")
    k8_t = (min(h1, h2), min(r1, r2), bound_k3(yi, inb, ct, shape), min(l1, l2),
            min(m1, m2))
    if not k8_t[0] <= 0.5 * k8_t[3]:
        raise AssertionError(f"K8's wrapper {k8_t[0]:.4f} ms is more than half of "
                             f"index_put_'s {k8_t[3]:.4f} ms")
    return k4_t, k7_t, k8_t


@contextlib.contextmanager
def _env(**kv):
    """The environment variables ``kv`` set for the block, restored after."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)


def _compile_with_emk(root, device):
    """``compile_scene`` with ``PTX_EMK=1`` set around it, as
    tests/test_emission_kernel.py:26-30 does for the JAX package."""
    from ptx_torch.integrate.trace import compile_scene

    with _env(PTX_EMK="1"):
        scene = compile_scene(root, device)
    if scene.emission_fn is None:
        raise AssertionError("PTX_EMK=1 did not build the emission kernel")
    return scene


def _mirror_world():
    """A mirror-ball sky world, as tests/test_emission_kernel.py:87-115."""
    import numpy as np
    from ptx_torch.geom.tape import Sphere
    from ptx_torch.scenes import builders
    from ptx_torch.shade.materials import Material

    probe = np.random.default_rng(7).uniform(0.0, 2.0, (16, 32, 4)).astype(np.float32)
    sky = builders.make_sky_mirror_sphere(probe, scale=(1.5, 1.0, 0.5))
    return builders.union_array([Sphere((0.0, 0.0, -4.0), 1.0,
                                        Material(reflect=0.8, scatter=1.0))]
                                + builders.sky_planes(sky))


# ---------------------------------------------------------------------------
# path D, the large scenes: K5 (megasweep, fused mega bounce) and K6
# ---------------------------------------------------------------------------

def _large_scenes():
    """S1-S4, the JAX package's large-scene ladder at full width."""
    from ptx_torch.scenes import builders

    return {"S1": lambda: builders.stress_spheres(249),
            "S2": lambda: builders.stress_gadgets(112),
            "S3": lambda: builders.stress_spheres(249, transformed=True),
            "S4": lambda: builders.stress_spheres(
                249, sky_image=builders.procedural_sky_image(*PROBE))}


def phase_build_report():
    """D1: registers and stack frame of K5 and K6, from nvcc's report."""
    from ptx_torch.ops import _build

    lines = _build.BUILD_LOG.splitlines()
    out = []
    for kname in ("megasweep_kernel", "replay_bwd_kernel"):
        # the mangled entry name, length-prefixed: not the file's name in it
        i = next(j for j, ln in enumerate(lines)
                 if "Compiling entry function" in ln and f"{len(kname)}{kname}E" in ln)
        report = " ".join(ln.strip() for ln in lines[i + 1:i + 4])
        out.append(f"{kname}: {report}")
    log("[D1 build] " + " | ".join(out))


def _full_frame_chunk(scene, key):
    """A 65,536-ray chunk over the whole frame: every 4th row of the 512²
    camera (the frame's top rows see only the sky at bounce 0)."""
    from ptx_torch.integrate.camera import Camera, sample_rays

    return sample_rays(Camera.reference_demo(W, H), key, range(0, H, 4), range(W), 1,
                       scene.device)


def phase_k5_chunk(scene, tag, hit_check=False):
    """D2: K5 in bounce mode on every bounce of one compacted 65,536-ray
    chunk (full-frame rows, depth 16), recorded as ``trace_rays`` gives
    them (widths 65,536, 21,845, 4,096, fillers included): against its
    plain version (the sweep + the plain shading, ``bounce_reference``)
    as phase 3 holds K1, and cull on against cull off bit for bit.  With
    ``hit_check``, K5 in hit mode against ``megasweep_reference`` on the
    primary rays.  Returns (flips, max_abs_err, the first bounce's inputs,
    the fixpoint passes and active cull flags of the primary bounce)."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.trace import trace_rays
    from ptx_torch.ops.bounce_kernel import bounce_reference

    key = rng.fold(rng.PRNGKey(0), 0, 4)
    o, d = _full_frame_chunk(scene, key)
    rec = []
    sk = dataclasses.replace(scene, bounce_fn=_recording(scene.bounce_fn, rec))
    with torch.no_grad():
        trace_rays(sk, scene.params, o, d, key, DEPTH)
    torch.cuda.synchronize()
    widths = [inputs[0].shape[0] for inputs, _ in rec]
    if widths != _wavefront_widths(BAND_ROWS * W, DEPTH):
        raise AssertionError(f"{tag}: K5 widths {widths}")
    packed = scene.bounce_fn.pack(scene.params)
    flips, err = 0, 0.0
    for b, (inputs, out_k) in enumerate(rec):
        with torch.no_grad():
            out_p = bounce_reference(scene, scene.params, *inputs)
            out_nc = scene.bounce_fn(scene.params, *inputs, packed=packed, cull=False)
        torch.cuda.synchronize()
        if not all(torch.equal(out_k[k], out_nc[k]) for k in out_k):
            raise AssertionError(f"{tag}: bounce {b}: cull on and off differ")
        f, e = compare_bounce(scene, inputs, out_k, out_p)
        flips, err = flips + f, max(err, e)
        log(f"[{tag}] bounce {b}: B={widths[b]} alive={int(inputs[4].sum())} "
            f"hit={int(out_k['hit'].sum())} flips={f} max_abs_err={e:.3g}; cull on == off")
    inputs = rec[0][0]
    raw = scene.bounce_fn.kernel.launch(packed, *inputs[:2], carry=inputs[2:7],
                                        in_depth=True, stats=True)
    stats = raw["stats"].float()
    lay = scene.plain_hit_fn.layout
    log(f"[{tag}] primary bounce: fixpoint passes per lane mean {float(stats[:, 0].mean()):.3f} "
        f"max {int(stats[:, 0].max())}; cull flags active per warp mean "
        f"{float(stats[:, 1].mean()):.3f} of {lay.n_flags}")
    if hit_check:
        hk = scene.hit_fn(scene.params, *inputs[:2])
        with torch.no_grad():
            hp = scene.plain_hit_fn(scene.params, *inputs[:2])
        f, e = compare_hit(scene, *inputs[:2], hk, hp)
        flips, err = flips + f, max(err, e)
        log(f"[{tag}] K5 hit mode vs megasweep_reference on the primary rays: "
            f"hit={int(hk['hit'].sum())} flips={f} max_abs_err={e:.3g}")
    return flips, err, inputs, stats


def phase_k6_chunk(scene, tag):
    """D3: K6 against its plain versions on every backward bounce of one
    fwd+bwd chunk (the D2 chunk, ``radiance.mean()``): per lane, per leaf
    and ``d_params`` as phase 5 holds K2; two launches the same bits."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.trace import trace_rays

    key = rng.fold(rng.PRNGKey(0), 0, 4)
    o, d = _full_frame_chunk(scene, key)
    rec = []
    trace_rays(_recording_bwd(scene, rec), _leaf_params(scene.params), o, d, key,
               DEPTH).mean().backward()
    torch.cuda.synchronize()
    widths = sorted((r[0].shape[0] for r in rec), reverse=True)
    if widths != _wavefront_widths(BAND_ROWS * W, DEPTH - 1):
        raise AssertionError(f"{tag}: K6 widths {widths}")
    err = _check_k2(scene, rec, tag, name="K6")
    return err, next(r for r in rec if r[0].shape[0] == BAND_ROWS * W)


class _WidestBwd:
    """A K6 wrapper that keeps the inputs of its calls at ``width`` lanes."""

    def __init__(self, kern, width):
        self.kern, self.width, self.calls = kern, width, []

    def __getattr__(self, name):
        return getattr(self.kern, name)

    def __call__(self, params, o, d, thr, dec, *cts):
        if o.shape[0] == self.width:
            self.calls.append((o, d, thr, dec, cts))
        return self.kern(params, o, d, thr, dec, *cts)


def phase_train_large(scene, tag, expect, keep_widest=False):
    """D5: 3 ``make_train_step`` steps at 512², spp 16, depth 16 with exact
    launch counts; with ``keep_widest``, the K6 inputs at 4,194,304 lanes."""
    widest = _WidestBwd(scene.bounce_bwd_fn, W * H * SPP) if keep_widest else None
    cm = _swapped(scene, "bounce_bwd_fn", widest) if keep_widest else None
    c, secs, peak, _ = phase_train(scene, tag, expect, cm)
    return c, secs, peak, (widest.calls[0] if keep_widest else None)


def phase_render_scene(tag, kernel="K5"):
    """D6 (E4): ``python -m ptx_torch render --scene scenes/composed.json``
    (512², spp 16, depth 8 from the spec) through ``ptx_torch.cli.main``,
    counters zeroed just before: ``kernel`` (K5; K9 under
    ``PTX_SWEEP_MODE=kernel PTX_MEGAB=0``) 4 bands × 16 samples × 9
    bounces, tile ordering on in every ``trace_rays`` call, nothing
    else."""
    import numpy as np
    import torch
    from ptx_torch import cli
    from ptx_torch.integrate import trace

    _reset_counters()
    tiled = trace.TILE_ORDERED
    t0 = time.perf_counter()
    frame = cli.main(["render", "--scene", os.path.join(ROOT, "scenes", "composed.json"),
                      "--device", "cuda", "--out", os.path.join(OUT, "smoke_composed")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counters()
    tiled = trace.TILE_ORDERED - tiled
    spp, depth = 16, 8
    expect = _expect(**{kernel: (H // BAND_ROWS) * spp * (depth + 1)})
    rays = W * H * spp * (depth + 1)
    log(f"[{tag}] render --scene scenes/composed.json {W}x{H} spp {spp} depth {depth}: wall "
        f"{wall:.3f} s incl. scene compile and image writes, {rays / wall:.4g} rays/s; "
        f"launches {c} (expected {expect}); tile-ordered trace_rays calls {tiled} of "
        f"{(H // BAND_ROWS) * spp}; image mean {float(frame.mean()):.6g}")
    if frame.shape != (H, W, 3) or not np.isfinite(frame).all() or not frame.mean() > 0:
        raise AssertionError(f"{tag}: render is not a finite, non-black (H, W, 3) image")
    if c != expect or tiled != (H // BAND_ROWS) * spp:
        raise AssertionError(f"{tag}: launches {c} or tiled calls {tiled} off")
    return rays / wall


def bound_k5(B, n_rows):
    """K5 in bounce mode at B lanes: reads o, d, thr, strength, alive,
    u_coin, u3 (57 B), writes t, o2, d2, thr2, strength2, flags, evt, mat,
    u_sel (68 B); operations: one unculled pass of interval arithmetic,
    ~25 per (row, ray)."""
    return _bound(125 * B, 25 * n_rows * B)


def phase_timing_large(scene, tag, k5_in, k6_in, k6_wide):
    """D7: K5 (wrapper, bare launch, plain) at 65,536 lanes; K6 (wrapper,
    bare launch, plain) at 65,536 and the bare launch at 4,194,304 lanes;
    in turns plain, kernel, kernel, plain."""
    from ptx_torch.ops import bounce_kernel as bk

    inputs = k5_in
    packed = scene.bounce_fn.pack(scene.params)
    k5 = lambda: scene.bounce_fn(scene.params, *inputs, packed=packed)
    k5p = lambda: bk.bounce_reference(scene, scene.params, *inputs)
    k5b = lambda: scene.bounce_fn.kernel.launch(packed, *inputs[:2], carry=inputs[2:7],
                                                in_depth=True)
    p1, w1, w2, p2 = _time_ms(k5p), _time_ms(k5), _time_ms(k5), _time_ms(k5p)
    b1, b2 = _time_back_to_back_ms(k5b), _time_back_to_back_ms(k5b)
    B = inputs[0].shape[0]
    lay = scene.plain_hit_fn.layout
    k5_bound = bound_k5(B, lay.ns + lay.npl)
    log(f"[{tag}] K5 bounce mode at B={B} (L={lay.L}, {lay.ns + lay.npl} rows): wrapper "
        f"{w1:.4f} / {w2:.4f} ms; bare launch {b1:.4f} / {b2:.4f} ms (mean of 20 back to "
        f"back); plain {p1:.4f} / {p2:.4f} ms; bound {k5_bound[0]:.4g} ms ({k5_bound[1]})")
    kern = scene.bounce_bwd_fn
    o, d, thr, dec, cts = k6_in
    k6 = lambda: kern(scene.params, o, d, thr, dec, *cts)
    k6p = lambda: bk.bounce_bwd_reference(scene, scene.params, o, d, thr, dec, *cts)
    p36 = kern.pack36(scene.params).detach()
    k6b = lambda: kern.launch(p36, o, d, thr, dec, *cts)
    q1, v1, v2, q2 = _time_ms(k6p), _time_ms(k6), _time_ms(k6), _time_ms(k6p)
    c1, c2 = _time_back_to_back_ms(k6b), _time_back_to_back_ms(k6b)
    L = len(kern.leaves)
    cont = int((dec["take_transmit"] | dec["scatter_alive"]).sum())
    k6_bound = bound_k2(o.shape[0], cont, 34 * L)
    wide = ""
    if k6_wide is not None:
        o2, d2, thr2, dec2, cts2 = k6_wide
        wb = _time_back_to_back_ms(lambda: kern.launch(p36, o2, d2, thr2, dec2, *cts2))
        wbound = bound_k2(o2.shape[0], int((dec2["take_transmit"] | dec2["scatter_alive"]).sum()),
                          34 * L)
        wide = (f"; bare launch at B={o2.shape[0]} {wb:.4f} ms, bound {wbound[0]:.4g} ms "
                f"({wbound[1]})")
    log(f"[{tag}] K6 at B={o.shape[0]} (continuing {cont}): wrapper {v1:.4f} / {v2:.4f} ms; "
        f"bare launch {c1:.4f} / {c2:.4f} ms; plain {q1:.4f} / {q2:.4f} ms; bound "
        f"{k6_bound[0]:.4g} ms ({k6_bound[1]}){wide}")
    return ((min(w1, w2), min(p1, p2), k5_bound, min(b1, b2)),
            (min(v1, v2), min(q1, q2), k6_bound, min(c1, c2)))


# ---------------------------------------------------------------------------
# path E, the union sweep's other modes: K9 (sweep select), the local fold,
# the candidate-blocked hit
# ---------------------------------------------------------------------------

SPP_E = 4               # path E's train steps: 1,048,576 rays (module docstring)
K9_OUTPUTS = ("t_star", "entering", "m_start", "m_end", "found")
_STRESS_SKY = dict(reflect=0.0, scatter=0.0, emissive=(0.7, 0.8, 1.0))


def _bitten_union(n=48):
    """``n`` spheres with four spherical bites each (``Difference(sphere,
    Union(4 bites))``, past the megasweep's slot algebra) in a jittered
    grid over the ground plane under the stress sky: ``5n + 7`` leaves."""
    import math

    import numpy as np
    from ptx_torch.geom.tape import Difference, Plane, Sphere, Union
    from ptx_torch.scenes import builders
    from ptx_torch.shade.materials import Material

    diffuse = [Material(reflect=(0.8, 0.3, 0.3), scatter=1.0),
               Material(reflect=(0.3, 0.8, 0.3), scatter=1.0)]
    r = np.random.default_rng(5)
    side = max(1, int(math.ceil(math.sqrt(n))))
    gadgets = []
    for i in range(n):
        rad = r.uniform(0.3, 0.5)
        c = np.array([(i % side - (side - 1) / 2) * 1.4 + r.uniform(-0.2, 0.2), -1.0 + rad,
                      -3.0 - (i // side) * 1.4 + r.uniform(-0.2, 0.2)])
        bites = [Sphere(c + 0.8 * rad * np.array([math.cos(a), 0.4, math.sin(a)]), 0.45 * rad,
                        diffuse[(i + 1) % 2]) for a in (0.3, 1.9, 3.5, 5.1)]
        gadgets.append(Difference(Sphere(c, rad, diffuse[i % 2]), Union(*bites)))
    return builders.union_array([*gadgets, Plane((0.0, 1.0, 0.0), 1.0,
                                                 Material(reflect=0.6, scatter=1.0)),
                                 *builders.sky_planes(Material(**_STRESS_SKY))])


def _carved_tape():
    """``Union(Intersection(big sphere, union_array(64 spheres)), ground,
    sky planes)``: 72 leaves, no union of small groups."""
    import numpy as np
    from ptx_torch.geom.tape import Intersection, Plane, Sphere, Union
    from ptx_torch.scenes import builders
    from ptx_torch.shade.materials import Material

    m = Material(reflect=(0.7, 0.5, 0.3), scatter=0.5)
    r = np.random.default_rng(9)
    balls = [Sphere((r.uniform(-2, 2), r.uniform(-1, 1.5), r.uniform(-7, -3)),
                    r.uniform(0.3, 0.7), m) for _ in range(64)]
    return Union(Intersection(Sphere((0.0, 0.0, -5.0), 2.2, m), builders.union_array(balls)),
                 Plane((0.0, 1.0, 0.0), 1.0, Material(reflect=0.6, scatter=1.0)),
                 *builders.sky_planes(Material(**_STRESS_SKY)))


def _sweep_scenes():
    """Path E's worlds and the environment each compiles under."""
    from ptx_torch.scenes import builders

    kernel = dict(PTX_SWEEP_MODE="kernel", PTX_MEGAB="0")
    return {"S1": (lambda: builders.stress_spheres(249), kernel),
            "S2": (lambda: builders.stress_gadgets(112), kernel),
            "bitten": (_bitten_union, dict(PTX_SWEEP_MODE="kernel")),
            "bitten-default": (_bitten_union, {}),
            "carved": (_carved_tape, {})}


def _compile_e(name, dev):
    from ptx_torch.geom import fasthit
    from ptx_torch.integrate.trace import compile_scene

    make, env = _sweep_scenes()[name]
    with _env(**env):
        scene = compile_scene(make(), dev)
    want = {"bitten-default": (fasthit.UnionSweepHit, "fixpoint"),
            "carved": (fasthit.BlockedHit, None)}.get(name, (fasthit.UnionSweepHit, "kernel"))
    if not isinstance(scene.hit_fn, want[0]) or getattr(scene.hit_fn, "mode", None) != want[1]:
        raise AssertionError(f"E {name}: hit {type(scene.hit_fn).__name__} "
                             f"{getattr(scene.hit_fn, 'mode', '')}, expected {want}")
    return scene


def _plain_select(s, e, t0, t1, L, eps, sort=False):
    """K9's plain version in the wrapper's place (the plain path of E2)."""
    from ptx_torch.ops import sweep_kernel

    return sweep_kernel.sweep_select_reference(s, e, t0, t1, L, eps, sort)


def phase_k9_chunk(scene, tag, k5_check):
    """E1: the kernel-mode sweep on every bounce of one compacted 65,536-ray
    chunk (the D2 chunk: widths 65,536 / 21,845 / 4,096), each hit's
    intervals recomputed from its rays: K9 as called (``sort=False`` on the
    stable-sorted starts) and K9 ``sort=True`` (on the unsorted valid-masked
    intervals) against ``sweep_select_reference``, 0 differing lanes in all
    five outputs; the whole hit equal to the ``fixpoint`` and ``sort``
    modes' bit for bit; with ``k5_check``, equal to K5's plain version
    (``megasweep_reference``) except float64-adjudicated near-ties.
    Returns (lanes compared, K9's max_abs_err against its plain version,
    flips vs K5's plain version, max_abs_err of the hits' floats against it,
    the fixpoint passes per bounce, the first 65,536-lane K9 inputs)."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.core.constants import EPS
    from ptx_torch.geom import fasthit
    from ptx_torch.integrate.trace import trace_rays
    from ptx_torch.ops import sweep_kernel

    key = rng.fold(rng.PRNGKey(0), 0, 4)
    o, d = _full_frame_chunk(scene, key)
    rec = []
    with _swapped(scene, "hit_fn", _RecordingHit(scene.hit_fn, rec)), torch.no_grad():
        trace_rays(scene, scene.params, o, d, key, DEPTH)
    torch.cuda.synchronize()
    widths = [ob.shape[0] for ob, _, _ in rec]
    if widths != _wavefront_widths(BAND_ROWS * W, DEPTH):
        raise AssertionError(f"{tag}: hit widths {widths}")
    hit = scene.hit_fn
    other = {m: fasthit.UnionSweepHit(scene.plan, hit.leaves, m) for m in ("fixpoint", "sort")}
    mega = (fasthit.compile_fast_hit(scene.plan, scene.params, sweep_mode="mega")
            if k5_check else None)
    lanes, k9_err, flips, err, passes, first = 0, 0.0, 0, 0.0, [], None
    for b, (ob, db, out_k) in enumerate(rec):
        with torch.no_grad():
            t0, t1, s, e = hit.intervals(scene.params, ob, db)
            s_s, idx = torch.sort(s, dim=0, stable=True)
            e_s = e.gather(0, idx)
            want = sweep_kernel.sweep_select_reference(s_s, e_s, t0, t1, hit.L, EPS, False)
            got = {"sort=False": sweep_kernel.launch(s_s, e_s, t0, t1, hit.L, EPS, False),
                   "sort=True": sweep_kernel.launch(s, e, t0, t1, hit.L, EPS, True)}
            modes = {m: h(scene.params, ob, db) for m, h in other.items()}
        torch.cuda.synchronize()
        for flag, g in got.items():
            bad = {n: int((a != w).sum()) for n, a, w in zip(K9_OUTPUTS, g, want)}
            if any(bad.values()):
                raise AssertionError(f"{tag}: bounce {b}: K9 {flag} differs from its plain "
                                     f"version on {bad} lanes")
            k9_err = max([k9_err] + [float((a.double() - w.double()).abs().max())
                                     for a, w in zip(g, want)])
        for m, out in modes.items():
            if not all(torch.equal(out_k[k], out[k]) for k in out_k):
                raise AssertionError(f"{tag}: bounce {b}: kernel mode differs from {m} mode")
        passes.append(other["fixpoint"].last_passes)
        lanes += ob.shape[0]
        if first is None and ob.shape[0] == BAND_ROWS * W:
            first = (s_s, e_s, t0, t1, s, e, hit.L)
        msg = ""
        if mega is not None:
            with torch.no_grad():
                out_p = mega(scene.params, ob, db)
            torch.cuda.synchronize()
            f, e_ = compare_hit(scene, ob, db, out_k, out_p, name=f"{tag} vs K5 plain")
            flips, err = flips + f, max(err, e_)
            msg = f"; vs K5's plain version: flips={f} max_abs_err={e_:.3g}"
        log(f"[{tag}] bounce {b}: B={ob.shape[0]} S={s.shape[0]} L={hit.L} "
            f"hit={int(out_k['hit'].sum())} entering={int(out_k['entering'].sum())}: K9 "
            f"sort=False and sort=True == plain on every lane of all five outputs; kernel "
            f"== fixpoint == sort mode bit for bit; fixpoint passes {passes[-1]}{msg}")
    return lanes, k9_err, flips, err, passes, first


def bound_k9(S, L, B, out_bytes):
    """K9 at B lanes: reads s, e (S rows) and t0, t1 (L rows), writes its
    outputs once (``out_bytes`` a lane); ~6 compares and selects per
    (row, lane) of the sweep, 2 per (leaf, lane) of the payload match."""
    return _bound((2 * S + 2 * L) * B * 4 + out_bytes * B, (6 * S + 2 * L) * B)


def phase_timing_k9(tag, inputs):
    """E5: at 65,536 lanes on a chunk's recorded K9 inputs, K9's wrapper
    as the sweep calls it, its bare launch (``sort=False`` and ``sort=True``,
    outputs allocated once), its plain version and, as context, the
    ``torch.sort`` of the starts the kernel mode runs before it; each the
    median of 20 single calls between CUDA events (bare: mean of 20 back to
    back), in turns plain, kernel, kernel, plain."""
    import torch
    from ptx_torch.core.constants import EPS
    from ptx_torch.ops import _build, sweep_kernel
    from ptx_torch.ops.bounce_kernel import _ptr, _stream

    s_s, e_s, t0, t1, s, e, L = inputs
    S, B = s.shape
    lib = _build.library()
    outs = sweep_kernel.launch(s_s, e_s, t0, t1, L, EPS, False)
    Sp = sweep_kernel.padded_rows(S)

    def bare(sort):
        a, b = (s, e) if sort else (s_s, e_s)
        err = lib.ptx_sweep_select(_ptr(a), _ptr(b), S, _ptr(t0), _ptr(t1), L, B, float(EPS),
                                   int(sort), Sp if sort else S,
                                   sweep_kernel.tile_width(Sp) if sort else 0,
                                   *(_ptr(x) for x in outs), _stream(s.device))
        if err:
            raise AssertionError(f"{tag}: K9 launch failed: CUDA error {err}")

    wrap = lambda: sweep_kernel.sweep_select(s_s, e_s, t0, t1, L, EPS)
    plain = lambda: sweep_kernel.sweep_select_reference(s_s, e_s, t0, t1, L, EPS, False)
    p1, w1, w2, p2 = _time_ms(plain), _time_ms(wrap), _time_ms(wrap), _time_ms(plain)
    b1, b2 = _time_back_to_back_ms(lambda: bare(False)), _time_back_to_back_ms(lambda: bare(False))
    q1, q2 = _time_back_to_back_ms(lambda: bare(True)), _time_back_to_back_ms(lambda: bare(True))
    srt = _time_ms(lambda: torch.sort(s, dim=0, stable=True))
    bound = bound_k9(S, L, B, sum(x.element_size() for x in outs))
    log(f"[{tag}] K9 at B={B} (S={S}, L={L}): wrapper {w1:.4f} / {w2:.4f} ms; bare launch "
        f"sort=False {b1:.4f} / {b2:.4f} ms, sort=True (Sp={Sp}, "
        f"{sweep_kernel.tile_width(Sp)} lanes a block) {q1:.4f} / {q2:.4f} ms; plain "
        f"{p1:.4f} / {p2:.4f} ms; torch.sort of the starts (context) {srt:.4f} ms; bound "
        f"{bound[0]:.4g} ms ({bound[1]})")
    return min(w1, w2), min(p1, p2), bound, min(b1, b2), min(q1, q2), srt


def run_path_e(dev):
    """Path E (module docstring); returns what the summary and the kernels
    line read."""
    from ptx_torch.ops import sweep_kernel

    lanes, k9_err, flips, k9_in, trainE = 0, 0.0, 0, {}, {}
    for nm in ("S1", "S2", "bitten"):
        sc = _compile_e(nm, dev)
        n, e9, f, _, passes, k9_in[nm] = _timed(f"E1 {nm} K9 chunk", phase_k9_chunk, sc,
                                                f"E1 {nm} K9 vs plain", nm != "bitten")
        lanes, k9_err, flips = lanes + n, max(k9_err, e9), flips + f
        log(f"[E1 {nm}] fixpoint passes per bounce {passes}")
        if nm == "bitten":
            del k9_in[nm]
        del sc
    for nm, cm in (("S2", _swapped(sweep_kernel, "sweep_select", _plain_select)),
                   ("bitten-default", None), ("carved", None)):
        sc = _compile_e(nm, dev)
        _timed(f"E2 {nm} gradients", phase_gradients, sc, f"E2 {nm} gradients", cm)
        del sc
    for nm in ("S1", "S2", "bitten", "bitten-default", "carved"):
        sc = _compile_e(nm, dev)
        k9 = {"K9": 3 * (DEPTH + 1)} if getattr(sc.hit_fn, "mode", None) == "kernel" else {}
        trainE[nm] = _timed(f"E3 {nm} train", phase_train, sc, f"E3 {nm} train",
                            _expect(K6=3 * DEPTH, **k9), None, SPP_E)
        del sc
    with _env(PTX_SWEEP_MODE="kernel", PTX_MEGAB="0"):
        rays_s = _timed("E4 render --scene", phase_render_scene, "E4 render --scene", "K9")
    timeE = {nm: _timed(f"E5 {nm} timing", phase_timing_k9, f"E5 {nm} timing", k9_in[nm])
             for nm in ("S1", "S2")}
    return lanes, k9_err, flips, trainE, rays_s, timeE


def _timed(label, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase seconds] {label}: {time.perf_counter() - t0:.2f} s")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ptx_torch.integrate.trace import compile_scene
    from ptx_torch.scenes import builders

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(0)
    os.makedirs(OUT, exist_ok=True)
    t_start = time.perf_counter()
    name, smi = phase_device()
    build_s = _timed("2 build", phase_build)

    # the demo: K1, K2, K3
    scene = compile_scene(builders.make_world(), dev)
    flips3, err3, inputs = _timed("3 K1 primary bounces", phase_kernel_vs_plain, scene)
    flips3c, err3c = _timed("3 K1 render chunks", phase_compacted_chunks, scene)
    render_launches, wall, rays_s = _timed("4 render", phase_slice, scene)
    flips4 = _timed("4 band", phase_band_vs_plain, scene)
    err_k2, err_k3, err_k8a, k2_in, k3_in = _timed("5 K2 K3 K8", phase_backward_kernels,
                                                   scene)
    _timed("6 gradients", phase_gradients, scene)
    train, secs, peak, target = _timed(
        "7 train", phase_train, scene, "7 train",
        _expect(3, K1=3 * (DEPTH + 1), K2=3 * DEPTH, K3=3 * 3))
    flips8, err8_1, err8_2, err8_3 = _timed("8 train-width kernels", phase_train_kernels,
                                            scene, target)
    del target

    # path A, config 4: the unfused bounce on K4, the checker's gradient on K3
    c4 = compile_scene(builders.baseline_config4(), dev)
    flipsA, err4, k4_in = _timed("A1 K4 chunk", phase_k4_chunk, c4)
    c4_rays_s = _timed("A2 render config4", phase_render_cli, "config4", "A2 render",
                       _expect(K4=(H // BAND_ROWS) * SPP * (DEPTH + 1)))
    train4, secs4, peak4, _ = _timed(
        "A3 config4 train", phase_train, c4, "A3 config4 train",
        _expect(K4=3 * (DEPTH + 1), K3=3 * (DEPTH + 3)))
    _timed("A4 config4 gradients", phase_gradients, c4, "A4 config4 gradients")

    # path B, the 1536x3072 probe: the sky's gradient on K8
    pb = compile_scene(builders.make_world(
        sky_image=builders.procedural_sky_image(*PROBE)), dev)
    trainB, secsB, peakB, err8, k8_in = _timed("B probe train", phase_probe, pb)
    del pb

    # path C, the emission kernel K7: the demo with PTX_EMK=1, a mirror-ball sky
    pe = _compile_with_emk(builders.make_world(), dev)
    err7a, near_a, k7_in = _timed("C1 K7 chunk", phase_k7_chunk, pe, "C1 K7 chunk")
    trainC, secsC, peakC, err7b, near_b, err3c7 = _timed("C2 K7 train", phase_train_k7, pe)
    _timed("C3 K7 gradients", phase_gradients, pe, "C3 K7 gradients")
    pm = _compile_with_emk(_mirror_world(), dev)
    err7m, near_m, _ = _timed("C4 mirror-ball chunk", phase_k7_chunk, pm,
                              "C4 mirror-ball K7 chunk")
    _timed("C5 mirror-ball gradients", phase_gradients, pm, "C5 mirror-ball gradients")
    del pm

    # path D, the large scenes: K5 (fused mega bounce, hit mode) and K6
    _timed("D1 build report", phase_build_report)
    flipsD, err5, err6, k5_in, k6_in, trainD, large = 0, 0.0, 0.0, {}, {}, {}, {}
    for nm, make in _large_scenes().items():
        sc = compile_scene(make(), dev)
        if nm != "S4":
            f, e, k5_in[nm], _ = _timed(f"D2 {nm} K5 chunk", phase_k5_chunk, sc,
                                        f"D2 {nm} K5 vs plain", nm == "S2")
            flipsD, err5 = flipsD + f, max(err5, e)
        if nm in ("S1", "S2"):
            e, k6_in[nm] = _timed(f"D3 {nm} K6 chunk", phase_k6_chunk, sc, f"D3 {nm} K6 vs plain")
            err6 = max(err6, e)
            _timed(f"D4 {nm} gradients", phase_gradients, sc, f"D4 {nm} gradients")
            large[nm] = sc
        extra = {"K8": 3 * 3} if nm == "S4" else {}
        trainD[nm] = _timed(f"D5 {nm} train", phase_train_large, sc, f"D5 {nm} train",
                            _expect(K5=3 * (DEPTH + 1), K6=3 * DEPTH, **extra), nm == "S1")
        del sc
    composed_rays_s = _timed("D6 render --scene", phase_render_scene, "D6 render --scene")
    timeD = {nm: _timed(f"D7 {nm} timing", phase_timing_large, large[nm], f"D7 {nm} timing",
                        k5_in[nm], k6_in[nm], trainD["S1"][3] if nm == "S1" else None)
             for nm in ("S1", "S2")}
    (k5_ms, k5p_ms, k5_bound, _), (k6_ms, k6p_ms, k6_bound, _) = timeD["S1"]
    del large, k5_in, k6_in

    # path E, the union sweep's other modes: K9, the local fold, the blocked hit
    k9_lanes, err9, flipsE, trainE, composed_k9_rays_s, timeE = run_path_e(dev)
    k9_ms, k9p_ms, k9_bound, _, _, _ = timeE["S1"]

    fb_rays, f_rays = _timed("9 fwd+bwd", phase_fwd_bwd, scene)
    w_ms, p_ms, dev_ms = _timed("10 K1 timing", phase_timing, scene, inputs)
    (k2_ms, k2p_ms, k2_bound, k2_pack_ms, k2_step, k2_step_old), (
        k3_ms, k3p_ms, k3_lib, k3_bound, k3_add) = _timed(
        "10 K2 K3 timing", phase_timing_backward, scene, k2_in, k3_in)
    k4_t, k7_t, k8_t = _timed("10 K4 K7 K8 timing", phase_timing_small, c4, k4_in, pe,
                              k7_in, k8_in)
    k1_bound = bound_k1(inputs[0].shape[0], scene.bounce_fn.layout[0])
    log(f"summary: build {build_s:.2f} s; flips {flips3} (primary bounces) + "
        f"{flips3c} (render chunks) + {flips4} (band) + {flips8} (train step) + {flipsA} "
        f"(K4); render {rays_s:.4g} rays/s (K1 launches {render_launches}), config4 "
        f"{c4_rays_s:.4g} rays/s; train step demo {min(secs):.3f} s / {peak:.3f} GiB, "
        f"config4 {min(secs4):.3f} s / {peak4:.3f} GiB, probe {min(secsB):.3f} s / "
        f"{peakB:.3f} GiB, K7 demo {min(secsC):.3f} s / {peakC:.3f} GiB; K7 lanes on "
        f"another texel at a boundary {near_a} + {near_b} + {near_m}; fwd+bwd chunk {fb_rays:.4g} "
        f"rays/s, fwd {f_rays:.4g} rays/s; K1 {w_ms:.4f} ms vs plain {p_ms:.4f} ms "
        f"(bound {k1_bound[0]:.4g} ms, {k1_bound[1]}); K2 {k2_ms:.4f} vs {k2p_ms:.4f} ms "
        f"(bound {k2_bound[0]:.4g} ms), pack + VJP {k2_pack_ms:.4f} ms once per call, "
        f"per step {k2_step:.4f} ms against {k2_step_old:.4f} ms per bounce; K3 "
        f"{k3_ms:.4f} vs {k3p_ms:.4f} ms, index_put_ {k3_lib:.4f} ms, index_add_ "
        f"{k3_add:.4f} ms (bound {k3_bound[0]:.4g} ms); K4 {k4_t[0]:.4f} vs "
        f"{k4_t[1]:.4f} ms (bound {k4_t[2][0]:.4g} ms); K7 {k7_t[0]:.4f} vs "
        f"{k7_t[1]:.4f} ms (bound {k7_t[2][0]:.4g} ms); K8 {k8_t[0]:.4f} vs "
        f"{k8_t[1]:.4f} ms, index_put_ {k8_t[3]:.4f} ms, index_add_ {k8_t[4]:.4f} ms "
        f"(bound {k8_t[2][0]:.4g} ms); "
        f"large scenes: flips {flipsD}, train step "
        + ", ".join(f"{nm} {min(v[1]):.3f} s / {v[2]:.3f} GiB" for nm, v in trainD.items())
        + f", render --scene {composed_rays_s:.4g} rays/s; K5 {k5_ms:.4f} vs {k5p_ms:.4f} ms "
        f"(bound {k5_bound[0]:.4g} ms); K6 {k6_ms:.4f} vs {k6p_ms:.4f} ms (bound "
        f"{k6_bound[0]:.4g} ms); path E: K9 == plain on {k9_lanes} lanes, flips vs K5's "
        f"plain version {flipsE}, train step (spp {SPP_E}) "
        + ", ".join(f"{nm} {min(v[1]):.3f} s / {v[2]:.3f} GiB" for nm, v in trainE.items())
        + f", render --scene (kernel mode) {composed_k9_rays_s:.4g} rays/s; K9 {k9_ms:.4f} vs "
        f"{k9p_ms:.4f} ms (bound {k9_bound[0]:.4g} ms); total "
        f"{time.perf_counter() - t_start:.1f} s; {smi}")
    entry = lambda name_, source, replaces, launches, err, ms, plain, bound, lib: {
        "name": name_, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib}
    print(smi)
    print(json.dumps({"kernels": [
        entry("bounce_forward (K1: fused hit + shade + scatter)",
              "ptx_torch/csrc/bounce_kernel.cu", "ptx/ops/bounce_kernel.py:236",
              train["K1"], max(err3, err3c, err8_1), w_ms, p_ms, k1_bound, None),
        entry("bounce_backward (K2: decision-frozen replay VJP)",
              "ptx_torch/csrc/bounce_bwd_kernel.cu", "ptx/ops/bounce_kernel.py:578",
              train["K2"], max(err_k2, err8_2), k2_ms, k2p_ms, k2_bound, None),
        entry("image_hist (K3: image-gather transpose)",
              "ptx_torch/csrc/image_hist_kernel.cu", "ptx/ops/imagegrad.py:91",
              train["K3"], max(err_k3, err8_3, err3c7), k3_ms, k3p_ms, k3_bound, k3_lib),
        entry("first_hit (K4: hit-only CSG fold)",
              "ptx_torch/csrc/fasthit_kernel.cu", "ptx/ops/fasthit_kernel.py:233",
              train4["K4"], err4, k4_t[0], k4_t[1], k4_t[2], None),
        entry("megasweep (K5: union-sweep first hit + shade + scatter, S1)",
              "ptx_torch/csrc/megasweep_kernel.cu", "ptx/ops/megasweep.py:589",
              trainD["S1"][0]["K5"], err5, k5_ms, k5p_ms, k5_bound, None),
        entry("replay_bwd (K6: row-fed replay VJP at any L, S1)",
              "ptx_torch/csrc/replay_bwd_kernel.cu", "ptx/ops/replay_bwd.py:47",
              trainD["S1"][0]["K6"], err6, k6_ms, k6p_ms, k6_bound, None),
        entry("emission_forward (K7: fused emission chain)",
              "ptx_torch/csrc/emission_kernel.cu", "ptx/ops/emission_kernel.py:98",
              trainC["K7"], max(err7a, err7b, err7m), k7_t[0], k7_t[1], k7_t[2], None),
        entry("image_hist_atomic (K8: image-gather transpose by device-memory atomics)",
              "ptx_torch/csrc/image_hist_kernel.cu", "ptx/ops/imagegrad.py:218",
              trainB["K8"], max(err8, err_k8a), k8_t[0], k8_t[1], k8_t[2], k8_t[3]),
        entry("sweep_select (K9: union-sweep prefix max, break minima, payload match, S1)",
              "ptx_torch/csrc/sweep_kernel.cu", "ptx/ops/sweep_kernel.py:164",
              trainE["S1"][0]["K9"], err9, k9_ms, k9p_ms, k9_bound, None),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
