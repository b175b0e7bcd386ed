#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (ptx_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``ptx_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes the main path
gives it, renders the demo at full size through the CLI entry point, and
checks the render.  Any failed phase raises: the exit code is nonzero and
no result line is printed.  Without CUDA it exits 1 before doing anything.

Phases:
1. device: name, and power limit as ``nvidia-smi`` reports it;
2. build: nvcc, timed;
3. kernel vs plain, at every shape the main path gives K1: (a) three
   chained bounces of 65,536 primary rays (a 128-row band of the 512×512
   demo camera), each on the kernel's own carry; (b) the first chunk of
   the render's bands at rows 0 and 256 as the render runs them
   (``render_rows``, 65,536 rays at depth 16, compacted to 21,845 lanes
   from bounce 2 and to 4,096 from bounce 6), each of the 17 recorded
   kernel inputs of each fed to ``bounce_reference``.  Decisions must be equal except flips a float64
   recompute puts at a near-tie; floats must agree within ``rtol 1e-5,
   atol 5e-6`` on agreeing lanes;
4. slice: ``python -m ptx_torch render --demo demo --width 512 --height
   512 --spp 16 --depth 16`` through ``ptx_torch.cli.main``, with the
   launch counters zeroed just before; then a 16-row band at spp 2
   rendered with the kernel and with the plain bounce on the card, equal
   within ``rtol 1e-4, atol 1e-5`` except pixels whose paths hold an
   adjudicated flip;
5. timing: one bounce at B = 65,536, the K1 wrapper as the main path
   calls it against the plain bounce, each the median of 20 single calls
   between CUDA events; the bare launch, back to back, beside them;
6. the JSON lines: the kernels, then the device.

Outputs (the rendered image, the nvcc report) go to ``build/chip_smoke/``.
"""

from __future__ import annotations

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
    from ptx_torch.core.constants import EPS, MAX_VALUE
    from ptx_torch.geom import fasthit

    if lanes.numel() == 0:
        return torch.zeros(0, dtype=torch.bool)
    lanes = lanes.cpu()
    p64 = _f64_cpu(scene.params)
    o, d, _, st, _, uc, _, _ = inputs
    o, d = o.cpu()[lanes].double(), d.cpu()[lanes].double()
    st, uc = st.cpu()[lanes].double(), uc.cpu()[lanes].double()

    # every boundary time, in float64: (2L, n), event order of the kernel
    t0, t1, _, _ = fasthit._leaf_intervals(fasthit.collect_leaves(scene.plan),
                                           p64, *o.unbind(-1), *d.unbind(-1))
    t_evt = torch.cat([t0, t1])
    n = lanes.numel()
    idx = torch.arange(n)

    def winner_tied(evt):
        """The winner sits within tol of EPS or of another finite boundary
        — but not exactly on it: exactly equal boundaries (the demo's
        coincident spheres) round identically in both versions, so a flip
        there breaks the leaf-order tie-break and is a fault."""
        e = evt.cpu()[lanes].long()
        te = t_evt[e, idx]
        tol = TIE_REL * torch.clamp(te.abs(), min=1.0)
        gap = (t_evt - te[None]).abs()
        near = (gap > 0) & (gap <= tol) & (t_evt.abs() < MAX_VALUE)
        return (te.abs() < MAX_VALUE) & (near.any(dim=0) | ((te - EPS).abs() <= tol))

    hit_class = torch.zeros(n, dtype=torch.bool)
    for k in ("evt", "hit", "entering", "mat_id"):
        hit_class |= (out_k[k] != out_p[k]).cpu()[lanes]
    hit_ok = winner_tied(out_k["evt"]) | winner_tied(out_p["evt"])

    # same hit: the shading gates, recomputed in float64
    hit = scene.hit_fn(p64, o, d)
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
    bounce_kernel.LAUNCHES = 0
    bounce_kernel.REFERENCE_CALLS = 0
    t0 = time.perf_counter()
    frame = cli.main(["render", "--demo", "demo", "--width", str(W), "--height",
                      str(H), "--spp", str(SPP), "--depth", str(DEPTH),
                      "--device", "cuda", "--out", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bounce_kernel.LAUNCHES
    plain = bounce_kernel.REFERENCE_CALLS
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
    if launches != expected or plain != 0:
        raise AssertionError(f"main path launches: K1 {launches} (expected "
                             f"{expected}), plain {plain} (expected 0)")
    return launches, wall, rays / wall


def _recording(fn, log_list):
    def call(params, *inputs):
        out = fn(params, *inputs)
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

    wrapped = lambda: scene.bounce_fn(scene.params, *inputs)
    plain = lambda: bounce_kernel.bounce_reference(scene, scene.params, *inputs)
    raw = lambda: scene.bounce_fn.launch(*inputs)
    # plain, kernel, kernel, plain: two readings of each on one card
    p1 = _time_ms(plain)
    w1, d1 = _time_ms(wrapped), _time_back_to_back_ms(raw)
    w2, d2 = _time_ms(wrapped), _time_back_to_back_ms(raw)
    p2 = _time_ms(plain)
    log(f"[5 timing] one bounce at B={inputs[0].shape[0]}: K1 wrapper (launch "
        f"+ flag decode, as the render calls it) {w1:.4f} / {w2:.4f} ms; plain "
        f"PyTorch {p1:.4f} / {p2:.4f} ms (each the median of 20 single calls "
        f"between CUDA events, 3 warm-up); K1 bare launch {d1:.4f} / "
        f"{d2:.4f} ms (mean of 20 launches back to back)")
    return min(w1, w2), min(p1, p2), min(d1, d2)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ptx_torch.integrate.trace import compile_scene
    from ptx_torch.scenes.builders import make_world

    torch.cuda.set_device(0)
    os.makedirs(OUT, exist_ok=True)
    name, smi = phase_device()
    build_s = phase_build()
    scene = compile_scene(make_world(), torch.device("cuda", 0))
    flips3, err3, inputs = phase_kernel_vs_plain(scene)
    flips3c, err3c = phase_compacted_chunks(scene)
    launches, wall, rays_s = phase_slice(scene)
    flips4 = phase_band_vs_plain(scene)
    w_ms, p_ms, dev_ms = phase_timing(scene, inputs)
    log(f"summary: build {build_s:.2f} s; flips {flips3} (primary bounces) + "
        f"{flips3c} (render chunks) + {flips4} (band); render {rays_s:.4g} "
        f"rays/s; per bounce at B=65536: K1 wrapper {w_ms:.4f} ms vs plain "
        f"{p_ms:.4f} ms (K1 bare launch {dev_ms:.4f} ms); {smi}")
    print(json.dumps({"kernels": [{
        "name": "bounce_forward (K1: fused hit + shade + scatter)",
        "route": "cuda",
        "source": "ptx_torch/csrc/bounce_kernel.cu",
        "replaces": "ptx/ops/bounce_kernel.py:236",
        "launches": launches,
        "max_abs_err": max(err3, err3c),
        "ms": w_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
