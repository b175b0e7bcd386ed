"""Roofline of the card: its measured ceilings, and K4 and the forward
trace placed against them.

``python -m ptx_torch.roofline [--device cuda]`` is the port's counterpart
of every ``measure_*`` of ``tools/roofline.py``, in the same order, at the
same sizes, and prints one JSON line each, with the card's ``nvidia-smi``
name and power limit on every line:

1. ``fp32_chain``: K10 (``ops/roofline_kernel.fma_chain``), the dependent
   ``x ← x + x·x·c`` chain on (8192, 128) float32, R 2048 / 4096; its rate
   in operations a second (3 a step, as the tool counts), beside the
   unfused float32 peak (33.5 T/s: the port builds with ``-fmad=false``,
   and the published 67 TFLOP/s counts a fused multiply-add as two) and the
   published one; ``nvidia-smi``'s SM clock, power draw and temperature
   sampled beside the window (as beside each window of 2-4);
2. ``hbm_torch_loop``: the counterpart of ``measure_hbm_bw`` (an XLA loop,
   not a kernel): ``mul_(1.0000001)`` over 512 MiB in plain PyTorch, R 8 /
   24; bytes a second, each pass reading and writing the buffer once;
3. ``hbm_copy_kernel``: K11 (``ops/roofline_kernel.copy_plus_one``), ``o =
   x + 1`` chained back and forth between two (32768, 1024) float32 buffers
   (128 MiB each: together past the 50 MB L2), R 16 / 48;
4. ``tensor_bf16_matmul``: the counterpart of ``measure_mxu_peak``:
   ``torch.matmul`` chained on 2048² bf16, R 64 / 192.  The port has no
   bf16 path, so this rate bounds none of its kernels;
5. ``hit_kernel``: K4 on the demo (``compile_scene(make_world(), pallas=
   True)``), 131,072 primary rays (rows 0-255 × 512 of the 512² demo
   camera, spp 1), the calls chained through ``o + 1e-12·t``, R 64 / 192;
   the tool's op model (:func:`hit_ops_per_ray`, 3,536 a ray at L = 13)
   and its 48 bytes a ray, so both tools count the same work; the shares of
   the measured K10 rate, of the published float32 rate and of the better
   of the two HBM rates; beside them K4's bare launch, ``R1`` of them
   queued behind a device sleep (the card's time without the host's, the
   best of ``REPS``), and its shares.  K4 walks the event times in order and no longer
   computes the model's O(L²) fold: a share above 1 says that the model
   counts more than K4 computes, and the line says so;
6. ``trace_forward``, ``compact`` off and on: ``trace_rays`` at depth 16 on
   the same rays under ``torch.no_grad()``, 40 iterations chained through
   ``o + 1e-12·Σ radiance``; segments a second and the share of a forward's
   time that 17 hit-kernel calls at full width would take
   (``hit_kernel_fraction_at_full_width``).

Timing: CUDA events after a warm-up, the best of ``REPS`` windows at each
of the tool's two R, and the slope between them, which cancels the fixed
cost of a window.  No bytes are fetched to the host.  The module runs on
the card unless ``--device cpu`` is given; on the CPU it times the plain
versions with the host clock, and its figures are the CPU's.  The
functions take a ``torch.device`` and their sizes as arguments, the tool's
sizes by default.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time

import torch

# NVIDIA's data sheet, H100 SXM at 700 W: dense rates, no sparsity
PUBLISHED_FP32 = 67e12          # float32 FLOP/s outside the tensor cores (an FFMA is 2)
FP32_UNFUSED = PUBLISHED_FP32 / 2   # separately rounded float32 operations a second
PUBLISHED_HBM = 3.35e12         # bytes/s
PUBLISHED_BF16 = 989e12         # bf16 tensor-core FLOP/s
REPS = 3                        # timed windows at each R; the best is kept
HIT_BYTES_PER_RAY = 48          # the tool's count: o, d in; t, normal out
HIT_N_NODES = 14                # the tool's tape nodes for the demo, as it hard-codes them
TRACE_DEPTH = 16


def hit_ops_per_ray(L: int, n_nodes: int = HIT_N_NODES) -> int:
    """The tool's op model of the hit kernel (``tools/roofline.py:198-199``,
    ``docs/perf_roofline.md``): 25·L interval math, 2L events × (6L
    membership compares + 2·n_nodes tape folds + 10 selects), 15·L payload
    selects."""
    return 25 * L + 2 * L * (6 * L + 2 * n_nodes + 10) + 15 * L


def card(device) -> dict:
    """The device's name and ``nvidia-smi``'s ``name, power.limit`` for
    it; on the CPU, ``cpu`` and nothing measured."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": "cpu", "card": "not measured (cpu)"}
    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    return {"device": torch.cuda.get_device_name(index), "card": smi}


class ClockSampler:
    """``nvidia-smi``'s SM clock, power draw and temperature, read over and
    over (every 50 ms and the query's own time) by a thread while the
    ``with`` block runs, after one sample taken before it starts; on the
    CPU, nothing.  :meth:`summary` gives min /
    median / max of each."""

    FIELDS = ("clocks_sm_mhz", "power_draw_w", "temperature_c")

    def __init__(self, device):
        self.device = torch.device(device)
        self.rows: list[list[float]] = []
        self._stop = threading.Event()
        self._thread = None
        self.error = None

    def _sample(self):
        index = self.device.index if self.device.index is not None else 0
        text = subprocess.run(["nvidia-smi", "-i", str(index),
                               "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                               "--format=csv,noheader,nounits"], capture_output=True,
                              text=True, check=True, timeout=60).stdout
        try:
            row = [float(v) for v in text.split(",")]
        except ValueError:              # "[N/A]" for a field the card does not report
            return
        if len(row) == len(self.FIELDS):
            self.rows.append(row)

    def _loop(self):
        while not self._stop.is_set():
            try:
                self._sample()
            except (subprocess.SubprocessError, OSError) as e:
                self.error = repr(e)            # reported by summary(); sampling stops
                return
            self._stop.wait(0.05)

    def __enter__(self):
        if self.device.type == "cuda":
            self._sample()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=120)
            self._thread = None
        return False

    def summary(self) -> dict:
        if not self.rows:
            return {"clocks": "not measured"}
        out = {"clock_samples": len(self.rows)}
        if self.error:
            out["clock_error"] = self.error
        for j, name in enumerate(self.FIELDS):
            col = [r[j] for r in self.rows]
            out[name] = [min(col), statistics.median(col), max(col)]
        return out


def _seconds(device, fn) -> float:
    """Seconds of one window ``fn()``: between two CUDA events on a card
    (the device's clock, no bytes fetched), the host clock on the CPU."""
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _slope(device, run, r1: int, r2: int, reps: int = REPS):
    """Seconds a unit of R from the best of ``reps`` windows of ``run(r1)``
    and of ``run(r2)``, each warmed once: ``(d2 − d1) / (r2 − r1)``.
    Raises where the slope is not positive: the windows were noise."""
    run(r1)
    run(r2)
    d1 = min(_seconds(device, lambda: run(r1)) for _ in range(reps))
    d2 = min(_seconds(device, lambda: run(r2)) for _ in range(reps))
    per_r = (d2 - d1) / (r2 - r1)
    if per_r <= 0:
        raise RuntimeError(f"roofline: R {r2} took {d2:.6f} s against {d1:.6f} s at R {r1}: "
                           "no positive slope (make the work a unit of R larger)")
    return per_r, d1, d2


def _queued_seconds(fn, n: int) -> float:
    """Device seconds a call of ``fn`` over ``n`` calls queued behind a
    device sleep of some 25 ms, so that all are enqueued before the first
    runs: the card's time without the host's.  Raises where the host took
    longer than the sleep to enqueue them."""
    s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s.record()
    torch.cuda._sleep(50_000_000)
    a.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t0
    b.record()
    b.synchronize()
    if host * 1e3 >= s.elapsed_time(a):
        raise RuntimeError(f"roofline: the host took {host * 1e3:.3f} ms to enqueue {n} calls, "
                           f"past the {s.elapsed_time(a):.3f} ms sleep")
    return a.elapsed_time(b) / 1e3 / n


def _windows(r1, r2, d1, d2) -> dict:
    return {f"d_r{r1}_ms": d1 * 1e3, f"d_r{r2}_ms": d2 * 1e3}


def measure_fp32_chain(device, rows: int = 8192, lanes: int = 128, r1: int = 2048,
                       r2: int = 4096, c: float = 1e-9) -> dict:
    """K10's rate in float32 operations a second (3 a step), on the tool's
    input: x = 0.5 everywhere."""
    from ptx_torch.ops import roofline_kernel

    x = torch.full((rows, lanes), 0.5, dtype=torch.float32, device=device)
    out = torch.empty_like(x)
    run = lambda r: roofline_kernel.fma_chain(x, r, c, out=out)
    with ClockSampler(device) as clocks:
        per_r, d1, d2 = _slope(device, run, r1, r2)
    rate = rows * lanes * roofline_kernel.STEPS * 3 / per_r
    return {"measure": "fp32_chain", "kernel": "K10", "shape": [rows, lanes], "c": c,
            "fp32_ops_per_s": rate, "fp32_tops_per_s": rate / 1e12,
            "share_of_unfused_peak": rate / FP32_UNFUSED,
            "share_of_published_peak": rate / PUBLISHED_FP32,
            **_windows(r1, r2, d1, d2), **clocks.summary()}


def measure_hbm_torch_loop(device, numel: int = 128 * 1024 * 1024, r1: int = 8,
                           r2: int = 24) -> dict:
    """``mul_(1.0000001)`` passes over a float32 buffer (512 MiB): bytes a
    second, each pass reading and writing every element once."""
    x = torch.ones(numel, dtype=torch.float32, device=device)

    def run(r):
        for _ in range(r):
            x.mul_(1.0000001)

    with ClockSampler(device) as clocks:
        per_r, d1, d2 = _slope(device, run, r1, r2)
    rate = 2 * numel * 4 / per_r
    return {"measure": "hbm_torch_loop", "kernel": None, "bytes": numel * 4,
            "hbm_bytes_per_s": rate, "hbm_gb_per_s": rate / 1e9,
            "share_of_published_peak": rate / PUBLISHED_HBM,
            **_windows(r1, r2, d1, d2), **clocks.summary()}


def measure_hbm_copy_kernel(device, rows: int = 32768, lanes: int = 1024, r1: int = 16,
                            r2: int = 48) -> dict:
    """K11 chained back and forth between two (rows, lanes) float32 buffers
    (128 MiB each): bytes a second, each pass reading one buffer and writing
    the other once."""
    from ptx_torch.ops import roofline_kernel

    bufs = [torch.ones((rows, lanes), dtype=torch.float32, device=device),
            torch.empty((rows, lanes), dtype=torch.float32, device=device)]

    def run(r):
        for k in range(r):
            roofline_kernel.copy_plus_one(bufs[k % 2], out=bufs[1 - k % 2])

    with ClockSampler(device) as clocks:
        per_r, d1, d2 = _slope(device, run, r1, r2)
    nbytes = rows * lanes * 4
    rate = 2 * nbytes / per_r
    return {"measure": "hbm_copy_kernel", "kernel": "K11", "bytes": nbytes,
            "hbm_bytes_per_s": rate, "hbm_gb_per_s": rate / 1e9,
            "share_of_published_peak": rate / PUBLISHED_HBM,
            **_windows(r1, r2, d1, d2), **clocks.summary()}


def measure_tensor_bf16_matmul(device, n: int = 2048, r1: int = 64, r2: int = 192) -> dict:
    """``torch.matmul`` chained on n² bf16 (``measure_mxu_peak``'s
    counterpart, a plain product that JAX left to XLA): FLOP/s at 2n³ a
    product."""
    x = torch.ones((n, n), dtype=torch.bfloat16, device=device)
    w = torch.eye(n, dtype=torch.bfloat16, device=device) * 1.0000001
    bufs = [x, torch.empty_like(x)]

    def run(r):
        for k in range(r):
            torch.matmul(bufs[k % 2], w, out=bufs[1 - k % 2])

    with ClockSampler(device) as clocks:
        per_r, d1, d2 = _slope(device, run, r1, r2)
    rate = 2 * n ** 3 / per_r
    return {"measure": "tensor_bf16_matmul", "kernel": None, "n": n,
            "bf16_flops_per_s": rate, "bf16_tflops_per_s": rate / 1e12,
            "share_of_published_peak": rate / PUBLISHED_BF16,
            "bounds": "none of the port's kernels: the port has no bf16 path",
            **_windows(r1, r2, d1, d2), **clocks.summary()}


def _demo_rays(device, rows: int, width: int):
    """Primary rays of rows 0..rows-1 × ``width`` columns of the demo
    camera at ``width``², spp 1, key 0, flat (B, 3)."""
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera, sample_rays

    o, d = sample_rays(Camera.reference_demo(width, width), rng.PRNGKey(0), range(rows),
                       range(width), 1, device)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def measure_hit_kernel(device, fp32_rate: float, hbm_rate: float, rows: int = 256,
                       width: int = 512, r1: int = 64, r2: int = 192) -> dict:
    """K4 on the demo, R calls chained through ``o + 1e-12·t``, placed by
    the tool's op and byte model against the measured rates given
    (``fp32_rate`` from :func:`measure_fp32_chain`, ``hbm_rate`` the better
    of the two HBM measures) and the published ones; on a card also the
    bare launch queued (``r1`` launches a window, ``REPS`` windows)."""
    from ptx_torch.geom.fasthit import collect_leaves
    from ptx_torch.integrate.trace import compile_scene
    from ptx_torch.scenes.builders import make_world

    scene = compile_scene(make_world(), device, pallas=True if device.type == "cuda" else None)
    L = len(collect_leaves(scene.plan))
    o, d = _demo_rays(device, rows, width)
    B = o.shape[0]
    packed = scene.hit_fn.pack(scene.params)        # once, as trace_rays packs once a call

    def run(r):
        x = o
        for _ in range(r):
            h = scene.hit_fn(scene.params, x, d, packed=packed)
            x = x + 1e-12 * h["t"][:, None]

    with torch.no_grad():
        per_r, d1, d2 = _slope(device, run, r1, r2)
        if device.type == "cuda":       # the bare launch: K4's own time on the card
            launch = lambda: scene.hit_fn.launch(packed, o, d)
            queued = min(_queued_seconds(launch, r1) for _ in range(REPS))
    per_ray = hit_ops_per_ray(L)
    ops_s, bytes_s = B * per_ray / per_r, B * HIT_BYTES_PER_RAY / per_r
    out = {"measure": "hit_kernel", "kernel": "K4", "B": B, "L": L,
           "seconds_per_call": per_r, "rays_per_s": B / per_r,
           "analytic_ops_per_ray": per_ray, "ops_per_s": ops_s,
           "bytes_per_ray": HIT_BYTES_PER_RAY, "bytes_per_s": bytes_s,
           "share_of_published_fp32": ops_s / PUBLISHED_FP32,
           **_windows(r1, r2, d1, d2)}
    out["share_of_fp32_chain"] = ops_s / fp32_rate
    out["hbm_share"] = bytes_s / hbm_rate
    if device.type == "cuda":
        out["launch_queued_seconds"] = queued
        out["launch_share_of_published_fp32"] = B * per_ray / queued / PUBLISHED_FP32
        out["launch_share_of_fp32_chain"] = B * per_ray / queued / fp32_rate
    else:
        out["launch_queued_seconds"] = "not measured (cpu)"
    if max(out["share_of_fp32_chain"], out.get("launch_share_of_fp32_chain", 0)) > 1:
        out["note"] = ("the op model counts more than K4 computes (K4 walks the event times "
                       "in order; the model counts the O(L^2) fold): not a utilization")
    return out


def measure_trace_forward(device, compact: bool, hit_seconds: float, rows: int = 256,
                          width: int = 512, depth: int = TRACE_DEPTH, iters: int = 40) -> dict:
    """``trace_rays`` on the demo's rays, ``iters`` forwards chained through
    ``o + 1e-12·Σ radiance`` after one warm-up, timed as one window;
    ``hit_seconds`` (a hit-kernel call at full width) gives the share of a
    forward that ``depth + 1`` such calls would take."""
    from ptx_torch.core import rng
    from ptx_torch.integrate.trace import compile_scene, trace_rays
    from ptx_torch.scenes.builders import make_world

    scene = compile_scene(make_world(), device)
    o, d = _demo_rays(device, rows, width)
    key = rng.PRNGKey(0)
    B = o.shape[0]

    def step(x):
        r = trace_rays(scene, scene.params, x, d, key, depth, compact=compact)
        return x + 1e-12 * r.sum(-1, keepdim=True)

    def chain():
        x = o
        for _ in range(iters):
            x = step(x)

    with torch.no_grad():
        step(o)
        dt = _seconds(device, chain) / iters
    return {"measure": "trace_forward", "B": B, "depth": depth, "compact": compact,
           "iters": iters, "seconds": dt, "segments_per_s": B * (depth + 1) / dt,
           "hit_kernel_fraction_at_full_width": hit_seconds * (depth + 1) / dt}


def run(device, sizes: dict | None = None):
    """Every measurement in the tool's order, as dicts, one at a time;
    ``sizes`` maps a measure's name (``fp32_chain``, ``hbm_torch_loop``,
    ``hbm_copy_kernel``, ``tensor_bf16_matmul``, ``hit_kernel``,
    ``trace_forward``) to keyword arguments of its function (the tool's
    sizes by default).  Every dict carries the card's name and power
    limit."""
    device = torch.device(device)
    sizes = sizes or {}
    tag = card(device)
    fp32 = measure_fp32_chain(device, **sizes.get("fp32_chain", {}))
    yield {**fp32, **tag}
    loop = measure_hbm_torch_loop(device, **sizes.get("hbm_torch_loop", {}))
    yield {**loop, **tag}
    copy = measure_hbm_copy_kernel(device, **sizes.get("hbm_copy_kernel", {}))
    yield {**copy, **tag}
    yield {**measure_tensor_bf16_matmul(device, **sizes.get("tensor_bf16_matmul", {})), **tag}
    hit = measure_hit_kernel(device, fp32["fp32_ops_per_s"],
                             max(loop["hbm_bytes_per_s"], copy["hbm_bytes_per_s"]),
                             **sizes.get("hit_kernel", {}))
    yield {**hit, **tag}
    for compact in (False, True):
        yield {**measure_trace_forward(device, compact, hit["seconds_per_call"],
                                       **sizes.get("trace_forward", {})), **tag}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ptx_torch.roofline",
        description="Measure the card's FP32 and HBM ceilings (K10, K11), a bf16 product's "
                    "rate, and place K4 and the forward trace against them: one JSON line "
                    "a measurement.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions, timed on the host)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("ptx_torch.roofline: CUDA is not available (use --device cpu for the plain "
              "versions)", file=sys.stderr)
        return 1
    for line in run(device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
