"""Where a render's time goes, layer by layer, on one device.

    python -m ptx_torch.layer_profile [--chunks 4] [--device cuda]

Renders the demo at 512×512 and depth 16 the way the CLI does (128-row
bands of 65,536 rays, one sample per chunk): one warm-up band, then
``--chunks`` chunks of rows 128-255 three times without the profiler
(the best wall is kept), then the same chunks once under
``torch.profiler`` with one ``record_function`` range per layer.  The
Chrome trace goes to ``--out`` and is parsed here (:func:`summarize`):

- kernels: trace events of category ``kernel``, one per launch;
- device busy: the union of kernel, memcpy and memset intervals; the
  idle share is ``1 − busy / unprofiled wall``;
- per layer: the kernels whose launch call (matched by correlation id)
  lies inside the layer's host range, their device time, and the
  range's share of the profiled host wall;
- K1: launches and mean device time of ``bounce_forward_kernel``.

It prints the card's name and power limit, the figures, and last a JSON
object with the same numbers.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import functools
import json
import os
import subprocess
import sys
import time

LAYERS = (                      # (range name, module, function)
    ("camera", "ptx_torch.integrate.render", "sample_rays"),
    ("rng_draws", "ptx_torch.integrate.trace", "_phase_uniforms"),
    ("bounce", "ptx_torch.integrate.trace", "_bounce"),
    ("compaction", "ptx_torch.integrate.trace", "_compact_wavefront"),
    ("emission", "ptx_torch.integrate.trace", "_phase_emission"),
)
K1_NAME = "bounce_forward_kernel"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def summarize(events, layers=tuple(n for n, _, _ in LAYERS)):
    """Derive the layer figures from a Chrome trace's ``traceEvents``.

    Returns a dict: ``kernels`` (launches), ``busy_ms`` (device),
    ``host_ms`` (profiled host wall, first to last host event),
    ``k1_launches``, ``k1_mean_us`` and ``layers``: per layer
    ``kernels``, ``device_ms`` and ``host_share``."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"] in layers)
    starts = [r[0] for r in ranges]
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime",
                                                  "user_annotation")]
    host_us = (max(e["ts"] + e["dur"] for e in host) - min(e["ts"] for e in host)
               if host else 0.0)

    per = {n: {"kernels": 0, "device_ms": 0.0, "host_share": 0.0} for n in layers}
    for a, b, name in ranges:
        per[name]["host_share"] += (b - a) / host_us
    for k in kernels:
        ts = launch_ts.get(k["args"].get("correlation"))
        i = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
        if i >= 0 and ts <= ranges[i][1]:
            per[ranges[i][2]]["kernels"] += 1
            per[ranges[i][2]]["device_ms"] += k["dur"] / 1e3
    k1 = [k["dur"] for k in kernels if K1_NAME in k["name"]]
    return {"kernels": len(kernels),
            "busy_ms": _union_us((e["ts"], e["ts"] + e["dur"]) for e in device) / 1e3,
            "host_ms": host_us / 1e3,
            "k1_launches": len(k1),
            "k1_mean_us": sum(k1) / len(k1) if k1 else 0.0,
            "layers": per}


@contextlib.contextmanager
def _layer_ranges():
    """Wrap each layer's function in a ``record_function`` range of its
    name for the duration of the block."""
    import importlib

    from torch.profiler import record_function

    saved = []
    for label, mod_name, fn_name in LAYERS:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)

        def ranged(*a, _fn=fn, _label=label, **k):
            with record_function(_label):
                return _fn(*a, **k)
        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, functools.wraps(fn)(ranged))
    try:
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def main(argv=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ptx_torch.core import rng
    from ptx_torch.integrate import render
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.integrate.trace import compile_scene
    from ptx_torch.scenes.builders import make_world

    ap = argparse.ArgumentParser(prog="python -m ptx_torch.layer_profile")
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--out", default=os.path.join("build", "layer_profile"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        print(subprocess.run(["nvidia-smi", "-i", str(device.index or 0),
                              "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout.strip())

    scene = compile_scene(make_world(), device)
    cam = Camera.reference_demo(args.size, args.size)
    rows = max(1, min(args.size, 2 ** 16 // args.size))

    def run(y0, n):
        render.render_rows(scene, scene.params, cam, rng.PRNGKey(0), y0, rows,
                           1, n, 16)
        sync()

    run(0, 2)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(rows, args.chunks)
        walls.append(time.perf_counter() - t0)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with _layer_ranges(), profile(activities=activities) as prof:
        run(rows, args.chunks)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        s = summarize(json.load(f)["traceEvents"])

    wall_ms = min(walls) * 1e3
    s.update(chunks=args.chunks, rays_per_chunk=rows * args.size,
             wall_ms=wall_ms, walls_ms=[w * 1e3 for w in walls],
             idle_share=1.0 - s["busy_ms"] / wall_ms)
    print(f"{args.chunks} chunks of {rows * args.size} rays, depth 16: unprofiled "
          f"wall {wall_ms:.3f} ms (best of {[round(w * 1e3, 3) for w in walls]}); "
          f"profiled host wall {s['host_ms']:.3f} ms")
    print(f"kernels launched {s['kernels']}; device busy {s['busy_ms']:.3f} ms; "
          f"idle share {s['idle_share']:.4f} (1 - busy / unprofiled wall)")
    print(f"K1 ({K1_NAME}): {s['k1_launches']} launches, mean "
          f"{s['k1_mean_us']:.2f} us")
    print("layer            kernels  device_ms  share of profiled host wall")
    for name, v in s["layers"].items():
        print(f"{name:<16} {v['kernels']:>7}  {v['device_ms']:>9.3f}  "
              f"{v['host_share']:.4f}")
    print(f"trace: {path}")
    print(json.dumps(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
