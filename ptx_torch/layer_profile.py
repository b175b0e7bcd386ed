"""Where a render's time goes, layer by layer, on one device.

    python -m ptx_torch.layer_profile [--chunks 4] [--device cuda] [--grad | --train]
        [--demo demo|config1|config2|config3|config4 | --large S1|S2|S3|S4
         | --scene spec.json] [--sky HxW]

Renders a built-in scene (the demo by default; ``--sky HxW`` gives the
demo or config 4 a procedural sky of that size, as ``bench.py --sky``
does; ``--large`` one of the large-scene ladder, S1 ``stress_spheres(249)``,
S2 ``stress_gadgets(112)``, S3 S1 transformed, S4 S1 under the 1536×3072
probe; ``--scene`` a JSON spec) at 512×512 and depth 16 the way the CLI
does (128-row
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
- K1-K9: calls and mean device time per call, over all of a kernel's
  launches: ``bounce_forward_kernel``; ``bounce_bwd_kernel`` and the
  ``reduce_partials_kernel`` launched after it; ``hist_shared_kernel``;
  ``first_hit_kernel``; ``megasweep_kernel``; ``replay_bwd_kernel`` and
  ``replay_bwd_reduce_kernel``; ``emission_forward_kernel``;
  ``hist_atomic_kernel``; ``sweep_select_kernel`` (the union sweep's
  ``kernel`` mode: ``PTX_SWEEP_MODE=kernel PTX_MEGAB=0`` with ``--large``);
- the ``TOP`` kernels by total device time, with their calls;
- peak device memory (``max_memory_allocated``) over the unprofiled runs.

``--train`` profiles ``--chunks`` ``make_train_step`` steps instead of
render chunks: each one 4,194,304-ray wavefront (512², spp 16, depth 16)
forward and backward, against a target rendered before the timing, with
the backward ranges of ``--grad``.

``--grad`` runs each chunk forward and backward (``radiance.mean()``,
then ``backward()``) and adds one range per backward layer: K2's scene
vector, packed once per ``trace_rays`` call (``replay_pack``), and its VJP
to the params (``replay_pack_bwd``), the replay backward (``bounce_bwd``:
K2, or K6 and its params mapping), the compaction
transpose (``compaction_bwd``), the emission backward (``emission_bwd``)
and the sky image's histogram (``sky_hist``: K3).  The backward runs in
autograd's engine, so those ranges open and close in hooks on the
autograd nodes each forward layer created (:func:`_backward_ranges`).

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
    ("replay_pack", "ptx_torch.integrate.trace", "_replay_pack"),
    ("bounce", "ptx_torch.integrate.trace", "_bounce"),
    ("compaction", "ptx_torch.integrate.trace", "_compact_wavefront"),
    ("emission", "ptx_torch.integrate.trace", "_emission"),
)
GRAD_LAYERS = (                 # (range name, module, function, its backward range)
    ("replay_pack", "ptx_torch.integrate.trace", "_replay_pack", "replay_pack_bwd"),
    ("bounce", "ptx_torch.integrate.trace", "_bounce", "bounce_bwd"),
    ("compaction", "ptx_torch.integrate.trace", "_compact_wavefront", "compaction_bwd"),
    ("emission", "ptx_torch.integrate.trace", "_emission", "emission_bwd"),
)
SKY_HIST = "sky_hist"           # the image gather's backward node, inside emission
# per kernel, the names of its launches; one call launches each once, and
# the first name counts the calls
KERNELS = {"k1": ("bounce_forward_kernel",),
           "k2": ("bounce_bwd_kernel", "reduce_partials_kernel"),
           "k3": ("hist_shared_kernel",),
           "k4": ("first_hit_kernel",),
           "k5": ("megasweep_kernel",),
           "k6": ("replay_bwd_kernel", "replay_bwd_reduce_kernel"),
           "k7": ("emission_forward_kernel",),
           "k8": ("hist_atomic_kernel",),
           "k9": ("sweep_select_kernel",)}
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 8                         # kernels listed by total device time


def large_world(name):
    """A scene of the large-scene ladder: S1 ``stress_spheres(249)``, S2
    ``stress_gadgets(112)``, S3 S1 transformed, S4 S1 under the 1536×3072
    probe."""
    from ptx_torch.scenes import builders
    if name == "S2":
        return builders.stress_gadgets(112)
    kw = {"S3": {"transformed": True},
          "S4": {"sky_image": builders.procedural_sky_image(1536, 3072)}}.get(name, {})
    return builders.stress_spheres(249, **kw)


LARGE = ("S1", "S2", "S3", "S4")


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
    ``k1_calls``, ``k1_mean_us`` (device time per call; also for k2, k3)
    and ``layers``: per layer
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
    out = {"kernels": len(kernels),
           "busy_ms": _union_us((e["ts"], e["ts"] + e["dur"]) for e in device) / 1e3,
           "host_ms": host_us / 1e3}
    for tag, names in KERNELS.items():
        calls = sum(names[0] in k["name"] for k in kernels)
        dur = sum(k["dur"] for k in kernels if any(n in k["name"] for n in names))
        out[f"{tag}_calls"] = calls
        out[f"{tag}_mean_us"] = dur / calls if calls else 0.0
    out["layers"] = per
    by_name: dict = {}
    for k in kernels:
        calls, us = by_name.get(k["name"], (0, 0.0))
        by_name[k["name"]] = (calls + 1, us + k["dur"])
    out["top"] = [{"name": n[:90], "calls": c, "device_ms": us / 1e3} for n, (c, us)
                  in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]]
    return out


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


def _sequence_nr():
    """The autograd node counter's current value (a throwaway node's)."""
    import torch

    return (torch.zeros((), requires_grad=True) * 1.0).grad_fn._sequence_nr()


@contextlib.contextmanager
def _backward_ranges():
    """While active, each GRAD_LAYERS function tags the autograd nodes its
    call creates, so that their backward runs inside a range named after
    the layer (the image gather's node, inside emission, gets
    ``SKY_HIST``)."""
    import importlib

    import torch
    from torch.profiler import record_function

    open_ranges = {}

    def tag(node, label):
        def pre(_grads):
            rf = record_function(label)
            rf.__enter__()
            open_ranges[node] = rf

        def post(_gin, _gout):
            open_ranges.pop(node).__exit__(None, None, None)

        node.register_prehook(pre)
        node.register_hook(post)

    def tag_between(outputs, lo, hi, label):
        stack = [t.grad_fn for t in outputs
                 if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        seen = set()
        while stack:
            node = stack.pop()
            if node is None or node in seen or not lo < node._sequence_nr() < hi:
                continue
            seen.add(node)
            tag(node, SKY_HIST if "ImageGather" in type(node).__name__ else label)
            stack += [n for n, _ in node.next_functions]

    saved = []
    for _, mod_name, fn_name, label in GRAD_LAYERS:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)

        def tagged(*a, _fn=fn, _label=label, **k):
            lo = _sequence_nr()
            out = _fn(*a, **k)
            flat = []
            for x in (out if isinstance(out, tuple) else (out,)):
                flat += list(x) if isinstance(x, (tuple, list)) else (
                    list(x.values()) if isinstance(x, dict) else [x])
            tag_between(flat, lo, _sequence_nr(), _label)
            return out
        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, functools.wraps(fn)(tagged))
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
    from ptx_torch.scenes import builders

    ap = argparse.ArgumentParser(prog="python -m ptx_torch.layer_profile")
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--out", default=os.path.join("build", "layer_profile"))
    ap.add_argument("--grad", action="store_true",
                    help="forward and backward of each chunk's mean radiance")
    ap.add_argument("--train", action="store_true",
                    help="make_train_step steps (--size², spp 16) instead of chunks")
    ap.add_argument("--demo", choices=sorted(builders.DEMOS), default="demo",
                    help="built-in scene")
    ap.add_argument("--large", choices=LARGE,
                    help="a scene of the large-scene ladder (K5, K6)")
    ap.add_argument("--scene", help="a JSON scene spec")
    ap.add_argument("--sky", help="HxW procedural sky for the demo or config4")
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

    kw = {}
    if args.sky:
        h, w = (int(v) for v in args.sky.lower().split("x"))
        kw["sky_image"] = builders.procedural_sky_image(h, w)
    if args.scene:
        from ptx_torch.scenes.spec import SceneSpec
        world = SceneSpec.load(args.scene).build()[0]
        name = os.path.splitext(os.path.basename(args.scene))[0]
    elif args.large:
        world, name = large_world(args.large), args.large
    else:
        world, name = builders.DEMOS[args.demo](**kw), args.demo
    scene = compile_scene(world, device)
    cam = Camera.reference_demo(args.size, args.size)
    rows = max(1, min(args.size, 2 ** 16 // args.size))
    args.grad = args.grad or args.train
    if args.train:
        from ptx_torch.parallel.render import _local_render, make_train_step
        with torch.no_grad():
            target = _local_render(scene, cam, 16, 16, scene.params, rng.PRNGKey(1), 0,
                                   cam.height)
        step = make_train_step(scene, cam, spp=16, depth=16, learning_rate=3e-4)

    def run(y0, n):
        if args.train:
            for i in range(n):
                step(scene.params, target, rng.fold(rng.PRNGKey(2), y0, i))
            sync()
            return
        if not args.grad:
            with torch.no_grad():
                render.render_rows(scene, scene.params, cam, rng.PRNGKey(0), y0,
                                   rows, 1, n, 16)
            sync()
            return
        for i in range(n):      # render_rows's chunks, each forward + backward
            k = rng.fold(rng.PRNGKey(0), i, y0)
            o, d = render.sample_rays(cam, k, range(y0, y0 + rows), range(cam.width),
                                      1, device)
            params = {key: ([x.detach().requires_grad_(True) for x in v]
                            if isinstance(v, list) else v.detach().requires_grad_(True))
                      for key, v in scene.params.items()}
            render.trace_rays(scene, params, o, d, k, 16).mean().backward()
        sync()

    run(0, 2)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(rows, args.chunks)
        walls.append(time.perf_counter() - t0)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    grad_ranges = _backward_ranges() if args.grad else contextlib.nullcontext()
    with _layer_ranges(), grad_ranges, profile(activities=activities) as prof:
        run(rows, args.chunks)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"trace_{name}"
                        f"{'_sky' + args.sky if args.sky else ''}"
                        f"{'_train' if args.train else '_grad' if args.grad else ''}.json")
    prof.export_chrome_trace(path)
    names = [n for n, _, _ in LAYERS]
    if args.grad:
        names += [g for *_, g in GRAD_LAYERS] + [SKY_HIST]
    with open(path) as f:
        s = summarize(json.load(f)["traceEvents"], tuple(names))

    wall_ms = min(walls) * 1e3
    s.update(scene=name, sky=args.sky, chunks=args.chunks, train=args.train,
             rays_per_chunk=args.size ** 2 * 16 if args.train else rows * args.size,
             peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda else None,
             wall_ms=wall_ms, walls_ms=[w * 1e3 for w in walls],
             idle_share=1.0 - s["busy_ms"] / wall_ms)
    print(f"{name}{' sky ' + args.sky if args.sky else ''}: "
          f"{args.chunks} {'train steps' if args.train else 'chunks'} of "
          f"{s['rays_per_chunk']} rays, depth 16"
          f"{', forward + backward' if args.grad else ''}: unprofiled "
          f"wall {wall_ms:.3f} ms (best of {[round(w * 1e3, 3) for w in walls]}); "
          f"profiled host wall {s['host_ms']:.3f} ms")
    print(f"kernels launched {s['kernels']}; device busy {s['busy_ms']:.3f} ms; "
          f"idle share {s['idle_share']:.4f} (1 - busy / unprofiled wall); peak "
          f"memory {s['peak_gib'] if cuda else 'not measured'} GiB")
    for tag, names in KERNELS.items():
        print(f"{tag.upper()} ({' + '.join(names)}): {s[f'{tag}_calls']} calls, mean "
              f"{s[f'{tag}_mean_us']:.2f} us per call")
    for t in s["top"]:
        print(f"top kernel: {t['device_ms']:9.3f} ms in {t['calls']:6d} calls  {t['name']}")
    print("layer            kernels  device_ms  share of profiled host wall")
    for name, v in s["layers"].items():
        print(f"{name:<16} {v['kernels']:>7}  {v['device_ms']:>9.3f}  "
              f"{v['host_share']:.4f}")
    print(f"trace: {path}")
    print(json.dumps(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
