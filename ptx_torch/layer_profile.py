"""Where a render's time goes, layer by layer, on one device.

    python -m ptx_torch.layer_profile [--chunks 4] [--device cuda] [--grad | --train
        [--spp 16]] [--demo demo|config1|config2|config3|config4 | --large S1|S2|S3|S4
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
``torch.profiler``, where the port records its spans
(:mod:`ptx_torch.utils.profiling`: one ``record_function`` range a span
on the profiler's clock, and in memory each span's host time,
synchronises and collector time).  The Chrome trace goes to ``--out``,
the recorder's :func:`~ptx_torch.utils.profiling.snapshot` beside it as
``<trace>.spans.json``; the trace is parsed here (:func:`summarize`):

- kernels: trace events of category ``kernel``, one per launch;
- device busy: the union of kernel, memcpy and memset intervals; the
  idle share is ``1 − busy / unprofiled wall``;
- per span: the kernels whose launch call (matched by correlation id)
  lies inside the span's host range and in none of its child spans,
  their device time, and the range's share of the profiled host wall;
- K1-K9: calls and mean device time per call, over all of a kernel's
  launches: ``bounce_forward_kernel``; ``bounce_bwd_kernel`` and the
  ``reduce_partials_kernel`` launched after it; ``hist_direct_kernel`` or
  ``hist_private_kernel`` (K3's two regimes); ``first_hit_kernel``;
  ``megasweep_kernel``; ``replay_bwd_kernel`` and the
  ``reduce_partials_kernel`` after it (K2's and K6's second launch is one
  kernel, counted with the launch it follows); ``emission_forward_kernel``
  and, apart from it (``k7_bwd``), K7's backward ``emission_backward_kernel``;
  ``hist_atomic_kernel``; ``sweep_select_kernel`` or
  ``sweep_sort_select_kernel`` (the union sweep's ``kernel`` mode:
  ``PTX_SWEEP_MODE=kernel PTX_MEGAB=0`` with ``--large``); the sky bank
  (``sb``: ``sky_bank_forward_kernel``; ``sb_bwd``:
  ``sky_bank_backward_kernel`` and the ``sky_bank_reduce_kernel`` after it);
- the ``TOP`` kernels by total device time, with their calls, and the
  ``TOP`` longest device idle gaps, each named by the innermost span open
  on the host at its midpoint (:func:`idle_gaps`);
- peak device memory (``max_memory_allocated``) over the unprofiled runs.

``--train`` profiles ``--chunks`` ``make_train_step`` steps instead of
render chunks: each one 4,194,304-ray wavefront (512², spp 16, depth 16)
forward and backward, against a target rendered before the timing;
``--spp`` sets the step's samples per
pixel (``--spp 4``: the 1,048,576-ray step of chip_smoke.py's path E, whose
sweep holds (rows, B) tensors per bounce).

``--grad`` runs each chunk forward and backward (``radiance.mean()``,
then ``backward()``), so the backward's spans appear: the VJP of K2's or
K6's scene vector (``replay_pack_bwd``; the vector is packed once per
``trace_rays`` call, ``replay_pack``), the replay backward
(``bounce_bwd``: K2 or K6), the compaction transpose
(``compaction_bwd``), the emission backward (``emission_bwd``) and the
sky image's histogram (``sky_hist``: K3).

It prints the card's name and power limit, the figures, per span its
host self ms, device ms, synchronises and collector ms, and last a JSON
object with the same numbers.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import subprocess
import sys
import time

from ptx_torch.utils import profiling

# per kernel: the names of the launch that starts a call (one per call),
# and of the launch that follows it in the same call, if any
KERNELS = {"k1": (("bounce_forward_kernel",), None),
           "k2": (("bounce_bwd_kernel",), "reduce_partials_kernel"),
           "k3": (("hist_direct_kernel", "hist_private_kernel"), None),
           "k4": (("first_hit_kernel",), None),
           "k5": (("megasweep_kernel",), None),
           "k6": (("replay_bwd_kernel",), "reduce_partials_kernel"),
           "k7": (("emission_forward_kernel",), None),
           "k7_bwd": (("emission_backward_kernel",), None),
           "k8": (("hist_atomic_kernel",), None),
           "k9": (("sweep_select_kernel", "sweep_sort_select_kernel"), None),
           "sb": (("sky_bank_forward_kernel",), None),
           "sb_bwd": (("sky_bank_backward_kernel",), "sky_bank_reduce_kernel")}
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 8                         # kernels listed by total device time, and idle gaps


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


def _innermost(events, layers):
    """The ``layers`` ranges of a trace, sorted by start (the longer
    first), and a function from a host time to the innermost of them open
    at it (its index, or -1)."""
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "user_annotation" and e["name"] in layers),
                    key=lambda r: (r[0], -r[1]))
    starts = [r[0] for r in ranges]
    parent, open_ = [], []      # each range's innermost enclosing range
    for a, b, _ in ranges:
        while open_ and ranges[open_[-1]][1] < b:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(len(parent) - 1)

    def at(ts):
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0 and ranges[i][1] < ts:
            i = parent[i]
        return i
    return ranges, at


def summarize(events, layers=profiling.SPANS + profiling.UNFUSED_SPANS):
    """Derive the span figures from a Chrome trace's ``traceEvents``.

    Returns a dict: ``kernels`` (launches), ``busy_ms`` (device),
    ``host_ms`` (profiled host wall, first to last host event),
    ``k1_calls``, ``k1_mean_us`` (device time per call; also for k2-k9,
    ``k7_bwd``, ``sb`` and ``sb_bwd``;
    ``k2_second_us``, ``k6_second_us``, ``sb_bwd_second_us``: the second
    launch's share)
    and ``layers``: per span name ``kernels`` and ``device_ms`` (of the
    launches it is the innermost of ``layers`` open at) and
    ``host_share``."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    ranges, at = _innermost(events, layers)
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime",
                                                  "user_annotation")]
    host_us = (max(e["ts"] + e["dur"] for e in host) - min(e["ts"] for e in host)
               if host else 0.0)

    per = {n: {"kernels": 0, "device_ms": 0.0, "host_share": 0.0} for n in layers}
    for a, b, name in ranges:
        per[name]["host_share"] += (b - a) / host_us
    for k in kernels:
        ts = launch_ts.get(k["args"].get("correlation"))
        i = at(ts) if ts is not None else -1
        if i >= 0:
            per[ranges[i][2]]["kernels"] += 1
            per[ranges[i][2]]["device_ms"] += k["dur"] / 1e3
    out = {"kernels": len(kernels),
           "busy_ms": _union_us((e["ts"], e["ts"] + e["dur"]) for e in device) / 1e3,
           "host_ms": host_us / 1e3}
    ordered = sorted(kernels, key=lambda k: k["ts"])
    for tag, (starts_call, follower) in KERNELS.items():
        calls, dur, second = 0, 0.0, 0.0
        for i, k in enumerate(ordered):
            if any(n in k["name"] for n in starts_call):
                calls, dur = calls + 1, dur + k["dur"]
                nxt = ordered[i + 1] if i + 1 < len(ordered) else None
                if follower and nxt is not None and follower in nxt["name"]:
                    second += nxt["dur"]
        out[f"{tag}_calls"] = calls
        out[f"{tag}_mean_us"] = (dur + second) / calls if calls else 0.0
        if follower:
            out[f"{tag}_second_us"] = second / calls if calls else 0.0
    out["layers"] = per
    by_name: dict = {}
    for k in kernels:
        calls, us = by_name.get(k["name"], (0, 0.0))
        by_name[k["name"]] = (calls + 1, us + k["dur"])
    out["top"] = [{"name": n[:90], "calls": c, "device_ms": us / 1e3} for n, (c, us)
                  in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]]
    return out


def idle_gaps(events, layers=profiling.SPANS + profiling.UNFUSED_SPANS, top=TOP):
    """The ``top`` longest gaps between device work (kernel, memcpy and
    memset intervals), longest first, as ``[span, ms]``: the innermost of
    ``layers`` open on the host at the gap's midpoint, or
    ``outside_spans``."""
    busy = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in _DEVICE_CATS)
    merged = []
    for a, b in busy:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    ranges, at = _innermost(events, layers)
    gaps = []
    for (_, b), (a, _) in zip(merged, merged[1:]):
        i = at((a + b) / 2)
        gaps.append([ranges[i][2] if i >= 0 else "outside_spans", (a - b) / 1e3])
    return sorted(gaps, key=lambda g: -g[1])[:top]


def main(argv=None):
    import torch

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
                    help="make_train_step steps (--size², --spp) instead of chunks")
    ap.add_argument("--spp", type=int, default=16, help="samples per pixel of a --train step")
    ap.add_argument("--demo", choices=sorted(builders.DEMOS), default="demo",
                    help="built-in scene")
    ap.add_argument("--large", choices=LARGE,
                    help="a scene of the large-scene ladder (K5, K6)")
    ap.add_argument("--scene", help="a JSON scene spec")
    ap.add_argument("--sky", help="HxW procedural sky for the demo or config4")
    args = ap.parse_args(argv)
    if args.spp != 16 and not args.train:
        ap.error("--spp sets a --train step's samples per pixel")
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
            target = _local_render(scene, cam, 16, args.spp, scene.params, rng.PRNGKey(1), 0,
                                   cam.height)
        step = make_train_step(scene, cam, spp=args.spp, depth=16, learning_rate=3e-4)

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
    path = os.path.join(args.out, f"trace_{name}"
                        f"{'_sky' + args.sky if args.sky else ''}"
                        f"{'_train' if args.train else '_grad' if args.grad else ''}"
                        f"{f'_spp{args.spp}' if args.spp != 16 else ''}.json")
    profiling.reset()
    with profiling.trace(path, cuda):
        run(rows, args.chunks)
    spans = profiling.snapshot()
    with open(path[:-len(".json")] + ".spans.json", "w") as f:
        json.dump(spans, f, indent=1)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    s = summarize(events)
    s.update(gaps=idle_gaps(events), spans=spans)

    wall_ms = min(walls) * 1e3
    s.update(scene=name, sky=args.sky, chunks=args.chunks, train=args.train,
             rays_per_chunk=args.size ** 2 * args.spp if args.train else rows * args.size,
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
    for tag, (starts_call, follower) in KERNELS.items():
        names = " or ".join(starts_call) + (f" + {follower}" if follower else "")
        second = (f" (the second launch {s[f'{tag}_second_us']:.2f} us)" if follower
                  else "")
        print(f"{tag.upper()} ({names}): {s[f'{tag}_calls']} calls, mean "
              f"{s[f'{tag}_mean_us']:.2f} us per call{second}")
    for t in s["top"]:
        print(f"top kernel: {t['device_ms']:9.3f} ms in {t['calls']:6d} calls  {t['name']}")
    print("span             calls  host_self_ms  kernels  device_ms  syncs  gc_ms  "
          "share of profiled host wall")
    for name, v in s["layers"].items():
        r = spans["spans"].get(name, {"calls": 0, "self_ms": 0.0, "syncs": 0, "gc_ms": 0.0})
        print(f"{name:<16} {r['calls']:>5}  {r['self_ms']:>12.3f}  {v['kernels']:>7}  "
              f"{v['device_ms']:>9.3f}  {r['syncs']:>5}  {r['gc_ms']:>5.2f}  "
              f"{v['host_share']:.4f}")
    print(f"outside every span: syncs {spans['outside']['syncs']}, gc "
          f"{spans['outside']['gc_ms']:.2f} ms; counters {spans['counters']}"
          f"{'' if spans['cuda'] else ' (no CUDA: synchronises not counted)'}")
    for span, ms in s["gaps"]:
        print(f"idle gap: {ms:8.3f} ms in {span}")
    print(f"trace: {path}")
    print(json.dumps(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
