"""Command-line driver of the port: ``python -m ptx_torch render | serve |
farm`` (port of ``ptx/cli.py``; its ``bench`` runs the JAX package's
benchmark and is not ported).

- ``render`` — render full-width row bands of at most
  ``--rays-per-chunk`` rays with ``--spp-chunk`` samples per wavefront
  (the JAX package's chunking and keys), write ``.bmp`` + ``.hdr`` and
  print rays/s.  ``--checkpoint path.npz`` accumulates per-pixel sample
  sums, saved after each sample chunk; re-running continues from the
  recorded sample count (a checkpoint written by either package).
  ``--preview`` redraws a terminal half-block preview after each band.
  ``--adaptive`` runs the variance-guided sampler
  (:mod:`ptx_torch.integrate.adaptive`).
- ``serve`` — TCP render-farm worker: renders the tiles it is asked for
  on this process's device and streams them back in row bands.
- ``farm addr [addr...]`` — farm a frame's tiles to servers and write it.

The scene is a built-in (``--demo``) or a JSON spec (``--scene``,
:mod:`ptx_torch.scenes.spec`).  ``render`` and ``serve`` run on the card
unless ``--device cpu`` is given; ``farm`` renders nothing itself.
Structured progress goes to stderr as JSON lines
(:mod:`ptx_torch.utils.profiling`).
"""

from __future__ import annotations

import argparse
import sys
import time


def _world(args):
    """The scene tree, camera, spp and depth, as ``ptx/cli.py:30-56``: from
    the ``--scene`` JSON (its camera and ``render`` options, overridden by
    the flags) or the ``--demo`` builder."""
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.scenes import builders
    from ptx_torch.scenes.spec import SceneSpec

    if args.scene:
        world, cam, opts = SceneSpec.load(args.scene).build()
    else:
        world, cam, opts = builders.DEMOS[args.demo](), None, {}
    width = args.width or int(opts.get("width", 0)) or (cam.width if cam else 640)
    height = args.height or int(opts.get("height", 0)) or (cam.height if cam else 480)
    cam = Camera.reference_demo(width, height) if cam is None else (
        cam if (cam.width, cam.height) == (width, height)
        else Camera(width, height, cam.screen_width, cam.screen_height,
                    cam.screen_distance, cam.pose))
    spp = args.spp or int(opts.get("spp", 10))
    depth = args.depth or int(opts.get("depth", 16))
    return world, cam, spp, depth


def _build_scene(args, device):
    """:func:`_world` with the scene compiled on ``device``."""
    from ptx_torch.integrate.trace import compile_scene

    world, cam, spp, depth = _world(args)
    return compile_scene(world, device), cam, spp, depth


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to render "
                         "on the CPU with the plain PyTorch path")
    return device


def _write(args, img):
    from ptx_torch import io

    out_base = args.out or f"image{int(time.time()):08X}"
    io.write_bmp(out_base + ".bmp", img)
    io.write_hdr(out_base + ".hdr", img)
    return out_base


def _terminal_preview(img):
    """ANSI half-block preview of a float image: at most 80 columns and 22
    text lines (two pixel rows a line)."""
    import numpy as np

    h, w = img.shape[:2]
    cols = min(80, w)
    rows = min(44, h - h % 2)
    ys = (np.linspace(0, h - 1, rows)).astype(int)
    xs = (np.linspace(0, w - 1, cols)).astype(int)
    small = np.clip(img[ys][:, xs] * 256, 0, 255).astype(int)
    out = []
    for y in range(0, rows - 1, 2):
        line = []
        for x in range(cols):
            t, b = small[y, x], small[y + 1, x]
            line.append(f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
                        f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀")
        out.append("".join(line) + "\x1b[0m")
    sys.stdout.write("\x1b[H\x1b[2J" + "\n".join(out) + "\n")
    sys.stdout.flush()


def _render_adaptive(args, scene, cam, spp, depth, key):
    """``render --adaptive`` (``ptx/cli.py:91-111``): base pass at
    ``max(2, spp // 2)``, 4 rounds on the top 1/8 of the pixels at
    ``max(4, spp // 2)``; ``--checkpoint`` holds the moments after the
    base pass and each round."""
    from ptx_torch.integrate.adaptive import render_adaptive
    from ptx_torch.parallel.checkpoint import AdaptiveCheckpoint

    t0 = time.time()
    ckpt = AdaptiveCheckpoint(cam.height, cam.width, args.checkpoint)
    final, counts, _ = render_adaptive(
        scene, cam, key, spp_base=max(2, spp // 2), rounds=4, frac=0.125,
        spp_refine=max(4, spp // 2), depth=depth,
        state=ckpt.state, on_round=ckpt.update)
    final, counts = final.cpu().numpy(), counts.cpu().numpy()
    out_base = _write(args, final)
    print(f"wrote {out_base}.bmp/.hdr  adaptive spp "
          f"{counts.min():.0f}-{counts.max():.0f} "
          f"(mean {counts.mean():.1f}) in {time.time() - t0:.1f}s")
    return final


def cmd_render(args):
    import numpy as np

    from ptx_torch.core import rng
    from ptx_torch.integrate.render import render_rows, render_tile
    from ptx_torch.parallel.checkpoint import RenderAccumulator
    from ptx_torch.utils.profiling import Meter, log

    device = _device(args.device)
    t_build = time.time()
    scene, cam, spp, depth = _build_scene(args, device)
    key = rng.PRNGKey(args.seed)
    if args.adaptive:
        return _render_adaptive(args, scene, cam, spp, depth, key)

    acc = RenderAccumulator(cam.height, cam.width, args.checkpoint)
    done_spp = acc.samples_done if args.checkpoint else 0
    if done_spp >= spp:
        print(f"checkpoint already has {done_spp}/{spp} spp")
    meter = Meter("render")
    log("render_start", width=cam.width, height=cam.height, spp=spp,
        depth=depth, resume_spp=done_spp)

    # snap the sample chunk to a divisor of spp and the band to a divisor
    # of H, as the JAX CLI does (same chunking ⇒ same keys ⇒ same image)
    spp_step = max(1, min(spp, args.spp_chunk))
    while spp % spp_step:
        spp_step -= 1
    rows = max(1, min(cam.height, args.rays_per_chunk // (cam.width * spp_step)))
    while cam.height % rows:
        rows -= 1
    t0 = time.time()

    if not args.checkpoint and not args.preview:
        # each band's whole sample loop in one call; chunk i keyed
        # fold(key, i·spp_step, y0), as the chunked path below keys it
        frame = np.zeros((cam.height, cam.width, 3), np.float32)
        first_band_s = None
        for y0 in range(0, cam.height, rows):
            band = render_rows(scene, scene.params, cam, key, y0, rows, spp_step,
                               spp // spp_step, depth)
            frame[y0:y0 + rows] = band.cpu().numpy()
            if first_band_s is None:
                first_band_s = time.time() - t0
            meter.add(rays=rows * cam.width * spp * (depth + 1),
                      samples=rows * cam.width * spp, tiles=1)
            sys.stdout.write(f"\r[{y0 + rows}/{cam.height} rows] "
                             f"{time.time() - t0:.1f}s")
            sys.stdout.flush()
        print()
        dt = time.time() - t0
        out_base = _write(args, frame)
        rays = cam.width * cam.height * spp * (depth + 1)
        meter.emit()
        log("render_done", out=out_base, seconds=round(dt, 2),
            rays_per_sec=round(rays / max(dt, 1e-9), 1),
            first_band_s=round(first_band_s, 2))
        print(f"wrote {out_base}.bmp/.hdr  ({rays / max(dt, 1e-9):.3g} rays/s on "
              f"{device}; first band incl. kernel build {first_band_s:.1f}s; scene "
              f"compile {t0 - t_build:.2f}s)")
        return frame

    # chunked: host boundaries for the checkpoint (saved after each sample
    # chunk) and the live preview; chunk (s, y0) keyed fold(key, s, y0)
    s = done_spp
    while s < spp:
        cur = min(spp_step, spp - s)
        for y0 in range(0, cam.height, rows):
            img = render_tile(scene, scene.params, cam, rng.fold(key, s, y0), 0, y0,
                              cam.width, rows, cur, depth)
            acc.add(img, cur, y0)
            meter.add(rays=rows * cam.width * cur * (depth + 1),
                      samples=rows * cam.width * cur, tiles=1)
            # row-sample units on both sides: each chunk covers cur samples
            # for every row it renders
            done = (s - done_spp) * cam.height + (y0 + rows) * cur
            total = (spp - done_spp) * cam.height
            if args.preview:
                _terminal_preview(acc.image())
            else:
                sys.stdout.write(f"\r[{done}/{total} row-samples] "
                                 f"{time.time() - t0:.1f}s")
                sys.stdout.flush()
        s += cur
        if args.checkpoint:
            acc.save()
    print()
    final = acc.image()
    out_base = _write(args, final)
    rays = cam.width * cam.height * (spp - done_spp) * (depth + 1)
    dt = time.time() - t0
    meter.emit()
    log("render_done", out=out_base, seconds=round(dt, 2),
        rays_per_sec=round(rays / max(dt, 1e-9), 1))
    print(f"wrote {out_base}.bmp/.hdr  ({rays / max(dt, 1e-9):.3g} rays/s on {device})")
    return final


def serve_render_fn(scene, cam, adaptive=False, rounds=2, frac=0.25):
    """The ``serve`` callback: ``render_fn(x0, y0, w, h, spp, depth, seed)``
    renders exactly that rectangle of ``cam`` (through the variance-guided
    sampler at the same budget when ``adaptive``; the reference's farmed
    blocks are adaptive blocks), keyed ``PRNGKey(seed & 0x7FFFFFFF)``, and
    logs a ``tile_done`` line.

    The server's pool threads call it concurrently; the kernel wrappers
    keep module state (launch counters, the loaded library, K2's per-call
    pack), so one lock lets one band at a time run on the device."""
    import functools
    import threading

    from ptx_torch.core import rng
    from ptx_torch.integrate.adaptive import render_adaptive_tile
    from ptx_torch.integrate.render import render_tile
    from ptx_torch.utils.profiling import log

    device_lock = threading.Lock()
    fn = (functools.partial(render_adaptive_tile, rounds=rounds, frac=frac)
          if adaptive else render_tile)

    def render_fn(x0, y0, w, h, spp, depth, seed):
        t0 = time.perf_counter()
        k = rng.PRNGKey(seed & 0x7FFFFFFF)
        with device_lock:
            out = fn(scene, scene.params, cam, k, int(x0), int(y0), int(w), int(h),
                     int(spp), int(depth)).cpu().numpy()
        log("tile_done", x0=int(x0), y0=int(y0), w=int(w), h=int(h),
            spp=int(spp), adaptive=bool(adaptive),
            seconds=round(time.perf_counter() - t0, 3))
        return out

    return render_fn


def cmd_serve(args):
    from ptx_torch.runtime import RenderFarmServer

    device = _device(args.device)
    scene, cam, _, _ = _build_scene(args, device)
    render_fn = serve_render_fn(scene, cam, args.adaptive, args.adaptive_rounds,
                                args.adaptive_frac)
    srv = RenderFarmServer(render_fn, port=args.port, bind=args.bind,
                           max_inflight=args.max_inflight,
                           chunk_rows=args.chunk_rows)
    print(f"ptx_torch render-farm server on :{srv.port} "
          f"(scene={args.scene or args.demo}, device={device})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()


def cmd_farm(args):
    from ptx_torch.runtime import RenderFarmClient

    _, cam, spp, depth = _world(args)
    t0 = time.time()
    state = {"tiles": 0, "total_tiles": 0}

    def progress(done, total):
        state["tiles"], state["total_tiles"] = done, total

    def row_progress(rows, total_rows):
        # live intra-tile progress from streamed row bands
        sys.stdout.write(
            f"\r[{state['tiles']}/{state['total_tiles']} tiles, "
            f"{rows}/{total_rows} rows] {time.time() - t0:.1f}s")
        sys.stdout.flush()

    with RenderFarmClient(args.addresses, default_port=args.port) as cli:
        img = cli.render_image(cam.width, cam.height, tile=args.tile,
                               spp=spp, depth=depth, seed=args.seed,
                               parallel=args.parallel, progress=progress,
                               row_progress=row_progress)
    print()
    out_base = _write(args, img)
    print(f"wrote {out_base}.bmp/.hdr")
    return img


def parser() -> argparse.ArgumentParser:
    """The command line: ``render``, ``serve`` and ``farm`` with the JAX
    CLI's flags, plus ``--device`` where the command renders."""
    p = argparse.ArgumentParser(prog="ptx_torch",
                                description="CSG path tracer, PyTorch/CUDA port")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--scene", help="JSON scene spec (its camera and render "
                        "options apply unless a flag overrides them); takes "
                        "precedence over --demo")
        sp.add_argument("--demo", choices=["demo", "config1", "config2", "config3",
                                           "config4"], default="demo",
                        help="built-in scene: the reference demo or BASELINE config 1-4")
        sp.add_argument("--width", type=int, default=0)
        sp.add_argument("--height", type=int, default=0)
        sp.add_argument("--spp", type=int, default=0)
        sp.add_argument("--depth", type=int, default=0)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--out", help="output basename")

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain path)")

    sp = sub.add_parser("render", help="render locally")
    common(sp)
    device(sp)
    sp.add_argument("--preview", action="store_true", help="live terminal preview")
    sp.add_argument("--adaptive", action="store_true",
                    help="variance-guided adaptive sampling")
    sp.add_argument("--checkpoint", help="sample-sum checkpoint (.npz)")
    sp.add_argument("--spp-chunk", type=int, default=1)
    sp.add_argument("--rays-per-chunk", type=int, default=2 ** 16)
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("serve", help="render-farm worker (TCP)")
    common(sp)
    device(sp)
    sp.add_argument("--port", type=int, default=12346)
    sp.add_argument("--bind", default="127.0.0.1",
                    help="listen address (default loopback; pass 0.0.0.0 "
                         "explicitly for farm deployments: the tile "
                         "protocol is unauthenticated)")
    sp.add_argument("--max-inflight", type=int, default=0)
    sp.add_argument("--chunk-rows", type=int, default=16,
                    help="stream tiles incrementally in row bands of this "
                         "many rows (0 = send each tile whole)")
    sp.add_argument("--adaptive", action="store_true",
                    help="render each farmed tile adaptively at the requested "
                         "budget (base pass at spp/2, the rest on the tile's "
                         "highest-variance pixels)")
    sp.add_argument("--adaptive-rounds", type=int, default=2)
    sp.add_argument("--adaptive-frac", type=float, default=0.25)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("farm", help="farm tiles to servers")
    common(sp)
    sp.add_argument("addresses", nargs="+", help="server host[:port] list")
    sp.add_argument("--port", type=int, default=12346)
    sp.add_argument("--tile", type=int, default=64)
    sp.add_argument("--parallel", type=int, default=8)
    sp.set_defaults(fn=cmd_farm)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    return args.fn(args)
