"""Command-line driver of the port: ``python -m ptx_torch render``.

Mirrors the fast path of ``ptx/cli.py``'s ``render``: build and compile
the scene, render full-width row bands of at most ``--rays-per-chunk``
rays with ``--spp-chunk`` samples per wavefront (same keys as the JAX
package), write ``.bmp`` + ``.hdr`` and print rays/s.  The scene is a built-in
(``--demo``) or a JSON spec (``--scene``, :mod:`ptx_torch.scenes.spec`).
``--adaptive``, ``--checkpoint``, ``--preview`` and the ``serve`` /
``farm`` / ``bench`` commands come later (ROADMAP).
"""

from __future__ import annotations

import argparse
import sys
import time


def _build_scene(args, device):
    """The scene, camera, spp and depth, as ``ptx/cli.py:30-56``: from the
    ``--scene`` JSON (its camera and ``render`` options, overridden by the
    flags) or the ``--demo`` builder."""
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.integrate.trace import compile_scene
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
    return compile_scene(world, device), cam, spp, depth


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to render "
                         "on the CPU with the plain PyTorch path")
    return device


def cmd_render(args):
    import numpy as np

    from ptx_torch import io
    from ptx_torch.core import rng
    from ptx_torch.integrate.render import render_rows

    device = _device(args.device)
    t_build = time.time()
    scene, cam, spp, depth = _build_scene(args, device)
    key = rng.PRNGKey(args.seed)

    # snap the sample chunk to a divisor of spp and the band to a divisor
    # of H, as the JAX CLI does (same chunking ⇒ same keys ⇒ same image)
    spp_step = max(1, min(spp, args.spp_chunk))
    while spp % spp_step:
        spp_step -= 1
    rows = max(1, min(cam.height, args.rays_per_chunk // (cam.width * spp_step)))
    while cam.height % rows:
        rows -= 1
    n_chunks = spp // spp_step

    frame = np.zeros((cam.height, cam.width, 3), np.float32)
    t0 = time.time()
    first_band_s = None
    for y0 in range(0, cam.height, rows):
        band = render_rows(scene, scene.params, cam, key, y0, rows, spp_step,
                           n_chunks, depth)
        frame[y0:y0 + rows] = band.cpu().numpy()
        if first_band_s is None:
            first_band_s = time.time() - t0
        sys.stdout.write(f"\r[{y0 + rows}/{cam.height} rows] "
                         f"{time.time() - t0:.1f}s")
        sys.stdout.flush()
    print()
    dt = time.time() - t0
    out_base = args.out or f"image{int(time.time()):08X}"
    io.write_bmp(out_base + ".bmp", frame)
    io.write_hdr(out_base + ".hdr", frame)
    rays = cam.width * cam.height * spp * (depth + 1)
    print(f"wrote {out_base}.bmp/.hdr  ({rays / max(dt, 1e-9):.3g} rays/s on "
          f"{device}; first band incl. kernel build {first_band_s:.1f}s; scene "
          f"compile {t0 - t_build:.2f}s)")
    return frame


def main(argv=None):
    p = argparse.ArgumentParser(prog="ptx_torch",
                                description="CSG path tracer, PyTorch/CUDA port")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("render", help="render locally")
    sp.add_argument("--demo", choices=["demo", "config1", "config2", "config3",
                                       "config4"], default="demo",
                    help="built-in scene: the reference demo or BASELINE config 1-4")
    sp.add_argument("--scene", help="JSON scene spec (its camera and render options "
                    "apply unless a flag overrides them); takes precedence over --demo")
    sp.add_argument("--width", type=int, default=0)
    sp.add_argument("--height", type=int, default=0)
    sp.add_argument("--spp", type=int, default=0)
    sp.add_argument("--depth", type=int, default=0)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--out", help="output basename")
    sp.add_argument("--spp-chunk", type=int, default=1)
    sp.add_argument("--rays-per-chunk", type=int, default=2 ** 16)
    sp.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain path)")
    sp.set_defaults(fn=cmd_render)
    args = p.parse_args(argv)
    return args.fn(args)
