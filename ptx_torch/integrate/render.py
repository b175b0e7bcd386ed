"""Tile / row-band rendering drivers (port of ``ptx/integrate/render.py``).

The pixel grid × sample axis splits into uniform ray chunks, each traced
as one flat wavefront; chunks exist to bound live memory.  Keys fold
exactly as in the JAX package, so the port renders the same image from
the same seed up to float32 reassociation.  A plain Python loop for now:
no CUDA graphs yet.
"""

from __future__ import annotations

import torch

from ptx_torch.core import rng
from ptx_torch.core.constants import DEFAULT_RAY_DEPTH
from ptx_torch.integrate.camera import Camera, sample_rays
from ptx_torch.integrate.trace import CompiledScene, trace_rays
from ptx_torch.utils import profiling


def render_tile(scene: CompiledScene, params, cam: Camera, key,
                x0: int, y0: int, cols: int, rows: int, spp: int, depth: int,
                compact=None):
    """The (x0, y0, cols, rows) pixel rectangle of the camera, ``spp``
    samples in one wavefront: mean radiance (rows, cols, 3)
    (``ptx.integrate.render._render_tile``)."""
    o, d = sample_rays(cam, key, range(y0, y0 + rows), range(x0, x0 + cols),
                       spp, scene.device)
    radiance = trace_rays(scene, params, o, d, key, depth, compact=compact)
    return radiance.mean(dim=0)


@profiling.spanned("render_rows")
def render_rows(scene: CompiledScene, params, cam: Camera, key, y0: int,
                rows: int, spp_chunk: int, n_chunks: int, depth: int):
    """A full-width row band at ``n_chunks · spp_chunk`` samples, one
    wavefront per chunk, chunk ``i`` keyed ``fold(key, i·spp_chunk, y0)``
    for both its camera jitter and its trace
    (``ptx.integrate.render._render_rows_fori``)."""
    ys, xs = range(y0, y0 + rows), range(cam.width)
    acc = torch.zeros((rows, cam.width, 3), dtype=torch.float32,
                      device=scene.device)
    for i in range(n_chunks):
        k = rng.fold(key, i * spp_chunk, y0)
        o, d = sample_rays(cam, k, ys, xs, spp_chunk, scene.device)
        acc = acc + trace_rays(scene, params, o, d, k, depth).mean(dim=0)
    return acc / n_chunks


def render(scene: CompiledScene, cam: Camera, key, spp: int = 16,
           depth: int = DEFAULT_RAY_DEPTH, params=None,
           rays_per_chunk: int = 2 ** 21, progress=None):
    """A full frame → (H, W, 3) float32 radiance, in row bands of at most
    ``rays_per_chunk`` rays, band ``y0`` keyed ``fold(key, y0)``."""
    params = scene.params if params is None else params
    rows_per_chunk = max(1, min(cam.height,
                                rays_per_chunk // max(1, cam.width * spp)))
    out = []
    y0 = 0
    while y0 < cam.height:
        rows = min(rows_per_chunk, cam.height - y0)
        out.append(render_tile(scene, params, cam, rng.fold(key, y0), 0, y0,
                               cam.width, rows, spp, depth))
        if progress is not None:
            progress(min(y0 + rows, cam.height), cam.height)
        y0 += rows
    return torch.cat(out, dim=0)
