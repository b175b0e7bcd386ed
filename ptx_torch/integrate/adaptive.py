"""Variance-guided adaptive sampling (port of ``ptx/integrate/adaptive.py``).

The reference concentrates work by recursive block subdivision; the JAX
package keeps its objective (samples where the variance is) with
uniform-shaped work, and so does the port:

1. a dense base pass renders every pixel at ``spp_base``, keeping the
   per-pixel sums Σx and Σx² (so the variance of the mean is known);
2. each refinement round ranks the pixels by the estimated variance of
   their mean, takes the ``k`` highest, traces ``spp_refine`` more
   samples for each in one wavefront per gather chunk and adds them in.

Every pixel is truly sampled, and every wavefront is dense.  Keys as in
the JAX package, each driving both the jitter and the trace: base band
``fold(key, y0)``; refinement round ``r`` ``fold(key, 1000 + r)``, then
``fold(·, c0)`` per gather chunk; a farm tile's round ``r``
``fold(key, 2000 + r)``.  The ranking is ``jax.lax.top_k``'s: among equal
priorities the lower pixel index first (a stable descending sort here,
since ``torch.topk`` promises no order among ties).

Over a device mesh, :func:`ptx_torch.parallel.render.render_adaptive_sharded`
renders the dense base pass sharded and hands its full-frame moments to
:func:`render_adaptive` as ``state``; every rank then runs the refinement
rounds alike.
"""

from __future__ import annotations

import numpy as np
import torch

from ptx_torch.core import rng
from ptx_torch.core.constants import DEFAULT_RAY_DEPTH
from ptx_torch.integrate.camera import Camera, pixel_rays, sample_rays
from ptx_torch.integrate.trace import CompiledScene, trace_rays


def _moments(radiance):
    """Σ and Σ² over the sample axis of ``(spp, ..., 3)`` radiance."""
    return radiance.sum(dim=0), (radiance ** 2).sum(dim=0)


def _base_tile(scene, params, cam: Camera, key, x0: int, y0: int, cols: int,
               rows: int, spp: int, depth: int):
    """``(s1, s2)`` (rows, cols, 3) of the pixel rectangle at ``spp``
    jittered samples (``_base_rows`` / ``_base_tile``)."""
    o, d = sample_rays(cam, key, range(y0, y0 + rows), range(x0, x0 + cols), spp,
                       scene.device)
    return _moments(trace_rays(scene, params, o, d, key, depth))


def _base_pass(scene, params, cam: Camera, key, spp: int, depth: int,
               rays_per_chunk: int = 2 ** 21):
    """The dense base pass in full-width row bands of at most
    ``rays_per_chunk`` rays, band ``y0`` keyed ``fold(key, y0)``."""
    rows_per_chunk = max(1, min(cam.height,
                                rays_per_chunk // max(1, cam.width * spp)))
    s1 = torch.empty((cam.height, cam.width, 3), device=scene.device)
    s2 = torch.empty_like(s1)
    for y0 in range(0, cam.height, rows_per_chunk):
        rows = min(rows_per_chunk, cam.height - y0)
        s1[y0:y0 + rows], s2[y0:y0 + rows] = _base_tile(
            scene, params, cam, rng.fold(key, y0), 0, y0, cam.width, rows, spp, depth)
    count = torch.full((cam.height, cam.width), float(spp), device=scene.device)
    return s1, s2, count


def _rank_pixels(s1, s2, count, k: int):
    """The flat indices of the ``k`` pixels of highest priority, the
    estimated variance of the pixel mean summed over channels (s²/n), in
    ``jax.lax.top_k``'s order: descending, the lower index first among
    ties."""
    mean = s1 / count[..., None]
    var = torch.clamp(s2 / count[..., None] - mean ** 2, min=0.0)
    priority = ((var[..., 0] + var[..., 1]) + var[..., 2]) / count
    return torch.sort(priority.reshape(-1), descending=True, stable=True)[1][:k]


def _refine(scene, params, cam: Camera, key, x0: int, y0: int, cols: int,
            s1, s2, count, flat_idx, spp: int, depth: int):
    """Trace ``spp`` more samples for each pixel ``flat_idx`` of the
    rectangle at ``(x0, y0)``, ``cols`` wide, and add them into ``s1``,
    ``s2``, ``count`` in place (``_refine_chunk`` / ``_refine_tile``).
    The indices are unique, so each sum takes one add."""
    py = (y0 + flat_idx // cols).float()
    px = (x0 + flat_idx % cols).float()
    shape = (spp,) + tuple(flat_idx.shape)
    o, d = pixel_rays(cam, px.expand(shape), py.expand(shape),
                      rng.sample_square(key, shape, scene.device))
    add1, add2 = _moments(trace_rays(scene, params, o, d, key, depth))   # (k, 3)
    s1.view(-1, 3).index_add_(0, flat_idx, add1)
    s2.view(-1, 3).index_add_(0, flat_idx, add2)
    count.view(-1).index_add_(0, flat_idx, torch.full_like(flat_idx, spp,
                                                           dtype=count.dtype))


def _refine_round(scene, params, cam: Camera, key, s1, s2, count, k: int,
                  spp: int, depth: int, rays_per_chunk: int = 2 ** 21):
    """One ranked refinement round, gather-chunked so that no wavefront
    holds more than ``rays_per_chunk`` rays; chunk ``c0`` keyed
    ``fold(key, c0)``."""
    flat_idx = _rank_pixels(s1, s2, count, k)
    k_chunk = max(1, min(k, rays_per_chunk // max(1, spp)))
    for c0 in range(0, k, k_chunk):
        _refine(scene, params, cam, rng.fold(key, c0), 0, 0, cam.width, s1, s2, count,
                flat_idx[c0:c0 + k_chunk], spp, depth)


def render_adaptive(scene: CompiledScene, cam: Camera, key,
                    spp_base: int = 8, rounds: int = 4,
                    frac: float = 0.125, spp_refine: int = 16,
                    depth: int = DEFAULT_RAY_DEPTH, params=None,
                    state=None, on_round=None):
    """Adaptive full-frame render → ``(image (H, W, 3), counts (H, W),
    state)``.

    The budget is ``spp_base`` samples a pixel plus ``rounds`` rounds of
    ``spp_refine`` samples on the ``frac`` of pixels whose mean is the
    most uncertain.

    - ``state``: ``(s1, s2, count, rounds_done)`` from a checkpoint
      (tensors or arrays); the base pass is skipped and only the remaining
      rounds run, so resume ≡ uninterrupted.
    - ``on_round(s1, s2, count, rounds_done)``: called after the base pass
      and after each round (the checkpoint's hook).
    """
    params = scene.params if params is None else params
    k = max(1, int(cam.height * cam.width * frac))
    if state is not None and int(state[3]) >= 0 and state[2] is not None:
        s1, s2, count = (x.to(scene.device, torch.float32, copy=True) if torch.is_tensor(x)
                         else torch.tensor(np.asarray(x, np.float32), device=scene.device)
                         for x in state[:3])
        rounds_done = int(state[3])
    else:
        s1, s2, count = _base_pass(scene, params, cam, key, spp_base, depth)
        rounds_done = 0
        if on_round is not None:
            on_round(s1, s2, count, rounds_done)
    for r in range(rounds_done, rounds):
        _refine_round(scene, params, cam, rng.fold(key, 1000 + r), s1, s2, count, k,
                      spp_refine, depth)
        if on_round is not None:
            on_round(s1, s2, count, r + 1)
    return s1 / count[..., None], count, (s1, s2, count, rounds)


# --------------------------------------------------------------------------
# farm tiles: the server renders each requested tile adaptively at the
# requested budget (the reference's farmed blocks are adaptive blocks)
# --------------------------------------------------------------------------

def adaptive_tile_moments(scene: CompiledScene, params, cam: Camera, key,
                          x0: int, y0: int, cols: int, rows: int, spp: int,
                          depth: int, rounds: int = 2, frac: float = 0.25):
    """``(s1, s2, count)`` of one tile at the budget of a dense render at
    ``spp``: a base pass at ``max(1, spp // 2)``, then ``rounds`` rounds on
    the top ``frac`` of the tile's pixels at ``max(1, round(remaining ·
    rows · cols / (rounds · k)))`` samples (no round when nothing
    remains)."""
    spp_base = max(1, spp // 2)
    remaining = max(0, spp - spp_base)
    k = max(1, int(rows * cols * frac))
    spp_refine = max(1, int(round(remaining * rows * cols / max(1, rounds * k))))
    s1, s2 = _base_tile(scene, params, cam, key, x0, y0, cols, rows, spp_base, depth)
    count = torch.full((rows, cols), float(spp_base), device=scene.device)
    for r in range(rounds if remaining else 0):
        flat_idx = _rank_pixels(s1, s2, count, k)
        _refine(scene, params, cam, rng.fold(key, 2000 + r), x0, y0, cols, s1, s2, count,
                flat_idx, spp_refine, depth)
    return s1, s2, count


def render_adaptive_tile(scene: CompiledScene, params, cam: Camera, key,
                         x0: int, y0: int, cols: int, rows: int, spp: int,
                         depth: int, rounds: int = 2, frac: float = 0.25):
    """The (rows, cols, 3) mean image of :func:`adaptive_tile_moments`: a
    drop-in for :func:`ptx_torch.integrate.render.render_tile` in the farm
    server."""
    s1, _, count = adaptive_tile_moments(scene, params, cam, key, x0, y0, cols, rows,
                                         spp, depth, rounds, frac)
    return s1 / count[..., None]
