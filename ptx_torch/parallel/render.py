"""Sharded rendering and the gradient training step over a (tiles ×
samples) mesh (port of ``ptx/parallel/render.py``).

Each rank renders its row band (``tiles``) at its share of the samples
(``samples``) under the ray key ``fold(key, tile_idx, samp_idx)``, as the
JAX ``_local_render`` folds the mesh indices, so a mesh render equals the
per-band renders of one process bit for bit.  The collectives are
all-reduces over the mesh's groups (:mod:`ptx_torch.parallel.mesh`):

- ``render_sharded``: the band's mean over the sample group, summed then
  divided by the group's size (JAX's ``pmean``), then the frame: each rank
  writes its band into a zero frame and the tile group sums the frames
  (``x + 0`` is exact), so every rank returns the full ``(H, W, 3)``
  image, what ``np.asarray`` of JAX's row-sharded output gives; the mesh
  needs no collective but the all-reduce;
- ``render_sharded_moments``: Σ radiance and Σ radiance² summed over the
  sample group, gathered the same way; ``render_adaptive_sharded``, the
  adaptive sampler with that as its dense base pass;
- ``make_train_step``: each rank's loss on its band of the full target,
  the gradients flattened into one buffer and averaged over the tile
  group, then over the sample group (JAX's ``pmean(pmean(g, tiles),
  samples)``), the loss the same way, and the same SGD update on every
  rank.

``mesh=None`` (and a :class:`~ptx_torch.parallel.mesh.LocalMesh`) is the
1×1 mesh: tile 0, sample 0, no collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ptx_torch.core import rng
from ptx_torch.core.constants import DEFAULT_RAY_DEPTH
from ptx_torch.integrate import adaptive
from ptx_torch.integrate.camera import Camera, sample_rays
from ptx_torch.integrate.trace import CompiledScene, trace_rays
from ptx_torch.parallel.mesh import (SAMPLE_AXIS, TILE_AXIS, LocalMesh, coordinate,
                                     image_rows, mesh_device, mesh_shape)
from ptx_torch.utils import profiling


def _local_render(scene: CompiledScene, cam: Camera, depth: int, spp_local: int,
                  params, key, y0: int, rows: int, tile_idx: int = 0, samp_idx: int = 0,
                  remat: bool = True, compact=None, manual_vjp=None):
    """``rows`` rows from ``y0`` at ``spp_local`` samples: this rank's mean
    radiance (rows, W, 3) under ``fold(key, tile_idx, samp_idx)``
    (``ptx/parallel/render.py:32``, before its ``pmean``); ``remat``,
    ``compact`` and ``manual_vjp`` pass through to ``trace_rays``."""
    k = rng.fold(key, tile_idx, samp_idx)
    o, d = sample_rays(cam, k, range(y0, y0 + rows), range(cam.width), spp_local,
                       scene.device)
    return trace_rays(scene, params, o, d, k, depth, compact=compact,
                      manual_vjp=manual_vjp, remat=remat).mean(dim=0)


def _sum(x, mesh, axis):
    """All-reduce SUM of ``x`` in place over the mesh's ``axis`` group (none
    on a :class:`LocalMesh`)."""
    group = mesh.get_group(axis)
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _mean(x, mesh, axis):
    """JAX's ``pmean``: the sum over the ``axis`` group, divided by its size."""
    n = mesh_shape(mesh)[(TILE_AXIS, SAMPLE_AXIS).index(axis)]
    return _sum(x, mesh, axis).div_(n)


def _frame(band, mesh, height: int, y0: int):
    """The full frame from every rank's row band: the band written into a
    zero frame, summed over the tile group."""
    frame = band.new_zeros((height,) + tuple(band.shape[1:]))
    frame[y0:y0 + band.shape[0]] = band
    return _sum(frame, mesh, TILE_AXIS)


def _split(scene, cam: Camera, mesh, spp: int):
    """``(tile_idx, samp_idx, y0, rows, spp_local)`` of this rank; raises
    the JAX version's ``ValueError`` where the camera's height or ``spp``
    does not divide by the mesh axes, and where the scene is compiled for
    another kind of device than the mesh's."""
    tiles, samples = mesh_shape(mesh)
    if cam.height % tiles or spp % samples:
        raise ValueError("height/spp must divide the mesh axes")
    if mesh_device(mesh).type != scene.device.type:
        raise ValueError(f"the scene is compiled for {scene.device}, the mesh is on "
                         f"{mesh_device(mesh)}")
    tile_idx, samp_idx = coordinate(mesh)
    y0, rows = image_rows(mesh, cam.height)
    return tile_idx, samp_idx, y0, rows, spp // samples


@torch.no_grad()
def render_sharded(scene: CompiledScene, cam: Camera, mesh, key, spp: int = 16,
                   depth: int = DEFAULT_RAY_DEPTH, params=None, compact=None,
                   manual_vjp=None):
    """The full frame (H, W, 3) rendered over ``mesh``, on every rank.
    ``cam.height`` must divide by the tile axis and ``spp`` by the sample
    axis."""
    params = scene.params if params is None else params
    t, s, y0, rows, spp_local = _split(scene, cam, mesh, spp)
    band = _local_render(scene, cam, depth, spp_local, params, key, y0, rows, t, s,
                         compact=compact, manual_vjp=manual_vjp)
    return _frame(_mean(band, mesh, SAMPLE_AXIS), mesh, cam.height, y0)


@torch.no_grad()
def render_sharded_moments(scene: CompiledScene, cam: Camera, mesh, key, spp: int = 16,
                           depth: int = DEFAULT_RAY_DEPTH, params=None):
    """Like :func:`render_sharded`, the per-pixel sample moments ``(s1,
    s2)``: Σ radiance and Σ radiance² over all ``spp`` samples, each a full
    (H, W, 3) frame on every rank, summed over the sample group (the
    adaptive sampler's base pass, :mod:`ptx_torch.integrate.adaptive`)."""
    params = scene.params if params is None else params
    t, s, y0, rows, spp_local = _split(scene, cam, mesh, spp)
    k = rng.fold(key, t, s)
    o, d = sample_rays(cam, k, range(y0, y0 + rows), range(cam.width), spp_local,
                       scene.device)
    rad = trace_rays(scene, params, o, d, k, depth)
    return tuple(_frame(_sum(m, mesh, SAMPLE_AXIS), mesh, cam.height, y0)
                 for m in (rad.sum(dim=0), (rad ** 2).sum(dim=0)))


def render_adaptive_sharded(scene: CompiledScene, cam: Camera, mesh, key,
                            spp_base: int = 8, rounds: int = 4, frac: float = 0.125,
                            spp_refine: int = 16, depth: int = DEFAULT_RAY_DEPTH,
                            params=None, on_round=None):
    """:func:`~ptx_torch.integrate.adaptive.render_adaptive` with its dense
    base pass rendered over ``mesh`` (:func:`render_sharded_moments`, keyed
    as that function keys a rank's band): ``(image, counts, state)`` on
    every rank, each running the refinement rounds alike from the
    full-frame moments.  ``on_round`` is called after the base pass and
    after each round."""
    s1, s2 = render_sharded_moments(scene, cam, mesh, key, spp=spp_base, depth=depth,
                                    params=params)
    count = torch.full((cam.height, cam.width), float(spp_base), device=scene.device)
    if on_round is not None:
        on_round(s1, s2, count, 0)
    return adaptive.render_adaptive(scene, cam, key, spp_base, rounds, frac, spp_refine,
                                    depth, params, state=(s1, s2, count, 0),
                                    on_round=on_round)


def _leaves(params):
    """The param tensors in a fixed order (list entries flattened)."""
    out = []
    for k in params:
        v = params[k]
        out += [(k, i, x) for i, x in enumerate(v)] if isinstance(v, list) else [(k, None, v)]
    return out


def _rebuild(params, leaves, tensors):
    """``params``' layout over ``tensors``: its keys in its order, lists
    (an empty one too) where it has lists."""
    out = {k: ([] if isinstance(v, list) else None) for k, v in params.items()}
    for (k, i, _), x in zip(leaves, tensors):
        if i is None:
            out[k] = x
        else:
            out[k].append(x)
    return out


def make_train_step(scene: CompiledScene, cam: Camera, mesh=None, spp: int = 16,
                    depth: int = DEFAULT_RAY_DEPTH, learning_rate: float = 1e-2,
                    remat: bool = True, compact=None, manual_vjp=None):
    """``step(params, target, key) -> (params, loss)`` over ``mesh`` (None:
    the 1×1 mesh).  Each rank renders its band (module docstring) and
    takes the mean squared error against its rows of ``target``, the full
    (H, W, 3) image, through the band averaged over the sample group; the
    gradients of every param tensor (images included; zeros where a
    tensor does not reach the loss) and the loss are averaged over the
    tile group, then over the sample group; every rank returns ``p −
    learning_rate · g`` for each param, without autograd history.
    ``remat``, ``compact`` and ``manual_vjp`` pass through to
    ``trace_rays`` (``remat`` acts only under ``manual_vjp=False``)."""
    mesh = LocalMesh(scene.device) if mesh is None else mesh

    @profiling.spanned("train_step")
    def step(params, target, key):
        t, s, y0, rows, spp_local = _split(scene, cam, mesh, spp)
        leaves = _leaves(params)
        xs = [x.detach().requires_grad_(True) for _, _, x in leaves]
        with profiling.span("forward"):
            band = _local_render(scene, cam, depth, spp_local,
                                 _rebuild(params, leaves, xs), key, y0, rows, t, s,
                                 remat=remat, compact=compact, manual_vjp=manual_vjp)
        # the loss sees the sample group's mean band; its cotangent goes to
        # this rank's band as it is (JAX transposes the pmean so), and the
        # sample-group mean of the gradients below divides it back
        img = _mean(band.detach().clone(), mesh, SAMPLE_AXIS).requires_grad_(True)
        loss = torch.mean((img - target[y0:y0 + rows]) ** 2)
        (ct,) = torch.autograd.grad(loss, img)
        with profiling.span("backward"):
            grads = torch.autograd.grad(band, xs, ct, allow_unused=True)
        with profiling.span("update"):
            flat = torch.cat([(torch.zeros_like(x) if g is None else g).reshape(-1)
                              for x, g in zip(xs, grads)])
            flat = _mean(_mean(flat, mesh, TILE_AXIS), mesh, SAMPLE_AXIS)
            loss = _mean(_mean(loss.detach().clone(), mesh, TILE_AXIS), mesh, SAMPLE_AXIS)
            with torch.no_grad():
                gs = flat.split([x.numel() for x in xs])
                new = [x.detach() - learning_rate * g.view_as(x) for x, g in zip(xs, gs)]
            return _rebuild(params, leaves, new), loss

    return step
