"""The gradient training step (port of ``ptx/parallel/render.py``).

``make_train_step`` is the differentiable-rendering analogue of a training
step: render the frame under the current scene params, compare it with a
target image, and take an SGD step on every param.  The JAX package runs
it under ``shard_map`` over a (tiles × samples) mesh and averages the
gradients over both axes; here it runs on one device, which equals the
JAX step on a 1×1 mesh: tile 0, sample 0, the ray key ``fold(key, 0, 0)``.
"""

from __future__ import annotations

import torch

from ptx_torch.core import rng
from ptx_torch.core.constants import DEFAULT_RAY_DEPTH
from ptx_torch.integrate.camera import Camera, sample_rays
from ptx_torch.integrate.trace import CompiledScene, trace_rays


def _local_render(scene: CompiledScene, cam: Camera, depth: int, spp_local: int,
                  params, key, y0: int, rows: int):
    """``rows`` rows from ``y0`` at ``spp_local`` samples: mean radiance
    (rows, W, 3), the key folded by the mesh indices of a 1×1 mesh, tile 0
    and sample 0 (``ptx/parallel/render.py:32``)."""
    k = rng.fold(key, 0, 0)
    o, d = sample_rays(cam, k, range(y0, y0 + rows), range(cam.width), spp_local,
                       scene.device)
    return trace_rays(scene, params, o, d, k, depth).mean(dim=0)


def _leaves(params):
    """The param tensors in a fixed order (list entries flattened)."""
    out = []
    for k in params:
        v = params[k]
        out += [(k, i, x) for i, x in enumerate(v)] if isinstance(v, list) else [(k, None, v)]
    return out


def make_train_step(scene: CompiledScene, cam: Camera, spp: int = 16,
                    depth: int = DEFAULT_RAY_DEPTH, learning_rate: float = 1e-2):
    """``step(params, target, key) -> (params, loss)``: the loss is the mean
    squared error of the full-frame render against ``target`` (H, W, 3);
    the new params are ``p - learning_rate · dloss/dp`` for every param
    tensor (images included), computed without autograd history."""

    def step(params, target, key):
        leaves = _leaves(params)
        xs = [x.detach().requires_grad_(True) for _, _, x in leaves]
        p = {k: [] for k, v in params.items() if isinstance(v, list)}   # an empty list too
        for (k, i, _), x in zip(leaves, xs):
            if i is None:
                p[k] = x
            else:
                p.setdefault(k, []).append(x)
        img = _local_render(scene, cam, depth, spp, p, key, 0, cam.height)
        loss = torch.mean((img - target) ** 2)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
        new = {k: [] for k in p if isinstance(p[k], list)}
        with torch.no_grad():
            for (k, i, _), x, g in zip(leaves, xs, grads):
                v = x.detach() if g is None else x.detach() - learning_rate * g
                if i is None:
                    new[k] = v
                else:
                    new.setdefault(k, []).append(v)
        return new, loss.detach()

    return step
