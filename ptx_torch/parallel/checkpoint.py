"""Checkpoint / resume for long renders and optimization runs (port of
``ptx/parallel/checkpoint.py``).

The files are the JAX package's, key for key, so a checkpoint written by
either package resumes in the other:

- a render's ``.npz`` holds per-pixel sample sums and counts (``sum``
  float64 (H, W, 3), ``count`` int64 (H, W)); resuming continues at the
  next sample index, and merging shards is addition;
- the adaptive sampler's holds its moments (``s1``, ``s2``, ``count``
  float32) and ``rounds_done``;
- an optimization run's holds the params as ``leaf_<i>`` in the order
  ``jax.tree.flatten`` gives a params dict (keys sorted, list entries in
  order), ``n_leaves``, ``step`` and ``key`` (uint32[2]).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _numpy(x, dtype) -> np.ndarray:
    """A copy of ``x`` (a tensor on any device, or an array) as numpy."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
    return np.array(x, dtype)


class RenderAccumulator:
    """Sample-sum image accumulator with durable save/resume."""

    def __init__(self, height: int, width: int, path: str | None = None):
        self.path = path
        self.sum = np.zeros((height, width, 3), np.float64)
        self.count = np.zeros((height, width), np.int64)
        if path and os.path.exists(path):
            with np.load(path) as z:
                self.sum = z["sum"]
                self.count = z["count"]

    @property
    def samples_done(self) -> int:
        return int(self.count.min())

    def add(self, image, spp: int, y0: int = 0) -> None:
        """Merge a mean image of ``spp`` samples covering rows
        ``y0:y0+image.shape[0]``."""
        img = _numpy(image, np.float64)
        h = img.shape[0]
        self.sum[y0:y0 + h] += img * spp
        self.count[y0:y0 + h] += spp

    def image(self) -> np.ndarray:
        c = np.maximum(self.count, 1)[..., None]
        return (self.sum / c).astype(np.float32)

    def save(self, path: str | None = None) -> None:
        path = path or self.path
        if path is None:
            raise ValueError("no checkpoint path configured")
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, sum=self.sum, count=self.count)
        os.replace(tmp, path)


class AdaptiveCheckpoint:
    """Durable state for the adaptive sampler: per-pixel sample moments
    (Σx, Σx², count) and the completed-round counter.  Resuming re-enters
    :func:`ptx_torch.integrate.adaptive.render_adaptive` through its
    ``state`` argument; the refinement sequence is a function of (state,
    key), so an interrupted and resumed render equals the uninterrupted
    one."""

    def __init__(self, height: int, width: int, path: str | None = None):
        self.path = path
        self.s1 = np.zeros((height, width, 3), np.float32)
        self.s2 = np.zeros((height, width, 3), np.float32)
        self.count = np.zeros((height, width), np.float32)
        self.rounds_done = -1          # -1 = no base pass yet
        if path and os.path.exists(path):
            with np.load(path) as z:
                self.s1 = z["s1"]
                self.s2 = z["s2"]
                self.count = z["count"]
                self.rounds_done = int(z["rounds_done"])

    @property
    def state(self):
        """``state`` tuple for render_adaptive, or None if fresh."""
        if self.rounds_done < 0:
            return None
        return (self.s1, self.s2, self.count, self.rounds_done)

    def update(self, s1, s2, count, rounds_done: int) -> None:
        self.s1 = _numpy(s1, np.float32)
        self.s2 = _numpy(s2, np.float32)
        self.count = _numpy(count, np.float32)
        self.rounds_done = int(rounds_done)
        if self.path:
            tmp = self.path + ".tmp.npz"
            np.savez_compressed(tmp, s1=self.s1, s2=self.s2,
                                count=self.count,
                                rounds_done=self.rounds_done)
            os.replace(tmp, self.path)


def _flatten(params):
    """The param tensors in ``jax.tree.flatten`` order: keys sorted, a
    list's entries in order."""
    out = []
    for k in sorted(params):
        v = params[k]
        out += list(v) if isinstance(v, (list, tuple)) else [v]
    return out


def save_params(path: str, params, step: int, key) -> None:
    """Write ``params`` (the port's dict of tensors), ``step`` and ``key``
    (an :mod:`ptx_torch.core.rng` key) as the JAX package's
    ``save_params`` does."""
    flat = _flatten(params)
    np.savez_compressed(
        path + ".tmp.npz",
        step=step, key=np.asarray(key, np.uint32),
        n_leaves=len(flat),
        **{f"leaf_{i}": _numpy(x, np.float32) for i, x in enumerate(flat)})
    os.replace(path + ".tmp.npz", path)


def load_params(path: str, params_template):
    """``(params, step, key)`` from a file of either package: the leaves
    laid out as ``params_template`` (the port's dict), on its device."""
    with np.load(path) as z:
        n = int(z["n_leaves"])
        leaves = [z[f"leaf_{i}"] for i in range(n)]
        step = int(z["step"])
        key = tuple(int(v) for v in z["key"])
    if n != len(_flatten(params_template)):
        raise ValueError(f"{path}: {n} leaves, the template has "
                         f"{len(_flatten(params_template))}")
    it = iter(leaves)
    out = {}
    for k in sorted(params_template):
        v = params_template[k]
        conv = lambda t: torch.from_numpy(np.array(next(it), np.float32)).to(t.device)
        out[k] = [conv(t) for t in v] if isinstance(v, (list, tuple)) else conv(v)
    return {k: out[k] for k in params_template}, step, key
