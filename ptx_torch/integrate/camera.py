"""Pinhole camera / pixel-ray generation (port of ``ptx/integrate/camera.py``).

The reference ``tracePixel`` mapping (path-trace.h:172-201): the camera
sits at the origin looking down −z at a screen of world size
``(screen_width, screen_height)`` at ``screen_distance``; pixel
``(px, py)`` maps to ``x = 2(px+jx)/W − 1``, ``y = 1 − 2(py+jy)/H`` with
per-sample in-pixel jitter.  An optional pose affine re-seats the camera.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ptx_torch.core import linalg, rng
from ptx_torch.core.constants import (DEFAULT_SCREEN_DISTANCE,
                                      DEFAULT_SCREEN_HEIGHT,
                                      DEFAULT_SCREEN_WIDTH)


@dataclasses.dataclass(frozen=True)
class Camera:
    width: int
    height: int
    screen_width: float = DEFAULT_SCREEN_WIDTH
    screen_height: float = DEFAULT_SCREEN_HEIGHT
    screen_distance: float = DEFAULT_SCREEN_DISTANCE
    pose: Any = None            # optional (3, 4) camera-to-world affine

    @staticmethod
    def reference_demo(width: int, height: int) -> "Camera":
        """The demo driver's parameterization (test.cpp:450): screen size =
        pixel dimensions, distance = 2·min(W, H)."""
        return Camera(width, height, float(width), float(height),
                      2.0 * min(width, height))


def pixel_rays(cam: Camera, px, py, jitter=None):
    """Rays for float32 pixel coordinates ``px, py`` (matching shapes);
    ``jitter`` (..., 2) in [0, 1) is added to them."""
    if jitter is not None:
        px = px + jitter[..., 0]
        py = py + jitter[..., 1]
    x = 2.0 * px / cam.width - 1.0
    y = 1.0 - 2.0 * py / cam.height
    direction = torch.stack([
        x * cam.screen_width,
        y * cam.screen_height,
        torch.full_like(x, -cam.screen_distance),
    ], dim=-1)
    origin = torch.zeros_like(direction)
    if cam.pose is not None:
        pose = torch.tensor(np.asarray(cam.pose, np.float32),
                            device=direction.device)
        origin, direction = linalg.transform_ray(pose, origin, direction)
    return origin, direction


def sample_rays(cam: Camera, key, ys, xs, spp: int, device):
    """Jittered rays for the pixel grid ``ys × xs`` (sequences of ints):
    ``(origin, dir)`` of shape ``(spp, len(ys), len(xs), 3)``.  The jitter
    is ``uniform(key, (spp, rows, cols, 2))`` as in the JAX package."""
    ys = torch.as_tensor(ys, dtype=torch.float32, device=device)
    xs = torch.as_tensor(xs, dtype=torch.float32, device=device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    shape = (spp,) + tuple(py.shape)
    jitter = rng.uniform(key, shape + (2,), device)
    return pixel_rays(cam, px.expand(shape), py.expand(shape), jitter)
