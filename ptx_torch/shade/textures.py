"""Texture expression trees compiled to batched lookups.

Port of ``ptx/shade/textures.py``.  Each tree compiles to a closure
``fn(params, pos) -> (..., 3)`` whose numeric leaves (constant colours,
multiply factors, lookup transforms, images) live in the params dict.

Lookup semantics, as in the JAX package and the reference:

- :class:`ImageTex`: wrap via ``x − floor(x)``, y flipped before
  scaling, nearest texel, out-of-bounds reads black
  (image_texture.h:18-28, image.cpp:366-380);
- :class:`SphericalCoords`: the equirect direction → uv map
  (transform_texture.h:73-85);
- :class:`Multiply`: per-channel factor (filter_texture.h:30-73).

``Skybox``, ``MirrorBall`` and ``Log`` can be described but do not
compile yet (ROADMAP Queue 1 #3): the demo's sky chain does not use
them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ptx_torch.core import linalg


# ---------------------------------------------------------------------------
# expression tree
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Constant:
    color: Any                  # scalar or (3,)


@dataclasses.dataclass(frozen=True)
class ImageTex:
    image: Any                  # (H, W, 4) float32 RGBA
    alpha: bool = False         # ImageAlphaTexture (image_texture.h:35-70)


@dataclasses.dataclass(frozen=True)
class Skybox:
    top: Any; bottom: Any; left: Any; right: Any; front: Any; back: Any
    alpha: bool = False


@dataclasses.dataclass(frozen=True)
class TransformedTex:
    """Looks up the child at ``A · pos`` (texture.h:60-90)."""
    transform: Any              # (3, 4)
    child: Any


@dataclasses.dataclass(frozen=True)
class MirrorBall:
    child: Any


@dataclasses.dataclass(frozen=True)
class SphericalCoords:
    child: Any


@dataclasses.dataclass(frozen=True)
class Multiply:
    factor: Any                 # scalar or (3,)
    child: Any


@dataclasses.dataclass(frozen=True)
class Log:
    child: Any


def transform_texture(A, tex):
    """The reference's ``transform(m, Texture*)`` (texture.h:92-98):
    constants are transform-invariant; an existing ``TransformedTex``
    chains with the argument applied first (texture.h:86-89)."""
    if isinstance(tex, Constant):
        return tex
    if isinstance(tex, TransformedTex):
        outer = torch.as_tensor(np.asarray(tex.transform, np.float32))
        inner = torch.as_tensor(np.asarray(A, np.float32))
        return TransformedTex(linalg.compose(outer, inner).numpy(), tex.child)
    return TransformedTex(A, tex)


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------

class TextureCompiler:
    """Assigns param slots for texture leaves; one instance per scene."""

    def __init__(self):
        self.params: dict = {"const": [], "factor": [], "tex_xform": []}
        self.images: list = []           # list of (H, W, 4) arrays
        self._image_ids: dict = {}       # id(array) -> index

    def _image_id(self, img) -> int:
        key = id(img)
        if key not in self._image_ids:
            arr = np.asarray(img, np.float32)
            if arr.ndim == 2:
                arr = arr[..., None].repeat(4, axis=-1)
            if arr.shape[-1] == 3:
                arr = np.concatenate([arr, np.ones_like(arr[..., :1])], axis=-1)
            self._image_ids[key] = len(self.images)
            self.images.append(arr)
        return self._image_ids[key]

    def compile(self, tex):
        """Returns ``fn(params, pos) -> (..., 3)``."""
        if isinstance(tex, Constant):
            idx = len(self.params["const"])
            self.params["const"].append(
                np.broadcast_to(np.asarray(tex.color, np.float32), (3,)).copy())
            return lambda p, pos: p["const"][idx].expand(pos.shape)

        if isinstance(tex, ImageTex):
            img_id = self._image_id(tex.image)
            alpha = tex.alpha

            def image_fn(p, pos):
                img = p["images"][img_id]
                h, w = img.shape[0], img.shape[1]
                x = pos[..., 0] - torch.floor(pos[..., 0])
                y = 1.0 - (pos[..., 1] - torch.floor(pos[..., 1]))
                xi = torch.floor(x * w).to(torch.int64)
                yi = torch.floor(y * h).to(torch.int64)
                return _get_pixel(img, xi, yi, alpha)
            return image_fn

        if isinstance(tex, TransformedTex):
            idx = len(self.params["tex_xform"])
            self.params["tex_xform"].append(
                np.asarray(tex.transform, np.float32).reshape(3, 4))
            child = self.compile(tex.child)
            return lambda p, pos: child(p, linalg.apply(p["tex_xform"][idx], pos))

        if isinstance(tex, SphericalCoords):
            child = self.compile(tex.child)
            return lambda p, pos: child(p, _spherical_uv(pos))

        if isinstance(tex, Multiply):
            idx = len(self.params["factor"])
            self.params["factor"].append(
                np.broadcast_to(np.asarray(tex.factor, np.float32), (3,)).copy())
            child = self.compile(tex.child)
            return lambda p, pos: child(p, pos) * p["factor"][idx]

        if isinstance(tex, (Skybox, MirrorBall, Log)):
            raise NotImplementedError(
                f"{type(tex).__name__} textures are not ported yet "
                "(ROADMAP Queue 1 #3)")
        raise TypeError(f"unknown texture node {type(tex)!r}")

    def finalize(self, device) -> dict:
        """The params-dict contribution, on ``device``."""
        def table(rows, shape):
            return torch.from_numpy(
                np.array(rows, np.float32).reshape(shape)).to(device)
        return {
            "const": table(self.params["const"], (-1, 3)),
            "factor": table(self.params["factor"], (-1, 3)),
            "tex_xform": table(self.params["tex_xform"], (-1, 3, 4)),
            "images": [torch.from_numpy(img).to(device) for img in self.images],
        }


# ---------------------------------------------------------------------------
# lookups
# ---------------------------------------------------------------------------

def _get_pixel(img, xi, yi, alpha: bool):
    """Bounds-checked nearest lookup; outside → black / alpha 0
    (image.cpp:366-396).  Returns (..., 3); alpha broadcast to grey.  The
    gather is :func:`ptx_torch.ops.imagegrad.image_gather`, whose backward
    is the histogram kernel K3 on the card."""
    from ptx_torch.ops.imagegrad import image_gather

    h, w = img.shape[0], img.shape[1]
    inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    texel = image_gather(img, xi.clamp(0, w - 1), yi.clamp(0, h - 1), inb)
    val = texel[..., 3:4] if alpha else texel[..., :3]
    return val.expand(val.shape[:-1] + (3,))


def _spherical_uv(v):
    """Equirect lat-long mapping (transform_texture.h:73-85)."""
    zero = (v == 0.0).all(dim=-1)
    n = linalg.normalize(v)
    theta = torch.atan2(n[..., 1], n[..., 0])
    phi = torch.asin(torch.clamp(n[..., 2], -1.0, 1.0))
    u = theta * 0.5 / math.pi + 0.5
    w = phi / (math.pi / 2.0) * 0.5 + 0.5
    u = torch.where(zero, 0.0, u)
    w = torch.where(zero, 0.0, w)
    return torch.stack([u, w, torch.zeros_like(u)], dim=-1)
