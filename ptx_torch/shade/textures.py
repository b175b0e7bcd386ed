"""Texture expression trees compiled to batched lookups.

Port of ``ptx/shade/textures.py``.  Each tree compiles to a closure
``fn(params, pos) -> (..., 3)`` whose numeric leaves (constant colours,
multiply factors, lookup transforms, images) live in the params dict.

Lookup semantics, as in the JAX package and the reference:

- :class:`ImageTex`: wrap via ``x − floor(x)``, y flipped before
  scaling, nearest texel, out-of-bounds reads black
  (image_texture.h:18-28, image.cpp:366-380);
- :class:`Skybox`: 6-face cubemap selected by dominant axis, with the
  reference's face orientations (image_texture.h:90-110); the face folds
  into the row index of one ``(6·H, W, 4)`` gather, so its transpose is
  one histogram;
- :class:`SphericalCoords` / :class:`MirrorBall`: the equirect and
  angular-probe direction → uv maps (transform_texture.h:46-59, 73-85);
- :class:`Multiply` / :class:`Log`: post-filters (filter_texture.h:30-73).

Each compiled closure carries ``.spec``, the chain's structure with its
param indices, as in the JAX package: the fused emission kernel
(:mod:`ptx_torch.ops.emission_kernel`) reads it to decide eligibility.
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
        """Returns ``fn(params, pos) -> (..., 3)`` with its ``.spec``."""
        if isinstance(tex, Constant):
            idx = len(self.params["const"])
            self.params["const"].append(
                np.broadcast_to(np.asarray(tex.color, np.float32), (3,)).copy())
            return _spec(lambda p, pos: p["const"][idx].expand(pos.shape),
                         ("const", idx))

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
            return _spec(image_fn, ("image", img_id, alpha))

        if isinstance(tex, Skybox):
            faces = [tex.top, tex.bottom, tex.left, tex.right, tex.front, tex.back]
            ids = [self._image_id(f) for f in faces]
            if len({self.images[i].shape for i in ids}) != 1:
                raise ValueError("skybox faces must share dimensions")
            alpha = tex.alpha

            def skybox_fn(p, pos):
                stack = torch.stack([p["images"][i] for i in ids])   # (6, H, W, 4)
                return _skybox_lookup(stack, pos, alpha)
            return _spec(skybox_fn, ("skybox", tuple(ids), alpha))

        if isinstance(tex, TransformedTex):
            idx = len(self.params["tex_xform"])
            self.params["tex_xform"].append(
                np.asarray(tex.transform, np.float32).reshape(3, 4))
            child = self.compile(tex.child)
            return _spec(lambda p, pos: child(p, linalg.apply(p["tex_xform"][idx], pos)),
                         ("xform", idx, child.spec))

        if isinstance(tex, MirrorBall):
            child = self.compile(tex.child)
            return _spec(lambda p, pos: child(p, _mirror_ball_uv(pos)),
                         ("mirror", child.spec))

        if isinstance(tex, SphericalCoords):
            child = self.compile(tex.child)
            return _spec(lambda p, pos: child(p, _spherical_uv(pos)),
                         ("spherical", child.spec))

        if isinstance(tex, Multiply):
            idx = len(self.params["factor"])
            self.params["factor"].append(
                np.broadcast_to(np.asarray(tex.factor, np.float32), (3,)).copy())
            child = self.compile(tex.child)
            return _spec(lambda p, pos: child(p, pos) * p["factor"][idx],
                         ("mul", idx, child.spec))

        if isinstance(tex, Log):
            child = self.compile(tex.child)

            def log_fn(p, pos):
                v = child(p, pos)
                return torch.where(v <= 1e-30, 0.0,
                                   0.5 + torch.log2(torch.clamp(v, min=1e-30)) / 256.0)
            return _spec(log_fn, ("log", child.spec))

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


def _spec(fn, spec):
    fn.spec = spec
    return fn


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


def _skybox_face_uv(v):
    """Dominant-axis face index and the reference's per-face (u, w)
    (image_texture.h:90-110).  Faces: 0 top, 1 bottom, 2 left, 3 right,
    4 front, 5 back."""
    x, y, z = v.unbind(-1)
    ax, ay, az = x.abs(), y.abs(), z.abs()
    x_dom = (ax > ay) & (ax > az)
    y_dom = ~x_dom & (ay > az)
    safe = lambda a: torch.where(a == 0, 1.0, a)
    face = torch.where(x_dom, torch.where(x < 0, 2, 3),
                       torch.where(y_dom, torch.where(y < 0, 1, 0),
                                   torch.where(z < 0, 5, 4)))
    u = torch.where(x_dom, torch.where(x < 0, -z, z) / safe(ax),
                    torch.where(y_dom, torch.where(y < 0, -x, x) / safe(ay),
                                torch.where(z < 0, x, -x) / safe(az)))
    w = torch.where(x_dom, y / safe(ax), torch.where(y_dom, z / safe(ay), y / safe(az)))
    return face, u, w


def _skybox_lookup(stack, v, alpha: bool):
    """Cubemap lookup on the (6, H, W, 4) face stack: the face index folds
    into the row index of one (6·H, W, 4) gather, so the six faces share
    one histogram in the backward."""
    from ptx_torch.ops.imagegrad import image_gather

    zero_dir = (v == 0.0).all(dim=-1)
    face, u, w = _skybox_face_uv(v)
    h, wid = stack.shape[1], stack.shape[2]
    xi = torch.floor((u * 0.5 + 0.5) * wid).to(torch.int64)
    yi = torch.floor((0.5 - w * 0.5) * h).to(torch.int64)
    inb = (xi >= 0) & (xi < wid) & (yi >= 0) & (yi < h)
    flat = stack.reshape(6 * h, wid, stack.shape[3])
    texel = image_gather(flat, xi.clamp(0, wid - 1), face * h + yi.clamp(0, h - 1),
                         inb & ~zero_dir)
    val = texel[..., 3:4] if alpha else texel[..., :3]
    return val.expand(val.shape[:-1] + (3,))


def _mirror_ball_uv(v):
    """Angular mirror-ball probe mapping (transform_texture.h:46-59)."""
    zero = (v == 0.0).all(dim=-1)
    n = linalg.normalize(v)
    z = n[..., 2]
    d = torch.sqrt(torch.clamp(2.0 + 2.0 * z, min=0.0))
    bad = (z <= -1.0) | (d == 0.0)
    safe_d = torch.where(bad, 1.0, d)
    u = torch.where(bad, 0.0, n[..., 0] / safe_d * 0.5 + 0.5)
    w = torch.where(bad, 0.5, n[..., 1] / safe_d * 0.5 + 0.5)
    u = torch.where(zero, 0.0, u)
    w = torch.where(zero, 0.0, w)
    return torch.stack([u, w, torch.zeros_like(u)], dim=-1)


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
