"""Conversion of the JAX package's scenes and params into the port's.

Nothing here imports the JAX package: scene nodes are recognised by
class name and field, so the port reads a tree built by ``ptx.scenes``
without pulling in jax.
"""

from __future__ import annotations

import numpy as np
import torch

from ptx_torch.geom import tape
from ptx_torch.shade import materials, textures

_NODES = {"Sphere": tape.Sphere, "Plane": tape.Plane,
          "Transformed": tape.Transformed, "Difference": tape.Difference}
_TEXTURES = {c.__name__: c for c in (
    textures.Constant, textures.ImageTex, textures.Skybox,
    textures.TransformedTex, textures.MirrorBall, textures.SphericalCoords,
    textures.Multiply, textures.Log)}


def scene_from_jax(root):
    """The port's scene tree equal to a ``ptx.geom.tape`` tree.  Shared
    materials and images stay shared (material ids and image slots are
    assigned by identity)."""
    seen = {}

    def value(v):
        kind = type(v).__name__
        if kind in _NODES or kind in _TEXTURES or kind in (
                "Union", "Intersection", "Material"):
            return convert(v)
        if not hasattr(v, "__array__"):
            return v
        if id(v) not in seen:             # an image shared by skybox faces
            seen[id(v)] = np.asarray(v)
        return seen[id(v)]

    def convert(obj):
        if id(obj) in seen:
            return seen[id(obj)]
        kind = type(obj).__name__
        if kind in ("Union", "Intersection"):
            out = getattr(tape, kind)(*(convert(c) for c in obj.objects))
        elif kind == "Material":
            out = materials.Material(**{f: value(getattr(obj, f)) for f in (
                *materials.SLOTS, "ior")})
        else:
            cls = _NODES.get(kind) or _TEXTURES[kind]
            out = cls(**{f.name: value(getattr(obj, f.name))
                         for f in cls.__dataclass_fields__.values()})
        seen[id(obj)] = out
        return out

    return convert(root)


def params_from_jax(np_params: dict, device) -> dict:
    """The port's params from the JAX package's ``scene.params`` taken
    leaf by leaf with ``np.asarray`` (``images`` is a list of arrays):
    float32 tensors with the same keys and layout, on ``device``."""
    def conv(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    return {k: ([conv(x) for x in v] if isinstance(v, (list, tuple)) else conv(v))
            for k, v in np_params.items()}


def grads_to_numpy(params: dict) -> dict:
    """The ``.grad`` of each param tensor as float32 numpy, in the JAX
    pytree's layout (``images`` a list); zeros where no gradient reached
    a tensor, as ``jax.grad`` gives them."""
    def conv(x):
        g = x.grad if x.grad is not None else torch.zeros_like(x)
        return g.detach().cpu().numpy().astype(np.float32)
    return {k: ([conv(x) for x in v] if isinstance(v, (list, tuple)) else conv(v))
            for k, v in params.items()}
