"""Scene geometry tree → compiled parameter tables + static plan.

Port of ``ptx/geom/tape.py``.  Leaf parameters land in float32 tensors
with the JAX package's keys and layout; the CSG structure becomes a
static plan, with nested unions collapsed into one n-ary node.

``Transformed(obj, A)`` is the object mapped by ``x → A x``: rays are
pulled into object space with ``A⁻¹`` and normals pushed back with
``A⁻ᵀ`` (see the JAX module's docstring for why this differs from the
reference's convention).

The span-merge evaluator (``eval_fn`` and ``ptx/geom/spans.py``) is not
ported: the port's first hit is :mod:`ptx_torch.geom.fasthit`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


# ---------------------------------------------------------------------------
# user-facing geometry tree
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sphere:
    center: Any                 # (3,)
    radius: Any                 # scalar
    material: Any               # Material (see ptx_torch.shade.materials)


@dataclasses.dataclass(frozen=True)
class Plane:
    """Half-space ``normal·x + d <= 0``.  ``from_point`` mirrors the
    reference's point constructor ``d = −normal·pos`` (plane.cpp:11-13)."""
    normal: Any                 # (3,)
    d: Any                      # scalar
    material: Any

    @staticmethod
    def from_point(normal, point, material) -> "Plane":
        n = np.asarray(normal, np.float32)
        p = np.asarray(point, np.float32)
        return Plane(normal=n, d=float(-np.dot(n, p)), material=material)


@dataclasses.dataclass(frozen=True)
class Union:
    objects: tuple

    def __init__(self, *objects):
        object.__setattr__(self, "objects", tuple(objects))


@dataclasses.dataclass(frozen=True)
class Intersection:
    objects: tuple

    def __init__(self, *objects):
        object.__setattr__(self, "objects", tuple(objects))


@dataclasses.dataclass(frozen=True)
class Difference:
    a: Any
    b: Any


@dataclasses.dataclass(frozen=True)
class Transformed:
    obj: Any
    transform: Any              # (3, 4) affine


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _LeafPlan:
    kind: str                   # "sphere" | "plane"
    index: int
    mat_id: int
    xform_chain: tuple          # indices into params["xform"], outermost first


@dataclasses.dataclass
class _OpPlan:
    op: str                     # "union" | "intersection" | "difference"
    children: tuple


def compile_geometry(root, material_ids: dict, device):
    """Flatten the tree.  Returns ``(params, plan)``: ``params`` holds the
    geometry tables (``sphere_center`` (S, 3), ``sphere_radius`` (S,),
    ``plane_normal`` (P, 3), ``plane_d`` (P,), ``xform`` (X, 3, 4)) on
    ``device``; ``plan`` is the static tree of ``_LeafPlan`` /
    ``_OpPlan`` nodes.  ``material_ids`` maps ``id(material)`` to its
    table index (:func:`ptx_torch.shade.materials.assign_material_ids`)."""
    centers, radii, normals, ds, xforms = [], [], [], [], []

    def walk(node, chain):
        if isinstance(node, Transformed):
            xforms.append(np.asarray(node.transform, np.float32).reshape(3, 4))
            return walk(node.obj, chain + (len(xforms) - 1,))
        if isinstance(node, Sphere):
            centers.append(np.asarray(node.center, np.float32).reshape(3))
            radii.append(np.float32(node.radius))
            return _LeafPlan("sphere", len(radii) - 1,
                             material_ids[id(node.material)], chain)
        if isinstance(node, Plane):
            normals.append(np.asarray(node.normal, np.float32).reshape(3))
            ds.append(np.float32(node.d))
            return _LeafPlan("plane", len(ds) - 1,
                             material_ids[id(node.material)], chain)
        if isinstance(node, Union):
            kids = []

            # collapse nested unions into one n-ary node
            def gather(u):
                for c in u.objects:
                    if isinstance(c, Union):
                        gather(c)
                    else:
                        kids.append(walk(c, chain))
            gather(node)
            return _OpPlan("union", tuple(kids))
        if isinstance(node, Intersection):
            return _OpPlan("intersection",
                           tuple(walk(c, chain) for c in node.objects))
        if isinstance(node, Difference):
            return _OpPlan("difference",
                           (walk(node.a, chain), walk(node.b, chain)))
        raise TypeError(f"unknown scene node {type(node)!r}")

    plan = walk(root, ())

    def table(rows, shape):
        arr = np.array(rows, np.float32).reshape(shape)
        return torch.from_numpy(arr).to(device)

    params = {
        "sphere_center": table(centers, (-1, 3)),
        "sphere_radius": table(radii, (-1,)),
        "plane_normal": table(normals, (-1, 3)),
        "plane_d": table(ds, (-1,)),
        "xform": table(xforms, (-1, 3, 4)),
    }
    return params, plan
