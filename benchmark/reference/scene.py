"""The reference's reading of a configuration's scene document.

It parses the same JSON the port's spec reader gets, on its own: spheres,
planes (``normal`` and ``d``), unions, intersections and differences;
materials with constant slots, and on a terminal material (reflect and
transmit zero) an emissive chain of ``transformed`` (``matrix``),
``multiply``, ``spherical`` and ``image`` nodes.  Anything else raises:
the reference covers what the configurations use.

The semantics it fixes, as the reference renderer defines them
(``programmerjake/path-trace``):

- leaves in reversed depth-first order: where two boundaries fall at the
  same distance, the first leaf in that order is the one hit (the
  reference's union merge);
- a material id per distinct material name, in first-seen depth-first
  order;
- one constant row (a colour) per constant slot, scalars broadcast to
  three channels; a slot's scalar value is the channel mean.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from benchmark import hdr

SLOTS = ("reflect", "scatter", "emissive", "transmit", "transmit_reflect")
DEFAULTS = {"reflect": 1.0, "scatter": 1.0, "emissive": 0.0, "transmit": 0.0,
            "transmit_reflect": 0.0, "ior": 1.0}     # the reference's material.h


@dataclasses.dataclass
class Leaf:
    kind: str                   # "sphere" | "plane"
    index: int                  # row of its kind's table
    mat: int
    parity: float               # -1 under the B side of an odd number of differences


@dataclasses.dataclass
class RefScene:
    leaves: list                # reversed depth-first order
    tree: tuple                 # ("leaf", position) | (op, children)
    flat_union: bool            # a union of leaves only
    n_materials: int
    slot_row: dict              # slot -> (M,) row of const, the zero row where dynamic
    terminal_chains: list       # (material, chain) of terminal dynamic emissive slots
    tables: dict                # float32 numpy tables (see params)
    images: list                # float32 (H, W, 4) arrays
    width: int
    height: int


def _vec3(v):
    return np.broadcast_to(np.asarray(v, np.float32), (3,)).copy()


class _Parser:
    def __init__(self, base_dir):
        self.base_dir = base_dir
        self.centers, self.radii, self.normals, self.ds = [], [], [], []
        self.mat_ids, self.mat_order = {}, []
        self.factors, self.xforms, self.images = [], [], []

    def material(self, name):
        if name not in self.mat_ids:
            self.mat_ids[name] = len(self.mat_order)
            self.mat_order.append(name)
        return self.mat_ids[name]

    def node(self, spec, leaves):
        t = spec["type"]
        if t == "sphere":
            self.centers.append(_vec3(spec["center"]))
            self.radii.append(np.float32(spec["radius"]))
            leaves.append(("sphere", len(self.radii) - 1, self.material(spec["material"])))
            return ("leaf", len(leaves) - 1)
        if t == "plane":
            if "d" not in spec:
                raise NotImplementedError("the reference reads planes by normal and d")
            self.normals.append(_vec3(spec["normal"]))
            self.ds.append(np.float32(spec["d"]))
            leaves.append(("plane", len(self.ds) - 1, self.material(spec["material"])))
            return ("leaf", len(leaves) - 1)
        if t in ("union", "intersection"):
            kids = [self.node(o, leaves) for o in spec["objects"]]
            if t == "union":        # nested unions are one n-ary union
                kids = [g for k in kids for g in (k[1] if k[0] == "union" else [k])]
            return (t, kids)
        if t == "difference":
            return ("difference", [self.node(spec["a"], leaves), self.node(spec["b"], leaves)])
        raise NotImplementedError(f"the reference has no object type {t!r}")

    def chain(self, spec):
        if isinstance(spec, (int, float, list)):
            raise NotImplementedError("a constant inside an emissive chain")
        t = spec["type"]
        if t == "transformed":
            if set(spec["transform"]) != {"matrix"}:
                raise NotImplementedError("the reference reads transforms as a matrix")
            self.xforms.append(np.asarray(spec["transform"]["matrix"], np.float32).reshape(3, 4))
            return ("xform", len(self.xforms) - 1, self.chain(spec["child"]))
        if t == "multiply":
            self.factors.append(_vec3(spec["factor"]))
            return ("mul", len(self.factors) - 1, self.chain(spec["child"]))
        if t == "spherical":
            return ("spherical", self.chain(spec["child"]))
        if t == "image":
            path = os.path.join(self.base_dir, spec["file"])
            self.images.append(hdr.read_flat(path))
            return ("image", len(self.images) - 1)
        raise NotImplementedError(f"the reference has no texture type {t!r}")


def _parities(tree, parity, out):
    if tree[0] == "leaf":
        out[tree[1]] = parity
    elif tree[0] == "difference":
        _parities(tree[1][0], parity, out)
        _parities(tree[1][1], -parity, out)
    else:
        for k in tree[1]:
            _parities(k, parity, out)


def _renumber(tree, pos):
    if tree[0] == "leaf":
        return ("leaf", pos[tree[1]])
    return (tree[0], [_renumber(k, pos) for k in tree[1]])


def parse(doc: dict, base_dir: str) -> RefScene:
    """A scene document (``materials``, ``world``, ``camera``) → RefScene;
    image files are read relative to ``base_dir``."""
    p = _Parser(base_dir)
    dfs = []
    tree = p.node(doc["world"], dfs)
    par = {}
    _parities(tree, 1.0, par)
    n = len(dfs)
    order = list(range(n))[::-1]             # reversed depth-first
    pos = {old: new for new, old in enumerate(order)}
    leaves = [Leaf(dfs[i][0], dfs[i][1], dfs[i][2], par[i]) for i in order]
    tree = _renumber(tree, pos)
    flat = tree[0] == "union" and all(k[0] == "leaf" for k in tree[1])

    M = len(p.mat_order)
    const, iors, chains = [], [], []
    slot_row = {s: np.zeros(M, np.int64) for s in SLOTS}
    dynamic = []
    for mi, name in enumerate(p.mat_order):
        m = dict(DEFAULTS, **doc["materials"][name])
        iors.append(np.float32(m["ior"]))
        for s in SLOTS:
            if not isinstance(m[s], dict):
                slot_row[s][mi] = len(const)
                const.append(_vec3(m[s]))
            elif s == "emissive" and not any(
                    isinstance(m[k], dict) or np.any(_vec3(m[k])) for k in ("reflect", "transmit")):
                dynamic.append((mi, m[s]))
            else:
                raise NotImplementedError("the reference evaluates textures only as the "
                                          "emission of a terminal material")
    if dynamic:                 # their constant rows read zero
        for mi, _ in dynamic:
            slot_row["emissive"][mi] = len(const)
        const.append(np.zeros(3, np.float32))
        chains = [(mi, p.chain(v)) for mi, v in dynamic]

    def table(rows, shape):
        return np.array(rows, np.float32).reshape(shape)

    tables = {"sphere_center": table(p.centers, (-1, 3)),
              "sphere_radius": table(p.radii, (-1,)),
              "plane_normal": table(p.normals, (-1, 3)),
              "plane_d": table(p.ds, (-1,)),
              "const": table(const, (-1, 3)),
              "ior": table(iors, (-1,)),
              "factor": table(p.factors, (-1, 3)),
              "tex_xform": table(p.xforms, (-1, 3, 4))}
    cam = doc.get("camera", {})
    if not cam.get("reference_demo"):
        raise NotImplementedError("the reference reads the reference_demo camera")
    return RefScene(leaves=leaves, tree=tree, flat_union=flat, n_materials=M,
                    slot_row=slot_row, terminal_chains=chains, tables=tables,
                    images=p.images, width=int(cam["width"]), height=int(cam["height"]))


def params(scene: RefScene, device, dtype=torch.float32) -> dict:
    """The scene's parameters as tensors: the geometry tables, ``const``
    (one row per constant slot), ``ior``, the chains' ``factor`` and
    ``tex_xform``, and ``images`` (a list)."""
    out = {k: torch.from_numpy(v).to(device=device, dtype=dtype)
           for k, v in scene.tables.items()}
    out["images"] = [torch.from_numpy(im).to(device=device, dtype=dtype)
                     for im in scene.images]
    return out
