"""The reference's textured surface slots: an image texture on a
non-emissive slot of a material, looked up at the hit point.

The semantics, as the reference renderer defines them
(``programmerjake/path-trace``):

- ``include/texture.h:60-90``: a ``transformed`` node looks its child up
  at ``A · pos``;
- ``include/image_texture.h:18-28``: an ``image`` node wraps ``u`` and
  ``v`` into [0, 1) by ``x − floor(x)``, flips ``v``, and reads the
  nearest texel, black outside the image (``image.cpp:366-380``);
- ``include/texture.h:13-18``: a slot read as a scalar (``scatter``,
  ``transmit_reflect``) reads the channel mean of its colour.

Departures from that description:

- the lookup runs in float32 (or the control's precision), with the port's
  plain arithmetic at commit 79562cc copied in operation order
  (``ptx_torch/shade/textures.py``, ``ptx_torch/core/linalg.apply``):
  :func:`benchmark.reference.tracer.eval_chain`'s;
- a surface slot takes ``transformed`` and ``image`` nodes only (what
  config 4 uses), and the image's colour, not its alpha; any other texture
  on a non-emissive slot raises, as does an emissive texture on a
  material that is not terminal;
- the gradient: the renderer has none.  The texel read is piecewise
  constant in the hit point, so autograd carries the slot's cotangent into
  the image texels alone; the transform and the point get none through
  it;
- the tables are laid out as the port compiles them
  (``MaterialTable``): a material's slots in turn, one constant row each,
  one zero row at the first textured slot shared by every textured slot,
  and each chain's transforms, factors and images numbered where its slot
  comes, an image file once however many nodes name it.  The check maps
  the program's tables into the reference's by name, so the rows must
  fall alike.

:func:`install` puts :func:`parse` and :func:`bounce` in place of
``benchmark.reference.scene.parse`` and ``benchmark.reference.tracer.
bounce``.  Both hand a scene without a textured surface slot to the
functions they replace, so every other configuration reads what it read
before, bit for bit.  The surface image's formula
(``benchmark/images/checker.py``) calls it when a run loads it.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from benchmark import hdr
from benchmark.reference import scene as rscene
from benchmark.reference import tracer

_PARSE, _BOUNCE = rscene.parse, tracer.bounce
SURFACE_SLOTS = tuple(s for s in rscene.SLOTS if s != "emissive")


@dataclasses.dataclass
class TexturedScene(rscene.RefScene):
    surface_chains: list = dataclasses.field(default_factory=list)  # (material, slot, chain)


class _Parser(rscene._Parser):
    """The scene parser, reading each image file once."""

    def __init__(self, base_dir):
        super().__init__(base_dir)
        self.files = {}

    def chain(self, spec):
        if isinstance(spec, dict) and spec.get("type") == "image":
            f = spec["file"]
            if f not in self.files:
                self.files[f] = len(self.images)
                self.images.append(hdr.read_flat(os.path.join(self.base_dir, f)))
            return ("image", self.files[f])
        return super().chain(spec)

    def surface_chain(self, spec):
        node = spec
        while isinstance(node, dict) and node.get("type") == "transformed":
            node = node.get("child")
        if not (isinstance(node, dict) and node.get("type") == "image"
                and not node.get("alpha", False)):
            raise NotImplementedError("the reference evaluates a surface slot's texture "
                                      "only as transformed nodes over an image's colour")
        return self.chain(spec)


def textured_surfaces(doc: dict) -> bool:
    """Whether a material of the document has a texture on a non-emissive
    slot."""
    return any(isinstance(m.get(s), dict) for m in doc["materials"].values()
               for s in SURFACE_SLOTS)


def parse(doc: dict, base_dir: str) -> rscene.RefScene:
    """:func:`benchmark.reference.scene.parse`, and a
    :class:`TexturedScene` where a surface slot is textured."""
    if not textured_surfaces(doc):
        return _PARSE(doc, base_dir)
    p = _Parser(base_dir)
    dfs = []
    tree = p.node(doc["world"], dfs)
    par = {}
    rscene._parities(tree, 1.0, par)
    order = list(range(len(dfs)))[::-1]                 # reversed depth-first
    pos = {old: new for new, old in enumerate(order)}
    leaves = [rscene.Leaf(dfs[i][0], dfs[i][1], dfs[i][2], par[i]) for i in order]
    tree = rscene._renumber(tree, pos)
    flat = tree[0] == "union" and all(k[0] == "leaf" for k in tree[1])

    M = len(p.mat_order)
    const, iors, terminal, surface = [], [], [], []
    slot_row = {s: np.zeros(M, np.int64) for s in rscene.SLOTS}
    zero = None
    for mi, name in enumerate(p.mat_order):
        m = dict(rscene.DEFAULTS, **doc["materials"][name])
        iors.append(np.float32(m["ior"]))
        for s in rscene.SLOTS:
            if not isinstance(m[s], dict):
                slot_row[s][mi] = len(const)
                const.append(rscene._vec3(m[s]))
                continue
            if zero is None:
                zero = len(const)
                const.append(np.zeros(3, np.float32))
            slot_row[s][mi] = zero
            if s != "emissive":
                surface.append((mi, s, p.surface_chain(m[s])))
            elif any(isinstance(m[k], dict) or np.any(rscene._vec3(m[k]))
                     for k in ("reflect", "transmit")):
                raise NotImplementedError("the reference evaluates an emissive texture only "
                                          "on a terminal material")
            else:
                terminal.append((mi, p.chain(m[s])))

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
    return TexturedScene(leaves=leaves, tree=tree, flat_union=flat, n_materials=M,
                         slot_row=slot_row, terminal_chains=terminal, tables=tables,
                         images=p.images, width=int(cam["width"]),
                         height=int(cam["height"]), surface_chains=surface)


def material_at(scene: TexturedScene, P, mat_id, pos):
    """:func:`benchmark.reference.tracer.material` with each textured slot
    read at ``pos`` on its material's lanes, and the scalar slots' means
    taken after."""
    m = tracer.material(scene, P, mat_id)
    for mi, s, chain in scene.surface_chains:
        m[s] = torch.where((mat_id == mi)[:, None], tracer.eval_chain(chain, P, pos), m[s])
    m["scatter_f"] = tracer.mean3(m["scatter"])
    m["transmit_reflect_f"] = tracer.mean3(m["transmit_reflect"])
    return m


def bounce(scene, lv, P, o, d, thr, strength, alive, in_depth, u_coin, u3):
    """:func:`benchmark.reference.tracer.bounce`, its material read by
    :func:`material_at` where the scene has textured surface slots."""
    if not getattr(scene, "surface_chains", None):
        return _BOUNCE(scene, lv, P, o, d, thr, strength, alive, in_depth, u_coin, u3)
    EPS = tracer.EPS
    t, normal, mat_id, entering, hit = tracer.first_hit(scene, lv, P, o, d)
    pos = o + t[:, None] * d
    m = material_at(scene, P, mat_id, pos)
    cont = alive & hit & in_depth & (strength >= EPS)
    rel_ior = torch.where(entering, 1.0 / m["ior"], m["ior"])
    trc = tracer.clip01(m["transmit_reflect_f"])
    refract_factor = trc * tracer.refract_strength(d, rel_ior, normal)
    refr_dir = tracer.refract(d, rel_ior, normal)
    refr_ok = (refract_factor > EPS) & (refr_dir != 0.0).any(dim=-1)
    p_transmit = torch.where(refr_ok, refract_factor, 0.0)
    take_transmit = (u_coin < p_transmit) & cont
    add_factor = 1.0 - p_transmit
    scatter_alive = cont & ~take_transmit & (add_factor >= EPS)
    scat_dir, scat_ok = tracer.sample_scatter_dir(d, normal, m["scatter_f"], u3)
    sc = tracer.clip01(m["scatter_f"])
    factor = 1.0 - (1.0 - tracer.dot(scat_dir, normal)) * sc
    scatter_alive = scatter_alive & scat_ok
    new_alive = take_transmit | scatter_alive
    tt = take_transmit[:, None]
    new_dir = torch.where(tt, refr_dir, scat_dir)
    tint = torch.where(tt, m["transmit"], factor[:, None] * m["reflect"])
    new_thr = thr * tint
    vcount = torch.floor(10000.0 * strength * add_factor * sc)
    fanout = torch.where((sc <= EPS) | (vcount < 1.0), 1.0, vcount)
    tr_strength = strength * refract_factor * tracer.vnorm(m["transmit"])
    sc_strength = strength / fanout * add_factor * factor * tracer.vnorm(m["reflect"])
    new_strength = torch.where(take_transmit, tr_strength, sc_strength).detach()
    na = new_alive[:, None]
    carry = (torch.where(na, pos, o), torch.where(na, new_dir, d),
             torch.where(na, new_thr, thr), torch.where(new_alive, new_strength, strength),
             new_alive)
    return carry, (pos.detach(), mat_id, alive & hit)


def install() -> None:
    """Put :func:`parse` and :func:`bounce` in place of the scene reader's
    and the tracer's (module docstring)."""
    rscene.parse = parse
    tracer.bounce = bounce
