"""Declarative JSON scene specification (port of ``ptx/scenes/spec.py``).

A JSON document in the reference's vocabulary (primitives, CSG,
materials, textures, transforms), read by ``python -m ptx_torch render
--scene``::

    {"materials": {"glass": {"reflect": 0.7, "scatter": 0, "transmit": 0.9,
                             "ior": 1.3, "transmit_reflect": 1}, ...},
     "world": {"type": "union", "objects": [
         {"type": "sphere", "center": [1, 0, -4], "radius": 0.2,
          "material": "glass"},
         {"type": "transformed", "transform": {"rotate_x": 1.5708},
          "object": {...}}, ...]},
     "camera": {"width": 1920, "height": 1080, "reference_demo": true},
     "render": {"spp": 10, "depth": 16}}

Texture slots take scalars, RGB triples or texture objects (``constant``,
``image``, ``skybox``, ``transformed``, ``mirror_ball``, ``spherical``,
``multiply``, ``log``); image files are read by :func:`ptx_torch.io.load`
relative to the spec's directory.  Transforms take ``translate``,
``scale``, ``rotate_x|y|z``, ``rotate`` (axis, angle), ``matrix`` (3×4),
or a list applied outermost first.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ptx_torch import io
from ptx_torch.core import linalg
from ptx_torch.geom import tape
from ptx_torch.integrate.camera import Camera
from ptx_torch.shade import textures as tx
from ptx_torch.shade.materials import Material

_CPU = torch.device("cpu")


def parse_transform(spec) -> np.ndarray:
    """A transform spec → a (3, 4) float32 affine."""
    if isinstance(spec, list) and spec and isinstance(spec[0], dict):
        out = linalg.affine(torch.eye(3), torch.zeros(3))
        for s in spec:
            out = linalg.compose(out, torch.from_numpy(parse_transform(s)))
        return out.numpy()
    if "matrix" in spec:
        return np.asarray(spec["matrix"], np.float32).reshape(3, 4)
    if "translate" in spec:
        out = linalg.translate(np.asarray(spec["translate"], np.float32), _CPU)
    elif "scale" in spec:
        out = linalg.scale(spec["scale"], _CPU)
    elif "rotate_x" in spec:
        out = linalg.rotate_x(spec["rotate_x"], _CPU)
    elif "rotate_y" in spec:
        out = linalg.rotate_y(spec["rotate_y"], _CPU)
    elif "rotate_z" in spec:
        out = linalg.rotate_z(spec["rotate_z"], _CPU)
    elif "rotate" in spec:
        r = spec["rotate"]
        out = linalg.rotate(np.asarray(r["axis"], np.float32), r["angle"], _CPU)
    else:
        raise ValueError(f"unknown transform spec {spec!r}")
    return out.numpy()


class SceneSpec:
    def __init__(self, doc: dict, base_dir: str = "."):
        self.doc = doc
        self.base_dir = base_dir
        self._images: dict = {}

    @staticmethod
    def load(path) -> "SceneSpec":
        with open(path) as f:
            doc = json.load(f)
        return SceneSpec(doc, base_dir=os.path.dirname(os.path.abspath(path)))

    def _image(self, name):
        if name not in self._images:
            p = name if os.path.isabs(name) else os.path.join(self.base_dir, name)
            self._images[name] = io.load(p)
        return self._images[name]

    def parse_texture(self, spec):
        if isinstance(spec, (int, float)):
            return tx.Constant(float(spec))
        if isinstance(spec, list):
            return tx.Constant(np.asarray(spec, np.float32))
        t = spec["type"]
        if t == "constant":
            return tx.Constant(np.asarray(spec["color"], np.float32))
        if t == "image":
            return tx.ImageTex(self._image(spec["file"]), alpha=spec.get("alpha", False))
        if t == "skybox":
            faces = {k: self._image(spec[k])
                     for k in ("top", "bottom", "left", "right", "front", "back")}
            return tx.Skybox(**faces, alpha=spec.get("alpha", False))
        if t == "transformed":
            return tx.TransformedTex(parse_transform(spec["transform"]),
                                     self.parse_texture(spec["child"]))
        if t == "mirror_ball":
            return tx.MirrorBall(self.parse_texture(spec["child"]))
        if t == "spherical":
            return tx.SphericalCoords(self.parse_texture(spec["child"]))
        if t == "multiply":
            return tx.Multiply(np.asarray(spec["factor"], np.float32),
                               self.parse_texture(spec["child"]))
        if t == "log":
            return tx.Log(self.parse_texture(spec["child"]))
        raise ValueError(f"unknown texture type {t!r}")

    def parse_material(self, spec) -> Material:
        kw = {slot: self.parse_texture(spec[slot])
              for slot in ("reflect", "scatter", "emissive", "transmit", "transmit_reflect")
              if slot in spec}
        if "ior" in spec:
            kw["ior"] = float(spec["ior"])
        return Material(**kw)

    def parse_object(self, spec, materials):
        t = spec["type"]
        if t == "sphere":
            return tape.Sphere(np.asarray(spec["center"], np.float32), float(spec["radius"]),
                               materials[spec["material"]])
        if t == "plane":
            m = materials[spec["material"]]
            n = np.asarray(spec["normal"], np.float32)
            if "point" in spec:
                return tape.Plane.from_point(n, np.asarray(spec["point"], np.float32), m)
            return tape.Plane(n, float(spec["d"]), m)
        if t in ("union", "intersection"):
            node = tape.Union if t == "union" else tape.Intersection
            return node(*[self.parse_object(o, materials) for o in spec["objects"]])
        if t == "difference":
            return tape.Difference(self.parse_object(spec["a"], materials),
                                   self.parse_object(spec["b"], materials))
        if t == "transformed":
            return tape.Transformed(self.parse_object(spec["object"], materials),
                                    parse_transform(spec["transform"]))
        if t == "lens":
            from ptx_torch.scenes.builders import make_lens
            return make_lens(spec["position"], spec["orientation"], spec["radius"],
                             spec["sphere_radius"], materials[spec["material"]])
        raise ValueError(f"unknown object type {t!r}")

    def build(self):
        """``(world, camera, render_options)``."""
        materials = {name: self.parse_material(m)
                     for name, m in self.doc.get("materials", {}).items()}
        world = self.parse_object(self.doc["world"], materials)
        cam_doc = dict(self.doc.get("camera", {}))
        w = int(cam_doc.get("width", 640))
        h = int(cam_doc.get("height", 480))
        if cam_doc.get("reference_demo"):
            cam = Camera.reference_demo(w, h)
        else:
            cam = Camera(w, h, float(cam_doc.get("screen_width", 4.0 / 3.0)),
                         float(cam_doc.get("screen_height", 1.0)),
                         float(cam_doc.get("screen_distance", 2.0)),
                         tuple(map(tuple, cam_doc["pose"])) if "pose" in cam_doc else None)
        return world, cam, dict(self.doc.get("render", {}))
