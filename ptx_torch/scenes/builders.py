"""The demo scene and its helpers (port of ``ptx/scenes/builders.py``).

Scene trees are host-side descriptions (numpy arrays and Python
numbers); ``compile_scene`` moves their tables to the device.  The
baseline configs and stress scenes of the JAX module come later.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ptx_torch.core import linalg
from ptx_torch.geom.tape import Intersection, Plane, Sphere, Union
from ptx_torch.shade import textures as tx
from ptx_torch.shade.materials import Material, transform_material

_CPU = torch.device("cpu")


def union_array(objects):
    """The reference's balanced union tree (test.cpp:52-64); the tape
    compiler merges it into one n-ary union."""
    return Union(*objects)


def make_lens(position, orientation, radius, sphere_radius, material):
    """Biconvex lens = intersection of two spheres (test.cpp:66-72)."""
    position = np.asarray(position, np.float32)
    orientation = np.asarray(orientation, np.float32)
    orientation = orientation / np.linalg.norm(orientation)
    dist = math.sqrt(max(sphere_radius ** 2 - radius ** 2, 0.0))
    return Intersection(
        Sphere(position + orientation * dist, sphere_radius, material),
        Sphere(position - orientation * dist, sphere_radius, material),
    )


def make_sky_spherical(image, scale=(1.0, 1.0, 1.0)) -> Material:
    """Equirect HDR sky material (test.cpp:97-105)."""
    return Material(reflect=0.0, scatter=0.0,
                    emissive=tx.Multiply(scale, tx.SphericalCoords(tx.ImageTex(image))))


def sky_planes(material, distance=200.0):
    """Six inward-facing planes sharing one emissive material — the
    reference's sky enclosure (test.cpp:134-140)."""
    normals = [(0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0), (1, 0, 0), (-1, 0, 0)]
    return [Plane(np.asarray(n, np.float32), distance, material) for n in normals]


def procedural_sky_image(h=64, w=128):
    """The JAX package's deterministic equirect HDR stand-in for the
    reference's probe asset: a blue-to-horizon gradient with a bright sun
    disc (sky ~10², sun ~10⁴ before the demo's ×0.01 scale)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    v = ys / (h - 1)
    u = xs / (w - 1)
    sky = 100.0 * np.stack([0.25 + 0.3 * v, 0.4 + 0.4 * v, 0.7 + 0.3 * v],
                           axis=-1)
    sun = np.exp(-(((u - 0.7) * 18) ** 2 + ((v - 0.75) * 18) ** 2))
    img = sky + sun[..., None] * np.array([4000.0, 3600.0, 3000.0],
                                          np.float32)
    return np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=-1)


def make_world(sky_image=None):
    """The reference demo scene (test.cpp:107-145): two small diffuse
    spheres, a glass CSG bulb (sphere ∩ (plane ∪ emissive core)), a glass
    CSG lens, inside a 6-plane equirect-HDR sky rotated 90° about x.
    13 leaves."""
    mat_diffuse = Material(reflect=0.8, scatter=1.0)
    mat_emit_w = Material(reflect=0.0, scatter=0.0, emissive=2.0)
    mat_glass = Material(reflect=0.7, scatter=0.0, emissive=0.0,
                         transmit=0.9, ior=1.3, transmit_reflect=1.0)

    if sky_image is None:
        sky_image = procedural_sky_image()
    sky = transform_material(
        linalg.rotate_x(2 * math.pi / 4, _CPU).numpy(),
        make_sky_spherical(sky_image, scale=(0.01, 0.01, 0.01)))

    shift = linalg.translate((-1.0, 0.0, 4.0), _CPU).numpy()
    objects = [
        Sphere((1.0, 0.0, -4.0), 0.2, transform_material(shift, mat_diffuse)),
        Intersection(
            Sphere((1.0, 0.0, -4.0), 1.0, mat_glass),
            Union(
                Plane.from_point((-1.0, 0.0, -0.7), (1.0, 0.0, -4.0), mat_glass),
                Sphere((1.0, 0.0, -4.0), 0.2, transform_material(shift, mat_emit_w)),
            ),
        ),
        Sphere((-1.0, 0.0, -4.0), 0.2, mat_diffuse),
        *sky_planes(sky),
        make_lens((-2.5 / 4, 0.0, -2.5), (-1.0, 0.0, -4.0), 0.5, 1.0, mat_glass),
    ]
    return union_array(objects)
