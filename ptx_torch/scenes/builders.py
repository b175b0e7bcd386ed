"""The demo scene and its helpers (port of ``ptx/scenes/builders.py``).

Scene trees are host-side descriptions (numpy arrays and Python
numbers); ``compile_scene`` moves their tables to the device.  Here: the
demo world, the BASELINE configs 1-4 and the sky helpers; the stress
scenes of the JAX module come with the large-scene slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ptx_torch.core import linalg
from ptx_torch.geom.tape import (Difference, Intersection, Plane, Sphere,
                                 Transformed, Union)
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


def make_sky_box(face_images) -> Material:
    """Cubemap sky material; ``face_images``: dict with top / bottom /
    left / right / front / back arrays (test.cpp:88-91)."""
    return Material(reflect=0.0, scatter=0.0, emissive=tx.Skybox(**face_images))


def make_sky_mirror_sphere(image, scale=(1.0, 1.0, 1.0)) -> Material:
    """Mirror-ball probe sky material (test.cpp:93-96)."""
    return Material(reflect=0.0, scatter=0.0,
                    emissive=tx.Multiply(scale, tx.MirrorBall(tx.ImageTex(image))))


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


def baseline_config1():
    """BASELINE config #1: single diffuse sphere + ground plane, constant
    sky — the minimum end-to-end slice.  8 leaves."""
    diffuse = Material(reflect=0.8, scatter=1.0)
    ground = Material(reflect=0.6, scatter=1.0)
    sky = Material(reflect=0.0, scatter=0.0, emissive=(0.7, 0.8, 1.0))
    return union_array([
        Sphere((0.0, 0.0, -4.0), 1.0, diffuse),
        Plane((0.0, 1.0, 0.0), 1.0, ground),   # half-space y <= -1
        *sky_planes(sky),
    ])


def baseline_config2():
    """BASELINE config #2: CSG union / intersection / difference of
    transformed spheres and planes, diffuse only.  11 leaves."""
    red = Material(reflect=(0.8, 0.3, 0.3), scatter=1.0)
    green = Material(reflect=(0.3, 0.8, 0.3), scatter=1.0)
    blue = Material(reflect=(0.3, 0.3, 0.8), scatter=1.0)
    sky = Material(reflect=0.0, scatter=0.0, emissive=(1.0, 1.0, 1.0))
    csg = Union(
        Difference(
            Sphere((-1.2, 0.0, -4.0), 0.8, red),
            Sphere((-0.8, 0.3, -3.4), 0.5, green),
        ),
        Intersection(
            Sphere((1.0, 0.0, -4.0), 0.8, blue),
            Transformed(
                Sphere((1.4, 0.0, -4.0), 0.8, green),
                linalg.translate((0.0, 0.1, 0.0), _CPU).numpy(),
            ),
        ),
    )
    return union_array([csg, Plane((0.0, 1.0, 0.0), 1.0, red), *sky_planes(sky)])


def baseline_config3():
    """BASELINE config #3: specular reflection + glass transmission,
    multi-bounce.  9 leaves."""
    mirror = Material(reflect=0.99, scatter=0.0)
    glass = Material(reflect=0.7, scatter=0.0, transmit=0.9, ior=1.3,
                     transmit_reflect=1.0)
    diffuse = Material(reflect=(0.7, 0.6, 0.5), scatter=1.0)
    sky = Material(reflect=0.0, scatter=0.0, emissive=(0.9, 0.9, 1.0))
    return union_array([
        Sphere((-1.0, 0.0, -4.0), 0.8, mirror),
        Sphere((1.0, 0.0, -3.5), 0.7, glass),
        Plane((0.0, 1.0, 0.0), 1.0, diffuse),
        *sky_planes(sky),
    ])


def baseline_config4(sky_image=None):
    """BASELINE config #4: HDR environment lighting + an image-textured
    material (its reflect slot is a texture, so the bounce is the unfused
    one, with the hit-only kernel K4).  9 leaves."""
    if sky_image is None:
        sky_image = procedural_sky_image()
    sky = make_sky_spherical(sky_image, scale=(0.05, 0.05, 0.05))
    textured = Material(
        reflect=tx.TransformedTex(linalg.scale(0.25, _CPU).numpy(),
                                  tx.ImageTex(_checker_image())),
        scatter=1.0)
    mirror = Material(reflect=0.95, scatter=0.0)
    return union_array([
        Sphere((0.0, 0.0, -4.0), 1.0, textured),
        Sphere((1.8, 0.5, -5.0), 0.8, mirror),
        Plane((0.0, 1.0, 0.0), 1.0, textured),
        *sky_planes(sky),
    ])


def _checker_image(n=8):
    yy, xx = np.mgrid[0:n, 0:n]
    c = ((yy + xx) % 2).astype(np.float32)
    return np.stack([0.2 + 0.6 * c, 0.25 + 0.5 * c, 0.3 + 0.4 * c,
                     np.ones_like(c)], axis=-1)


DEMOS = {"demo": make_world, "config1": baseline_config1,
         "config2": baseline_config2, "config3": baseline_config3,
         "config4": baseline_config4}
