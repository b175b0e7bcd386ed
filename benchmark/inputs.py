"""What both sides of a run are given, made from ``--seed``: the scene
document with its images, the target image of a training cell, and the
keys.

The scene is the configuration's document with every constant emission
colour scaled by 0.9-1.1 a channel, and every emission chain's factor by
the same, drawn from the seed.  Emission never feeds a path's continuation, so every seed
bounces the same geometry and materials and does the same work; the
parameters the training step moves start from a seeded point.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch

from benchmark import hdr
from benchmark.reference import rng

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_json(kind: str, name: str, root: str = ROOT) -> dict:
    """``<root>/<kind>/<name>.json`` (``root``: the benchmark's folder)."""
    with open(os.path.join(root, kind, f"{name}.json")) as f:
        return json.load(f)


def _scale_chain(tex, g):
    while isinstance(tex, dict):
        if tex.get("type") == "multiply":
            tex["factor"] = [c * float(g.uniform(0.9, 1.1)) for c in tex["factor"]]
        tex = tex.get("child")


def scene_doc(config: dict, seed: int) -> dict:
    """The configuration's scene with its emission scaled from ``seed``,
    its camera at the configuration's frame."""
    doc = copy.deepcopy(config["scene"])
    g = np.random.default_rng([seed, 0x5CE2E])
    for name in sorted(doc["materials"]):
        m = doc["materials"][name]
        v = m.get("emissive", 0.0)
        if isinstance(v, dict):
            _scale_chain(v, g)
        else:
            v = [v] * 3 if isinstance(v, (int, float)) else v
            m["emissive"] = [c * float(g.uniform(0.9, 1.1)) for c in v]
    doc["camera"] = {"width": int(config["frame"]["width"]),
                     "height": int(config["frame"]["height"]), "reference_demo": True}
    return doc


def write_images(config: dict, directory: str, root: str = ROOT) -> None:
    hdr.materialize(config.get("images", {}), directory, root)


def target(seed: int, height: int, width: int, device) -> torch.Tensor:
    """The training target: a smooth random image (H, W, 3), bilinear over
    a 1/16-scale grid of uniforms in [0, 0.8), made on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    coarse = torch.rand((1, 3, max(1, height // 16), max(1, width // 16)), generator=g,
                        device=device) * 0.8
    img = torch.nn.functional.interpolate(coarse, size=(height, width), mode="bilinear",
                                          align_corners=False)
    return img[0].permute(1, 2, 0).contiguous()


def step_key(seed: int, i: int):
    """Training step ``i``'s key."""
    return rng.fold(rng.root_key(seed), i)


def frame_key(seed: int, f: int):
    """Render frame ``f``'s key."""
    return rng.fold(rng.root_key(seed), 0x0F2A3E, f)
