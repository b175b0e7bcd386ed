"""The Radiance RGBE files the configurations' images are stored in.

The benchmark writes each image a configuration names from a formula kept
in ``benchmark/images/<formula>.py`` into the run's scratch directory; the
port reads it through its own loader, the reference through
:func:`read_flat`.  Records are written flat (old-style, one RGBE record a
pixel, no run-length coding) and decode as the reference renderer decodes
them: ``mantissa · 179 · 2^(exponent − 136)``.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark import load_module

_HEADER = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
_LUMENS = 179.0


def encode(img) -> np.ndarray:
    """(H, W, ≥3) float → (H, W, 4) uint8 RGBE (Radiance's ``float2rgbe``)."""
    rgb = np.asarray(img, np.float64)[..., :3] / _LUMENS
    v = rgb.max(axis=-1)
    m, e = np.frexp(v)
    scale = np.where(v < 1e-32, 0.0, m * 256.0 / np.where(v < 1e-32, 1.0, v))
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.floor(rgb * scale[..., None]).astype(np.uint8)
    out[..., 3] = np.where(v < 1e-32, 0, e + 128).astype(np.uint8)
    # a record (1, 1, 1, n) would read as a repeat marker, and a row that
    # opens with (2, 2, x < 128) as a run-length row: neither is written
    marker = (out[..., 0] == 1) & (out[..., 1] == 1) & (out[..., 2] == 1)
    rle = np.zeros_like(marker)
    rle[:, 0] = (out[:, 0, 0] == 2) & (out[:, 0, 1] == 2) & (out[:, 0, 2] < 128)
    if marker.any() or rle.any():
        raise ValueError("the image encodes to a record a flat file cannot hold")
    return out


def decode(rgbe) -> np.ndarray:
    """(H, W, 4) uint8 RGBE → (H, W, 4) float32 RGBA, alpha 1."""
    rgbe = np.asarray(rgbe, np.uint8)
    factor = _LUMENS * np.exp2(rgbe[..., 3].astype(np.int32) - 136).astype(np.float64)
    out = np.ones(rgbe.shape[:-1] + (4,), np.float32)
    out[..., :3] = (rgbe[..., :3] * factor[..., None]).astype(np.float32)
    return out


def write_flat(path, img) -> None:
    rgbe = encode(img)
    h, w = rgbe.shape[:2]
    with open(path, "wb") as f:
        f.write(_HEADER + f"-Y {h} +X {w}\n".encode() + rgbe.tobytes())


def read_flat(path) -> np.ndarray:
    """A file :func:`write_flat` wrote → (H, W, 4) float32."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_HEADER):
        raise ValueError(f"{path}: not a flat RGBE file of this benchmark")
    line, _, body = data[len(_HEADER):].partition(b"\n")
    _, h, _, w = line.split()
    h, w = int(h), int(w)
    if len(body) != h * w * 4:
        raise ValueError(f"{path}: {len(body)} bytes of records, {h * w * 4} expected")
    return decode(np.frombuffer(body, np.uint8).reshape(h, w, 4))


def formula(name, root=os.path.dirname(__file__)):
    """The image formula ``<root>/images/<name>.py``'s ``make``."""
    return load_module("images", name, root).make


def materialize(images: dict, directory: str, root=os.path.dirname(__file__)) -> None:
    """Write every image a configuration names (``{file: {"formula": name,
    **arguments}}``) into ``directory``."""
    for fname, spec in images.items():
        args = {k: v for k, v in spec.items() if k != "formula"}
        write_flat(os.path.join(directory, fname), formula(spec["formula"], root)(**args))
