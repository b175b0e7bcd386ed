"""Image writers: 24-bit BMP and Radiance ``.hdr`` (RGBE, new-style RLE).

The port's own copies of the JAX package's numpy-only writers
(``ptx/io/bmp.py`` ``write``, ``ptx/io/hdr.py`` ``float_to_rgbe`` and
``_rle_encode``); they write the same bytes.
"""

from __future__ import annotations

import struct

import numpy as np


def write_bmp(path, img) -> None:
    """24-bit BI_RGB, bottom-up rows; float images are tone-mapped as the
    reference does (clamp ×256 to 8 bit, test.cpp:993-995)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img * 256.0, 0.0, 255.0).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w = img.shape[:2]
    bgr = img[..., :3][..., ::-1]
    pad = (4 - (w * 3) % 4) % 4
    rows = bytearray()
    for y in range(h - 1, -1, -1):
        rows += bgr[y].tobytes() + b"\x00" * pad
    header = struct.pack("<2sIHHI", b"BM", 54 + len(rows), 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(rows),
                       2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(header + info + bytes(rows))


def float_to_rgbe(img) -> np.ndarray:
    """Shared-exponent encode (the reference's image.cpp:414-428)."""
    rgb = np.asarray(img, np.float64)[..., :3]
    maxv = rgb.max(axis=-1) / 179.0
    dark = maxv < 1e-30
    safe = np.where(dark, 1.0, maxv)
    lg = np.ceil(np.log2(safe) + 1e-5).astype(np.int32)
    scl = np.exp2(-(lg - 8)) / 179.0
    mant = np.clip(np.floor(rgb * scl[..., None]), 0, 255).astype(np.uint8)
    out = np.empty(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.where(dark[..., None], 0, mant)
    out[..., 3] = np.where(dark, 0, lg + 128).astype(np.uint8)
    return out


def _rle_encode(row) -> bytes:
    """Per-component RLE: runs of ≥ 3 as (0x80 + len, v), literals of at
    most 0x80 (image.cpp:430-471)."""
    out = bytearray()
    w = len(row)
    x = 0
    while x < w:
        run_start = x
        while run_start < w:
            run_len = 1
            while (run_start + run_len < w and run_len < 0x7F
                   and row[run_start + run_len] == row[run_start]):
                run_len += 1
            if run_len >= 3:
                break
            run_start += run_len
        else:
            run_len = 0
        lit = run_start - x
        while lit > 0:
            n = min(lit, 0x80)
            out.append(n)
            out += row[x:x + n].tobytes()
            x += n
            lit -= n
        if run_start < w and run_len >= 3:
            out.append(0x80 + run_len)
            out.append(int(row[run_start]))
            x = run_start + run_len
    return bytes(out)


def write_hdr(path, img) -> None:
    """Float (H, W, 3/4) to a new-style RLE ``.hdr`` file (image.cpp:398-481)."""
    rgbe = float_to_rgbe(img)
    h, w = rgbe.shape[:2]
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    out += f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        out += bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF])
        for comp in range(4):
            out += _rle_encode(rgbe[y, :, comp])
    with open(path, "wb") as f:
        f.write(bytes(out))
