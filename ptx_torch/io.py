"""Image readers and writers: 24-bit BMP and Radiance ``.hdr`` (RGBE).

The port's own copies of the JAX package's numpy-only codecs
(``ptx/io/bmp.py`` ``read`` / ``write``, ``ptx/io/hdr.py`` ``read``,
``rgbe_to_float``, ``float_to_rgbe`` and ``_rle_encode``, and
``ptx/io/image.py`` ``load``); they read and write the same bytes.  The
JAX package's native RGBE fast path is not ported: :func:`read_hdr` is its
portable decoder.
"""

from __future__ import annotations

import io as _io
import os
import struct

import numpy as np


class HDRError(ValueError):
    pass


def load(path) -> np.ndarray:
    """An image file → float32 (H, W, 4) RGBA by extension: ``.hdr`` /
    ``.pic`` through :func:`read_hdr`, ``.bmp`` as 8-bit ÷ 255 with alpha
    1.  A ``.png`` raises: the PNG reader comes with a later slice."""
    ext = os.path.splitext(str(path))[1].lower().lstrip(".")
    if ext in ("hdr", "pic"):
        return read_hdr(path)
    if ext == "bmp":
        rgb = read_bmp(path).astype(np.float32) / 255.0
        return np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
    if ext == "png":
        raise NotImplementedError(f"{path}: the PNG reader is not ported yet (ROADMAP)")
    raise ValueError(f"invalid format: {path}")


def read_bmp(path) -> np.ndarray:
    """A 24/32-bit uncompressed BMP → uint8 (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    (offset,) = struct.unpack_from("<I", data, 10)
    _size, w, h = struct.unpack_from("<Iii", data, 14)
    (bpp,) = struct.unpack_from("<H", data, 28)
    (compression,) = struct.unpack_from("<I", data, 30)
    if compression != 0 or bpp not in (24, 32):
        raise ValueError("unsupported BMP variant")
    nb = bpp // 8
    stride = (w * nb + 3) & ~3
    flip = h > 0
    h = abs(h)
    out = np.empty((h, w, 3), np.uint8)
    for i in range(h):
        y = h - 1 - i if flip else i
        row = np.frombuffer(data, np.uint8, count=w * nb,
                            offset=offset + i * stride).reshape(w, nb)
        out[y] = row[:, 2::-1][:, :3] if nb == 3 else row[:, [2, 1, 0]]
    return out


def read_hdr(path_or_bytes) -> np.ndarray:
    """A Radiance HDR file → float32 (H, W, 4) RGBA (alpha 1): the
    ``#?RADIANCE`` header (``FORMAT=32-bit_rle_rgbe``, ``EXPOSURE`` and
    ``COLORCORR`` divide the scale), ``-Y h +X w`` rows, new-style
    per-component RLE or old-style packed records with (1, 1, 1, n)
    repeats (the reference's image.cpp:83-324)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    buf = _io.BytesIO(data)
    if buf.read(11) != b"#?RADIANCE\n":
        raise HDRError("magic string doesn't match")
    scale = np.ones(3, np.float64)
    got_format = False
    while True:
        line = _read_line(buf)
        if line.startswith(b"#") or line == b"":
            continue
        if line[:1] in (b"-", b"+"):
            res_line = line
            break
        if b"=" not in line:
            raise HDRError(f"unexpected header line {line!r}")
        key, _, val = line.partition(b"=")
        key = key.strip().decode()
        if key == "FORMAT":
            if got_format:
                raise HDRError("format already specified")
            got_format = True
            if val.strip() != b"32-bit_rle_rgbe":
                raise HDRError("invalid format specifier")
        elif key == "EXPOSURE":
            scale /= float(val)
        elif key == "COLORCORR":
            scale /= np.array([float(v) for v in val.split()], np.float64)
    parts = res_line.split()
    if len(parts) != 4 or parts[0] != b"-Y" or parts[2] != b"+X":
        raise HDRError("invalid resolution string")
    h, w = int(parts[1]), int(parts[3])
    if h <= 0 or w <= 0 or w >= 1 << 15:
        raise HDRError("invalid resolution string")

    rgbe = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        intro = buf.read(4)
        if len(intro) < 4:
            raise HDRError("unexpected EOF")
        if intro[0] == 2 and intro[1] == 2 and not (intro[2] & 0x80):
            if (intro[2] << 8) + intro[3] != w:
                raise HDRError("invalid line length in new compressed line")
            for comp in range(4):
                x = 0
                row = rgbe[y, :, comp]
                while x < w:
                    b = buf.read(1)
                    if not b:
                        raise HDRError("unexpected EOF")
                    code = b[0]
                    if code > 0x80:                 # run
                        count = code - 0x80
                        v = buf.read(1)
                        if not v:
                            raise HDRError("unexpected EOF")
                        if x + count > w:
                            raise HDRError("line too long")
                        row[x:x + count] = v[0]
                        x += count
                    else:                            # literal
                        lit = buf.read(code)
                        if len(lit) < code:
                            raise HDRError("unexpected EOF")
                        if x + code > w:
                            raise HDRError("line too long")
                        row[x:x + code] = np.frombuffer(lit, np.uint8)
                        x += code
        else:
            # old style: packed RGBE records; (1, 1, 1, n) repeats the
            # previous pixel n times, consecutive markers shifting by 8 bits
            x, rshift, record = 0, 0, intro
            while True:
                if record[0] == 1 and record[1] == 1 and record[2] == 1:
                    if rshift >= 32:
                        raise HDRError("too many bytes in repeat count")
                    count = record[3] << rshift
                    if count == 0 or x == 0 or x + count > w:
                        raise HDRError("invalid repeat count")
                    rgbe[y, x:x + count] = rgbe[y, x - 1]
                    x += count
                    rshift += 8
                else:
                    rgbe[y, x] = np.frombuffer(record, np.uint8)
                    x += 1
                    rshift = 0
                if x >= w:
                    break
                record = buf.read(4)
                if len(record) < 4:
                    raise HDRError("unexpected EOF")
    return rgbe_to_float(rgbe, scale)


def _read_line(buf) -> bytes:
    out = bytearray()
    while True:
        c = buf.read(1)
        if not c:
            raise HDRError("unexpected EOF")
        if c == b"\n":
            return bytes(out)
        out += c


def rgbe_to_float(rgbe, scale=(1.0, 1.0, 1.0)) -> np.ndarray:
    """RGBE → float: ``mantissa · 179 · 2^(e − 128 − 8) · scale``
    (image.cpp:306-314)."""
    rgbe = np.asarray(rgbe, np.uint8)
    exp = rgbe[..., 3].astype(np.int32) - 128
    factor = 179.0 * np.exp2(exp - 8).astype(np.float64)
    out = np.empty(rgbe.shape[:-1] + (4,), np.float32)
    for c in range(3):
        out[..., c] = rgbe[..., c] * factor * np.asarray(scale)[c]
    out[..., 3] = 1.0
    return out


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
