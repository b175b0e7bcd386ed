"""Image readers and writers: PNG, 24-bit BMP and Radiance ``.hdr`` (RGBE).

The port's own copies of the JAX package's codecs (``ptx/io/png.py``
``decode``, ``_unfilter``, ``write``, ``read_float``; ``ptx/io/bmp.py``
``read`` / ``write``; ``ptx/io/hdr.py`` ``read``, ``rgbe_to_float``,
``float_to_rgbe``, ``_rle_encode``; ``ptx/io/image.py`` ``load`` /
``save``); they read and write the same bytes.  The PNG decoder is the
self-contained one (stdlib ``zlib`` + numpy): where the JAX package
imports Pillow, the port never does.  The HDR scanlines go through the
native RGBE codec of :mod:`ptx_torch.runtime` where that library builds,
and through the Python codec here where it does not, as in the JAX
package.
"""

from __future__ import annotations

import io as _io
import os
import struct
import zlib

import numpy as np


class HDRError(ValueError):
    pass


class PNGError(ValueError):
    pass


def load(path) -> np.ndarray:
    """An image file → float32 (H, W, 4) RGBA by extension: ``.png`` as
    8-bit RGBA ÷ 255, ``.hdr`` / ``.pic`` through :func:`read_hdr`,
    ``.bmp`` as 8-bit ÷ 255 with alpha 1."""
    ext = os.path.splitext(str(path))[1].lower().lstrip(".")
    if ext == "png":
        return read_png(path).astype(np.float32) / 255.0
    if ext in ("hdr", "pic"):
        return read_hdr(path)
    if ext == "bmp":
        rgb = read_bmp(path).astype(np.float32) / 255.0
        return np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
    raise ValueError(f"invalid format: {path}")


def save(path, img) -> None:
    """Write ``img`` by extension: ``.png`` (float clipped to [0, 1]),
    ``.hdr`` / ``.pic``, ``.bmp``."""
    img = np.asarray(img)
    ext = os.path.splitext(str(path))[1].lower().lstrip(".")
    if ext == "png":
        write_png(path, img if img.dtype == np.uint8 else np.clip(img, 0.0, 1.0))
    elif ext in ("hdr", "pic"):
        write_hdr(path, img)
    elif ext == "bmp":
        write_bmp(path, img)
    else:
        raise ValueError(f"invalid format: {path}")


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def read_png(path) -> np.ndarray:
    """A PNG file → uint8 (H, W, 4) RGBA (16-bit stripped, palette
    expanded, alpha filled opaque: the reference's png_decoder.cpp:85-97)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 (H, W, 4) RGBA; non-interlaced, any bit depth and
    color type."""
    if data[:8] != _PNG_MAGIC:
        raise PNGError("bad signature")
    pos = 8
    ihdr = None
    idat = bytearray()
    palette = None
    trns = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(chunk, np.uint8)
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise PNGError("missing IHDR")
    w, h, depth, color, comp, filt, interlace = ihdr
    if comp != 0 or filt != 0:
        raise PNGError("unsupported compression/filter method")
    if interlace != 0:
        raise PNGError("interlaced PNG not supported")
    if color not in (0, 2, 3, 4, 6):
        raise PNGError(f"bad color type {color}")

    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    raw = zlib.decompress(bytes(idat))

    if depth in (8, 16):
        sample_bytes = depth // 8
        bpp = channels * sample_bytes
        img = _unfilter(raw, h, w * bpp, bpp)
        arr = img.reshape(h, w, channels, sample_bytes)[..., 0]  # strip 16→8
    elif depth in (1, 2, 4):
        stride = (w * channels * depth + 7) // 8
        img = _unfilter(raw, h, stride, 1)
        bits = np.unpackbits(img.reshape(h, -1), axis=1)
        vals = bits.reshape(h, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1)
        arr = (vals * weights).sum(axis=2)[:, :w * channels]
        arr = arr.reshape(h, w, channels).astype(np.uint8)
        if color != 3:     # grayscale scale-up to 8-bit
            arr = (arr * (255 // ((1 << depth) - 1))).astype(np.uint8)
    else:
        raise PNGError(f"unsupported bit depth {depth}")

    if color == 3:
        if palette is None:
            raise PNGError("palette image without PLTE")
        idx = arr[..., 0]
        rgb = palette[idx]
        if trns is not None:
            a = np.full(len(palette), 255, np.uint8)
            a[:len(trns)] = trns[:len(palette)]
            alpha = a[idx]
        else:
            alpha = np.full_like(idx, 255)
        return np.dstack([rgb, alpha]).astype(np.uint8)
    if color == 0:
        g = arr[..., 0]
        return np.dstack([g, g, g, np.full_like(g, 255)])
    if color == 2:
        return np.dstack([arr, np.full(arr.shape[:2] + (1,), 255, np.uint8)])
    if color == 4:
        g, a = arr[..., 0], arr[..., 1]
        return np.dstack([g, g, g, a])
    return arr   # color == 6


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (none, sub, up, average, Paeth) of ``h``
    rows of ``stride`` bytes, ``bpp`` bytes a pixel."""
    if len(raw) < h * (stride + 1):
        raise PNGError("truncated IDAT")
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, cur = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            rec = cur
        elif ftype == 1:       # sub: a running sum mod 256 per byte of a pixel
            rec = np.empty(stride, np.uint8)
            for j in range(min(bpp, stride)):
                rec[j::bpp] = np.cumsum(cur[j::bpp], dtype=np.uint64) & 0xFF
        elif ftype == 2:       # up
            rec = cur + prev   # uint8 arithmetic wraps mod 256
        elif ftype in (3, 4):  # average, Paeth: serial in x
            c, b = cur.tolist(), prev.tolist()
            r = [0] * stride
            for x in range(stride):
                a = r[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    r[x] = (c[x] + ((a + b[x]) >> 1)) & 0xFF
                else:
                    cc = b[x - bpp] if x >= bpp else 0
                    p = a + b[x] - cc
                    pa, pb, pc = abs(p - a), abs(p - b[x]), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else (b[x] if pb <= pc else cc)
                    r[x] = (c[x] + pred) & 0xFF
            rec = np.asarray(r, np.uint8)
        else:
            raise PNGError(f"bad filter {ftype}")
        out[y] = rec
        prev = out[y]
    return out


def write_png(path, img) -> None:
    """Encode uint8 (H, W, 1/3/4) or float (clipped to [0, 1], ×255) as an
    8-bit PNG, filter 0, zlib level 6."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    color = {1: 0, 3: 2, 4: 6}[ch]
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * ch)], axis=1)
    payload = zlib.compress(rows.tobytes(), 6)

    def chunk(tag, body):
        out = struct.pack(">I", len(body)) + tag + body
        return out + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(_PNG_MAGIC)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(chunk(b"IDAT", payload))
        f.write(chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# BMP and HDR
# ---------------------------------------------------------------------------

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

    from ptx_torch import runtime
    if runtime.runtime_available():
        pos = buf.tell()
        try:
            return rgbe_to_float(runtime.rgbe_decode(buf.read(), w, h), scale)
        except ValueError:
            buf.seek(pos)         # the Python decoder below names the fault

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
    from ptx_torch import runtime
    if runtime.runtime_available():
        out += runtime.rgbe_encode(rgbe)
    else:
        for y in range(h):
            out += bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF])
            for comp in range(4):
                out += _rle_encode(rgbe[y, :, comp])
    with open(path, "wb") as f:
        f.write(bytes(out))
