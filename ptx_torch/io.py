"""Image writers: the JAX package's numpy-only ``ptx/io/bmp.py`` and
``ptx/io/hdr.py``, loaded without importing jax (see :mod:`ptx_torch._reuse`)."""

from __future__ import annotations

from ptx_torch._reuse import load

bmp = load("io/bmp.py")
hdr = load("io/hdr.py")


def write_hdr(path, img) -> None:
    """``hdr.write`` without its native-codec probe: that probe imports
    ``ptx.runtime``, and any ``ptx.*`` import runs ``ptx/core/__init__.py``,
    which imports jax.  The bytes of
    ``hdr``'s pure-Python path: new-style RLE scanlines from its encoder."""
    rgbe = hdr.float_to_rgbe(img)
    h, w = rgbe.shape[:2]
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    out += f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        out += bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF])
        for comp in range(4):
            out += hdr._rle_encode(rgbe[y, :, comp])
    with open(path, "wb") as f:
        f.write(bytes(out))
