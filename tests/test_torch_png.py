"""The port's PNG codec and image dispatch (``ptx_torch.io``) against the
JAX package's ``ptx.io.png`` and ``ptx.io.image``.

- ``docs/demo_scene.png`` (640×360 RGB, Paeth / up / sub rows) decodes to
  the RGBA8 that ``ptx.io.png.read`` (Pillow where it imports) and
  ``ptx.io.png.decode`` (its own decoder) give, bit for bit;
- every color type and bit depth the decoder takes, written by Pillow
  with its adaptive filters, decodes as ``ptx.io.png.decode`` does;
- a write / read round trip; RGB gets opaque alpha;
- ``load`` / ``save`` equal ``ptx.io.image``'s for ``.png``, ``.hdr`` and
  ``.bmp``;
- a ``SceneSpec`` with a PNG texture builds the JAX spec's params.
"""

import json
import os

import numpy as np
import pytest
import torch

from ptx.io import image as jimage
from ptx.io import png as jpng
from ptx.scenes.spec import SceneSpec as JaxSceneSpec
from ptx_torch import io
from ptx_torch.convert import params_from_jax
from ptx_torch.integrate import trace
from ptx_torch.scenes.spec import SceneSpec

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_PNG = os.path.join(ROOT, "docs", "demo_scene.png")


@pytest.fixture(scope="module")
def demo_decoded():
    with open(DEMO_PNG, "rb") as f:
        data = f.read()
    return jpng.read(DEMO_PNG), jpng.decode(data)


def test_demo_png_decodes_as_the_jax_readers(demo_decoded):
    got = io.read_png(DEMO_PNG)
    assert got.shape == (360, 640, 4) and got.dtype == np.uint8
    for want in demo_decoded:
        np.testing.assert_array_equal(got, want)
    assert (got[..., 3] == 255).all()


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1", "I;16"])
def test_color_types_decode_as_the_jax_decoder(tmp_path, mode):
    PIL = pytest.importorskip("PIL.Image")
    r = np.random.default_rng(3)
    rgba = r.integers(0, 256, (23, 41, 4), dtype=np.uint8)
    rgba[:, 10:20] = rgba[:, 10:11]            # runs: sub / up / Paeth rows
    im = PIL.fromarray(rgba, "RGBA")
    im = im if mode == "RGBA" else im.convert("RGB").convert(mode)
    path = tmp_path / f"{mode.replace(';', '')}.png"
    im.save(path, optimize=True)
    want = jpng.decode(path.read_bytes())
    np.testing.assert_array_equal(io.read_png(path), want)


def test_write_read_round_trip(tmp_path):
    r = np.random.default_rng(0)
    for ch in (1, 3, 4):
        img = r.integers(0, 256, (7, 9, ch), dtype=np.uint8)
        io.write_png(tmp_path / "rt.png", img)
        got = io.read_png(tmp_path / "rt.png")
        rgb = np.repeat(img, 3, axis=-1) if ch == 1 else img[..., :3]
        np.testing.assert_array_equal(got[..., :3], rgb)
        np.testing.assert_array_equal(got[..., 3], img[..., 3] if ch == 4 else 255)
        jpng.write(tmp_path / "j.png", img)
        assert (tmp_path / "j.png").read_bytes() == (tmp_path / "rt.png").read_bytes()


def test_rgb_gets_opaque_alpha(tmp_path):
    img = np.full((2, 3, 3), 7, np.uint8)
    io.write_png(tmp_path / "rgb.png", img)
    got = io.load(tmp_path / "rgb.png")
    assert got.shape == (2, 3, 4) and (got[..., 3] == 1.0).all()
    np.testing.assert_array_equal(got[..., :3], 7 / 255.0 * np.ones((2, 3, 3), np.float32))


@pytest.mark.parametrize("ext", ["png", "hdr", "bmp"])
def test_load_and_save_dispatch_as_the_jax_image_module(tmp_path, ext):
    img = (np.random.default_rng(1).uniform(0, 1.2, (6, 10, 3))).astype(np.float32)
    io.save(tmp_path / f"t.{ext}", img)
    jimage.save(str(tmp_path / f"j.{ext}"), img)
    assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
    got = io.load(tmp_path / f"t.{ext}")
    assert got.dtype == np.float32 and got.shape == (6, 10, 4)
    np.testing.assert_array_equal(got, jimage.load(str(tmp_path / f"t.{ext}")))


def test_scene_spec_with_a_png_texture(tmp_path):
    tex = np.random.default_rng(2).integers(0, 256, (4, 8, 3), dtype=np.uint8)
    io.write_png(tmp_path / "checker.png", tex)
    doc = {
        "materials": {
            "tex": {"reflect": {"type": "image", "file": "checker.png"}, "scatter": 1.0},
            "sky": {"reflect": 0.0, "scatter": 0.0, "emissive": [0.7, 0.8, 1.0]}},
        "world": {"type": "union", "objects": [
            {"type": "sphere", "center": [0, 0, -4], "radius": 1.0, "material": "tex"},
            {"type": "plane", "normal": [0, 0, 1], "d": 200, "material": "sky"}]},
        "camera": {"width": 8, "height": 6, "reference_demo": True}}
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    world, cam, _ = SceneSpec.load(path).build()
    jworld, _, _ = JaxSceneSpec.load(str(path)).build()
    from ptx.integrate import trace as jtr
    want = params_from_jax(jtr.compile_scene(jworld, pallas=False).params, "cpu")
    got = trace.compile_scene(world, "cpu").params
    assert (cam.width, cam.height) == (8, 6)
    assert len(got["images"]) == len(want["images"]) == 1
    np.testing.assert_array_equal(got["images"][0].numpy(), want["images"][0].numpy())
    np.testing.assert_array_equal(got["images"][0][..., :3].numpy(),
                                  tex.astype(np.float32) / 255.0)
