"""The port's JSON scene spec and image readers against the JAX package's.

- ``ptx_torch.io.read_hdr`` decodes ``scenes/sky_probe.hdr`` to exactly the
  floats ``ptx.io.hdr.read`` gives;
- ``SceneSpec.load("scenes/composed.json").build()`` compiles to the same
  params as the JAX ``SceneSpec`` (taken through ``params_from_jax``):
  equal, except the composed transforms (``xform``), within 1e-6: a
  float32 matrix product and cos / sin of two libraries round their last
  bit differently;
- ``load`` takes ``.hdr``, ``.bmp`` and ``.png`` (the PNG cases are in
  ``tests/test_torch_png.py``).
"""

import os

import numpy as np
import jax
import pytest
import torch

from ptx.integrate import trace as jtr
from ptx.io import bmp as jbmp
from ptx.io import hdr as jhdr
from ptx.scenes.spec import SceneSpec as JaxSceneSpec
from ptx_torch import io
from ptx_torch.convert import params_from_jax
from ptx_torch.integrate import trace
from ptx_torch.ops.megasweep import MegaHit
from ptx_torch.scenes.spec import SceneSpec, parse_transform

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPOSED = os.path.join(ROOT, "scenes", "composed.json")
PROBE = os.path.join(ROOT, "scenes", "sky_probe.hdr")


def test_read_hdr_matches_the_jax_reader():
    got = io.read_hdr(PROBE)
    want = jhdr.read(PROBE)
    assert got.shape == want.shape == (256, 512, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with open(PROBE, "rb") as f:
        np.testing.assert_array_equal(io.read_hdr(f.read()), want)


def test_read_hdr_old_style_records_and_header_scale(tmp_path):
    """An old-style (packed, run-marker) file with EXPOSURE and COLORCORR."""
    rgbe = np.array([[[128, 64, 32, 130], [1, 1, 1, 3]]], np.uint8)
    data = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nEXPOSURE=2\nCOLORCORR=1 2 4\n\n"
            b"-Y 1 +X 4\n" + rgbe.tobytes())
    np.testing.assert_array_equal(io.read_hdr(data), jhdr.read(data))
    with pytest.raises(io.HDRError):
        io.read_hdr(b"#?RADIANCE\nFORMAT=other\n\n-Y 1 +X 1\n\x00\x00\x00\x00")


def test_load_by_extension(tmp_path):
    img = np.random.default_rng(0).uniform(0, 1, (3, 5, 3)).astype(np.float32)
    jbmp.write(str(tmp_path / "a.bmp"), img)
    got = io.load(tmp_path / "a.bmp")
    assert got.shape == (3, 5, 4)
    np.testing.assert_array_equal(
        got[..., :3], jbmp.read(str(tmp_path / "a.bmp")).astype(np.float32) / 255.0)
    np.testing.assert_array_equal(io.load(PROBE), jhdr.read(PROBE))
    io.write_png(tmp_path / "a.png", img)
    assert io.load(tmp_path / "a.png").shape == (3, 5, 4)
    with pytest.raises(ValueError, match="invalid format"):
        io.load(tmp_path / "a.tga")


def test_composed_spec_builds_the_jax_params():
    jw, jcam, jopts = JaxSceneSpec.load(COMPOSED).build()
    tw, tcam, topts = SceneSpec.load(COMPOSED).build()
    fields = lambda c: (c.width, c.height, c.screen_width, c.screen_height,
                        c.screen_distance, c.pose)
    assert fields(tcam) == fields(jcam) == (512, 512, 512.0, 512.0, 1024.0, None)
    assert topts == jopts == {"spp": 16, "depth": 8}
    js = jtr.compile_scene(jw, pallas=False)
    ts = trace.compile_scene(tw, "cpu")
    want = params_from_jax(jax.tree.map(np.asarray, js.params), "cpu")
    assert set(ts.params) == set(want)
    for k, w in want.items():
        got = ts.params[k]
        for a, b in zip(*(x if isinstance(x, list) else [x] for x in (got, w))):
            assert a.shape == b.shape, k
            if k == "xform":
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
            else:
                assert torch.equal(a, b), k
    # 52 leaves with transformed spheres: K5's 32-column table, tile ordering
    assert isinstance(ts.hit_fn, MegaHit) and ts.tile_hint
    assert ts.plain_hit_fn.layout.L == 52 and ts.plain_hit_fn.layout.tw == 32


@pytest.mark.parametrize("spec", [{"translate": [1.0, -2.0, 0.5]}, {"scale": [1.2, 0.8, 1.0]},
                                  {"scale": 2.0}, {"rotate_y": 0.7}, {"rotate_z": -1.1},
                                  {"rotate": {"axis": [1.0, 2.0, 0.5], "angle": 0.3}},
                                  [{"rotate_x": 1.5708}, {"translate": [0.0, 1.0, 0.0]}]])
def test_parse_transform_matches_jax(spec):
    from ptx.scenes.spec import parse_transform as jparse
    np.testing.assert_allclose(parse_transform(spec), jparse(spec), rtol=1e-6, atol=1e-6)
