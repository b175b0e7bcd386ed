"""The port's entry point and its routing rules.

- ``python -m ptx_torch render`` runs on the CPU when asked and never
  imports jax (the card's machine has none);
- on CUDA a scene the fused bounce kernel cannot take raises
  ``NotImplementedError`` at compile time — before touching the device,
  so this holds on a host without a card too; no quiet fallback.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ptx_torch.geom.tape import Plane, Sphere, Union
from ptx_torch.integrate import trace
from ptx_torch.ops import bounce_kernel
from ptx_torch.scenes import builders
from ptx_torch.shade import textures as tx
from ptx_torch.shade.materials import Material

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
from ptx_torch.cli import main
frame = main(sys.argv[1:])
print("JAX_IMPORTED", "jax" in sys.modules)
print("PTX_FILES", [m for m, mod in sys.modules.items()
                    if "/ptx/" in (getattr(mod, "__file__", None) or "")])
import numpy as np
assert frame.shape == (8, 8, 3) and np.isfinite(frame).all() and frame.mean() > 0
np.save(sys.argv[-1] + ".npy", frame)
"""


def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get(
        "PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-c", _PROBE, *args], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)


def test_cli_cpu_render_without_jax(tmp_path):
    out = str(tmp_path / "img")
    proc = _run(["render", "--demo", "demo", "--device", "cpu", "--width", "8",
                 "--height", "8", "--spp", "1", "--depth", "2", "--out", out],
                tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "rays/s" in proc.stdout
    assert "JAX_IMPORTED False" in proc.stdout
    assert "PTX_FILES []" in proc.stdout
    # the port's writers: same bytes as the JAX package's, read back by it
    from ptx.io import bmp, hdr
    frame = np.load(out + ".npy")
    assert bmp.read(out + ".bmp").shape == (8, 8, 3)
    assert hdr.read(out + ".hdr").shape[:2] == (8, 8)
    bmp.write(str(tmp_path / "ref.bmp"), frame)
    hdr.write(str(tmp_path / "ref.hdr"), frame)
    for ext in ("bmp", "hdr"):
        assert (tmp_path / f"ref.{ext}").read_bytes() == open(
            f"{out}.{ext}", "rb").read(), ext


def test_cli_module_entry_point(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get(
        "PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "ptx_torch", "render", "--device", "cpu",
         "--width", "8", "--height", "8", "--spp", "1", "--depth", "2",
         "--out", str(tmp_path / "m")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "m.bmp").exists() and (tmp_path / "m.hdr").exists()


def test_cli_cuda_default_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device renders")
    proc = _run(["render", "--width", "8", "--height", "8", "--spp", "1",
                 "--depth", "2", "--out", str(tmp_path / "x")], tmp_path)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def _textured_world():
    """A textured reflect slot (the unfused bounce) on 27 leaves."""
    checker = np.ones((4, 4, 4), np.float32)
    textured = Material(reflect=tx.TransformedTex(
        np.eye(3, 4, dtype=np.float32), tx.ImageTex(checker)), scatter=1.0)
    sky = Material(reflect=0.0, scatter=0.0, emissive=(0.7, 0.8, 1.0))
    return Union(*(Sphere((0.1 * i, 0.0, -4.0), 0.05, textured) for i in range(21)),
                 *builders.sky_planes(sky))


def _big_world():
    mat = Material(reflect=0.5, scatter=1.0)
    sky = Material(reflect=0.0, scatter=0.0, emissive=1.0)
    return Union(*(Sphere((0.1 * i, 0.0, -4.0), 0.05, mat) for i in range(20)),
                 *builders.sky_planes(sky))


@pytest.mark.parametrize("world", [_textured_world, _big_world],
                         ids=["dynamic-reflect", "26-leaves"])
def test_cuda_compile_rejects_ineligible_scene(world):
    """More than 24 leaves: the large-scene kernels K5/K6 are not ported."""
    with pytest.raises(NotImplementedError, match="K5.*K6.*ROADMAP"):
        trace.compile_scene(world(), "cuda")
    # the CPU keeps the plain bounce (constant slots) or the unfused one
    # on the dense hit (a textured slot) for such scenes
    scene = trace.compile_scene(world(), "cpu")
    assert scene.hit_fn is scene.plain_hit_fn
    if world is _textured_world:
        assert isinstance(scene.bounce_fn, trace.UnfusedBounce)
    else:
        assert scene.bounce_fn.func is bounce_kernel.bounce_reference


def test_cuda_compile_accepts_the_demo_routing():
    scene = trace.compile_scene(builders.make_world(), "cpu")
    # K1-eligible: 13 leaves
    assert isinstance(scene.bounce_fn, bounce_kernel.BounceKernel)
