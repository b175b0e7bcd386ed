"""The port's entry point and its routing rules.

- ``python -m ptx_torch render`` runs on the CPU when asked and never
  imports jax (the card's machine has none);
- ``compile_scene`` routes alike on every device: what it picks for a
  scene on the CPU is what it picks on the card, where every kernel
  wrapper launches its kernel or raises (no quiet fallback);
- ``render --scene scenes/composed.json`` (52 leaves: the large-scene
  path) runs on the CPU and never imports jax;
- ``render``, ``serve`` and ``farm`` take the JAX CLI's flags (``serve``
  refuses the default ``--device cuda`` without a card, as ``render``
  does); ``render --adaptive`` runs on the CPU and resumes from its
  checkpoint to the uninterrupted image.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ptx_torch.geom import fasthit
from ptx_torch.geom.tape import Intersection, Plane, Sphere, Union
from ptx_torch.integrate import trace
from ptx_torch.ops import bounce_kernel, megasweep
from ptx_torch.ops.replay_bwd import RowFedReplayBwd
from ptx_torch.scenes import builders
from ptx_torch.shade import bounce
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
assert frame.shape[2] == 3 and np.isfinite(frame).all() and frame.mean() > 0
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
    """A textured reflect slot (the unfused bounce) on 28 leaves, 21 of them
    in one intersection: not a union of small groups."""
    checker = np.ones((4, 4, 4), np.float32)
    textured = Material(reflect=tx.TransformedTex(
        np.eye(3, 4, dtype=np.float32), tx.ImageTex(checker)), scatter=1.0)
    sky = Material(reflect=0.0, scatter=0.0, emissive=(0.7, 0.8, 1.0))
    return Union(Intersection(Sphere((1.0, 0.0, -4.0), 3.0, textured),
                              Union(*(Sphere((0.1 * i, 0.0, -4.0), 0.05, textured)
                                      for i in range(20)))),
                 *builders.sky_planes(sky))


def _big_world():
    """26 leaves, 20 of them in one intersection."""
    mat = Material(reflect=0.5, scatter=1.0)
    sky = Material(reflect=0.0, scatter=0.0, emissive=1.0)
    return Union(Intersection(Sphere((1.0, 0.0, -4.0), 3.0, mat),
                              Union(*(Sphere((0.1 * i, 0.0, -4.0), 0.05, mat)
                                      for i in range(19)))),
                 *builders.sky_planes(sky))


@pytest.mark.parametrize("world", [_textured_world, _big_world],
                         ids=["dynamic-reflect", "26-leaves"])
def test_cuda_compile_rejects_ineligible_scene(world):
    """More than 24 leaves that are not a union of small groups: no hit
    kernel takes them, and the JAX package folds them densely in XLA.
    ``compile_scene``, whose routing reads no device, gives them the dense
    hit in plain PyTorch, the unfused bounce on it, and the replay
    backward: K6's wrapper on constant slots, autograd of the replay on a
    textured slot."""
    scene = trace.compile_scene(world(), "cpu")
    assert scene.hit_fn is scene.plain_hit_fn
    assert not isinstance(scene.hit_fn, (megasweep.SweepHit, fasthit.UnionSweepHit,
                                         fasthit.BlockedHit))
    assert isinstance(scene.bounce_fn, bounce.UnfusedBounce) and scene.tile_hint
    if world is _textured_world:
        assert isinstance(scene.bounce_bwd_fn, bounce.ReplayVJP)
    else:
        assert isinstance(scene.bounce_bwd_fn, RowFedReplayBwd)


def test_cuda_compile_accepts_the_demo_routing():
    scene = trace.compile_scene(builders.make_world(), "cpu")
    # K1-eligible: 13 leaves
    assert isinstance(scene.bounce_fn, bounce_kernel.BounceKernel)


def test_cli_scene_spec_render_without_jax(tmp_path):
    """The large-scene path from the CLI: the composed spec (52 leaves, a
    52-leaf union under the HDR probe), its camera overridden by the flags."""
    out = str(tmp_path / "composed")
    proc = _run(["render", "--scene", os.path.join(ROOT, "scenes", "composed.json"),
                 "--device", "cpu", "--width", "32", "--height", "16", "--spp", "1",
                 "--depth", "2", "--out", out], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_IMPORTED False" in proc.stdout and "PTX_FILES []" in proc.stdout
    assert np.load(out + ".npy").shape == (16, 32, 3)


@pytest.mark.parametrize("argv, want", [
    (["render", "--adaptive", "--checkpoint", "c.npz", "--preview", "--device", "cpu"],
     dict(adaptive=True, checkpoint="c.npz", preview=True, device="cpu", spp_chunk=1,
          rays_per_chunk=2 ** 16)),
    (["serve", "--port", "0", "--bind", "0.0.0.0", "--max-inflight", "3", "--chunk-rows",
      "8", "--adaptive", "--adaptive-rounds", "3", "--adaptive-frac", "0.5", "--demo",
      "config4"],
     dict(port=0, bind="0.0.0.0", max_inflight=3, chunk_rows=8, adaptive=True,
          adaptive_rounds=3, adaptive_frac=0.5, demo="config4", device="cuda")),
    (["serve"], dict(port=12346, bind="127.0.0.1", max_inflight=0, chunk_rows=16,
                     adaptive=False, adaptive_rounds=2, adaptive_frac=0.25)),
    (["farm", "h1:1", "h2", "--tile", "32", "--parallel", "2", "--spp", "4"],
     dict(addresses=["h1:1", "h2"], port=12346, tile=32, parallel=2, spp=4)),
], ids=["render", "serve", "serve-defaults", "farm"])
def test_cli_parses_the_jax_flags(argv, want):
    from ptx_torch import cli

    args = vars(cli.parser().parse_args(argv))
    assert {k: args[k] for k in want} == want
    assert "device" not in args or argv[0] != "farm"


def test_cli_serve_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device serves")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get(
        "PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "ptx_torch", "serve", "--port", "0",
                           "--width", "8", "--height", "8"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_cli_adaptive_render_and_resume(tmp_path, capsys):
    """``render --adaptive`` on the CPU: base 2 spp, 4 rounds of 8 pixels ×
    4 spp on the 8×8 frame (mean 4 spp); stopped after round 2 with its
    checkpoint written, the command resumes to the uninterrupted image."""
    from ptx_torch import cli
    from ptx_torch.core import rng
    from ptx_torch.integrate.adaptive import render_adaptive
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.parallel.checkpoint import AdaptiveCheckpoint

    argv = ["render", "--adaptive", "--device", "cpu", "--width", "8", "--height", "8",
            "--spp", "4", "--depth", "2", "--out", str(tmp_path / "x")]
    whole = cli.main(argv + ["--checkpoint", str(tmp_path / "w.npz")])
    assert "adaptive spp 2-" in capsys.readouterr().out
    done = AdaptiveCheckpoint(8, 8, str(tmp_path / "w.npz"))
    assert done.rounds_done == 4 and done.count.sum() == 8 * 8 * 2 + 4 * 8 * 4
    np.testing.assert_array_equal(whole, done.s1 / done.count[..., None])

    part = AdaptiveCheckpoint(8, 8, str(tmp_path / "p.npz"))

    def stop_after_round_2(*state):
        part.update(*state)
        if state[3] == 2:
            raise KeyboardInterrupt

    scene = trace.compile_scene(builders.make_world(), "cpu")
    with pytest.raises(KeyboardInterrupt):
        render_adaptive(scene, Camera.reference_demo(8, 8), rng.PRNGKey(0), spp_base=2,
                        rounds=4, frac=0.125, spp_refine=4, depth=2,
                        on_round=stop_after_round_2)
    resumed = cli.main(argv + ["--checkpoint", str(tmp_path / "p.npz")])
    np.testing.assert_array_equal(resumed, whole)
