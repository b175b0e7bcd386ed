"""The BASELINE configs 1-4 in the port: built by the port's builders,
rendered on the CPU against the JAX package's goldens, compiled to the
JAX package's tables, and routed as its ``compile_scene`` routes them.

Goldens: ``tests/goldens/config{1..4}.npz``, ``Camera(32, 24)``, spp 32,
depth 6, key 0 (``tests/make_goldens.py``).  Same keys give the same
paths, so the images differ only by float32 rounding: ``rtol 1e-4, atol
1e-5``, the port's render tolerance.
"""

import os

import numpy as np
import jax
import pytest
import torch

from ptx.integrate import trace as jtr
from ptx.scenes import builders as jbuilders
from ptx_torch import cli
from ptx_torch.convert import params_from_jax
from ptx_torch.core import rng
from ptx_torch.integrate import trace
from ptx_torch.integrate.camera import Camera
from ptx_torch.integrate.render import render
from ptx_torch.ops.emission_kernel import EmissionKernel
from ptx_torch.ops.fasthit_kernel import HitKernel
from ptx_torch.ops.bounce_kernel import BounceKernel
from ptx_torch.scenes import builders
from ptx_torch.shade import bounce

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
CONFIGS = ("config1", "config2", "config3", "config4")


@pytest.mark.parametrize("name", CONFIGS)
def test_render_matches_golden(name):
    scene = trace.compile_scene(builders.DEMOS[name](), "cpu")
    with torch.no_grad():
        got = render(scene, Camera(32, 24), rng.PRNGKey(0), spp=32, depth=6).numpy()
    want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["img"]
    assert got.shape == want.shape and want.mean() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_tables_match_jax(name):
    """The port's builders give the JAX package's params (transform-derived
    entries within 1e-6: each package rounds its own cos/sin) and the same
    slot routing."""
    js = jtr.compile_scene(getattr(jbuilders, f"baseline_{name}")(), pallas=False)
    ts = trace.compile_scene(builders.DEMOS[name](), "cpu")
    jp = jax.tree.map(np.asarray, js.params)
    assert set(jp) == set(ts.params)
    for k, v in jp.items():
        for a, b in zip(*(x if isinstance(x, list) else [x] for x in (v, ts.params[k]))):
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6, err_msg=k)
    assert ts.material_fn.dynamic_slots == js.material_fn.dynamic_slots
    assert ([(mi, spec) for mi, spec in ts.material_fn.emissive_dynamic_specs]
            == list(js.material_fn.emissive_dynamic_specs))


def test_config4_dynamic_slots_match_the_jax_table():
    """Reflect, scatter and transmit of every material at random positions
    on config 4 (the checker-textured reflect slot among them)."""
    root = jbuilders.baseline_config4()
    js = jtr.compile_scene(root, pallas=False)
    ts = trace.compile_scene(builders.baseline_config4(), "cpu")
    ts.params = params_from_jax(jax.tree.map(np.asarray, js.params), "cpu")
    r = np.random.default_rng(0)
    pos = r.uniform(-6.0, 6.0, (512, 3)).astype(np.float32)
    mid = r.integers(0, ts.material_fn.n_materials, 512)
    want = js.material_fn(js.params, pos, mid.astype(np.int32))
    got = ts.material_fn(ts.params, torch.from_numpy(pos), torch.from_numpy(mid))
    for k in ("reflect", "scatter", "transmit", "scatter_f", "transmit_reflect_f", "ior"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert ts.material_fn.dynamic_slots["reflect"] == [0]


def test_routing_follows_the_jax_package(monkeypatch):
    """Configs 1-3: K1/K2; config 4 (textured reflect slot): the unfused
    bounce on K4 with the full-param replay backward; every scene of at
    most 24 leaves gets K4's hit; ``PTX_EMK=1`` gives the demo K7."""
    for name in CONFIGS:
        scene = trace.compile_scene(builders.DEMOS[name](), "cpu")
        assert isinstance(scene.hit_fn, HitKernel)
        assert scene.emission_fn is None          # every dynamic emitter is terminal
        if name == "config4":
            assert isinstance(scene.bounce_fn, bounce.UnfusedBounce)
            assert isinstance(scene.bounce_bwd_fn, bounce.ReplayVJP)
            assert scene.diff_keys == bounce.DIFF_KEYS + bounce.TEXTURE_KEYS
        else:
            assert isinstance(scene.bounce_fn, BounceKernel)
            assert scene.diff_keys == bounce.DIFF_KEYS
    monkeypatch.setenv("PTX_EMK", "1")
    scene = trace.compile_scene(builders.make_world(), "cpu")
    assert isinstance(scene.emission_fn, EmissionKernel)
    monkeypatch.setenv("PTX_EMK", "0")
    assert trace.compile_scene(builders.make_world(), "cpu").emission_fn is None


def test_cli_renders_config4_on_the_cpu(tmp_path):
    frame = cli.main(["render", "--demo", "config4", "--device", "cpu", "--width", "8",
                      "--height", "6", "--spp", "1", "--depth", "3",
                      "--out", str(tmp_path / "c4")])
    assert frame.shape == (6, 8, 3) and np.isfinite(frame).all() and frame.mean() > 0
    assert (tmp_path / "c4.bmp").exists() and (tmp_path / "c4.hdr").exists()
