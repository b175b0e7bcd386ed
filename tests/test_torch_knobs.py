"""The JAX package's routing knobs in the port: ``compile_scene(fast=,
pallas=)``, ``PTX_PALLAS``, ``PTX_FUSED``, ``PTX_SKYSEL`` and
``trace_rays(manual_vjp=)``.

- the routes each knob picks (the hit, the bounce and its backward, K7,
  the tile ordering), on the demo and on a 27-leaf union of spheres; the
  requests that raise: the kernels on the CPU, the manual VJP without a
  hit replay; and plain autograd through K4's wrapper (its hit replay
  VJP), whose gradient matches the JAX package's plain autodiff;
- on the demo (8×6, spp 2, depth 3, the mean radiance), the port under
  each knob against the JAX package under the same knob: ``PTX_PALLAS=0``,
  ``fast=False`` (the span merge under plain autodiff),
  ``manual_vjp=False`` and ``PTX_SKYSEL=0``; ``PTX_FUSED=0`` on BASELINE
  config 1 (JAX: ``PTX_PALLAS=1``, its hit kernel in interpret mode, whose
  build for the demo's 13 leaves takes over a minute here; config 1 has
  8).  Radiance within ``rtol 1e-4,
  atol 1e-5`` (``tests/test_torch_trace.py``), the loss within 1e-5
  relative and each param's gradient within ``1e-4 · max|g| + 1e-7``
  (``tests/test_torch_grad.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.integrate import trace as jtr
from ptx.integrate.camera import Camera as JCamera, sample_rays as jax_sample_rays
from ptx.scenes.builders import baseline_config1 as jax_config1
from ptx.scenes.builders import make_world as jax_make_world
from ptx_torch.convert import grads_to_numpy, params_from_jax, scene_from_jax
from ptx_torch.core import rng
from ptx_torch.integrate import trace
from ptx_torch.integrate.camera import Camera, sample_rays
from ptx_torch.ops.bounce_kernel import BounceBwdKernel, BounceKernel
from ptx_torch.ops.fasthit_kernel import HitKernel
from ptx_torch.ops.megasweep import MegaHit, SweepHit
from ptx_torch.ops.replay_bwd import RowFedReplayBwd
from ptx_torch.scenes.builders import make_world, stress_spheres
from ptx_torch.shade.bounce import ReplayVJP

torch.set_num_threads(1)
W, H, SPP, DEPTH = 8, 6, 2, 3
KNOBS = ("PTX_PALLAS", "PTX_FUSED", "PTX_SKYSEL", "PTX_EMK", "PTX_MEGAB")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _route(scene):
    replay = isinstance(scene.bounce_bwd_fn, ReplayVJP)
    return (type(scene.hit_fn).__name__, type(scene.bounce_fn).__name__,
            "replay_vjp" if replay else type(scene.bounce_bwd_fn).__name__,
            scene.emission_fn is not None, scene.tile_hint)


def test_routes_on_the_demo(monkeypatch):
    s = trace.compile_scene(make_world(), "cpu")
    assert isinstance(s.hit_fn, HitKernel) and isinstance(s.bounce_fn, BounceKernel)
    assert isinstance(s.bounce_bwd_fn, BounceBwdKernel) and s.spans_fn is not None
    monkeypatch.setenv("PTX_EMK", "1")
    assert _route(trace.compile_scene(make_world(), "cpu"))[3]
    monkeypatch.setenv("PTX_FUSED", "0")           # K4 stays, the fused bounce and K7 go
    assert _route(trace.compile_scene(make_world(), "cpu")) == (
        "HitKernel", "UnfusedBounce", "replay_vjp", False, False)
    monkeypatch.setenv("PTX_FUSED", "1")
    monkeypatch.setenv("PTX_PALLAS", "0")          # the plain route, asked for
    s = trace.compile_scene(make_world(), "cpu")
    assert _route(s) == ("DenseHit", "UnfusedBounce", "replay_vjp", False, False)
    assert s.hit_fn is s.plain_hit_fn
    s = trace.compile_scene(make_world(), "cpu", fast=False)
    assert (s.hit_fn, s.hit_replay_fn, s.bounce_fn, s.bounce_bwd_fn, s.emission_fn) == \
        (None,) * 5


def test_routes_on_a_large_union(monkeypatch):
    root = stress_spheres(20)
    assert _route(trace.compile_scene(root, "cpu")) == (
        "MegaHit", "MegaBounce", "RowFedReplayBwd", False, True)
    monkeypatch.setenv("PTX_FUSED", "0")
    s = trace.compile_scene(root, "cpu")
    assert _route(s) == ("MegaHit", "UnfusedBounce", "replay_vjp", False, True)
    assert not isinstance(s.bounce_bwd_fn, RowFedReplayBwd)
    s = trace.compile_scene(root, "cpu", pallas=False)
    assert isinstance(s.hit_fn, SweepHit) and not isinstance(s.hit_fn, MegaHit)
    assert _route(s)[1:] == ("UnfusedBounce", "replay_vjp", False, False)


def test_requests_that_raise(monkeypatch):
    with pytest.raises(ValueError, match="no kernel runs on cpu"):
        trace.compile_scene(make_world(), "cpu", pallas=True)
    monkeypatch.setenv("PTX_PALLAS", "1")
    with pytest.raises(ValueError, match="no kernel runs on cpu"):
        trace.compile_scene(make_world(), "cpu")
    trace.compile_scene(make_world(), "cpu", pallas=False)     # the argument wins
    monkeypatch.delenv("PTX_PALLAS")
    o, d = sample_rays(Camera.reference_demo(W, H), rng.PRNGKey(0), range(H), range(W), 1,
                       "cpu")
    # plain autograd through K4's wrapper: its hit replay VJP, as JAX's
    # plain autodiff through its hit (JAX side: the dense hit, pallas=False)
    s = trace.compile_scene(make_world(), "cpu")
    assert isinstance(s.hit_fn, HitKernel)
    js = jtr.compile_scene(jax_make_world(), pallas=False)
    s.params = params_from_jax(jax.tree.map(np.asarray, js.params), "cpu")
    kj = jax.random.PRNGKey(0)
    oj, dj = jax_sample_rays(JCamera.reference_demo(W, H), kj, jnp.arange(H), jnp.arange(W),
                             SPP)
    g_j = jax.jit(jax.grad(lambda p: jnp.mean(jtr.trace_rays(js, p, oj, dj, kj, DEPTH,
                                                            manual_vjp=False))))(js.params)
    p = {k: ([x.clone().requires_grad_(True) for x in v] if isinstance(v, list)
             else v.clone().requires_grad_(True)) for k, v in s.params.items()}
    ot, dt = sample_rays(Camera.reference_demo(W, H), rng.PRNGKey(0), range(H), range(W),
                         SPP, "cpu")
    trace.trace_rays(s, p, ot, dt, rng.PRNGKey(0), DEPTH, manual_vjp=False).mean().backward()
    g_t, g_j = grads_to_numpy(p), jax.tree.map(np.asarray, g_j)
    for k in g_j:
        for a, b in zip(*(x if isinstance(x, list) else [x] for x in (g_t[k], g_j[k]))):
            scale = np.abs(b).max() if b.size else 0.0
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale + 1e-7, err_msg=k)
    assert np.abs(g_t["sphere_radius"]).sum() > 0
    s = trace.compile_scene(make_world(), "cpu", fast=False)
    with pytest.raises(ValueError, match="needs the hit replay"):
        trace.trace_rays(s, s.params, o, d, rng.PRNGKey(0), 2, manual_vjp=True)


def test_skysel_is_read_at_each_call(monkeypatch):
    s = trace.compile_scene(make_world(), "cpu")
    o, d = sample_rays(Camera.reference_demo(W, H), rng.PRNGKey(0), range(H), range(W), 1,
                       "cpu")
    calls = []
    full = s.material_fn.eval_emissive
    monkeypatch.setattr(s.material_fn, "eval_emissive",
                        lambda *a: calls.append(1) or full(*a))
    on = trace.trace_rays(s, s.params, o, d, rng.PRNGKey(0), DEPTH)
    assert calls == []                             # sky-select + mat-sum
    monkeypatch.setenv("PTX_SKYSEL", "0")
    off = trace.trace_rays(s, s.params, o, d, rng.PRNGKey(0), DEPTH)
    assert calls == [1]                            # every lane's emissive chain
    assert torch.equal(off, trace.trace_rays(s, s.params, o, d, rng.PRNGKey(0), DEPTH,
                                             skysel=False))
    torch.testing.assert_close(on, off, rtol=1e-4, atol=1e-5)


# (scene, port env, port compile_scene kw, port trace_rays kw, JAX env, JAX compile kw,
#  JAX trace_rays kw)
CASES = {
    "PTX_FUSED=0": (jax_config1, {"PTX_FUSED": "0"}, {}, {},
                    {"PTX_PALLAS": "1", "PTX_FUSED": "0"}, {}, {}),
    "PTX_PALLAS=0": (jax_make_world, {"PTX_PALLAS": "0"}, {}, {}, {"PTX_PALLAS": "0"}, {}, {}),
    "fast=False": (jax_make_world, {}, {"fast": False}, {}, {},
                   {"fast": False, "pallas": False}, {}),
    "manual_vjp=False": (jax_make_world, {}, {"pallas": False}, {"manual_vjp": False},
                         {}, {"pallas": False}, {"manual_vjp": False}),
    "PTX_SKYSEL=0": (jax_make_world, {"PTX_SKYSEL": "0"}, {}, {}, {"PTX_SKYSEL": "0"},
                     {"pallas": False}, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_knob_matches_jax(monkeypatch, case):
    build, penv, pkw, ptkw, jenv, jkw, jtkw = CASES[case]
    root = build()
    for k, v in jenv.items():
        monkeypatch.setenv(k, v)
    js = jtr.compile_scene(root, **jkw)
    kj = jax.random.PRNGKey(0)
    o, d = jax_sample_rays(JCamera.reference_demo(W, H), kj, jnp.arange(H), jnp.arange(W), SPP)
    def mean_and_radiance(p):
        rad = jtr.trace_rays(js, p, o, d, kj, DEPTH, **jtkw)
        return jnp.mean(rad), rad
    (loss_j, rad_j), g_j = jax.jit(jax.value_and_grad(mean_and_radiance, has_aux=True))(
        js.params)
    for k in jenv:
        monkeypatch.delenv(k)

    for k, v in penv.items():
        monkeypatch.setenv(k, v)
    ts = trace.compile_scene(scene_from_jax(root), "cpu", **pkw)
    p = params_from_jax(jax.tree.map(np.asarray, js.params), "cpu")
    ot, dt = sample_rays(Camera.reference_demo(W, H), rng.PRNGKey(0), range(H), range(W),
                         SPP, "cpu")
    with torch.no_grad():
        rad_t = trace.trace_rays(ts, p, ot, dt, rng.PRNGKey(0), DEPTH, **ptkw)
    np.testing.assert_allclose(rad_t.numpy(), np.asarray(rad_j), rtol=1e-4, atol=1e-5)
    for x in (y for v in p.values() for y in (v if isinstance(v, list) else [v])):
        x.requires_grad_(True)
    loss_t = trace.trace_rays(ts, p, ot, dt, rng.PRNGKey(0), DEPTH, **ptkw).mean()
    loss_t.backward()
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    g_t, g_j = grads_to_numpy(p), jax.tree.map(np.asarray, g_j)
    for k in g_j:
        for a, b in zip(*(x if isinstance(x, list) else [x] for x in (g_t[k], g_j[k]))):
            scale = np.abs(b).max() if b.size else 0.0
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale + 1e-7, err_msg=k)
    for k in ("sphere_center", "sphere_radius", "const"):
        assert np.abs(g_t[k]).sum() > 0, k
    if case == "PTX_FUSED=0":
        assert isinstance(ts.hit_fn, HitKernel) and not isinstance(ts.bounce_fn, BounceKernel)
