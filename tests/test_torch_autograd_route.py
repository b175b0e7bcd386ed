"""The port's plain-autograd route: ``trace_rays(manual_vjp=False,
remat=)`` and ``make_train_step(manual_vjp=False, remat=)`` on every hit
the scene has, and K4's hit replay VJP.

- K4's wrapper (``HitKernel``) on the CPU: its ``t`` and normal go through
  ``fasthit.HitReplay`` (the plain dense hit's values forward, autograd of
  the hit replay at the frozen decisions backward), held against autograd
  of the dense hit itself within ``rtol 1e-5`` (+``1e-5·max|g|``): the
  two are the same function, written two ways;
- ``trace_rays(manual_vjp=False)`` on the default route (the demo on K4's
  wrapper, a 27-leaf union of spheres on K5's hit-mode wrapper, both
  running their plain versions here) against the JAX package's
  ``manual_vjp=False, pallas=False`` and against the port's manual route:
  the loss within ``rel 1e-6``, the radiance within ``rtol 1e-4, atol
  1e-5``, every gradient within ``rtol 2e-3, atol 2e-5``
  (tests/test_gradients.py's tolerance for the manual VJP against plain
  autodiff);
- ``remat`` on against off, bit for bit, and the hit calls the recompute
  adds (every bounce but the last, whose carry feeds nothing);
- one ``make_train_step(remat=True, manual_vjp=False)`` step against the
  JAX package's on a 1×1 mesh (tests/test_torch_train.py's rule).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.integrate import trace as jtr
from ptx.integrate.camera import Camera as JCamera, sample_rays as jax_sample_rays
from ptx.parallel import mesh as pmesh
from ptx.parallel.render import make_train_step as jax_make_train_step
from ptx.parallel.render import render_sharded
from ptx.scenes.builders import make_world as jax_make_world
from ptx.scenes.builders import stress_spheres as jax_stress_spheres
from ptx_torch.convert import grads_to_numpy, params_from_jax, scene_from_jax
from ptx_torch.core import rng
from ptx_torch.geom.fasthit import GEO_KEYS
from ptx_torch.integrate import trace
from ptx_torch.integrate.camera import Camera, sample_rays
from ptx_torch.ops import fasthit_kernel, megasweep
from ptx_torch.ops.fasthit_kernel import HitKernel
from ptx_torch.parallel.render import make_train_step

torch.set_num_threads(1)
W, H, SPP, DEPTH = 8, 6, 2, 5
SCENES = {"demo": (jax_make_world, HitKernel), "spheres20": (lambda: jax_stress_spheres(20),
                                                             megasweep.MegaHit)}


def _leaves(params):
    return {k: ([x.clone().requires_grad_(True) for x in v] if isinstance(v, list)
                else v.clone().requires_grad_(True)) for k, v in params.items()}


def _hit_calls():
    return fasthit_kernel.REFERENCE_CALLS + megasweep.REFERENCE_CALLS


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    build, kind = SCENES[request.param]
    root = build()
    js = jtr.compile_scene(root, pallas=False)
    ts = trace.compile_scene(scene_from_jax(root), "cpu")
    assert isinstance(ts.hit_fn, kind)
    ts.params = params_from_jax(jax.tree.map(np.asarray, js.params), "cpu")
    return request.param, js, ts


def _port(ts, manual_vjp, remat=True, depth=DEPTH, compact=False):
    o, d = sample_rays(Camera.reference_demo(W, H), rng.PRNGKey(0), range(H), range(W),
                       SPP, "cpu")
    p = _leaves(ts.params)
    rad = trace.trace_rays(ts, p, o, d, rng.PRNGKey(0), depth, manual_vjp=manual_vjp,
                           remat=remat, compact=compact)
    loss = rad.mean()
    loss.backward()
    return float(loss.detach()), rad.detach().numpy(), grads_to_numpy(p)


def _close(g_t, g_j, rtol, atol):
    for k in g_j:
        for a, b in zip(*(x if isinstance(x, list) else [x] for x in (g_t[k], g_j[k]))):
            assert a.shape == b.shape and np.isfinite(a).all(), k
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=k)


def test_hit_kernel_vjp_matches_dense_autograd():
    """Σ w·t + Σ v·normal over 1,024 demo rays and 256 rays from inside
    the spheres: the gradient of every geometry param and of the rays
    through K4's wrapper equals the dense hit's autograd; without an input
    that needs a gradient the wrapper records nothing."""
    from ptx_torch.scenes.builders import make_world

    s = trace.compile_scene(make_world(), "cpu")
    o, d = sample_rays(Camera.reference_demo(32, 32), rng.PRNGKey(3), range(32), range(32), 1,
                       "cpu")
    g = np.random.default_rng(0)
    c = s.params["sphere_center"].numpy()
    pick = g.integers(0, len(c), 256)
    o = torch.cat([o.reshape(-1, 3), torch.from_numpy(
        (c[pick] + g.uniform(-0.2, 0.2, (256, 3))).astype(np.float32))])
    d = torch.cat([d.reshape(-1, 3), torch.from_numpy(g.normal(size=(256, 3)).astype(
        np.float32))])
    w = torch.from_numpy(g.uniform(-1, 1, len(o)).astype(np.float32))
    v = torch.from_numpy(g.uniform(-1, 1, (len(o), 3)).astype(np.float32))

    def grads(hit_fn):
        p = {k: s.params[k].clone().requires_grad_(True) for k in GEO_KEYS}
        rays = [o.clone().requires_grad_(True), d.clone().requires_grad_(True)]
        out = hit_fn(dict(s.params, **p), *rays)
        hit = out["hit"]
        loss = (w * out["t"]).sum() + (v * torch.where(hit[:, None], out["normal"],
                                                        0.0)).sum()
        return out, dict(zip([*GEO_KEYS, "o", "d"], torch.autograd.grad(
            loss, [*p.values(), *rays], allow_unused=True)))

    calls = fasthit_kernel.REFERENCE_CALLS
    out_k, g_k = grads(s.hit_fn)
    assert fasthit_kernel.REFERENCE_CALLS == calls + 1
    out_p, g_p = grads(s.plain_hit_fn)
    assert int(out_p["hit"].sum()) > 1000
    for k in out_p:
        assert torch.equal(out_k[k], out_p[k]), k
    for k, want in g_p.items():
        got = g_k[k]
        if want is None:
            assert got is None or not bool(got.any()), k
            continue
        if k in ("sphere_center", "sphere_radius", "plane_d", "o", "d"):
            assert bool(want.abs().sum() > 0), k
        scale = float(want.abs().max()) if want.numel() else 0.0
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale, msg=k)
    with torch.no_grad():
        assert s.hit_fn(s.params, o, d)["t"].grad_fn is None
    assert s.hit_fn(s.params, o, d)["t"].grad_fn is None      # no input needs a gradient


@pytest.mark.parametrize("compact", [False, True], ids=["flat", "compacted"])
def test_autograd_route_matches_jax_and_the_manual_route(pair, compact):
    """8×6 pixels, spp 2, depth 5, ``mean(radiance)`` on the default route;
    compacted: phases at 1/3 and 1/16 width from bounces 2 and 6 (depth 5
    reaches the first), with resampling and filler lanes."""
    name, js, ts = pair
    kj = jax.random.PRNGKey(0)
    o, d = jax_sample_rays(JCamera.reference_demo(W, H), kj, jnp.arange(H), jnp.arange(W), SPP)

    def mean_and_radiance(p):
        rad = jtr.trace_rays(js, p, o, d, kj, DEPTH, manual_vjp=False, compact=compact)
        return jnp.mean(rad), rad
    (loss_j, rad_j), g_j = jax.jit(jax.value_and_grad(mean_and_radiance, has_aux=True))(
        js.params)
    calls = _hit_calls()
    loss_a, rad_a, g_a = _port(ts, manual_vjp=False, compact=compact)
    # the forward's bounces and the backward's recompute of all but the last
    assert _hit_calls() == calls + 2 * DEPTH + 1
    loss_m, rad_m, g_m = _port(ts, manual_vjp=True, compact=compact)
    assert loss_a == pytest.approx(float(loss_j), rel=1e-6)
    assert loss_a == pytest.approx(loss_m, rel=1e-6)
    np.testing.assert_allclose(rad_a, np.asarray(rad_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rad_a, rad_m, rtol=1e-4, atol=1e-5)
    _close(g_a, jax.tree.map(np.asarray, g_j), rtol=2e-3, atol=2e-5)
    _close(g_a, g_m, rtol=2e-3, atol=2e-5)
    for k in ("sphere_center", "sphere_radius", "const"):
        assert np.abs(g_a[k]).sum() > 0, k


@pytest.mark.parametrize("compact", [False, True], ids=["flat", "compacted"])
def test_remat_changes_no_bit(pair, compact):
    """``remat`` on and off: the same loss, radiance and gradients bit for
    bit; off, the hit runs once a bounce."""
    _, _, ts = pair
    calls = _hit_calls()
    loss_off, rad_off, g_off = _port(ts, manual_vjp=False, remat=False, compact=compact)
    assert _hit_calls() == calls + DEPTH + 1
    loss_on, rad_on, g_on = _port(ts, manual_vjp=False, remat=True, compact=compact)
    assert loss_on == loss_off
    np.testing.assert_array_equal(rad_on, rad_off)
    for k in g_off:
        for a, b in zip(*(x if isinstance(x, list) else [x] for x in (g_on[k], g_off[k]))):
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_remat_is_ignored_by_the_manual_route(pair):
    """Under the manual VJP ``remat`` changes nothing: the same bits and
    one hit a bounce either way."""
    _, _, ts = pair
    runs = [_port(ts, manual_vjp=True, remat=r, depth=3) for r in (False, True)]
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_train_step_with_remat_matches_jax_on_a_1x1_mesh():
    """One SGD step of the demo under ``manual_vjp=False, remat=True``
    (radii ×1.05, const row 0 lowered by 0.1), 12×8, spp 2, depth 4, lr
    0.5: the loss within 1e-4 relative, every new param within
    ``1e-4 · max|update| + 1e-6``."""
    w, h, spp, depth, lr = 12, 8, 2, 4, 0.5
    root = jax_make_world()
    js = jtr.compile_scene(root, pallas=False)
    mesh = pmesh.make_mesh(devices=jax.devices()[:1], tiles=1, samples=1)
    cam_j = JCamera.reference_demo(w, h)
    target = render_sharded(js, cam_j, mesh, jax.random.PRNGKey(7), spp=spp, depth=depth)
    row0 = np.zeros((int(js.params["const"].shape[0]), 3), np.float32)
    row0[0] = -0.1
    p0 = dict(js.params)
    p0["sphere_radius"] = js.params["sphere_radius"] * 1.05
    p0["const"] = js.params["const"] + jnp.asarray(row0)
    step_j = jax_make_train_step(js, cam_j, mesh, spp=spp, depth=depth, learning_rate=lr,
                                 remat=True, manual_vjp=False)
    new_j, loss_j = step_j(p0, target, jax.random.PRNGKey(2))

    ts = trace.compile_scene(scene_from_jax(root), "cpu")
    tp0 = params_from_jax(jax.tree.map(np.asarray, p0), "cpu")
    step_t = make_train_step(ts, Camera.reference_demo(w, h), spp=spp, depth=depth,
                             learning_rate=lr, remat=True, manual_vjp=False)
    calls = fasthit_kernel.REFERENCE_CALLS
    new_t, loss_t = step_t(tp0, torch.from_numpy(np.array(target)), rng.PRNGKey(2))
    assert fasthit_kernel.REFERENCE_CALLS == calls + 2 * depth + 1
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-4)
    new_j, p0 = jax.tree.map(np.asarray, new_j), jax.tree.map(np.asarray, p0)
    for k in new_j:
        for a, b, start in zip(*(x if isinstance(x, list) else [x]
                                 for x in (new_t[k], new_j[k], p0[k]))):
            a = a.numpy()
            assert a.shape == b.shape and np.isfinite(a).all(), k
            step = np.abs(b - start).max() if b.size else 0.0
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * step + 1e-6, err_msg=k)
    assert not np.allclose(new_t["sphere_radius"].numpy(), p0["sphere_radius"])
