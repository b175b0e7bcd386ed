"""Gradients of the port's ``trace_rays`` (the manual bounce VJP, its
replay backward, compaction and emission under autograd, the sky image
through ``image_gather``) against the JAX package, and against central
finite differences on the port alone.

JAX side: ``jax.grad`` through ``ptx.integrate.trace.trace_rays`` with
``compile_scene(..., pallas=False)``, i.e. its manual VJP with
``jax.vjp`` of the replay.  Same scene, params, rays and keys: both take
the same decisions, so the gradients differ only by float32 rounding.
Tolerance, per param tensor: ``1e-4 · max|g|`` (+1e-7).  XLA on the CPU
contracts multiply-adds and PyTorch does not, which moves near-grazing
hits by a few ulps (ROADMAP Queue 3); the geometry gradients there carry
~1e-4 relative error in either package (measured: at most 4.5e-5 of the
largest entry on this tile).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.integrate import trace as jtr
from ptx.integrate.camera import Camera as JCamera, sample_rays as jax_sample_rays
from ptx.scenes.builders import baseline_config4 as jax_config4
from ptx.scenes.builders import make_world as jax_make_world
from ptx_torch.convert import grads_to_numpy, params_from_jax, scene_from_jax
from ptx_torch.core import rng
from ptx_torch.geom.tape import Plane, Sphere, Union
from ptx_torch.integrate import trace
from ptx_torch.integrate.camera import Camera, sample_rays
from ptx_torch.shade.materials import Material

torch.set_num_threads(1)

W, H, SPP, DEPTH = 16, 12, 2, 6


@pytest.fixture(scope="module")
def pair():
    root = jax_make_world()
    js = jtr.compile_scene(root, pallas=False)
    ts = trace.compile_scene(scene_from_jax(root), "cpu")
    ts.params = params_from_jax(jax.tree.map(np.asarray, js.params), "cpu")
    return js, ts


def _port_grad(scene, params, o, d, key, depth, compact):
    p = {k: ([x.clone().requires_grad_(True) for x in v] if isinstance(v, list)
             else v.clone().requires_grad_(True)) for k, v in params.items()}
    loss = trace.trace_rays(scene, p, o, d, key, depth, compact=compact).mean()
    loss.backward()
    return float(loss.detach()), grads_to_numpy(p)


@pytest.mark.parametrize("compact", [False, True], ids=["flat", "compacted"])
def test_trace_rays_gradient_matches_jax(pair, compact):
    """A 16×12 tile at spp 2, depth 6: every param leaf, the sky image
    included.  Compacted: phases at 1/3 and 1/16 width from bounces 2 and
    6, with resampling and filler lanes."""
    js, ts = pair
    kj = jax.random.PRNGKey(0)
    o, d = jax_sample_rays(JCamera.reference_demo(W, H), kj, jnp.arange(H),
                           jnp.arange(W), SPP)
    loss_j, g_j = jax.jit(jax.value_and_grad(lambda p: jnp.mean(
        jtr.trace_rays(js, p, o, d, kj, DEPTH, compact=compact))))(js.params)
    ot, dt = sample_rays(Camera.reference_demo(W, H), rng.PRNGKey(0), range(H),
                         range(W), SPP, "cpu")
    loss_t, g_t = _port_grad(ts, ts.params, ot, dt, rng.PRNGKey(0), DEPTH, compact)
    assert loss_t == pytest.approx(float(loss_j), rel=1e-5)
    g_j = jax.tree.map(np.asarray, g_j)
    assert set(g_t) == set(g_j)
    for k in g_j:
        for a, b in zip(*(x if isinstance(x, list) else [x] for x in (g_t[k], g_j[k]))):
            assert a.shape == b.shape and np.isfinite(a).all(), k
            scale = np.abs(b).max() if b.size else 0.0
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale + 1e-7, err_msg=k)
    for k in ("sphere_center", "sphere_radius", "ior", "const", "factor"):
        assert np.abs(g_t[k]).sum() > 0, k
    assert np.abs(g_t["images"][0]).sum() > 0


def test_config4_textured_slot_gradient_matches_jax():
    """BASELINE config 4: the checker texture is the reflect slot of the
    sphere and the ground, so the bounce is the unfused one and its replay
    reads the texture params.  The port must differentiate the replay in
    them (``factor``, ``tex_xform``, every image), as ``jax.vjp`` of the
    JAX replay does: the checker image's gradient among them."""
    root = jax_config4()
    js = jtr.compile_scene(root, pallas=False)
    ts = trace.compile_scene(scene_from_jax(root), "cpu")
    ts.params = params_from_jax(jax.tree.map(np.asarray, js.params), "cpu")
    w, h = 8, 6
    kj = jax.random.PRNGKey(0)
    o, d = jax_sample_rays(JCamera.reference_demo(w, h), kj, jnp.arange(h),
                           jnp.arange(w), 1)
    loss_j, g_j = jax.jit(jax.value_and_grad(lambda p: jnp.mean(
        jtr.trace_rays(js, p, o, d, kj, 4, compact=False))))(js.params)
    ot, dt = sample_rays(Camera.reference_demo(w, h), rng.PRNGKey(0), range(h),
                         range(w), 1, "cpu")
    loss_t, g_t = _port_grad(ts, ts.params, ot, dt, rng.PRNGKey(0), 4, False)
    assert loss_t == pytest.approx(float(loss_j), rel=1e-5)
    g_j = jax.tree.map(np.asarray, g_j)
    assert set(g_t) == set(g_j)
    for k in g_j:
        for a, b in zip(*(x if isinstance(x, list) else [x] for x in (g_t[k], g_j[k]))):
            assert a.shape == b.shape and np.isfinite(a).all(), k
            scale = np.abs(b).max() if b.size else 0.0
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale + 1e-7, err_msg=k)
    checker = next(i for i, im in enumerate(ts.params["images"]) if im.shape[0] == 8)
    assert np.abs(g_t["images"][checker]).max() > 1e-3


# --- central finite differences, the scene and rays of tests/test_gradients.py

@pytest.fixture(scope="module")
def fd_setup():
    diffuse = Material(reflect=0.8, scatter=1.0)
    sky = Material(reflect=0.0, scatter=0.0, emissive=(0.7, 0.8, 1.0))
    normals = [(0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0), (1, 0, 0), (-1, 0, 0)]
    world = Union(Sphere((0.0, 0.0, -4.0), 1.2, diffuse),
                  Plane((0.0, 1.0, 0.0), 1.0, diffuse),
                  *[Plane(np.asarray(n, np.float32), 200.0, sky) for n in normals])
    scene = trace.compile_scene(world, "cpu")
    g = np.random.default_rng(0)
    cand = np.stack([g.uniform(-0.45, 0.45, 256), g.uniform(-0.45, 0.45, 256),
                     np.full(256, -1.0)], -1).astype(np.float32)
    center, radius = np.array([0.0, 0.0, -4.0]), 1.2
    dhat = cand / np.linalg.norm(cand, axis=-1, keepdims=True)
    closest = np.linalg.norm(center - dhat * (dhat @ center)[:, None], axis=-1)
    d = cand[np.abs(closest - radius) > 0.08][:48]
    S = 256                 # samples per ray: common random numbers across evals
    o = torch.zeros((S, 48, 3))
    dirs = torch.from_numpy(np.tile(d[None], (S, 1, 1)))

    def loss(params):
        return trace.trace_rays(scene, params, o, dirs, rng.PRNGKey(0), depth=4).mean()

    return scene, loss


def _fd_check(scene, loss, key, idx, h, rtol, atol=1e-5):
    params = dict(scene.params)
    x = params[key].clone().requires_grad_(True)
    loss(dict(params, **{key: x})).backward()
    g = float(x.grad[idx])
    with torch.no_grad():
        up, dn = params[key].clone(), params[key].clone()
        up[idx] += h
        dn[idx] -= h
        fd = (float(loss(dict(params, **{key: up}))) -
              float(loss(dict(params, **{key: dn})))) / (2 * h)
    assert abs(g - fd) <= rtol * max(abs(fd), abs(g)) + atol, (key, idx, g, fd)
    return g, fd


def test_fd_material_reflect(fd_setup):
    scene, loss = fd_setup
    g, _ = _fd_check(scene, loss, "const", (0, 1), 1e-2, 0.05)
    assert abs(g) > 1e-4


def test_fd_sky_emissive(fd_setup):
    scene, loss = fd_setup
    consts = scene.params["const"].numpy()
    idx = next(i for i, c in enumerate(consts) if np.allclose(c, (0.7, 0.8, 1.0)))
    g, _ = _fd_check(scene, loss, "const", (idx, 2), 1e-2, 0.02)
    assert g > 1e-3


def test_fd_sphere_radius_radiance_finite(fd_setup):
    """The radiance-level geometry gradient exists and is finite (FD picks
    up visibility terms the interior gradient omits by design; see
    tests/test_gradients.py)."""
    scene, loss = fd_setup
    x = scene.params["sphere_radius"].clone().requires_grad_(True)
    loss(dict(scene.params, sphere_radius=x)).backward()
    assert np.isfinite(x.grad.numpy()).all() and float(x.grad.abs().sum()) > 0
