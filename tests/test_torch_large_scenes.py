"""The large-scene slice as a whole against the JAX package: the union
sweep (K5's plain version), the fused mega bounce's plain side, the replay
backward (K6's CPU path), tile ordering, the training step, the routing.

JAX side: ``compile_scene(world, pallas=False)`` on the CPU, i.e. the
fixpoint sweep with the local-fold gadget path, the unfused bounce and the
XLA replay VJP — the JAX package's own plain reference for K5 + K6.  Same
scene, params, rays and keys: the loss within ``rtol 1e-5``, every
gradient within 1e-4 of its tensor's largest entry (+1e-7), the tolerance
of tests/test_torch_grad.py (XLA on the CPU contracts multiply-adds,
PyTorch does not).
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
from ptx_torch.convert import grads_to_numpy, params_from_jax
from ptx_torch.core import rng
from ptx_torch.geom import fasthit
from ptx_torch.geom.tape import Intersection, Sphere
from ptx_torch.integrate import trace
from ptx_torch.integrate.camera import Camera, sample_rays
from ptx_torch.ops import megasweep
from ptx_torch.ops.replay_bwd import RowFedReplayBwd
from ptx_torch.parallel.render import make_train_step
from ptx_torch.scenes import builders
from ptx_torch.shade.bounce import UnfusedBounce
from ptx_torch.shade.materials import Material

from test_torch_megasweep import pair_for

torch.set_num_threads(1)


def _close_grads(g_t, g_j):
    assert set(g_t) == set(g_j)
    for k in g_j:
        for a, b in zip(*(x if isinstance(x, list) else [x] for x in (g_t[k], g_j[k]))):
            assert a.shape == b.shape and np.isfinite(a).all(), k
            scale = np.abs(b).max() if b.size else 0.0
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale + 1e-7, err_msg=k)


@pytest.mark.parametrize("name", ["spheres25", "gadgets12"])
def test_trace_rays_loss_and_gradients_match_jax(name):
    """8×16 pixels, spp 1, depth 4."""
    js, ts = pair_for(name)
    W, H, DEPTH = 16, 8, 4
    kj = jax.random.PRNGKey(0)
    o, d = jax_sample_rays(JCamera.reference_demo(W, H), kj, jnp.arange(H), jnp.arange(W), 1)
    loss_j, g_j = jax.jit(jax.value_and_grad(lambda p: jnp.mean(
        jtr.trace_rays(js, p, o, d, kj, DEPTH))))(js.params)
    ot, dt = sample_rays(Camera.reference_demo(W, H), rng.PRNGKey(0), range(H), range(W), 1,
                         "cpu")
    p = {k: ([x.clone().requires_grad_(True) for x in v] if isinstance(v, list)
             else v.clone().requires_grad_(True)) for k, v in ts.params.items()}
    calls = megasweep.REFERENCE_CALLS
    loss_t = trace.trace_rays(ts, p, ot, dt, rng.PRNGKey(0), DEPTH).mean()
    loss_t.backward()
    # the bounce runs the sweep (K5's plain version) once per bounce
    assert megasweep.REFERENCE_CALLS == calls + DEPTH + 1
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    g_t = grads_to_numpy(p)
    _close_grads(g_t, jax.tree.map(np.asarray, g_j))
    assert np.abs(g_t["sphere_center"]).sum() > 0 and np.abs(g_t["const"]).sum() > 0


def test_train_step_matches_jax_on_a_1x1_mesh():
    """One SGD step on stress_gadgets(12), radii ×1.05 and const row 0
    lowered by 0.1, 16×8, spp 1, depth 4: the loss and every new param."""
    js, ts = pair_for("gadgets12")
    W, H, SPP, DEPTH, LR = 16, 8, 1, 4, 0.5
    mesh = pmesh.make_mesh(devices=jax.devices()[:1], tiles=1, samples=1)
    cam_j = JCamera.reference_demo(W, H)
    target = render_sharded(js, cam_j, mesh, jax.random.PRNGKey(7), spp=SPP, depth=DEPTH)
    row0 = np.zeros((int(js.params["const"].shape[0]), 3), np.float32)
    row0[0] = -0.1
    p0 = dict(js.params, sphere_radius=js.params["sphere_radius"] * 1.05,
              const=js.params["const"] + jnp.asarray(row0))
    new_j, loss_j = jax_make_train_step(js, cam_j, mesh, spp=SPP, depth=DEPTH,
                                        learning_rate=LR)(p0, target, jax.random.PRNGKey(2))
    step_t = make_train_step(ts, Camera.reference_demo(W, H), spp=SPP, depth=DEPTH,
                             learning_rate=LR)
    tp0 = params_from_jax(jax.tree.map(np.asarray, p0), "cpu")
    new_t, loss_t = step_t(tp0, torch.from_numpy(np.array(target)), rng.PRNGKey(2))
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


def test_tile_ordering_matches_jax():
    """A (1, 32, 64) batch (four 16×32 tiles) at depth 4 on a tile-hinted
    scene: the JAX ``trace_rays`` with ``tile_hint`` set after
    ``compile_scene(pallas=False)``.  The permutation changes which lane
    draws which numbers, so the untiled estimate differs; depth > 8 is
    never tiled."""
    js, ts = pair_for("spheres25")
    js.tile_hint = True
    assert ts.tile_hint
    kj = jax.random.PRNGKey(3)
    o, d = jax_sample_rays(JCamera.reference_demo(64, 32), kj, jnp.arange(32),
                           jnp.arange(64), 1)
    want = np.asarray(jtr.trace_rays(js, js.params, o, d, kj, 4))
    ot, dt = sample_rays(Camera.reference_demo(64, 32), rng.PRNGKey(3), range(32), range(64),
                         1, "cpu")
    got = trace.trace_rays(ts, ts.params, ot, dt, rng.PRNGKey(3), 4)
    assert got.shape == (1, 32, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    try:
        ts.tile_hint = False
        assert not torch.allclose(trace.trace_rays(ts, ts.params, ot, dt, rng.PRNGKey(3), 4),
                                  got)
        untiled = trace.trace_rays(ts, ts.params, ot, dt, rng.PRNGKey(3), 9)
    finally:
        ts.tile_hint = True
    assert torch.equal(trace.trace_rays(ts, ts.params, ot, dt, rng.PRNGKey(3), 9), untiled)


def test_routing_takes_the_sweep_above_24_leaves():
    """A 25-64-leaf union scene takes the sweep (the dense fold before) with
    the mega bounce and K6's wrapper; 24 leaves or fewer keep the dense
    fold; a non-union tape above 64 leaves takes the candidate-blocked hit,
    with the unfused bounce and K6's wrapper."""
    sc = trace.compile_scene(builders.stress_spheres(25), "cpu")
    assert isinstance(sc.plain_hit_fn, megasweep.SweepHit) and sc.tile_hint
    assert isinstance(sc.hit_fn, megasweep.MegaHit)
    assert isinstance(sc.bounce_fn, megasweep.MegaBounce)
    assert isinstance(sc.bounce_bwd_fn, RowFedReplayBwd)
    small = trace.compile_scene(builders.stress_spheres(10), "cpu")
    assert not isinstance(small.plain_hit_fn, megasweep.SweepHit) and not small.tile_hint
    m = Material(reflect=0.5, scatter=1.0)
    big = Intersection(*[Sphere((0.01 * i, 0.0, -4.0), 1.0, m) for i in range(65)])
    sc = trace.compile_scene(big, "cpu")
    assert isinstance(sc.plain_hit_fn, fasthit.BlockedHit) and sc.hit_fn is sc.plain_hit_fn
    assert sc.plain_hit_fn.block == trace.DEFAULT_CANDIDATE_BLOCK
    assert isinstance(sc.bounce_fn, UnfusedBounce)
    assert isinstance(sc.bounce_bwd_fn, RowFedReplayBwd)
