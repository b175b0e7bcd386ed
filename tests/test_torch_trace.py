"""The port's forward render against the JAX package, end to end on the demo.

Same scene, same ``PRNGKey(0)``, same key folds: the port must draw the
same jitter and bounce uniforms (bit for bit, tests/test_torch_rng.py)
and take the same decisions, so radiance differs only by float32
reassociation and last-ulp transcendental differences between XLA and
PyTorch — tolerance ``rtol 1e-4, atol 1e-5``.  The JAX side runs as its
own tests run it on the CPU: ``compile_scene(..., pallas=False)``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.integrate import render as jrender
from ptx.integrate import trace as jtr
from ptx.integrate.camera import Camera as JCamera
from ptx.scenes.builders import make_world as jax_make_world
from ptx_torch.core import rng
from ptx_torch.integrate import render, trace
from ptx_torch.integrate.camera import Camera, sample_rays
from ptx_torch.scenes.builders import make_world

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def scenes():
    return (jtr.compile_scene(jax_make_world(), pallas=False),
            trace.compile_scene(make_world(), "cpu"))


def test_render_tile_matches_jax(scenes):
    """A 16×12 tile at spp 2, depth 8, no compaction."""
    js, ts = scenes
    W, H = 16, 12
    want = jrender._render_tile(js, js.params, JCamera.reference_demo(W, H),
                                jax.random.PRNGKey(0), 0, 0, W, H, 2, 8,
                                compact=False)
    got = render.render_tile(ts, ts.params, Camera.reference_demo(W, H),
                             rng.PRNGKey(0), 0, 0, W, H, 2, 8, compact=False)
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert float(got.mean()) > 0.0


def test_render_rows_matches_jax(scenes):
    """The CLI's band renderer: chunk i keyed fold(key, i·spp_chunk, y0)
    for both jitter and trace, averaged over chunks."""
    js, ts = scenes
    W, H = 12, 8
    want = jrender._render_rows_fori(js, js.params, JCamera.reference_demo(W, H),
                                     jax.random.PRNGKey(0), 4, 4, 1, 2, 3)
    got = render.render_rows(ts, ts.params, Camera.reference_demo(W, H),
                             rng.PRNGKey(0), 4, 4, 1, 2, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_general_emission_branch_matches_jax(scenes):
    """``skysel=False``: every record evaluates the full emissive slot,
    the sky chain included, instead of mat-sum + sky-select."""
    js, ts = scenes
    cam_j, cam_t = JCamera.reference_demo(10, 6), Camera.reference_demo(10, 6)
    from ptx.integrate.camera import sample_rays as jax_sample_rays

    kj = jax.random.PRNGKey(3)
    o, d = jax_sample_rays(cam_j, kj, jnp.arange(6), jnp.arange(10), 2)
    want = jax.jit(lambda p, o, d: jtr.trace_rays(
        js, p, o, d, kj, 6, compact=False, skysel=False))(js.params, o, d)

    kt = rng.PRNGKey(3)
    ot, dt = sample_rays(cam_t, kt, range(6), range(10), 2, "cpu")
    np.testing.assert_allclose(ot.numpy(), np.asarray(o), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(d), rtol=1e-6, atol=1e-6)
    got = trace.trace_rays(ts, ts.params, ot, dt, kt, 6, compact=False,
                           skysel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    skysel = trace.trace_rays(ts, ts.params, ot, dt, kt, 6, compact=False)
    np.testing.assert_allclose(skysel.numpy(), got.numpy(), rtol=RTOL, atol=ATOL)
