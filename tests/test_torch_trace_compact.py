"""Dead-lane compaction in the port against the JAX package.

``_compact_wavefront`` packs live lanes with systematic resampling and a
random phase offset; it is integer and gather work, so on the same carry
and key the port must produce the JAX package's packed carry exactly.
End to end, a compacted render (B = 2048 at depth 8: the resampling
phase draws and the per-phase ``index_add_`` into radiance by original
lane) must match within ``rtol 1e-4, atol 1e-5``, float32 reassociation
only (tests/test_torch_trace.py).
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
from ptx_torch.integrate.camera import Camera
from ptx_torch.scenes.builders import make_world

torch.set_num_threads(1)


@pytest.mark.parametrize("alive_frac,cap", [(0.2, 100), (0.7, 100), (0.0, 64)])
def test_compact_wavefront_matches_jax(alive_frac, cap):
    """Under-full packs, overflow resampling (throughput boost n/cap) and
    an all-dead wavefront."""
    r = np.random.default_rng(7)
    B = 300
    o = r.normal(size=(B, 3)).astype(np.float32)
    d = r.normal(size=(B, 3)).astype(np.float32)
    thr = r.random((B, 3), dtype=np.float32)
    st = r.random(B, dtype=np.float32)
    alive = r.random(B) < alive_frac
    orig = np.arange(B)

    (jo, jd, jthr, jst, jal), jorig = jax.jit(
        lambda c, oi: jtr._compact_wavefront(c, oi, cap,
                                             key=jax.random.PRNGKey(11)))(
        tuple(map(jnp.asarray, (o, d, thr, st, alive))),
        jnp.asarray(orig, jnp.int32))
    (to, td, tthr, tst, tal), torig = trace._compact_wavefront(
        tuple(map(torch.from_numpy, (o, d, thr, st, alive))),
        torch.from_numpy(orig), cap, key=rng.PRNGKey(11))

    np.testing.assert_array_equal(tal.numpy(), np.asarray(jal))
    live = tal.numpy()
    np.testing.assert_array_equal(torig.numpy()[live], np.asarray(jorig)[live])
    assert (torig.numpy()[~live] >= B).all()
    for a, b in ((to, jo), (td, jd), (tthr, jthr), (tst, jst)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compacted_render_matches_jax():
    W, H = 64, 32
    js = jtr.compile_scene(jax_make_world(), pallas=False)
    ts = trace.compile_scene(make_world(), "cpu")
    want = jrender._render_tile(js, js.params, JCamera.reference_demo(W, H),
                                jax.random.PRNGKey(0), 0, 0, W, H, 1, 8,
                                compact=True)
    got = render.render_tile(ts, ts.params, Camera.reference_demo(W, H),
                             rng.PRNGKey(0), 0, 0, W, H, 1, 8, compact=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
