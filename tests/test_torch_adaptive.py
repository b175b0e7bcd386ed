"""The port's adaptive sampler (``ptx_torch.integrate.adaptive``) against
the JAX package's ``ptx.integrate.adaptive`` on the demo, CPU, same keys.

- ``_rank_pixels`` on moments built with many exact ties (zero variance
  included) gives ``jax.lax.top_k``'s indices bit for bit;
- one refinement round from JAX's own base-pass moments: the counts
  equal exactly, the image within ``rtol 1e-4, atol 1e-5`` (the
  tolerance of ``tests/test_torch_trace.py``);
- a whole ``render_adaptive`` and a ``render_adaptive_tile``: the counts
  equal at every pixel except where JAX's priority in some round lies
  within 1e-5 (relative) of that round's k-th largest; the port's
  moments start from its own base pass, whose radiance differs from
  JAX's by float32 reassociation, so such a pixel may rank on either
  side.  The test counts those pixels and names them when it fails;
- an interrupted render resumed through ``AdaptiveCheckpoint`` equals the
  uninterrupted one bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.integrate import adaptive as jad
from ptx.integrate import trace as jtr
from ptx.integrate.camera import Camera as JCamera
from ptx.scenes.builders import make_world as jax_make_world
from ptx_torch.core import rng
from ptx_torch.integrate import adaptive, trace
from ptx_torch.integrate.camera import Camera
from ptx_torch.parallel.checkpoint import AdaptiveCheckpoint
from ptx_torch.scenes.builders import make_world

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5
TIE_REL = 1e-5
W = H = 8
FULL = dict(spp_base=2, rounds=2, frac=0.125, spp_refine=4, depth=3)
TILE = (16, 16, 8, 4, 8, 8, 4, 3)     # camera W H, x0 y0 cols rows, spp, depth


@pytest.fixture(scope="module")
def scenes():
    return (jtr.compile_scene(jax_make_world(), pallas=False),
            trace.compile_scene(make_world(), "cpu"))


def _priority(s1, s2, count):
    mean = s1 / count[..., None]
    return np.maximum(s2 / count[..., None] - mean ** 2, 0.0).sum(-1) / count


def _near_ties(states, k):
    """Pixels whose priority, in the state before some round, lies within
    TIE_REL of that round's k-th largest."""
    near = np.zeros(states[0][2].shape, bool)
    for s1, s2, count in states:
        p = _priority(*(np.asarray(x, np.float64) for x in (s1, s2, count)))
        kth = np.sort(p.ravel())[::-1][k - 1]
        near |= np.abs(p - kth) <= TIE_REL * abs(kth)
    return near


@pytest.fixture(scope="module")
def jax_full(scenes):
    js, _ = scenes
    states = []
    img, count, _ = jad.render_adaptive(
        js, JCamera.reference_demo(W, H), jax.random.PRNGKey(3), **FULL,
        on_round=lambda s1, s2, c, r: states.append(tuple(np.asarray(x) for x in (s1, s2, c))))
    return np.asarray(img), np.asarray(count), states


def test_rank_pixels_breaks_ties_as_top_k():
    r = np.random.default_rng(0)
    shape = (12, 20)
    count = r.choice([2.0, 4.0, 8.0], shape).astype(np.float32)
    m = r.choice([0.0, 0.5, 1.0, 2.0], shape + (3,)).astype(np.float32)
    v = r.choice([0.0, 0.0, 0.25, 1.0], shape + (3,)).astype(np.float32)
    s1, s2 = m * count[..., None], (m * m + v) * count[..., None]   # exact: var = v
    cam = JCamera.reference_demo(shape[1], shape[0])
    for k in (1, 7, 60, 120, shape[0] * shape[1]):
        want = np.asarray(jad._rank_pixels(cam, jnp.asarray(s1), jnp.asarray(s2),
                                           jnp.asarray(count), k))
        got = adaptive._rank_pixels(*(torch.from_numpy(x) for x in (s1, s2, count)), k)
        np.testing.assert_array_equal(got.numpy(), want)


def test_one_round_from_the_jax_base_pass(scenes):
    js, ts = scenes
    jcam, key = JCamera.reference_demo(W, H), jax.random.PRNGKey(1)
    s1, s2, count = (np.asarray(x) for x in jad._base_pass(js, js.params, jcam, key, 2, 3))
    kw = dict(spp_base=2, rounds=1, frac=0.25, spp_refine=4, depth=3,
              state=(s1, s2, count, 0))
    img_j, count_j, _ = jad.render_adaptive(js, jcam, key, **kw)
    img_t, count_t, _ = adaptive.render_adaptive(ts, Camera.reference_demo(W, H),
                                                 rng.PRNGKey(1), **kw)
    np.testing.assert_array_equal(count_t.numpy(), np.asarray(count_j))
    assert count_t.sum() == count.sum() + 16 * 4
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=RTOL, atol=ATOL)


def test_render_adaptive_matches_jax(scenes, jax_full):
    _, ts = scenes
    img_j, count_j, states = jax_full
    img_t, count_t, state = adaptive.render_adaptive(ts, Camera.reference_demo(W, H),
                                                     rng.PRNGKey(3), **FULL)
    count_t = count_t.numpy()
    k = int(W * H * FULL["frac"])
    assert count_t.sum() == W * H * FULL["spp_base"] + FULL["rounds"] * k * FULL["spp_refine"]
    near = _near_ties(states[:-1], k)
    off = count_t != count_j
    assert not (off & ~near).any(), (
        f"counts differ at {np.argwhere(off & ~near).tolist()}, not near-ties; "
        f"{int(near.sum())} near-tie pixels")
    same = ~off
    np.testing.assert_allclose(img_t.numpy()[same], img_j[same], rtol=RTOL, atol=ATOL,
                               err_msg=f"{int(near.sum())} near-tie pixels")
    assert state[3] == FULL["rounds"] and np.isfinite(img_t.numpy()).all()


def test_interrupted_and_resumed_equals_uninterrupted(scenes, tmp_path):
    _, ts = scenes
    cam, key = Camera.reference_demo(W, H), rng.PRNGKey(3)
    path = str(tmp_path / "a.npz")
    ckpt = AdaptiveCheckpoint(H, W, path)

    def stop_after_round_1(s1, s2, count, rounds_done):
        ckpt.update(s1, s2, count, rounds_done)
        if rounds_done == 1:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        adaptive.render_adaptive(ts, cam, key, **FULL, on_round=stop_after_round_1)
    resumed, count_r, _ = adaptive.render_adaptive(
        ts, cam, key, **FULL, state=AdaptiveCheckpoint(H, W, path).state)
    whole, count_w, _ = adaptive.render_adaptive(ts, cam, key, **FULL)
    np.testing.assert_array_equal(count_r.numpy(), count_w.numpy())
    np.testing.assert_array_equal(resumed.numpy(), whole.numpy())


def test_render_adaptive_tile_matches_jax(scenes):
    js, ts = scenes
    cw, ch, x0, y0, cols, rows, spp, depth = TILE
    jcam, key = JCamera.reference_demo(cw, ch), jax.random.PRNGKey(9)
    # JAX's render_adaptive_tile, its states kept: base at spp // 2, then
    # 2 rounds of k = 16 pixels at round(2·64 / (2·16)) = 4 samples
    k, spp_refine = 16, 4
    s1, s2 = jad._base_tile(js, js.params, jcam, key, x0, y0, cols, rows, spp // 2, depth)
    count = jnp.full((rows, cols), spp // 2, jnp.float32)
    states = []
    for r in range(2):
        states.append(tuple(np.asarray(x) for x in (s1, s2, count)))
        s1, s2, count = jad._refine_tile(js, js.params, jcam, jax.random.fold_in(key, 2000 + r),
                                         x0, y0, cols, s1, s2, count, spp_refine, depth, k)
    want = np.asarray(jad.render_adaptive_tile(js, js.params, jcam, key, x0, y0, cols, rows,
                                               spp, depth))
    np.testing.assert_array_equal(want, np.asarray(s1 / count[..., None]))

    cam = Camera.reference_demo(cw, ch)
    t1, _, tc = adaptive.adaptive_tile_moments(ts, ts.params, cam, rng.PRNGKey(9), x0, y0,
                                               cols, rows, spp, depth)
    got = adaptive.render_adaptive_tile(ts, ts.params, cam, rng.PRNGKey(9), x0, y0, cols,
                                        rows, spp, depth)
    np.testing.assert_array_equal(got.numpy(), (t1 / tc[..., None]).numpy())
    assert float(tc.sum()) == spp * rows * cols                  # the dense budget
    near = _near_ties(states, k)
    off = tc.numpy() != np.asarray(count)
    assert not (off & ~near).any(), (
        f"counts differ at {np.argwhere(off & ~near).tolist()}; {int(near.sum())} near-ties")
    np.testing.assert_allclose(got.numpy()[~off], want[~off], rtol=RTOL, atol=ATOL)
