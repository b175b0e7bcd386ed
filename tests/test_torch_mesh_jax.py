"""The port's mesh on gloo ranks against the JAX package's mesh.

The port side is ``tests/test_torch_mesh.py``'s rank worker (worlds of 2
and 4 ranks on the CPU: 2×1, 1×2 and 2×2 meshes); the JAX side
``make_mesh(jax.devices()[:n], tiles, samples)`` on conftest's 8 virtual
CPU devices.  The workload is that file's: config 1, ``Camera(16, 8)``,
spp 4, depth 3.  Tolerances are those of ``tests/test_torch_trace.py``
and ``tests/test_torch_train.py``:

- ``render_sharded`` and ``render_sharded_moments``: ``rtol 1e-4, atol
  1e-5``;
- one ``make_train_step`` step: the loss within ``1e-4`` relative, each
  new param tensor within ``1e-4`` of its largest step plus ``1e-6``;
- ``render_adaptive(mesh=)``: the base pass's moments as the renders; the
  counts equal except at pixels whose priority lies within 1e-5 of the
  round's k-th largest (``tests/test_torch_adaptive.py``); the image within
  ``rtol 1e-4, atol 1e-5`` where the counts are equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.integrate import adaptive as jad
from ptx.integrate import trace as jtr
from ptx.integrate.camera import Camera as JCamera
from ptx.parallel import mesh as jmesh
from ptx.parallel.render import make_train_step, render_sharded, render_sharded_moments
from ptx.scenes.builders import baseline_config1 as jax_config1
from ptx_torch.integrate import trace
from ptx_torch.parallel import render as prender
from ptx_torch.scenes.builders import baseline_config1

import test_torch_mesh as tm

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5
TIE_REL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for world in sorted(tm.SHAPES):
        out.update(tm.launch(world, tmp_path_factory.mktemp(f"world{world}")))
    return out


@pytest.fixture(scope="module")
def js():
    return jtr.compile_scene(jax_config1(), pallas=False)


def _unflat(vec):
    """The port's flat param vector as {key: array or list of arrays}."""
    params = trace.compile_scene(baseline_config1(), "cpu").params
    leaves = prender._leaves(params)
    parts = np.split(vec, np.cumsum([x.numel() for _, _, x in leaves])[:-1])
    return prender._rebuild(params, leaves, [v.reshape(tuple(x.shape))
                                             for (_, _, x), v in zip(leaves, parts)])


def _near_ties(states, k):
    near = np.zeros(states[0][2].shape, bool)
    for s1, s2, count in states:
        s1, s2, count = (np.asarray(x, np.float64) for x in (s1, s2, count))
        mean = s1 / count[..., None]
        p = np.maximum(s2 / count[..., None] - mean ** 2, 0.0).sum(-1) / count
        kth = np.sort(p.ravel())[::-1][k - 1]
        near |= np.abs(p - kth) <= TIE_REL * abs(kth)
    return near


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_matches_jax(js, ranks, shape):
    tiles, samples = shape
    got = ranks[shape][0]
    mesh = jmesh.make_mesh(jax.devices()[:tiles * samples], tiles=tiles, samples=samples)
    cam = JCamera(tm.W, tm.H)
    key = jax.random.PRNGKey(tm.RENDER_SEED)

    img = render_sharded(js, cam, mesh, key, spp=tm.SPP, depth=tm.DEPTH)
    np.testing.assert_allclose(got["img"], np.asarray(img), rtol=RTOL, atol=ATOL)
    for name, m in zip(("s1", "s2"), render_sharded_moments(js, cam, mesh, key, spp=tm.SPP,
                                                            depth=tm.DEPTH)):
        np.testing.assert_allclose(got[name], np.asarray(m), rtol=RTOL, atol=ATOL,
                                   err_msg=name)

    step = make_train_step(js, cam, mesh, spp=tm.SPP, depth=tm.DEPTH,
                           learning_rate=tm.LR)
    new_j, loss_j = step(js.params, jnp.asarray(tm.target().numpy()),
                         jax.random.PRNGKey(tm.STEP_SEED))
    assert float(got["loss"]) == pytest.approx(float(loss_j), rel=1e-4)
    new_t, p0 = _unflat(got["params"]), jax.tree.map(np.asarray, js.params)
    new_j = jax.tree.map(np.asarray, new_j)
    moved = 0.0
    for k in new_j:
        for a, b, start in zip(*(x if isinstance(x, list) else [x]
                                 for x in (new_t[k], new_j[k], p0[k]))):
            step_k = np.abs(b - start).max() if b.size else 0.0
            moved = max(moved, step_k)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * step_k + 1e-6, err_msg=k)
    assert moved > 0

    states = []
    img_j, count_j, _ = jad.render_adaptive(
        js, cam, jax.random.PRNGKey(tm.ADAPT_SEED), **tm.ADAPT, mesh=mesh,
        on_round=lambda s1, s2, c, r: states.append(tuple(np.asarray(x) for x in (s1, s2, c))))
    for name, want in zip(("a_s1", "a_s2"), states[0][:2]):
        np.testing.assert_allclose(got[name], want, rtol=RTOL, atol=ATOL, err_msg=name)
    k = int(tm.W * tm.H * tm.ADAPT["frac"])
    near = _near_ties(states[:-1], k)
    off = got["a_count"] != np.asarray(count_j)
    assert not (off & ~near).any(), f"counts differ at {np.argwhere(off & ~near).tolist()}"
    np.testing.assert_allclose(got["a_img"][~off], np.asarray(img_j)[~off], rtol=RTOL,
                               atol=ATOL)
