"""The hit-only kernel K4's plain side: the port's dense first hit, which
K4's wrapper runs on CPU tensors, against the JAX package's TPU kernel
(``ptx.ops.fasthit_kernel.build_hit_kernel``) run in interpret mode, on
BASELINE config 4 with 1,024 lanes; and K4's scene buffer.

Same scene, params and rays: the winning event, hit and entering flags
must be equal, and ``t`` and the normal (on hit lanes) within ``rtol
1e-5, atol 5e-6``, or, at near-grazing lanes, within twice the JAX
value's error against a float64 recompute of the plain hit (XLA on the
CPU contracts multiply-adds, PyTorch does not: tests/test_torch_bounce.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.integrate import trace as jtr
from ptx.ops.fasthit_kernel import build_hit_kernel
from ptx.scenes import builders as jbuilders
from ptx_torch.convert import params_from_jax, scene_from_jax
from ptx_torch.geom.fasthit import collect_leaves
from ptx_torch.integrate import trace
from ptx_torch.ops import fasthit_kernel

torch.set_num_threads(1)

N = 1024


@pytest.fixture(scope="module")
def pair():
    root = jbuilders.baseline_config4()
    js = jtr.compile_scene(root, pallas=False)
    ts = trace.compile_scene(scene_from_jax(root), "cpu")
    ts.params = params_from_jax(jax.tree.map(np.asarray, js.params), "cpu")
    return js, ts


def _rays():
    """Camera-like rays from the origin and rays from random points inside
    the sky box, some inside the spheres."""
    r = np.random.default_rng(0)
    o = np.zeros((N, 3), np.float32)
    o[N // 2:] = r.uniform(-3.0, 3.0, (N // 2, 3))
    o[N // 2::7] = (0.0, 0.0, -4.0) + r.uniform(-0.5, 0.5, (len(o[N // 2::7]), 3))
    d = r.normal(size=(N, 3)).astype(np.float32)
    d[: N // 2, 2] = -np.abs(d[: N // 2, 2]) - 1.0
    return o.astype(np.float32), d.astype(np.float32)


def test_plain_hit_matches_the_tpu_kernel_interpreted(pair):
    js, ts = pair
    o, d = _rays()
    want = build_hit_kernel(js.plan)(js.params, jnp.asarray(o), jnp.asarray(d))
    calls = fasthit_kernel.REFERENCE_CALLS
    got = ts.hit_fn(ts.params, torch.from_numpy(o), torch.from_numpy(d))
    assert fasthit_kernel.REFERENCE_CALLS == calls + 1
    want = {k: np.asarray(v) for k, v in want.items()}
    hit = want["hit"]
    assert hit.mean() > 0.9
    for k in ("hit", "entering", "_evt", "mat_id"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    p64 = {k: ([x.double() for x in v] if isinstance(v, list) else v.double())
           for k, v in ts.params.items()}
    truth = ts.plain_hit_fn(p64, torch.from_numpy(o).double(), torch.from_numpy(d).double())
    np.testing.assert_array_equal(truth["_evt"].numpy(), want["_evt"])
    for k in ("t", "normal"):
        g, w, t = (np.asarray(x, np.float64)[hit] for x in (got[k], want[k], truth[k]))
        off = ~np.isclose(g, w, rtol=1e-5, atol=5e-6)
        worse = np.abs(g - t) > 2.0 * np.abs(w - t) + 5e-6 + 1e-5 * np.abs(t)
        assert not (off & worse).any(), (k, g[off & worse], w[off & worse])


def test_geometry_buffer_has_no_material_scalars(pair):
    """K4's buffer: leaf records, geometry, then the tape, which closes it
    (K1's buffer appends the material rows to this one)."""
    _, ts = pair
    buf, (L, tape_off, tape_len) = fasthit_kernel.pack_geometry(ts.plan, ts.params)
    assert L == len(collect_leaves(ts.plan)) == 9
    assert tape_off + tape_len == buf.numel()
    assert torch.equal(ts.hit_fn.pack(ts.params), buf)
    # the tape is a postfix program: one push per leaf, one op per join
    prog = buf[tape_off:].tolist()
    assert sorted(int(x) for x in prog if x >= 0) == list(range(L))


def test_hit_wrapper_refuses_a_launch_off_the_card(pair):
    _, ts = pair
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError):
        ts.hit_fn(ts.params, meta, meta)
