"""The row-fed replay backward K6's plain side against the JAX package's
``build_replay_bwd`` (run in interpret mode on the CPU, one call at B =
4,096, as tests/test_replay_bwd.py), on stress_spheres(25) and
stress_gadgets(12).

Same params, every pixel of a 64×64 frame of the demo camera, a random
throughput, the decisions of the port's plain bounce, random cotangents:

- per lane, ``bounce_bwd_lanes_reference`` (autograd through
  ``replay_lane_math``, which K6 is held against on the card) against a
  float64 recompute, relative to the lane's largest |value|: below 1e-6
  at the median and 0.5 at the worst lane, and no worse than twice the
  JAX kernel's error at the median and the 90th and 99th percentiles.
  Near-grazing hits and the mirror-ish material's 1/scatter bias make
  some lanes ill-conditioned: both sides are off the float64 value by up
  to a few 1e-2 there, and XLA contracts multiply-adds, so the two
  float32 results are compared through their error, by quantiles, as
  tests/test_replay_bwd.py gates the JAX kernel;
- ``d_params`` of the wrapper's CPU path (its ``d_packed``: the plain
  per-leaf sums folded onto the materials, ``fold_packed``) mapped
  through the packing's VJP (``params_grad``): per tensor, off the float64
  fold mapped to the params by at most twice the JAX kernel's largest
  error plus 1e-4 of the tensor's largest entry (the sums are dominated by
  the ill-conditioned lanes above).

The wrapper's call on the CPU gives ``d_packed``, the fold of the plain
per-leaf sums, and runs the plain version once.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ptx.geom import fasthit as jfast
from ptx.ops.replay_bwd import build_replay_bwd
from ptx_torch.ops import bounce_kernel as bk
from ptx_torch.ops.replay_bwd import RowFedReplayBwd

from test_torch_megasweep import pair_for

torch.set_num_threads(1)
B = 4096


def _inputs(ts, seed=3):
    """Every pixel of a 64×64 frame of the demo camera, a random
    throughput, the decisions of the port's plain bounce, and random
    cotangents."""
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera, sample_rays

    o, d = sample_rays(Camera.reference_demo(64, 64), rng.PRNGKey(seed), range(64),
                       range(64), 1, "cpu")
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    r = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    thr = f(r.uniform(0.2, 1.0, (B, 3)))
    out = ts.bounce_fn(ts.params, o, d, thr, torch.ones(B), torch.ones(B, dtype=torch.bool),
                       f(r.uniform(size=B)), f(r.uniform(size=(B, 3))), True)
    dec = {k: out[k] for k in ("evt", "hit", "entering", "take_transmit", "scatter_alive",
                               "u_sel", "mat_id")}
    cts = tuple(f(r.normal(size=(B, 3))) for _ in range(3))
    return o, d, thr, dec, cts


@pytest.mark.parametrize("name", ["spheres25", "gadgets12"])
def test_plain_k6_matches_the_tpu_kernel_interpreted(name):
    js, ts = pair_for(name)
    kern = ts.bounce_bwd_fn
    assert isinstance(kern, RowFedReplayBwd)
    o, d, thr, dec, cts = _inputs(ts)
    assert int((dec["take_transmit"] | dec["scatter_alive"]).sum()) > B // 4
    assert int(dec["take_transmit"].sum()) >= 8 or name == "spheres25"

    leaves = jfast.collect_leaves(js.plan)
    mf = js.material_fn
    jbwd = build_replay_bwd(leaves, (mf.const_idx, mf.n_materials),
                            [lf.mat_id for lf, _ in leaves])
    jn = lambda t: jnp.asarray(t.numpy())
    jdec = {k: jn(v) for k, v in dec.items() if k != "mat_id"}
    want = jbwd(js.params, jn(o), jn(d), jn(thr), jdec, *(jn(c) for c in cts))
    want_lanes = [np.asarray(w, np.float64) for w in want[:3]]

    packed = kern.pack(ts.params).detach()
    got = bk.bounce_bwd_lanes_reference(packed, kern.aux, o, d, thr, dec, *cts)
    truth = bk.bounce_bwd_lanes_reference(
        packed.double(), kern.aux.double(), o.double(), d.double(), thr.double(),
        dict(dec, u_sel=dec["u_sel"].double()), *(c.double() for c in cts))
    for name_, g, w, t in zip(("d_o", "d_d", "d_thr"), got[:3], want_lanes, truth[:3]):
        g, t = g.double().numpy(), t.numpy()
        assert np.isfinite(g).all()
        # per lane, the error against float64 relative to the lane's largest
        # |value| (module docstring)
        scale = np.maximum(np.abs(t).max(-1), 1e-6)
        eg, ew = (np.abs(x - t).max(-1) / scale for x in (g, w))
        assert np.quantile(eg, 0.5) < 1e-6 and eg.max() < 0.5, name_
        for q in (0.5, 0.9, 0.99):
            assert np.quantile(eg, q) <= 2 * np.quantile(ew, q) + 1e-6, (name_, q)

    want_p = {k: np.asarray(v, np.float64) for k, v in want[3].items()
              if k in kern.scene.diff_keys}
    d_packed = kern(packed, o, d, thr, dec, *cts)[3]          # the wrapper's CPU path
    cpu_p = kern.params_grad(*kern.pack_leaves(ts.params), d_packed)
    p64 = {k: (v if isinstance(v, list) else v.double()) for k, v in ts.params.items()}
    truth_p = kern.params_grad(*kern.pack_leaves(p64), bk.fold_packed(
        truth[3], kern.leaf_mat, kern.n_materials))
    for k, w in want_p.items():
        if not w.size:
            continue
        t = truth_p[k].numpy()
        tol = 2 * float(np.abs(w - t).max()) + 1e-4 * float(np.abs(t).max()) + 1e-7
        err = float(np.abs(cpu_p[k].double().numpy() - t).max())
        assert err <= tol, (k, err, tol)


@pytest.mark.parametrize("name", ["spheres25", "gadgets12"])
def test_k6_call_on_the_cpu_gives_the_packed_cotangent(name):
    """K6's call on CPU tensors takes the scene vector and returns its
    cotangent: the per-lane cotangents and the per-leaf sums folded onto
    the materials (``fold_packed``) of ``bounce_bwd_lanes_reference``, bit
    for bit, through one plain call and no launch; ``d_packed`` has the
    vector's L·26 + M·8 words."""
    _, ts = pair_for(name)
    kern = ts.bounce_bwd_fn
    assert isinstance(kern, RowFedReplayBwd)
    o, d, thr, dec, cts = _inputs(ts, seed=5)
    packed = kern.pack(ts.params).detach()
    assert packed.shape == (len(kern.leaves) * 26 + kern.n_materials * 8,)
    before = (bk.BWD_REFERENCE_CALLS, RowFedReplayBwd.LAUNCHES, bk.BounceBwdKernel.LAUNCHES)
    got = kern(packed, o, d, thr, dec, *cts)
    assert (bk.BWD_REFERENCE_CALLS, RowFedReplayBwd.LAUNCHES,
            bk.BounceBwdKernel.LAUNCHES) == (before[0] + 1, before[1], before[2])
    ref = bk.bounce_bwd_lanes_reference(packed, kern.aux, o, d, thr, dec, *cts)
    for g, w in zip(got[:3], ref[:3]):
        assert torch.equal(g, w)
    assert torch.equal(got[3], bk.fold_packed(ref[3], kern.leaf_mat, kern.n_materials))
    assert got[3].shape == packed.shape and bool(got[3].abs().sum() > 0)
