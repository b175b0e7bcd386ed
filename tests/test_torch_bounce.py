"""The bounce kernel's module (ptx_torch.ops.bounce_kernel) against the JAX
package's unfused live bounce.

On the CPU the wrapper runs ``bounce_reference``, the kernel's plain
PyTorch version (dense first hit + plain shading).  It must equal
``ptx.integrate.trace._bounce_live(use_fused=False)`` on the same params
(through ``params_from_jax``), rays and uniforms, over two chained
bounces: decisions exactly, floats within ``rtol 1e-5, atol 5e-6`` — the
tolerance of tests/test_bounce_kernel.py, because positions reach the
200-unit sky planes, where one ulp of ``t`` is ~3e-5 absolute.  Both
packages take each bounce from the same input carry (the JAX chain's):
XLA on the CPU contracts multiply-adds and PyTorch does not, so the
sphere discriminant differs in the last bits, and if each package
chained its own carry that direction difference would be carried over
~250-unit flights into the next bounce's positions.

Near-grazing hits are ill-conditioned in float32: there ``t`` carries
~10 ulps of error in either package and the normal ``(oc + t·d)/r``
cancels further (and a grazing cap draw feeds acos near ±1).  A float
that misses the tolerance passes only if the port's error against a
float64 recompute (the port's own plain code on float64 tensors, with
identical decisions) is at most twice the JAX package's own error there,
plus the tolerance: at such lanes the two float32 errors have the same
size, not the same sign or last digit.

The CUDA kernel itself runs only on a card: tests/test_torch_kernel_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.integrate import trace as jtr
from ptx.scenes import builders as jbuilders
from ptx_torch.convert import params_from_jax, scene_from_jax
from ptx_torch.integrate import trace as ttr
from ptx_torch.geom.fasthit import collect_leaves
from ptx_torch.ops import bounce_kernel, fasthit_kernel

torch.set_num_threads(1)

B = 256
_DECISIONS = ("evt", "hit", "entering", "mat_id", "take_transmit",
              "scatter_alive", "alive2")
_FLOATS = ("t", "o2", "d2", "thr2", "strength2")


def _np_params(params):
    return {k: ([np.asarray(x) for x in v] if isinstance(v, list)
                else np.asarray(v)) for k, v in params.items()}


def _inputs(seed):
    r = np.random.default_rng(seed)
    d = np.stack([r.uniform(-0.6, 0.6, B), r.uniform(-0.6, 0.6, B),
                  -np.ones(B)], -1).astype(np.float32)
    u = [(r.random(B, dtype=np.float32), r.random((B, 3), dtype=np.float32))
         for _ in range(2)]
    return np.zeros((B, 3), np.float32), d, u


def _ellipsoid_world():
    """Transformed leaves: ellipsoids turned a quarter about y or x and
    squashed by powers of two about their centres, one with a transformed
    bite (a difference: parity through a transform), under the demo sky
    and over a ground plane.  These affines invert exactly in float32, so
    both packages see the same W⁻¹ and the comparison tests the affine
    path itself, not two LU roundings (an arbitrary rotation's inverse
    differs by an ulp between the packages, and the sphere normal's
    cancellation ``oc + t·d`` amplifies that past 1e-5)."""
    from ptx.geom.tape import Difference, Plane, Sphere, Transformed
    from ptx.shade.materials import Material

    def about(c, lin):
        c = np.asarray(c, np.float32)
        lin = np.asarray(lin, np.float32)
        return np.concatenate([lin, (c - lin @ c)[:, None]], axis=1)

    quarter_y = [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]
    quarter_x = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]
    diffuse = Material(reflect=(0.8, 0.3, 0.3), scatter=1.0)
    mirror = Material(reflect=(0.9, 0.9, 0.9), scatter=0.05)
    glass = Material(reflect=0.7, scatter=0.0, transmit=0.9, ior=1.3,
                     transmit_reflect=1.0)
    parts = []
    for i, (c, lin, mat) in enumerate([
            ((-1.2, -0.5, -4.0), np.diag([2.0, 0.5, 1.0]) @ quarter_y, diffuse),
            ((0.0, -0.4, -3.5), np.diag([1.0, 1.0, 0.5]) @ quarter_x, glass),
            ((1.2, -0.5, -4.5), np.diag([0.5, 1.0, 2.0]), mirror)]):
        parts.append(Transformed(Sphere(c, 0.5, mat), about(c, lin)))
    bite_c = (0.3, 0.4, -5.0)
    parts.append(Difference(
        Sphere((0.0, 0.3, -5.0), 0.6, diffuse),
        Transformed(Sphere(bite_c, 0.35, mirror),
                    about(bite_c, np.diag([2.0, 1.0, 1.0]) @ quarter_y))))
    sky = jbuilders._stress_sky(jbuilders.procedural_sky_image())
    return jbuilders.union_array([
        *parts, Plane((0.0, 1.0, 0.0), 1.0, Material(reflect=0.6, scatter=1.0)),
        *jbuilders.sky_planes(sky)])


@pytest.fixture(scope="module", params=["demo", "transformed"])
def pair(request):
    """(JAX scene, port scene with the JAX params)."""
    root = (jbuilders.make_world() if request.param == "demo"
            else _ellipsoid_world())
    js = jtr.compile_scene(root, pallas=False)
    ts = ttr.compile_scene(scene_from_jax(root), "cpu")
    ts.params = params_from_jax(_np_params(js.params), "cpu")
    ts.bounce_fn = bounce_kernel.BounceKernel(ts)
    return js, ts


def _jax_chain(js, o, d, us):
    step = jax.jit(lambda params, o, d, thr, st, al, uc, u3: jtr._bounce_live(
        js, params, o, d, thr, st, al, jax.random.PRNGKey(0), True,
        use_fused=False, u_coin=uc, u3=u3))
    carry = (jnp.asarray(o), jnp.asarray(d), jnp.ones((B, 3)), jnp.ones(B),
             jnp.ones(B, bool))
    outs = []
    for uc, u3 in us:
        carry, dec = step(js.params, *carry, jnp.asarray(uc), jnp.asarray(u3))
        outs.append(dict(dec, o2=carry[0], d2=carry[1], thr2=carry[2],
                         strength2=carry[3], alive2=carry[4]))
    return outs


def _f64(params):
    return {k: ([x.double() for x in v] if isinstance(v, list) else v.double())
            for k, v in params.items()}


def _port_steps(ts, o, d, us, want, dtype=torch.float32):
    """The port's bounce b on the JAX chain's input carry of bounce b
    (computed in ``dtype``)."""
    params = ts.params if dtype == torch.float32 else _f64(ts.params)
    carry = (o, d, np.ones((B, 3), np.float32), np.ones(B, np.float32),
             np.ones(B, bool))
    outs = []
    for (uc, u3), w in zip(us, want):
        cast = lambda x: (torch.from_numpy(np.array(x)) if x.dtype == bool
                          else torch.from_numpy(np.array(x)).to(dtype))
        outs.append(ts.bounce_fn(params, *map(cast, carry), cast(uc), cast(u3),
                                 True))
        carry = [np.asarray(w[k]) for k in ("o2", "d2", "thr2", "strength2",
                                            "alive2")]
    return outs


def _assert_close(got, want, truth, name):
    """``got`` (port) vs ``want`` (JAX) within rtol 1e-5, atol 5e-6; an
    element outside must be within twice the JAX value's own distance from
    the float64 ``truth``, plus the tolerance (module docstring)."""
    got, want, truth = (np.asarray(x, np.float64) for x in (got, want, truth))
    tol = 5e-6 + 1e-5 * np.abs(truth)
    off = ~np.isclose(got, want, rtol=1e-5, atol=5e-6)
    worse = np.abs(got - truth) > 2.0 * np.abs(want - truth) + tol
    assert not (off & worse).any(), (
        f"{name}: {int((off & worse).sum())} elements beyond tolerance and "
        f"over twice the JAX value's error against float64; port "
        f"{got[off & worse][:4]}, JAX {want[off & worse][:4]}, "
        f"float64 {truth[off & worse][:4]}")


def test_bounce_reference_matches_jax(pair):
    js, ts = pair
    o, d, us = _inputs(0)
    calls = bounce_kernel.REFERENCE_CALLS
    want = _jax_chain(js, o, d, us)
    got = _port_steps(ts, o, d, us, want)
    assert bounce_kernel.REFERENCE_CALLS == calls + 2
    truth = _port_steps(ts, o, d, us, want, torch.float64)
    for b, (w, g, t64) in enumerate(zip(want, got, truth)):
        for k in _DECISIONS:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                          err_msg=f"bounce {b} {k}")
            np.testing.assert_array_equal(t64[k].numpy(), np.asarray(w[k]),
                                          err_msg=f"float64 bounce {b} {k}")
        for k in _FLOATS:
            _assert_close(g[k], w[k], t64[k], f"bounce {b} {k}")
        hit = np.asarray(w["hit"])
        _assert_close(g["u_sel"].numpy()[hit], np.asarray(w["u_sel"])[hit],
                      t64["u_sel"].numpy()[hit], f"bounce {b} u_sel")
    assert np.asarray(want[1]["alive2"]).any()


def test_dense_first_hit_matches_jax(pair):
    """The hit half of K1's plain version against the JAX dense hit_fn."""
    js, ts = pair
    o, d, _ = _inputs(1)
    want = jax.jit(js.hit_fn)(js.params, jnp.asarray(o), jnp.asarray(d))
    got = ts.hit_fn(ts.params, torch.from_numpy(o), torch.from_numpy(d))
    truth = ts.hit_fn(_f64(ts.params), torch.from_numpy(o).double(),
                      torch.from_numpy(d).double())
    for k in ("_evt", "hit", "entering", "mat_id"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(truth[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("t", "normal"):
        _assert_close(got[k], want[k], truth[k], k)


def test_wrapper_rejects_non_cuda_launch(pair):
    """On a non-CPU tensor the wrapper launches or raises; here there is no
    card, so a launch attempt on a meta tensor must raise."""
    _, ts = pair
    meta = torch.empty((B, 3), device="meta")
    with pytest.raises(ValueError):
        ts.bounce_fn(ts.params, meta, meta, meta, meta[:, 0], meta[:, 0].bool(),
                     meta[:, 0], meta, True)


def test_k1_follows_the_params_of_the_call():
    """A changed radius reaches both the plain bounce and the kernel's
    scene buffer, which ``trace_rays`` packs from the params of each call
    (the card-only test runs the kernel itself on it)."""
    from ptx_torch.scenes.builders import make_world

    ts = ttr.compile_scene(make_world(), "cpu")
    kern = ts.bounce_fn
    lf_i = next(i for i, (lf, _) in enumerate(collect_leaves(ts.plan))
                if lf.kind == "sphere" and lf.index == 1)
    lf = collect_leaves(ts.plan)[lf_i][0]
    grown = dict(ts.params, sphere_radius=ts.params["sphere_radius"] * 1.1)
    geo = lambda buf: int(buf[fasthit_kernel.LEAF_STRIDE * lf_i + 1])
    old, new = kern.pack(ts.params), kern.pack(grown)
    assert float(old[geo(old) + 3]) == float(ts.params["sphere_radius"][lf.index])
    assert float(new[geo(new) + 3]) == float(grown["sphere_radius"][lf.index])

    o, d, us = _inputs(2)
    carry = (torch.from_numpy(o), torch.from_numpy(d), torch.ones((B, 3)),
             torch.ones(B), torch.ones(B, dtype=torch.bool))
    uc, u3 = (torch.from_numpy(u) for u in us[0])
    before = kern(ts.params, *carry, uc, u3, True)
    after = kern(grown, *carry, uc, u3, True)
    want = bounce_kernel.bounce_reference(ts, grown, *carry, uc, u3, True)
    assert not torch.equal(before["t"], after["t"])
    for k in ("t", "evt", "o2", "d2"):
        assert torch.equal(after[k], want[k]), k
