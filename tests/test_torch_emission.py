"""The fused emission kernel K7's plain side against the JAX package.

- The port's emission as K7's wrapper runs it on CPU tensors (``_Emission``
  with the plain forward ``lanes_reference`` and the plain backward
  ``backward_reference``) against the JAX package's TPU kernel
  (``ptx.ops.emission_kernel.build_emission_fn``) run in interpret mode,
  on the demo's rotated equirect sky and on a mirror-ball probe world
  with its ``Multiply`` factor.  Positions sit at texel-cell centres (each
  map inverted, as ``tests/test_emission_kernel.py`` builds them), so both
  pick the same texel: values within ``rtol 1e-5`` (the TPU kernel carries
  the image as a hi/lo bf16 pair, ~2⁻¹⁷ relative), their VJPs within
  ``rtol 1e-4, atol 1e-5`` (the TPU histogram's hi/lo split again).
- The two plain versions called as the card's wrapper calls its kernels:
  ``lanes_reference``'s ``em`` and bins (each chain lane's texel ``y·W +
  x``, every other lane ``H·W + row``), and ``backward_reference`` on a
  cotangent, against the TPU kernel's values and VJP.
- K7's backward on the CPU (one combined histogram over the image and the
  const rows, and the factor's reduction) against autograd of
  ``eval_emissive``: the same float32 terms summed in another order,
  ``rtol 1e-5, atol 1e-6``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.geom.tape import Sphere as JSphere
from ptx.integrate import trace as jtr
from ptx.ops.emission_kernel import build_emission_fn
from ptx.scenes import builders as jbuilders
from ptx_torch.convert import params_from_jax, scene_from_jax
from ptx_torch.integrate import trace
from ptx_torch.ops import emission_kernel as ek

torch.set_num_threads(1)

N = 1024


def _mirror_world():
    r = np.random.default_rng(7)
    probe = r.uniform(0.0, 2.0, (16, 32, 4)).astype(np.float32)
    sky = jbuilders.make_sky_mirror_sphere(probe, scale=(1.5, 1.0, 0.5))
    return jbuilders.union_array([JSphere((0.0, 0.0, -4.0), 1.0,
                                          jbuilders.Material(reflect=0.8, scatter=1.0))]
                                 + jbuilders.sky_planes(sky))


WORLDS = {"demo": jbuilders.make_world, "mirror-ball": _mirror_world}


def _interior_positions(kern, params, n, seed):
    """Positions whose chain uv is a texel-cell centre."""
    img = params["images"][kern.img_id]
    H, W = img.shape[0], img.shape[1]
    r = np.random.default_rng(seed)
    u = (r.integers(0, W, 4 * n) + 0.5) / W
    w = (r.integers(0, H, 4 * n) + 0.5) / H
    if kern.mirror:                  # nz = 1 − 2ρ², d = 2√(1 − ρ²), ρ < 0.95
        a, b = 2.0 * u - 1.0, 2.0 * w - 1.0
        rho2 = a * a + b * b
        keep = np.nonzero(rho2 < 0.95 ** 2)[0][:n]
        a, b, rho2 = a[keep], b[keep], rho2[keep]
        dd = 2.0 * np.sqrt(1.0 - rho2)
        d = np.stack([a * dd, b * dd, 1.0 - 2.0 * rho2], -1)
    else:
        theta, phi = (u[:n] - 0.5) * 2.0 * np.pi, (w[:n] - 0.5) * np.pi
        d = np.stack([np.cos(phi) * np.cos(theta), np.cos(phi) * np.sin(theta),
                      np.sin(phi)], -1)
    assert d.shape == (n, 3)
    d = d * r.uniform(5.0, 50.0, (n, 1))
    if kern.xform_idx is not None:
        A = params["tex_xform"][kern.xform_idx].numpy().astype(np.float64)
        d = (np.linalg.inv(A[:, :3]) @ (d - A[:, 3]).T).T
    return d.astype(np.float32)


@pytest.fixture(scope="module", params=sorted(WORLDS))
def case(request):
    root = WORLDS[request.param]()
    js = jtr.compile_scene(root, pallas=False)
    ts = trace.compile_scene(scene_from_jax(root), "cpu")
    ts.params = params_from_jax(jax.tree.map(np.asarray, js.params), "cpu")
    assert ek.supported(ts.material_fn)
    kern = ek.EmissionKernel(ts.material_fn, "cpu")
    jfn = build_emission_fn(js.material_fn, [np.asarray(x) for x in js.params["images"]])
    r = np.random.default_rng(3)
    pos = _interior_positions(kern, ts.params, N, seed=2)
    mid = r.integers(0, ts.material_fn.n_materials, N)
    wgt = r.uniform(0.2, 1.0, (N, 3)).astype(np.float32)
    return js, ts, kern, jfn, pos, mid, wgt


def _leaf_params(params):
    return {k: ([x.clone().requires_grad_(True) for x in v] if isinstance(v, list)
                else v.clone().requires_grad_(True)) for k, v in params.items()}


def test_plain_emission_matches_the_tpu_kernel_interpreted(case):
    js, ts, kern, jfn, pos, mid, wgt = case
    want = np.asarray(jfn(js.params, jnp.asarray(pos), jnp.asarray(mid, jnp.int32)))
    calls = ek.REFERENCE_CALLS
    got = kern(ts.params, torch.from_numpy(pos), torch.from_numpy(mid))
    assert ek.REFERENCE_CALLS == calls + 1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    sel = mid == kern.dyn_mi
    assert sel.any() and np.abs(want[sel]).max() > 0

    def loss(p):
        return jnp.sum(jfn(p, jnp.asarray(pos), jnp.asarray(mid, jnp.int32)) * wgt)
    g_j = jax.grad(loss)(js.params)
    p = _leaf_params(ts.params)
    (kern(p, torch.from_numpy(pos), torch.from_numpy(mid)) * torch.from_numpy(wgt)).sum().backward()
    for k in ("const", "factor"):
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(g_j[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(p["images"][kern.img_id].grad.numpy(),
                               np.asarray(g_j["images"][kern.img_id]), rtol=1e-4,
                               atol=1e-5)


def test_backward_through_one_combined_histogram(case):
    """``_Emission`` on the CPU (its plain forward and backward): the image,
    const-row and factor gradients equal autograd of ``eval_emissive``, and
    the backward makes one histogram call."""
    from ptx_torch.ops import imagegrad

    _, ts, kern, _, pos, mid, wgt = case
    pos_t, mid_t, wgt_t = (torch.from_numpy(x) for x in (pos, mid, wgt))
    p = _leaf_params(ts.params)
    em = ek._Emission.apply(kern, p["tex_xform"], p["const"], p["factor"],
                            p["images"][kern.img_id], pos_t, mid_t)
    calls = imagegrad.REFERENCE_CALLS
    (em * wgt_t).sum().backward()
    assert imagegrad.REFERENCE_CALLS == calls + 1
    q = _leaf_params(ts.params)
    want = ts.material_fn.eval_emissive(q, pos_t, mid_t)
    (want * wgt_t).sum().backward()
    np.testing.assert_array_equal(em.detach().numpy(), want.detach().numpy())
    for name, a, b in (("const", p["const"], q["const"]), ("factor", p["factor"], q["factor"]),
                       ("image", p["images"][kern.img_id], q["images"][kern.img_id])):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert p["tex_xform"].grad is None


def test_plain_lanes_and_backward_match_the_tpu_kernel_interpreted(case):
    """``lanes_reference`` and ``backward_reference``, called as the card's
    wrapper calls its two kernels, against the TPU kernel's values and its
    VJP (``jax.vjp`` with the cotangent ``wgt``): ``em``; every chain lane's
    bin its texel (these positions are texel-cell centres, in bounds), every
    other lane's ``H·W`` + its const row; ``d_const``, ``d_factor`` and the
    image's gradient (zero in the alpha plane)."""
    js, ts, kern, jfn, pos, mid, wgt = case
    p = ts.params
    img = p["images"][kern.img_id]
    H, W = img.shape[0], img.shape[1]
    pos_t, mid_t = torch.from_numpy(pos), torch.from_numpy(mid)
    em, bin_ = ek.lanes_reference(kern, p["tex_xform"], p["const"], p["factor"], img, pos_t,
                                  mid_t)
    want, vjp = jax.vjp(lambda q: jfn(q, jnp.asarray(pos), jnp.asarray(mid, jnp.int32)),
                        js.params)
    np.testing.assert_allclose(em.numpy(), np.asarray(want), rtol=1e-5, atol=0)
    chain = mid == kern.dyn_mi
    b = bin_.numpy()
    assert b.dtype == np.int32
    assert ((b[chain] >= 0) & (b[chain] < H * W)).all()
    np.testing.assert_array_equal(b[~chain], H * W + kern.const_rows.numpy()[mid[~chain]])
    texel = img.reshape(H * W, -1)[torch.from_numpy(b[chain]).long(), :3]
    f = p["factor"][kern.factor_idx] if kern.factor_idx is not None else 1.0
    np.testing.assert_array_equal(em.numpy()[chain], (texel * f).numpy())

    (g_j,) = vjp(jnp.asarray(wgt))
    d_img, d_const, d_factor = ek.backward_reference(
        kern, torch.from_numpy(wgt), bin_, img, p["factor"], tuple(p["const"].shape),
        tuple(p["factor"].shape))
    np.testing.assert_allclose(d_const.numpy(), np.asarray(g_j["const"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(d_img.numpy(), np.asarray(g_j["images"][kern.img_id]),
                               rtol=1e-4, atol=1e-5)
    assert not d_img[..., 3:].any()
    assert (d_factor is None) == (kern.factor_idx is None)
    if d_factor is not None:
        np.testing.assert_allclose(d_factor.numpy(), np.asarray(g_j["factor"]), rtol=1e-4,
                                   atol=1e-5)
