"""The port's skybox, mirror-ball and log textures against
``ptx.shade.textures`` on the same positions.

Positions are built at texel-cell centres by inverting each map, so the
texel each lookup picks sits half a texel from any boundary and the two
packages must agree exactly on it: values within ``rtol 1e-6``, image
gradients (the gathers' transposes) within ``rtol 1e-5, atol 1e-6``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.shade import textures as jtx
from ptx_torch.ops import imagegrad
from ptx_torch.shade import textures as ttx

torch.set_num_threads(1)

H, W, N = 8, 12, 512


def _faces(r):
    return {k: r.uniform(0.1, 2.0, (H, W, 4)).astype(np.float32)
            for k in ("top", "bottom", "left", "right", "front", "back")}


def _skybox_dirs(r):
    """Directions at texel centres of random faces (image_texture.h:90-110
    inverted): face 0 top, 1 bottom, 2 left, 3 right, 4 front, 5 back."""
    face = r.integers(0, 6, N)
    u = 2.0 * (r.integers(0, W, N) + 0.5) / W - 1.0
    w = 1.0 - 2.0 * (r.integers(0, H, N) + 0.5) / H
    one = np.ones(N)
    table = {0: (u, one, w), 1: (-u, -one, w), 2: (-one, w, -u), 3: (one, w, u),
             4: (-u, w, one), 5: (u, w, -one)}
    v = np.zeros((N, 3))
    for f, cols in table.items():
        v[face == f] = np.stack(cols, -1)[face == f]
    return (v * r.uniform(1.0, 50.0, (N, 1))).astype(np.float32)


def _mirror_dirs(r):
    """Directions whose mirror-ball uv is a texel centre with radius < 0.95
    (transform_texture.h:46-59 inverted: nz = 1 − 2r², d = 2√(1 − r²))."""
    out = []
    while len(out) < N:
        a = 2.0 * (r.integers(0, W) + 0.5) / W - 1.0
        b = 2.0 * (r.integers(0, H) + 0.5) / H - 1.0
        r2 = a * a + b * b
        if r2 < 0.95 ** 2:
            d = 2.0 * np.sqrt(1.0 - r2)
            out.append((a * d, b * d, 1.0 - 2.0 * r2))
    return (np.asarray(out) * r.uniform(1.0, 50.0, (N, 1))).astype(np.float32)


def _spherical_dirs(r):
    theta = ((r.integers(0, W, N) + 0.5) / W - 0.5) * 2.0 * np.pi
    phi = ((r.integers(0, H, N) + 0.5) / H - 0.5) * np.pi
    d = np.stack([np.cos(phi) * np.cos(theta), np.cos(phi) * np.sin(theta),
                  np.sin(phi)], -1)
    return (d * r.uniform(1.0, 50.0, (N, 1))).astype(np.float32)


def _cases():
    r = np.random.default_rng(0)
    img = r.uniform(0.0, 3.0, (H, W, 4)).astype(np.float32)
    img[::3, ::2] = 0.0                  # the log filter's zero branch
    faces = _faces(r)
    return {
        "skybox": (lambda m: m.Skybox(**faces), _skybox_dirs(r)),
        "skybox-alpha": (lambda m: m.Skybox(**faces, alpha=True), _skybox_dirs(r)),
        "mirror-ball": (lambda m: m.Multiply((1.5, 1.0, 0.5),
                                             m.MirrorBall(m.ImageTex(img))),
                        _mirror_dirs(r)),
        "log": (lambda m: m.Log(m.SphericalCoords(m.ImageTex(img))), _spherical_dirs(r)),
    }


CASES = _cases()


def _eval_jax(build, pos, wgt):
    comp = jtx.TextureCompiler()
    fn = comp.compile(build(jtx))
    params = comp.finalize()

    def loss(p):
        return jnp.sum(fn(p, jnp.asarray(pos)) * jnp.asarray(wgt))
    val = np.asarray(fn(params, jnp.asarray(pos)))
    return val, fn.spec, [np.asarray(g) for g in jax.grad(loss)(params)["images"]]


def _eval_port(build, pos, wgt):
    comp = ttx.TextureCompiler()
    fn = comp.compile(build(ttx))
    params = comp.finalize("cpu")
    params["images"] = [x.requires_grad_(True) for x in params["images"]]
    calls = imagegrad.REFERENCE_CALLS
    val = fn(params, torch.from_numpy(pos))
    (val * torch.from_numpy(wgt)).sum().backward()
    return (val.detach().numpy(), fn.spec, [x.grad.numpy() for x in params["images"]],
            imagegrad.REFERENCE_CALLS - calls)


@pytest.mark.parametrize("name", sorted(CASES))
def test_texture_matches_jax(name):
    build, pos = CASES[name]
    wgt = np.random.default_rng(1).uniform(0.2, 1.0, (N, 3)).astype(np.float32)
    want, spec_j, g_j = _eval_jax(build, pos, wgt)
    got, spec_t, g_t, hists = _eval_port(build, pos, wgt)
    assert spec_t == spec_j
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert len(g_t) == len(g_j)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # one gather, one histogram: the skybox's six faces share it
    assert hists == 1


def test_skybox_zero_direction_reads_black():
    comp = ttx.TextureCompiler()
    fn = comp.compile(ttx.Skybox(**_faces(np.random.default_rng(2))))
    out = fn(comp.finalize("cpu"), torch.zeros((4, 3)))
    assert torch.equal(out, torch.zeros((4, 3)))
