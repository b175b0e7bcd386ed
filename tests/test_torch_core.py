"""Port building blocks against the JAX package: vector / affine math,
texture lookups and camera rays, including their edge cases (zero
vectors, total internal reflection, out-of-bounds texels, a posed
camera).  Float32 on both sides: values agree within a few ulps
(``rtol 1e-6, atol 1e-6``); guards and masks agree exactly.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.core import linalg as jl
from ptx.shade import textures as jtx
from ptx_torch.core import linalg as tl
from ptx_torch.shade import textures as ttx

torch.set_num_threads(1)


def _vecs(n, seed):
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3)).astype(np.float32)
    v[:4] = 0.0                                   # zero vectors pass through
    return v


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("fn", ["dot", "norm", "normalize", "reflect"])
def test_vector_ops(fn):
    a, b = _vecs(64, 0), _vecs(64, 1)
    if fn in ("dot", "reflect"):
        _close(getattr(tl, fn)(torch.from_numpy(a), torch.from_numpy(b)),
               getattr(jl, fn)(jnp.asarray(a), jnp.asarray(b)))
    else:
        _close(getattr(tl, fn)(torch.from_numpy(a)), getattr(jl, fn)(jnp.asarray(a)))


@pytest.mark.parametrize("fn", ["refract", "refract_strength"])
def test_refraction(fn):
    """Including total internal reflection (eta 1.3 at grazing angles),
    eta outside (EPS, 1/EPS) and zero normals/directions."""
    d, n = _vecs(256, 2), _vecs(256, 3)
    eta = np.random.default_rng(4).choice(
        np.float32([1.0, 1.3, 1 / 1.3, 0.0, 2e3]), 256).astype(np.float32)
    got = getattr(tl, fn)(torch.from_numpy(d), torch.from_numpy(eta),
                          torch.from_numpy(n))
    want = getattr(jl, fn)(jnp.asarray(d), jnp.asarray(eta), jnp.asarray(n))
    _close(got, want, 1e-5)
    np.testing.assert_array_equal(got.numpy() == 0, np.asarray(want) == 0)


def test_affines():
    dev = torch.device("cpu")
    a = tl.rotate((0.3, -1.0, 0.5), 0.7, dev)
    b = tl.translate((1.0, -2.0, 0.25), dev)
    ja = jl.rotate(jnp.asarray([0.3, -1.0, 0.5]), 0.7)
    jb = jl.translate((1.0, -2.0, 0.25))
    _close(a, ja)
    _close(tl.rotate_x(2 * math.pi / 4, dev), jl.rotate_x(2 * math.pi / 4))
    _close(tl.compose(a, b), jl.compose(ja, jb))
    _close(tl.inverse(tl.compose(a, b)), jl.inverse(jl.compose(ja, jb)), 2e-6)
    o, d = _vecs(16, 5), _vecs(16, 6)
    for got, want in zip(tl.transform_ray(a, torch.from_numpy(o), torch.from_numpy(d)),
                         jl.transform_ray(ja, jnp.asarray(o), jnp.asarray(d))):
        _close(got, want)


def _texture(lib, img):
    """Multiply ∘ Transformed ∘ (Spherical ∘ Image) — the sky chain shape —
    and an alpha image lookup on raw positions."""
    xf = np.asarray([[0.5, 0, 0, 0.1], [0, 2.0, 0, -0.3], [0, 0, 1.0, 0.0]],
                    np.float32)
    return [lib.Multiply((0.5, 2.0, 1.0), lib.TransformedTex(
                xf, lib.SphericalCoords(lib.ImageTex(img)))),
            lib.ImageTex(img, alpha=True)]


@pytest.mark.parametrize("which", [0, 1], ids=["sky-chain", "alpha-image"])
def test_texture_lookups(which):
    r = np.random.default_rng(7)
    img = r.random((5, 7, 4)).astype(np.float32)
    pos = r.uniform(-3, 3, (512, 3)).astype(np.float32)
    pos[:8] = 0.0                                   # zero direction
    pos[8:16, :2] = np.round(pos[8:16, :2])         # integral y → row H (black)
    jc, tc = jtx.TextureCompiler(), ttx.TextureCompiler()
    jfn = jc.compile(_texture(jtx, img)[which])
    tfn = tc.compile(_texture(ttx, img)[which])
    jp = {k: (jnp.asarray(np.array(v, np.float32)) if k != "images" else v)
          for k, v in jc.params.items()}
    jp["images"] = [jnp.asarray(x) for x in jc.images]
    want = jax.jit(jfn)(jp, jnp.asarray(pos))
    got = tfn(tc.finalize("cpu"), torch.from_numpy(pos))
    _close(got, want, 1e-6)


def test_unported_textures_raise():
    """Every texture node of the JAX package compiles, with its chain
    spec; a node the compiler does not know raises."""
    comp = ttx.TextureCompiler()
    assert comp.compile(ttx.MirrorBall(ttx.Constant(1.0))).spec == ("mirror", ("const", 0))
    assert comp.compile(ttx.Log(ttx.Constant(1.0))).spec == ("log", ("const", 1))
    with pytest.raises(TypeError, match="unknown texture node"):
        comp.compile(object())


def test_posed_camera_rays():
    from ptx.integrate.camera import Camera as JCamera, pixel_rays as jpix
    from ptx_torch.integrate.camera import Camera, pixel_rays

    pose = np.asarray(jl.compose(jl.translate((0.5, 1.0, -2.0)),
                                 jl.rotate_y(0.4)))
    r = np.random.default_rng(9)
    px, py = r.uniform(0, 32, 64).astype(np.float32), r.uniform(0, 24, 64).astype(np.float32)
    jit = r.random((64, 2), dtype=np.float32)
    want = jpix(JCamera(32, 24, pose=pose), jnp.asarray(px), jnp.asarray(py),
                jnp.asarray(jit))
    got = pixel_rays(Camera(32, 24, pose=pose), torch.from_numpy(px),
                     torch.from_numpy(py), torch.from_numpy(jit))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
