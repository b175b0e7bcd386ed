"""The image gather and its transpose (ptx_torch.ops.imagegrad, the plain
side of K3) against the JAX package's ``ptx.ops.imagegrad``.

On the CPU ``image_gather``'s backward runs ``hist_reference``
(``index_put_`` with accumulation), the plain version of K3.  Both are
held against the JAX gather's gradient (its CPU scatter path) and one
small interpret-mode call of the TPU histogram kernel, as
``tests/test_imagegrad.py`` makes it.  Sums of the same float32 terms in
another order: ``rtol 1e-5, atol 1e-6``; the TPU kernel's hi/lo bf16
split is good to ~2^-17 relative, hence its looser bound.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.ops import imagegrad as jig
from ptx_torch.ops import imagegrad

torch.set_num_threads(1)


def _case(H=8, W=16, C=4, N=1024, seed=0):
    r = np.random.default_rng(seed)
    yi = r.integers(-2, H + 2, N)
    xi = r.integers(-2, W + 2, N)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    xc, yc = np.clip(xi, 0, W - 1), np.clip(yi, 0, H - 1)
    vals = r.normal(size=(N, C)).astype(np.float32)
    img = r.normal(size=(H, W, C)).astype(np.float32)
    return img, xc, yc, inb, vals


def _jax_grad(img, xc, yc, inb, vals):
    def loss(im):
        out = jig.image_gather(im, jnp.asarray(xc, jnp.int32), jnp.asarray(yc, jnp.int32),
                               jnp.asarray(inb))
        return jnp.sum(out * jnp.asarray(vals))
    return np.asarray(jax.grad(loss)(jnp.asarray(img)))


@pytest.mark.parametrize("shape", [(8, 16, 4), (5, 130, 3)])
def test_image_gather_forward_and_gradient_match_jax(shape):
    H, W, C = shape
    img, xc, yc, inb, vals = _case(H, W, C, N=2048, seed=H)
    x = torch.from_numpy(img).requires_grad_(True)
    calls = imagegrad.REFERENCE_CALLS
    out = imagegrad.image_gather(x, torch.from_numpy(xc), torch.from_numpy(yc),
                                 torch.from_numpy(inb))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.where(inb[:, None], img[yc, xc], 0.0))
    (out * torch.from_numpy(vals)).sum().backward()
    assert imagegrad.REFERENCE_CALLS == calls + 1
    np.testing.assert_allclose(x.grad.numpy(), _jax_grad(img, xc, yc, inb, vals),
                               rtol=1e-5, atol=1e-6)


def test_hist_reference_matches_the_tpu_kernel_interpreted():
    img, xc, yc, inb, vals = _case()
    H, W, C = img.shape
    hist = jig._build_hist(H, W, C, interpret=True)
    y = jnp.where(jnp.asarray(inb), jnp.asarray(yc), -1).astype(jnp.float32)
    want = np.asarray(hist(y, jnp.asarray(xc, jnp.float32), jnp.asarray(vals)))
    got = imagegrad.hist_reference(torch.from_numpy(yc), torch.from_numpy(xc),
                                   torch.from_numpy(inb), torch.from_numpy(vals),
                                   (H, W, C))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=3e-5)


def test_sky_texture_gradient_goes_through_image_gather():
    """The demo sky chain's image gradient is the gather transpose."""
    from ptx_torch.scenes.builders import make_world
    from ptx_torch.integrate import trace

    scene = trace.compile_scene(make_world(), "cpu")
    (mi, fn), = scene.material_fn.terminal_dynamic_emissive
    r = np.random.default_rng(1)
    pos = torch.from_numpy(r.normal(size=(64, 3)).astype(np.float32))
    img = scene.params["images"][0].clone().requires_grad_(True)
    params = dict(scene.params, images=[img])
    calls = imagegrad.REFERENCE_CALLS
    fn(params, pos).sum().backward()
    assert imagegrad.REFERENCE_CALLS == calls + 1
    assert float(img.grad.abs().sum()) > 0


def test_hist_kernel_wrapper_refuses_a_launch_off_the_card():
    """Off the CPU the wrapper launches or raises; here a meta tensor
    has no kernel."""
    meta = torch.empty((4, 4), device="meta")
    idx = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        imagegrad.hist(idx, idx, idx.bool(), meta, (2, 2, 4))
