"""The banded image-gradient histogram K8's plain side, its lane sort, and
the coarse estimator, against the JAX package's ``ptx.ops.imagegrad``.

- ``hist_reference`` (K8's plain version) against ``_build_banded_hist``
  run in interpret mode on a 130×600×4 image, one call: sums of the same
  float32 terms, the TPU kernel's hi/lo bf16 split good to ~2⁻¹⁷
  relative, hence ``rtol 1e-4, atol 3e-5`` as in tests/test_torch_imagegrad.py.
- The wrapper's lane sort (bin ids, stable argsort, searchsorted offsets,
  the packed row gather): walking each image block's lane range, as the
  kernel does, gives ``hist_reference``'s histogram.
- ``PTX_IMG_GRAD_COARSE``: equal to the JAX estimator when k divides H
  and W; where it does not, every coarse bin's total is exact (the JAX
  estimator undercounts the edge bins).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ptx.ops import imagegrad as jig
from ptx_torch.ops import imagegrad

torch.set_num_threads(1)


def _case(H, W, C=4, N=4096, seed=0):
    r = np.random.default_rng(seed)
    yi = r.integers(-3, H + 3, N)
    xi = r.integers(-3, W + 3, N)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    vals = r.normal(size=(N, C)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(np.clip(yi, 0, H - 1)), t(np.clip(xi, 0, W - 1)), t(inb), t(vals))


def test_hist_reference_matches_the_banded_tpu_kernel_interpreted():
    shape = (130, 600, 4)
    yi, xi, inb, ct = _case(*shape[:2])
    assert not imagegrad.fits_k3(shape)              # the image K8 takes
    hist = jig._build_banded_hist(*shape, interpret=True)
    y = jnp.where(jnp.asarray(inb.numpy()), jnp.asarray(yi.numpy()), -1).astype(jnp.float32)
    want = np.asarray(hist(y, jnp.asarray(xi.numpy(), jnp.float32), jnp.asarray(ct.numpy())))
    calls = imagegrad.REFERENCE_CALLS
    got = imagegrad.hist(yi, xi, inb, ct, shape)     # K8's wrapper on the CPU
    assert imagegrad.REFERENCE_CALLS == calls + 1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=3e-5)


def test_lane_sort_feeds_each_block_its_lanes():
    shape = (70, 530, 3)                              # ragged blocks on both axes
    yi, xi, inb, ct = _case(*shape[:2], C=3, seed=1)
    rows, offs = imagegrad.BandedHistKernel.sort_lanes(yi, xi, inb, ct, shape)
    H, W, C = shape
    n_bx = -(-W // imagegrad.BLOCK_W)
    assert offs.dtype == torch.int32 and offs.numel() == -(-H // imagegrad.BLOCK_H) * n_bx + 1
    assert int(offs[-1]) == int(inb.sum())            # skipped lanes sort last
    out = torch.zeros(shape)
    for b in range(offs.numel() - 1):                 # the kernel's walk, block by block
        y0, x0 = (b // n_bx) * imagegrad.BLOCK_H, (b % n_bx) * imagegrad.BLOCK_W
        blk = rows[int(offs[b]):int(offs[b + 1])]
        y, x = blk[:, 0].long(), blk[:, 1].long()
        assert bool(((y >= y0) & (y < y0 + imagegrad.BLOCK_H) & (x >= x0)
                     & (x < x0 + imagegrad.BLOCK_W)).all())
        out.index_put_((y, x), blk[:, 2:], accumulate=True)
    want = imagegrad.hist_reference(yi, xi, inb, ct, shape)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def _jax_coarse(yi, xi, inb, ct, shape, k):
    """The JAX package's estimator (imagegrad.py:355-373) from its pieces:
    the coarse histogram, divided by k², each bin repeated k×k, cut."""
    H, W, C = shape
    Hc, Wc = -(-H // k), -(-W // k)
    y = jnp.where(jnp.asarray(inb.numpy()), jnp.asarray(yi.numpy()) // k, -1)
    g = jig._build_hist(Hc, Wc, C, interpret=True)(
        y.astype(jnp.float32), (jnp.asarray(xi.numpy()) // k).astype(jnp.float32),
        jnp.asarray(ct.numpy())) / float(k * k)
    return np.asarray(jnp.repeat(jnp.repeat(g, k, axis=0), k, axis=1)[:H, :W])


@pytest.mark.parametrize("shape", [(128, 512, 4), (130, 600, 4)], ids=["divides", "ragged"])
def test_coarse_estimator(shape, monkeypatch):
    k = 8
    yi, xi, inb, ct = _case(*shape[:2], seed=2)
    monkeypatch.setattr(imagegrad, "COARSE", k)
    got = imagegrad.hist(yi, xi, inb, ct, shape).numpy()
    H, W, C = shape
    assert got.shape == shape
    exact = imagegrad.hist_reference(yi, xi, inb, ct, shape).numpy()
    Hc, Wc = -(-H // k), -(-W // k)
    pad = lambda a: np.pad(a, ((0, Hc * k - H), (0, Wc * k - W), (0, 0)))
    totals = lambda a: pad(a).reshape(Hc, k, Wc, k, C).sum(axis=(1, 3))
    np.testing.assert_allclose(totals(got), totals(exact), rtol=1e-5, atol=1e-5)
    jax_est = _jax_coarse(yi, xi, inb, ct, shape, k)
    if H % k == 0 and W % k == 0:
        np.testing.assert_allclose(got, jax_est, rtol=1e-4, atol=3e-5)
    else:                              # the JAX edge bins lose the mass cut off
        assert not np.allclose(totals(jax_est), totals(exact), rtol=1e-3, atol=1e-3)
