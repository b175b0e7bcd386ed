"""The image-gradient histogram K8's plain side, its wrapper's refusals,
the routing, and the coarse estimator, against the JAX package's
``ptx.ops.imagegrad``.

- ``hist_reference`` (K8's plain version) against ``_build_banded_hist``
  run in interpret mode on a 130×600×4 image, one call: sums of the same
  float32 terms, the TPU kernel's hi/lo bf16 split good to ~2⁻¹⁷
  relative, hence ``rtol 1e-4, atol 3e-5`` as in tests/test_torch_imagegrad.py.
- K8's wrapper refuses what its kernel cannot take (an image of 2³¹
  floats or more, more than 4 channels, another device), and ``hist``
  routes at K3's shared-memory edge; K3's plan (its regime and grid) is a
  pure function of N and the shape.
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


@pytest.mark.parametrize("case", ["image-2^31-floats", "five-channels", "meta-device"])
def test_k8_wrapper_refuses(case):
    """K8's wrapper raises, before any build or launch, for an image of
    2³¹ floats or more (its texel index is int32), for more than 4
    channels, and for a device that is neither CUDA nor the CPU."""
    yi, xi, inb, ct = _case(8, 8, C=5 if case == "five-channels" else 4, N=64)
    shape = {"image-2^31-floats": (1 << 15, 1 << 14, 4), "five-channels": (8, 8, 5),
             "meta-device": (8, 8, 4)}[case]
    launches = imagegrad.BandedHistKernel.LAUNCHES
    with pytest.raises(ValueError, match="2\\^31|channels|no kernel"):
        if case == "meta-device":
            imagegrad.k8(*(x.to("meta") for x in (yi, xi, inb, ct)), shape)
        else:
            imagegrad.k8.launch(yi, xi, inb, ct, shape)
    assert imagegrad.BandedHistKernel.LAUNCHES == launches


@pytest.mark.parametrize("grow", [0, 1], ids=["at-the-edge", "one-texel-past"])
def test_hist_routes_at_the_k3_edge(grow, monkeypatch):
    """``hist`` gives K3 an image of exactly ``K3_MAX_BYTES`` and K8 one
    texel row more; with ``PTX_IMG_GRAD_COARSE`` a coarse image that fits
    K3 goes to the coarse estimator instead of K8."""
    C = 4
    W = imagegrad.K3_MAX_BYTES // (4 * C * 454)       # 454 x 32 x 4 floats = 227 KB
    shape = (454 + grow, W, C)
    assert imagegrad.fits_k3(shape) == (grow == 0)
    yi, xi, inb, ct = _case(*shape[:2], seed=3)
    calls = []
    monkeypatch.setattr(imagegrad, "k3", lambda *a: calls.append("K3") or
                        imagegrad.hist_reference(*a))
    monkeypatch.setattr(imagegrad, "k8", lambda *a: calls.append("K8") or
                        imagegrad.hist_reference(*a))
    got = imagegrad.hist(yi, xi, inb, ct, shape)
    assert calls == ["K3" if grow == 0 else "K8"]
    np.testing.assert_array_equal(got.numpy(), imagegrad.hist_reference(
        yi, xi, inb, ct, shape).numpy())
    monkeypatch.setattr(imagegrad, "COARSE", 2)
    calls.clear()
    imagegrad.hist(yi, xi, inb, ct, shape)
    assert calls == ["K3"]                           # grow 0: K3 itself; 1: the coarse K3


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


@pytest.mark.parametrize("N,shape,want", [
    (65_536, (64, 128, 4), (0, 128)),             # the demo chunk's sky-select: direct
    (4_194_304, (64, 128, 4), (0, 528)),          # a train step's: direct, 4 blocks an SM
    (33_554_431, (64, 128, 4), (0, 528)),         # just below 1,024 lanes an entry
    (33_554_432, (64, 128, 4), (1, 132)),         # at it: private, one 128 KB copy an SM
    (262_144, (8, 8, 4), (1, 512)),               # config 4's checker: 4 copies an SM
    (1_000, (454, 32, 4), (0, 2)),                # K3's largest image, few lanes
    (10**9, (454, 32, 4), (1, 132)),              # and private: one 227 KB copy an SM
], ids=["chunk", "train", "below", "at", "checker", "edge-direct", "edge-private"])
def test_k3_plan_routes_by_lanes_per_entry(N, shape, want):
    """K3's plan is a pure function of N, the shape and the SM count:
    fewer than ``K3_PRIVATE_LANES`` lanes per image entry take the direct
    regime (``private`` 0), more the private regime (1); a block per 512
    lanes, at most 4 an SM, and in the private regime only as many as
    their copies of the image fit an SM's shared memory."""
    H, W, C = shape
    assert imagegrad.k3_plan(N, shape, 132) == want
    private, blocks = want
    assert (N >= imagegrad.K3_PRIVATE_LANES * H * W * C) == bool(private)
    assert blocks <= -(-N // 512)
    if private:
        per_sm = -(-blocks // 132)
        assert per_sm * (H * W * C * 4 + 1024) <= imagegrad.K3_SM_SMEM
