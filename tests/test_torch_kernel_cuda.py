"""The CUDA bounce kernel (K1) on the card, against its plain PyTorch version.

This file imports no jax, so it runs on a machine with a card and no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

(``--noconftest``: tests/conftest.py configures jax).  Without a CUDA
device every test here skips.  Decisions must be identical and floats
within ``rtol 1e-5, atol 5e-6``: the kernel follows the plain version's
operation order and is built without multiply-add contraction, so the
two round alike; chip_smoke.py adjudicates near-tie flips at full size.
"""

import pytest
import torch

from ptx_torch.core import rng
from ptx_torch.integrate import trace
from ptx_torch.integrate.camera import Camera, sample_rays
from ptx_torch.ops import bounce_kernel
from ptx_torch.scenes.builders import make_world

_DECISIONS = ("evt", "hit", "entering", "mat_id", "take_transmit",
              "scatter_alive", "alive2")
_FLOATS = ("t", "o2", "d2", "thr2", "strength2")


@pytest.fixture(scope="module")
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bounce kernel has no CPU mode")
    return trace.compile_scene(make_world(), torch.device("cuda"))


@pytest.mark.cuda
def test_kernel_matches_reference(cuda_scene):
    """Three chained bounces of 64×64 primary demo rays."""
    scene, dev = cuda_scene, cuda_scene.device
    o, d = sample_rays(Camera.reference_demo(64, 64), rng.PRNGKey(0),
                       range(64), range(64), 1, dev)
    n = 64 * 64
    carry = (o.reshape(-1, 3), d.reshape(-1, 3), torch.ones((n, 3), device=dev),
             torch.ones(n, device=dev), torch.ones(n, dtype=torch.bool, device=dev))
    launches = bounce_kernel.LAUNCHES
    for b in range(3):
        uc = rng.uniform(rng.PRNGKey(b), (n,), dev)
        u3 = rng.uniform(rng.PRNGKey(100 + b), (n, 3), dev)
        kb = scene.bounce_fn(scene.params, *carry, uc, u3, True)
        ref = bounce_kernel.bounce_reference(scene, scene.params, *carry, uc,
                                             u3, True)
        torch.cuda.synchronize()
        for k in _DECISIONS:
            assert torch.equal(kb[k], ref[k]), (b, k)
        for k in _FLOATS:
            torch.testing.assert_close(kb[k], ref[k], rtol=1e-5, atol=5e-6)
        carry = (kb["o2"], kb["d2"], kb["thr2"], kb["strength2"], kb["alive2"])
    assert bounce_kernel.LAUNCHES == launches + 3


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_scene):
    """Wrong dtype, shape or device raises instead of launching."""
    scene, dev = cuda_scene, cuda_scene.device
    n = 128
    good = dict(o=torch.zeros((n, 3), device=dev), d=torch.ones((n, 3), device=dev),
                thr=torch.ones((n, 3), device=dev), st=torch.ones(n, device=dev),
                al=torch.ones(n, dtype=torch.bool, device=dev),
                uc=torch.rand(n, device=dev), u3=torch.rand((n, 3), device=dev))
    for name, bad in (("d", torch.ones((n, 3), device=dev, dtype=torch.float64)),
                      ("st", torch.ones((n, 1), device=dev)),
                      ("u3", torch.rand((3, n), device=dev).T)):
        args = dict(good, **{name: bad})
        with pytest.raises(ValueError):
            scene.bounce_fn(scene.params, *args.values(), True)


@pytest.mark.cuda
def test_trace_rays_on_cuda_uses_only_the_kernel(cuda_scene):
    """A compacted 16,384-ray wavefront at depth 8 through trace_rays:
    every bounce is one K1 launch, the plain bounce never runs."""
    scene = cuda_scene
    o, d = sample_rays(Camera.reference_demo(128, 128), rng.PRNGKey(1),
                       range(128), range(128), 1, scene.device)
    k0, p0 = bounce_kernel.LAUNCHES, bounce_kernel.REFERENCE_CALLS
    rad = trace.trace_rays(scene, scene.params, o, d, rng.PRNGKey(1), 8)
    torch.cuda.synchronize()
    assert bounce_kernel.LAUNCHES - k0 == 9
    assert bounce_kernel.REFERENCE_CALLS == p0
    assert rad.shape == (1, 128, 128, 3) and bool(torch.isfinite(rad).all())
    assert float(rad.mean()) > 0
