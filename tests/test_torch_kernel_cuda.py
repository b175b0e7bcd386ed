"""The CUDA kernels on the card against their plain PyTorch versions: K1
(bounce), K2 (replay backward), K3 and K8 (image-gather transposes), K4
(first hit), K5 (megasweep: hit and bounce modes, 16- and 32-column
tables), K6 (row-fed replay backward), K7 (emission) and K9 (sweep
select, with and without its in-kernel sort).

This file imports no jax, so it runs on a machine with a card and no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

(``--noconftest``: tests/conftest.py configures jax).  Without a CUDA
device every test here skips.  Decisions must be identical and floats
within ``rtol 1e-5, atol 5e-6``: the kernel follows the plain version's
operation order and is built without multiply-add contraction, so the
two round alike; chip_smoke.py adjudicates near-tie flips at full size.
K2's hand adjoint orders its float32 operations unlike autograd: an
element passes within ``rtol 1e-5, atol 1e-6`` or within twice the plain
value's error against a float64 recompute plus 1e-4 relative (near-grazing
lanes are ill-conditioned).  K3 and K8 add with atomics in a varying
order: ``1e-5`` of each texel's sum of |ct|, or, for K8's degenerate
cases, the reordered-sum bound ``2·n·2⁻²⁴·Σ|ct|``.  K4 must equal the dense hit
as K1 does; K7 its plain lanes, with texel indices equal except where a
float64 recompute puts the lane within 1e-6 of a texel boundary.  K5 must
equal its plain version as K1 does, and culling must not change a bit;
K6 is held as K2.  K9 only compares, selects and takes maxima and minima:
its five outputs must equal its plain version's bit for bit.
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


def _k2_inputs(scene, n=64):
    """A primary bounce of n×n demo rays and its decisions, with random
    cotangents."""
    dev = scene.device
    o, d = sample_rays(Camera.reference_demo(n, n), rng.PRNGKey(3), range(n),
                       range(n), 1, dev)
    B = n * n
    carry = (o.reshape(-1, 3), d.reshape(-1, 3), torch.ones((B, 3), device=dev),
             torch.ones(B, device=dev), torch.ones(B, dtype=torch.bool, device=dev))
    uc = rng.uniform(rng.PRNGKey(4), (B,), dev)
    u3 = rng.uniform(rng.PRNGKey(5), (B, 3), dev)
    kb = scene.bounce_fn(scene.params, *carry, uc, u3, True)
    dec = {k: kb[k] for k in ("evt", "hit", "entering", "take_transmit",
                              "scatter_alive", "u_sel")}
    g = torch.Generator(device=dev).manual_seed(0)
    cts = [torch.randn((B, 3), device=dev, generator=g) for _ in range(3)]
    return carry, dec, cts


def _close(got, want, truth, scale=None):
    got, want, truth = (x.double() for x in (got, want, truth))
    scale = truth.abs() if scale is None else scale.double()
    ok = torch.isclose(got, want, rtol=1e-5, atol=1e-6) | (
        (got - truth).abs() <= 2 * (want - truth).abs() + 1e-4 * scale + 1e-6)
    assert bool(torch.isfinite(got).all()) and bool(ok.all()), int((~ok).sum())


@pytest.mark.cuda
def test_k2_matches_its_plain_version(cuda_scene):
    scene = cuda_scene
    carry, dec, cts = _k2_inputs(scene)
    kern = scene.bounce_bwd_fn
    packed = kern.pack(scene.params).detach()
    launches = bounce_kernel.BounceBwdKernel.LAUNCHES
    got = kern.launch(packed, *carry[:3], dec, *cts)
    again = kern.launch(packed, *carry[:3], dec, *cts)
    ref = bounce_kernel.bounce_bwd_lanes_reference(packed, kern.aux, *carry[:3], dec, *cts)
    ref64 = bounce_kernel.bounce_bwd_lanes_reference(
        packed.double(), kern.aux.double(), *(x.double() for x in carry[:3]),
        dict(dec, u_sel=dec["u_sel"].double()), *(c.double() for c in cts))
    torch.cuda.synchronize()
    assert bounce_kernel.BounceBwdKernel.LAUNCHES == launches + 2
    for g, w, t in zip(got[:3], ref[:3], ref64[:3]):
        _close(g, w, t)
    # d_packed against the per-leaf sums folded onto the materials, the
    # float64 fold as truth, at the scale of the folded sums of |term|
    fold = lambda acc: bounce_kernel.fold_packed(acc, kern.leaf_mat, kern.n_materials)
    assert got[3].shape == packed.shape
    _close(got[3], fold(ref[3]), fold(ref64[3]), fold(ref64[4]))
    for a, b in zip(got, again):            # the two-pass reduction is deterministic
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k1_follows_a_changed_radius_on_the_card(cuda_scene):
    scene = cuda_scene
    carry, _, _ = _k2_inputs(scene, 32)
    B = carry[0].shape[0]
    uc = rng.uniform(rng.PRNGKey(6), (B,), scene.device)
    u3 = rng.uniform(rng.PRNGKey(7), (B, 3), scene.device)
    grown = dict(scene.params, sphere_radius=scene.params["sphere_radius"] * 1.1)
    kb = scene.bounce_fn(grown, *carry, uc, u3, True)
    ref = bounce_kernel.bounce_reference(scene, grown, *carry, uc, u3, True)
    before = scene.bounce_fn(scene.params, *carry, uc, u3, True)
    torch.cuda.synchronize()
    assert torch.equal(kb["evt"], ref["evt"])
    torch.testing.assert_close(kb["t"], ref["t"], rtol=1e-5, atol=5e-6)
    assert not torch.equal(kb["t"], before["t"])


def _hist_case(shape, N=100_000, seed=1):
    H, W, C = shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    yi = torch.randint(0, H, (N,), device=dev, generator=g)
    xi = torch.randint(0, W, (N,), device=dev, generator=g)
    inb = torch.rand(N, device=dev, generator=g) < 0.9
    ct = torch.randn((N, C), device=dev, generator=g)
    return yi, xi, inb, ct


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128, 4)], ids=["shared"])
def test_k3_matches_its_plain_version(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the histogram kernel has no CPU mode")
    from ptx_torch.ops import imagegrad

    yi, xi, inb, ct = _hist_case(shape)
    launches = imagegrad.LAUNCHES
    got = imagegrad.hist(yi, xi, inb, ct, shape)
    want = imagegrad.hist_reference(yi, xi, inb, ct, shape)
    scale = imagegrad.hist_reference(yi, xi, inb, ct.abs(), shape)
    torch.cuda.synchronize()
    assert imagegrad.LAUNCHES == launches + 1
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-7).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 1024, 4), (250, 530, 3), (1536, 3072, 4)],
                         ids=["512x1024x4", "ragged-c3", "probe"])
def test_k8_matches_its_plain_version(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the histogram kernel has no CPU mode")
    from ptx_torch.ops import imagegrad

    yi, xi, inb, ct = _hist_case(shape, N=1 << 20)
    k3, k8 = imagegrad.LAUNCHES, imagegrad.BandedHistKernel.LAUNCHES
    got = imagegrad.hist(yi, xi, inb, ct, shape)
    want = imagegrad.hist_reference(yi, xi, inb, ct, shape)
    scale = imagegrad.hist_reference(yi, xi, inb, ct.abs(), shape)
    torch.cuda.synchronize()
    assert (imagegrad.LAUNCHES, imagegrad.BandedHistKernel.LAUNCHES) == (k3, k8 + 1)
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-7).all())


def _reordered_sum_ok(got, yi, xi, inb, ct, shape):
    """Within the reordered-sum bound ``2·n·2⁻²⁴·Σ|ct|`` per texel of n
    lanes (float atomics add in a varying order)."""
    from ptx_torch.ops import imagegrad

    want = imagegrad.hist_reference(yi, xi, inb, ct, shape)
    mag = imagegrad.hist_reference(yi, xi, inb, ct.abs(), shape)
    n = imagegrad.hist_reference(yi, xi, inb, torch.ones_like(ct), shape)
    return bool(torch.isfinite(got).all()) and bool(
        ((got - want).abs() <= 2 * n * 2.0 ** -24 * mag).all())


@pytest.mark.cuda
@pytest.mark.parametrize("C", [3, 4])
@pytest.mark.parametrize("case", ["one-texel", "all-skipped", "ragged-offset"])
def test_k8_degenerate_lanes(case, C):
    """K8 with every lane on one texel (all atomics on one address), with
    every lane skipped (an all-zero image), and on a ragged 250×530 image
    with ``ct`` a view one float into its storage (no 16-byte loads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the histogram kernel has no CPU mode")
    from ptx_torch.ops import imagegrad

    shape = (250, 530, C) if case == "ragged-offset" else (600, 500, C)
    yi, xi, inb, ct = _hist_case(shape, N=65_536, seed=2)
    if case == "one-texel":
        yi, xi = torch.full_like(yi, 123), torch.full_like(xi, 321)
    elif case == "all-skipped":
        inb = torch.zeros_like(inb)
    else:
        ct = torch.randn(ct.numel() + 1, device=ct.device)[1:].view(ct.shape)
    launches = imagegrad.BandedHistKernel.LAUNCHES
    got = imagegrad.hist(yi, xi, inb, ct, shape)
    torch.cuda.synchronize()
    assert imagegrad.BandedHistKernel.LAUNCHES == launches + 1
    assert _reordered_sum_ok(got, yi, xi, inb, ct, shape)
    if case == "all-skipped":
        assert not bool(got.any())
    if case == "one-texel":
        assert int((got != 0).any(dim=-1).sum()) == 1


@pytest.fixture(scope="module")
def config4_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hit kernel has no CPU mode")
    from ptx_torch.scenes.builders import baseline_config4
    return trace.compile_scene(baseline_config4(), torch.device("cuda"))


@pytest.mark.cuda
def test_config4_compiles_on_cuda_with_k4(config4_cuda):
    from ptx_torch.ops.fasthit_kernel import HitKernel

    assert isinstance(config4_cuda.hit_fn, HitKernel)
    assert isinstance(config4_cuda.bounce_fn, trace.UnfusedBounce)


@pytest.mark.cuda
def test_k4_matches_its_plain_version(config4_cuda):
    """Primary rays and one bounce's carry of 64×64 config-4 rays."""
    from ptx_torch.ops import fasthit_kernel

    scene, dev = config4_cuda, config4_cuda.device
    o, d = sample_rays(Camera.reference_demo(64, 64), rng.PRNGKey(0),
                       range(64), range(64), 1, dev)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    launches = fasthit_kernel.LAUNCHES
    for _ in range(2):
        got = scene.hit_fn(scene.params, o, d)
        want = scene.plain_hit_fn(scene.params, o, d)
        torch.cuda.synchronize()
        for k in ("_evt", "hit", "entering", "mat_id"):
            assert torch.equal(got[k], want[k]), k
        hit = want["hit"]
        torch.testing.assert_close(got["t"], want["t"], rtol=1e-5, atol=5e-6)
        torch.testing.assert_close(got["normal"][hit], want["normal"][hit], rtol=1e-5,
                                   atol=5e-6)
        o = o + want["t"][:, None] * d
        d = d - 2.0 * (d * want["normal"]).sum(-1, keepdim=True) * want["normal"]
    assert fasthit_kernel.LAUNCHES == launches + 2


@pytest.mark.cuda
def test_k7_matches_its_plain_version(monkeypatch):
    """The demo with ``PTX_EMK=1``: K7's outputs against its plain lanes and
    ``eval_emissive`` on random positions, and its backward (one histogram)
    against autograd of ``eval_emissive``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the emission kernel has no CPU mode")
    from ptx_torch.ops import emission_kernel as ek

    monkeypatch.setenv("PTX_EMK", "1")
    scene = trace.compile_scene(make_world(), torch.device("cuda"))
    kern, dev = scene.emission_fn, scene.device
    assert isinstance(kern, ek.EmissionKernel)
    g = torch.Generator(device=dev).manual_seed(2)
    N = 65_536
    pos = torch.randn((N, 3), device=dev, generator=g) * 30.0
    mid = torch.randint(0, scene.material_fn.n_materials, (N,), device=dev, generator=g)
    p = scene.params
    args = (p["tex_xform"], p["const"], p["factor"], p["images"][kern.img_id], pos, mid)
    got = kern.launch(*args)
    want = ek.lanes_reference(kern, *args)
    torch.cuda.synchronize()
    same = (got[2] == want[2]) & (got[3] == want[3]) & (got[4] == want[4])
    assert float(same.float().mean()) > 0.999
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a[same], b[same], rtol=1e-5, atol=1e-6)
    assert torch.equal(got[5], want[5])

    leaf = lambda: {k: ([x.detach().clone().requires_grad_(True) for x in v]
                        if isinstance(v, list) else v.detach().clone().requires_grad_(True))
                    for k, v in p.items()}
    wgt = torch.rand((N, 3), device=dev, generator=g) * same[:, None]
    pk, pp = leaf(), leaf()
    (kern(pk, pos, mid) * wgt).sum().backward()
    (scene.material_fn.eval_emissive(pp, pos, mid) * wgt).sum().backward()
    for k in ("const", "factor"):
        torch.testing.assert_close(pk[k].grad, pp[k].grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(pk["images"][kern.img_id].grad,
                               pp["images"][kern.img_id].grad, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", params=["spheres", "gadgets", "ellipsoids"])
def large_cuda(request):
    """A 32-leaf sphere scene (16-column table), a 35-leaf gadget scene and a
    30-leaf ellipsoid scene (32-column table), on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the megasweep kernel has no CPU mode")
    from ptx_torch.scenes import builders
    world = {"spheres": lambda: builders.stress_spheres(25),
             "gadgets": lambda: builders.stress_gadgets(12, seed=4),
             "ellipsoids": lambda: builders.stress_spheres(23, seed=7, transformed=True)}
    return trace.compile_scene(world[request.param](), torch.device("cuda"))


@pytest.mark.cuda
def test_k5_bounce_mode_matches_its_plain_version(large_cuda):
    """Three chained bounces of 64×64 primary rays: K5 in bounce mode vs
    the sweep + the plain shading; cull on and off the same bits."""
    from ptx_torch.ops import megasweep
    scene, dev = large_cuda, large_cuda.device
    o, d = sample_rays(Camera.reference_demo(64, 64), rng.PRNGKey(0), range(64), range(64), 1,
                       dev)
    n = 64 * 64
    carry = (o.reshape(-1, 3), d.reshape(-1, 3), torch.ones((n, 3), device=dev),
             torch.ones(n, device=dev), torch.ones(n, dtype=torch.bool, device=dev))
    launches = megasweep.MegaSweepKernel.LAUNCHES
    for b in range(3):
        uc = rng.uniform(rng.PRNGKey(b), (n,), dev)
        u3 = rng.uniform(rng.PRNGKey(100 + b), (n, 3), dev)
        kb = scene.bounce_fn(scene.params, *carry, uc, u3, True)
        nc = scene.bounce_fn(scene.params, *carry, uc, u3, True, cull=False)
        ref = bounce_kernel.bounce_reference(scene, scene.params, *carry, uc, u3, True)
        torch.cuda.synchronize()
        for k in kb:
            assert torch.equal(kb[k], nc[k]), k
        for k in _DECISIONS:
            assert torch.equal(kb[k], ref[k]), (b, k)
        for k in _FLOATS:
            torch.testing.assert_close(kb[k], ref[k], rtol=1e-5, atol=5e-6)
        h = ref["hit"]
        torch.testing.assert_close(kb["u_sel"][h], ref["u_sel"][h], rtol=1e-5, atol=5e-6)
        carry = (kb["o2"], kb["d2"], kb["thr2"], kb["strength2"], kb["alive2"])
    assert megasweep.MegaSweepKernel.LAUNCHES == launches + 6


@pytest.mark.cuda
def test_k5_hit_mode_matches_its_plain_version(large_cuda):
    from ptx_torch.ops import megasweep
    scene, dev = large_cuda, large_cuda.device
    o, d = sample_rays(Camera.reference_demo(64, 64), rng.PRNGKey(1), range(64), range(64), 1,
                       dev)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    calls = megasweep.REFERENCE_CALLS
    got = scene.hit_fn(scene.params, o, d)
    assert megasweep.REFERENCE_CALLS == calls
    want = scene.plain_hit_fn(scene.params, o, d)
    torch.cuda.synchronize()
    for k in ("_evt", "hit", "entering", "mat_id"):
        assert torch.equal(got[k], want[k]), k
    torch.testing.assert_close(got["t"], want["t"], rtol=1e-5, atol=5e-6)
    torch.testing.assert_close(got["normal"], want["normal"], rtol=1e-5, atol=5e-6)


@pytest.mark.cuda
def test_k6_matches_its_plain_version(large_cuda):
    from ptx_torch.ops.replay_bwd import RowFedReplayBwd
    scene = large_cuda
    carry, dec, cts = _k2_inputs(scene)
    kern = scene.bounce_bwd_fn
    assert isinstance(kern, RowFedReplayBwd)
    p36 = kern.pack36(scene.params).detach()
    packed = kern.pack(scene.params).detach()
    launches = RowFedReplayBwd.LAUNCHES
    got = kern.launch(p36, *carry[:3], dec, *cts)
    again = kern.launch(p36, *carry[:3], dec, *cts)
    ref = bounce_kernel.bounce_bwd_lanes_reference(packed, kern.aux, *carry[:3], dec, *cts)
    ref64 = bounce_kernel.bounce_bwd_lanes_reference(
        packed.double(), kern.aux.double(), *(x.double() for x in carry[:3]),
        dict(dec, u_sel=dec["u_sel"].double()), *(c.double() for c in cts))
    torch.cuda.synchronize()
    assert RowFedReplayBwd.LAUNCHES == launches + 2
    for g, w, t in zip(got[:3], ref[:3], ref64[:3]):
        _close(g, w, t)
    _close(got[3], ref[3], ref64[3], ref64[4])
    for a, b in zip(got, again):            # the two-pass reduction is deterministic
        assert torch.equal(a, b)


def _k9_inputs(S, L, B, ties, seed=0):
    """(s, e, t0, t1) on the card: L leaf intervals with some missed, the
    first S of them pooled and valid-masked; ``ties`` puts every boundary on
    a grid of quarters (duplicated starts, touching intervals).  The odd
    lanes start in front of every interval (an entry), the even ones mostly
    inside one (a chain exit)."""
    from ptx_torch.core.constants import EPS
    g = torch.Generator().manual_seed(seed)
    ahead = (torch.arange(B) % 2 == 1).float()
    t0 = torch.rand((L, B), generator=g) * (7.0 - 5.5 * ahead) - 1.0 + 2.5 * ahead
    t1 = t0 + torch.rand((L, B), generator=g) * 2.0 + 0.05
    if ties:
        t0 = torch.round(t0 * 4.0) / 4.0
        t1 = t0 + torch.round(torch.rand((L, B), generator=g) * 8.0) / 4.0 + 0.25
    miss = torch.rand((L, B), generator=g) < 0.25
    t0, t1 = torch.where(miss, 3e20, t0), torch.where(miss, 3e20, t1)
    s, e = t0[:S], t1[:S]
    valid = (s < e) & (e >= EPS)
    dev = torch.device("cuda")
    return tuple(x.contiguous().to(dev) for x in (torch.where(valid, s, 3e20),
                                                  torch.where(valid, e, -3e20), t0, t1))


@pytest.fixture
def k9_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep-select kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True], ids=["random", "tie-heavy"])
@pytest.mark.parametrize("S,L,B,sort", [(256, 256, 65536 + 37, False),
                                        (200, 256, 4096 + 5, False),
                                        (256, 256, 65536 + 37, True),
                                        (300, 320, 4096 + 5, True),
                                        (700, 700, 2048 + 3, True)],
                         ids=["presorted", "presorted-S<L", "sort-Sp256", "sort-Sp512",
                              "sort-Sp1024"])
def test_k9_matches_its_plain_version(k9_card, S, L, B, sort, ties):
    """K9 against ``sweep_select_reference`` bit for bit in all five
    outputs; with ``sort`` on the unsorted intervals (tile widths 32 and
    16), else on the stable-sorted ones."""
    from ptx_torch.core.constants import EPS
    from ptx_torch.ops import sweep_kernel
    s, e, t0, t1 = _k9_inputs(S, L, B, ties)
    if not sort:
        s, idx = torch.sort(s, dim=0, stable=True)
        e = e.gather(0, idx)
    launches = sweep_kernel.LAUNCHES
    got = sweep_kernel.sweep_select(s, e, t0, t1, L, EPS, sort=sort)
    want = sweep_kernel.sweep_select_reference(s, e, t0, t1, L, EPS, sort)
    torch.cuda.synchronize()
    assert sweep_kernel.LAUNCHES == launches + 1
    for name, a, b in zip(("t_star", "entering", "m_start", "m_end", "found"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert 0 < int(got[1].sum()) < B and int((got[2] < L).sum()) > 0


@pytest.mark.cuda
def test_k9_wrapper_raises(k9_card):
    """A CPU tensor among CUDA inputs, and more sorted rows than a block's
    shared memory holds at 8 lanes, raise instead of launching."""
    from ptx_torch.core.constants import EPS
    from ptx_torch.ops import sweep_kernel
    s, e, t0, t1 = _k9_inputs(64, 64, 256, False)
    with pytest.raises(ValueError, match="must be a contiguous"):
        sweep_kernel.sweep_select(s, e, t0.cpu(), t1, 64, EPS)
    big = torch.zeros((4097, 64), device=s.device)
    launches = sweep_kernel.LAUNCHES
    with pytest.raises(NotImplementedError, match="shared memory"):
        sweep_kernel.sweep_select(big, big, big, big, 4097, EPS, sort=True)
    assert sweep_kernel.LAUNCHES == launches
