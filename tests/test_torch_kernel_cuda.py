"""The CUDA kernels on the card against their plain PyTorch versions (and,
last, the 1×1 mesh on a world-1 NCCL group against the unsharded render
and train step, bit for bit): K1
(bounce), K2 (replay backward), K3 and K8 (image-gather transposes), K4
(first hit), K5 (megasweep: hit and bounce modes, 16- and 32-column
tables), K6 (row-fed replay backward), K7 (emission), K9 (sweep
select, with and without its in-kernel sort), the roofline's K10 (the
float32 chain) and K11 (the copy), and the rng kernel (``rng.uniform_many``).

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
order: ``1e-5`` of each texel's sum of |ct|, or, for K3 and K8's
degenerate cases, ``imagegrad._hist_bound_ok``: ``min(2·n·2⁻²⁴,
HIST_REL)·Σ|ct|`` of the float64 sum (n the texel's lanes with a nonzero
ct), the one limit the smoke run holds them to.  K4 must equal the dense hit
as K1 does; K7 its plain lanes, with bins equal except where a float64
recompute puts the lane within 1e-6 of a texel boundary, and its backward
within the reordered-sum bound of its plain version.  K5 must
equal its plain version as K1 does, and culling must not change a bit;
its list route must equal its recompute route (list capacities 0) and
lists of one bit for bit on the full-width stress scenes S1 and S2.  K1 and
K5 write their decisions themselves: they must equal the old wrapper decode
of the raw flags (K4's for K1, K5's hit mode for K5);
K6 is held as K2.  K9 only compares, selects and takes maxima and minima:
its five outputs must equal its plain version's bit for bit, with both
flags, at every tile width and segment count, and through the kernel
mode's route (the sort inside K9) as through the ``torch.sort`` route.
K4 writes the dense hit's dict itself: ``mat_id``, ``hit``, ``entering``
and ``_evt`` must equal the plain dict's, in its dtypes.  The sky bank
(``ops/sky_bank.py``) is held by ``chip_smoke.sky_bank_check``: its picks
and texels equal to the plain route's, its floats within the float64 rule,
each record's throughput gradient bit for bit, the same bits run to run but
the image's gradient; 1 forward and 2 backward launches a ``trace_rays``
call.  K10 and K11 run
their plain versions' float32 operations in the same order, each rounded
on its own: they must equal them bit for bit.  The rng kernel hashes
integers as the int64 route does: its draws must equal the route's bit for
bit, with no synchronise and one launch per 64 keys.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from ptx_torch.core import rng
from ptx_torch.integrate import trace
from ptx_torch.integrate.camera import Camera, sample_rays
from ptx_torch.ops import bounce_kernel
from ptx_torch.ops.imagegrad import _hist_bound_ok
from ptx_torch.scenes.builders import make_world
from ptx_torch.shade.bounce import UnfusedBounce

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


def _k3_plan(regime, N, shape):
    """K3's plan for ``regime``: ``None`` for the one ``k3_plan`` routes
    to, else the direct or the private regime forced."""
    from ptx_torch.ops import imagegrad

    H, W, C = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"routed": None, "direct": (0, min(-(-N // 512), 4 * sms)),
            "private": imagegrad.k3_plan(max(N, imagegrad.K3_PRIVATE_LANES * H * W * C),
                                         shape, sms)}[regime]


def _k3_case(shape, N, seed=1):
    """Lanes in runs of 8 on one texel (as neighbouring pixels find one sky
    texel), 10 % out of bounds, 30 % with a zero cotangent."""
    yi, xi, inb, ct = _hist_case(shape, N=-(-N // 8), seed=seed)
    yi, xi, inb = (x.repeat_interleave(8)[:N] for x in (yi, xi, inb))
    ct = torch.randn((N, shape[2]), device=ct.device, generator=torch.Generator(
        device=ct.device).manual_seed(seed + 1))
    return yi, xi, inb, torch.where(torch.rand(N, device=ct.device)[:, None] < 0.3, 0.0, ct)


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["routed", "direct", "private"])
@pytest.mark.parametrize("shape,N", [((64, 128, 4), 65_536), ((64, 128, 4), 4_194_304),
                                     ((8, 8, 4), 262_144), ((67, 93, 3), 100_000)],
                         ids=["sky-65536", "sky-4194304", "checker", "ragged-c3"])
def test_k3_matches_its_plain_version(shape, N, regime):
    """K3 in the regime ``k3_plan`` routes to and in each one forced: on
    the demo sky at the chunk and train widths, the 8x8 checker and a
    ragged three-channel image, within ``_hist_bound_ok``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the histogram kernel has no CPU mode")
    from ptx_torch.ops import imagegrad

    yi, xi, inb, ct = _k3_case(shape, N)
    launches = imagegrad.LAUNCHES
    plan = _k3_plan(regime, N, shape)
    got = (imagegrad.hist(yi, xi, inb, ct, shape) if plan is None
           else imagegrad.k3.launch(yi, xi, inb, ct, shape, plan=plan))
    torch.cuda.synchronize()
    assert imagegrad.LAUNCHES == launches + 1
    _hist_bound_ok("K3", got, yi, xi, inb, ct, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["direct", "private"])
@pytest.mark.parametrize("C", [3, 4])
@pytest.mark.parametrize("case", ["one-texel", "all-skipped", "ragged-offset"])
def test_k3_degenerate_lanes(case, C, regime):
    """K3 in each regime with every lane on one texel, with every lane
    skipped (an all-zero image), and on a ragged 67x93 image with ``ct`` a
    view one float into its storage (no 16-byte loads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the histogram kernel has no CPU mode")
    from ptx_torch.ops import imagegrad

    shape = (67, 93, C) if case == "ragged-offset" else (64, 128, C)
    yi, xi, inb, ct = _k3_case(shape, 65_536, seed=2)
    if case == "one-texel":
        yi, xi = torch.full_like(yi, 12), torch.full_like(xi, 34)
    elif case == "all-skipped":
        inb = torch.zeros_like(inb)
    else:
        ct = torch.randn(ct.numel() + 1, device=ct.device)[1:].view(ct.shape)
    got = imagegrad.k3.launch(yi, xi, inb, ct, shape, plan=_k3_plan(regime, 65_536, shape))
    torch.cuda.synchronize()
    _hist_bound_ok("K3", got, yi, xi, inb, ct, shape)
    if case == "all-skipped":
        assert not bool(got.any())
    if case == "one-texel":
        assert int((got != 0).any(dim=-1).sum()) == 1


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
    _hist_bound_ok("K8", got, yi, xi, inb, ct, shape)
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
    assert isinstance(config4_cuda.bounce_fn, UnfusedBounce)


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
    """The demo with ``PTX_EMK=1``: K7's ``em`` and bins against its plain
    lanes (``lanes_reference``) and ``eval_emissive`` on random positions;
    its backward, in each regime, against ``backward_reference`` run in
    float64, each entry within the reordered-sum bound ``2·n·2⁻²⁴·Σ|term|``
    (n its terms with a nonzero ct) and within 1e-4 of ``Σ|term|`` (a
    sparse cotangent, as a train step's); through autograd one forward
    launch and one backward launch, with gradients as autograd of
    ``eval_emissive``."""
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
    img = p["images"][kern.img_id]
    args = (p["tex_xform"], p["const"], p["factor"], img, pos, mid)
    em, bin_ = kern.launch(*args)
    em_p, bin_p = ek.lanes_reference(kern, *args)
    want = scene.material_fn.eval_emissive(p, pos, mid)
    torch.cuda.synchronize()
    same = bin_ == bin_p
    assert float(same.float().mean()) > 0.999
    torch.testing.assert_close(em[same], em_p[same], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(em[same], want[same], rtol=1e-5, atol=1e-6)

    ct = torch.randn((N, 3), device=dev, generator=g)
    ct = ct * (torch.rand(N, device=dev, generator=g) < 0.3)[:, None]
    bargs = (ct, bin_, img, p["factor"], tuple(p["const"].shape), tuple(p["factor"].shape))
    d = lambda x: x.double()
    ref = ek.backward_reference(kern, d(ct), bin_, d(img), d(p["factor"]), *bargs[4:])
    mag = ek.backward_reference(kern, d(ct).abs(), bin_, d(img).abs(), d(p["factor"]).abs(),
                                *bargs[4:])
    n = ek.backward_reference(kern, d(ct != 0), bin_, torch.ones_like(d(img)),
                              torch.ones_like(d(p["factor"])), *bargs[4:])
    for plan in (0, 1):
        got = kern.launch_bwd(*bargs, plan=plan)
        torch.cuda.synchronize()
        for k, a, b, m, c in zip(("d_img", "d_const", "d_factor"), got, ref, mag, n):
            assert bool(torch.isfinite(a).all()), (plan, k)
            lim = torch.clamp(2 * c * 2.0 ** -24, max=1e-4) * m
            assert bool(((d(a) - b).abs() <= lim).all()), (plan, k)
        assert float(got[1].abs().sum()) > 0 and float(got[2].abs().sum()) > 0

    leaf = lambda: {k: ([x.detach().clone().requires_grad_(True) for x in v]
                        if isinstance(v, list) else v.detach().clone().requires_grad_(True))
                    for k, v in p.items()}
    wgt = torch.rand((N, 3), device=dev, generator=g) * same[:, None]
    pk, pp = leaf(), leaf()
    fwd, bwd = ek.LAUNCHES, ek.BWD_LAUNCHES
    (kern(pk, pos, mid) * wgt).sum().backward()
    assert (ek.LAUNCHES, ek.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    (scene.material_fn.eval_emissive(pp, pos, mid) * wgt).sum().backward()
    for k in ("const", "factor"):
        torch.testing.assert_close(pk[k].grad, pp[k].grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(pk["images"][kern.img_id].grad,
                               pp["images"][kern.img_id].grad, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_k1_decode_in_kernel_matches_the_old_decode(cuda_scene):
    """K1 writes its decisions itself; on the same rays they equal the
    decode its wrapper used to run: hit and entering from K4's raw flag
    bits, ``mat_id`` the winning leaf's material through the leaf table,
    and the shading bits those of the plain bounce."""
    from ptx_torch.ops import fasthit_kernel
    from ptx_torch.geom.fasthit import collect_leaves

    scene, dev = cuda_scene, cuda_scene.device
    o, d = sample_rays(Camera.reference_demo(64, 64), rng.PRNGKey(3), range(64), range(64), 1,
                       dev)
    n = 64 * 64
    carry = (o.reshape(-1, 3), d.reshape(-1, 3), torch.ones((n, 3), device=dev),
             torch.ones(n, device=dev), torch.ones(n, dtype=torch.bool, device=dev))
    k4 = fasthit_kernel.HitKernel(scene.plan, scene.plain_hit_fn, scene.params)
    leaf_mat = torch.tensor([lf.mat_id for lf, _ in collect_leaves(scene.plan)],
                            dtype=torch.int64, device=dev)
    for b in range(3):
        uc = rng.uniform(rng.PRNGKey(b), (n,), dev)
        u3 = rng.uniform(rng.PRNGKey(50 + b), (n, 3), dev)
        got = scene.bounce_fn(scene.params, *carry, uc, u3, True)
        k4_out = k4.launch(k4.pack(scene.params), *carry[:2])
        ref = bounce_kernel.bounce_reference(scene, scene.params, *carry, uc, u3, True)
        torch.cuda.synchronize()
        L = leaf_mat.numel()
        hit, evt = k4_out["hit"], k4_out["_evt"]
        leaf = torch.where(evt >= L, evt - L, evt).to(torch.int64)
        assert got["hit"].dtype == torch.bool and got["mat_id"].dtype == torch.int64
        assert torch.equal(got["hit"], hit)
        assert torch.equal(got["entering"], k4_out["entering"])
        assert torch.equal(got["evt"], evt)
        assert torch.equal(got["mat_id"], torch.where(hit, leaf_mat[leaf], 0))
        assert torch.equal(got["mat_id"], k4_out["mat_id"])
        for k in ("take_transmit", "scatter_alive", "alive2"):
            assert torch.equal(got[k], ref[k]), k
        carry = (got["o2"], got["d2"], got["thr2"], got["strength2"], got["alive2"])


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
    """K6 on K2's scene vector: per lane as K2, ``d_packed`` against the
    per-leaf sums folded onto the materials (the float64 fold as truth),
    two launches the same bits."""
    from ptx_torch.ops.replay_bwd import RowFedReplayBwd
    scene = large_cuda
    carry, dec, cts = _k2_inputs(scene)
    kern = scene.bounce_bwd_fn
    assert isinstance(kern, RowFedReplayBwd)
    packed = kern.pack(scene.params).detach()
    launches = RowFedReplayBwd.LAUNCHES
    got = kern.launch(packed, *carry[:3], dec, *cts)
    again = kern.launch(packed, *carry[:3], dec, *cts)
    ref = bounce_kernel.bounce_bwd_lanes_reference(packed, kern.aux, *carry[:3], dec, *cts)
    ref64 = bounce_kernel.bounce_bwd_lanes_reference(
        packed.double(), kern.aux.double(), *(x.double() for x in carry[:3]),
        dict(dec, u_sel=dec["u_sel"].double()), *(c.double() for c in cts))
    torch.cuda.synchronize()
    assert RowFedReplayBwd.LAUNCHES == launches + 2
    for g, w, t in zip(got[:3], ref[:3], ref64[:3]):
        _close(g, w, t)
    fold = lambda acc: bounce_kernel.fold_packed(acc, kern.leaf_mat, kern.n_materials)
    assert got[3].shape == packed.shape
    _close(got[3], fold(ref[3]), fold(ref64[3]), fold(ref64[4]))
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
    outputs; with ``sort`` on the unsorted intervals (tile widths 16 and
    8), else on the stable-sorted ones."""
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
@pytest.mark.parametrize("S", [37, 256, 300, 700], ids=["S37", "Sp256", "Sp512", "Sp1024"])
@pytest.mark.parametrize("B", [1, 31, 4096, 65536])
def test_k9_both_flags_at_every_tile(k9_card, S, B):
    """K9 with both flags against its plain version bit for bit at B = 1,
    31, 4,096 and 65,536 lanes: ``sort=False`` at every tile width (8, 16,
    32 lanes: 32, 16, 8 segments of 16 rows, so S = 37 fills no chunk),
    ``sort=True`` at Sp 64, 256, 512 and 1024 at every tile that fits (32,
    16 and 8 lanes); L > S; tie-heavy at odd B."""
    from ptx_torch.core.constants import EPS
    from ptx_torch.ops import sweep_kernel
    L = S + 13
    s, e, t0, t1 = _k9_inputs(S, L, B, ties=B % 2 == 1, seed=S + B)
    s_s, idx = torch.sort(s, dim=0, stable=True)
    e_s = e.gather(0, idx)
    want = sweep_kernel.sweep_select_reference(s_s, e_s, t0, t1, L, EPS, False)
    runs = [(sweep_kernel.launch(s_s, e_s, t0, t1, L, EPS, False, tile=bw), f"sort=False {bw}")
            for bw in (8, 16, 32)]
    rows = max(32, sweep_kernel.padded_rows(S))
    runs += [(sweep_kernel.launch(s, e, t0, t1, L, EPS, True, tile=bw), f"sort=True {bw}")
             for bw in (32, 16, 8) if 8 * bw * (rows + 1) <= sweep_kernel.SORT_TILE_BYTES]
    torch.cuda.synchronize()
    for got, tag in runs:
        for name, a, b in zip(("t_star", "entering", "m_start", "m_end", "found"), got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (tag, name)


@pytest.mark.cuda
def test_k9_kernel_mode_route_equals_the_torch_sort_route(k9_card):
    """Kernel mode sorts inside K9 (``sort_inside``): on a 32-sphere scene's
    rays its select equals the ``torch.sort`` + ``sort=False`` route's bit for
    bit, and the whole hit the fixpoint mode's."""
    from ptx_torch.core.constants import EPS
    from ptx_torch.geom import fasthit
    from ptx_torch.ops import sweep_kernel
    from ptx_torch.scenes import builders
    scene = trace.compile_scene(builders.stress_spheres(25), torch.device("cuda"))
    leaves = fasthit.collect_leaves(scene.plan)
    hits = {m: fasthit.UnionSweepHit(scene.plan, leaves, m) for m in ("kernel", "fixpoint")}
    o, d = sample_rays(Camera.reference_demo(128, 64), rng.PRNGKey(4), range(64), range(128),
                       1, scene.device)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t0, t1, s, e = hits["kernel"].intervals(scene.params, o, d)
    assert sweep_kernel.sort_inside(s.shape[0])
    launches = sweep_kernel.LAUNCHES
    inside = hits["kernel"].select(t0, t1, s, e)
    assert sweep_kernel.LAUNCHES == launches + 1
    s_s, idx = torch.sort(s, dim=0, stable=True)
    outside = sweep_kernel.sweep_select(s_s.contiguous(), e.gather(0, idx), t0, t1,
                                        hits["kernel"].L, EPS, sort=False)
    got = {m: h(scene.params, o, d) for m, h in hits.items()}
    torch.cuda.synchronize()
    for a, b in zip(inside, outside):
        assert torch.equal(a, b)
    assert int(got["kernel"]["hit"].sum()) > 0
    for k, v in got["fixpoint"].items():
        assert torch.equal(got["kernel"][k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("world", ["config4", "tree17"])
def test_k4_writes_the_dense_hit_dict(world):
    """K4's one launch writes the dense hit's dict: ``mat_id``, ``hit``,
    ``entering`` and ``_evt`` equal to the plain dict's in its dtypes, ``t``
    and the normal (hit lanes) within the stated tolerance, on config 4 and
    on a random 17-leaf CSG tree (the 24-leaf bucket's first size,
    coincident boundaries)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hit kernel has no CPU mode")
    from ptx_torch.ops import fasthit_kernel
    from ptx_torch.scenes.builders import baseline_config4
    from test_torch_hit_fold_host import _random_tree
    root = baseline_config4() if world == "config4" else _random_tree(17, 7)
    scene = trace.compile_scene(root, torch.device("cuda"))
    assert isinstance(scene.hit_fn, fasthit_kernel.HitKernel)
    dev = scene.device
    o, d = sample_rays(Camera.reference_demo(96, 64), rng.PRNGKey(5), range(64), range(96), 1,
                       dev)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    o = torch.cat([o, o[:2048] + 0.5 * torch.randn_like(o[:2048])])
    d = torch.cat([d, torch.randn_like(d[:2048])])
    launches = fasthit_kernel.LAUNCHES
    got = scene.hit_fn(scene.params, o, d)
    want = scene.plain_hit_fn(scene.params, o, d)
    torch.cuda.synchronize()
    assert fasthit_kernel.LAUNCHES == launches + 1
    assert set(got) == set(want)
    for k in ("mat_id", "hit", "entering", "_evt"):
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    hit = want["hit"]
    assert int(hit.sum()) > 0
    torch.testing.assert_close(got["t"], want["t"], rtol=1e-5, atol=5e-6)
    torch.testing.assert_close(got["normal"][hit], want["normal"][hit], rtol=1e-5, atol=5e-6)


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


@pytest.mark.cuda
def test_k5_decode_in_kernel_matches_the_old_decode(large_cuda):
    """K5's bounce mode writes its decisions itself; on the same rays hit,
    entering, evt and mat_id equal the old decode of hit mode's raw flag
    bits and material (``MegaHit``'s), the shading bits the plain bounce's."""
    scene, dev = large_cuda, large_cuda.device
    o, d = sample_rays(Camera.reference_demo(64, 64), rng.PRNGKey(2), range(64), range(64), 1,
                       dev)
    n = 64 * 64
    carry = (o.reshape(-1, 3), d.reshape(-1, 3), torch.ones((n, 3), device=dev),
             torch.ones(n, device=dev), torch.ones(n, dtype=torch.bool, device=dev))
    kern = scene.bounce_fn.kernel
    packed = kern.pack(scene.params)
    for b in range(3):
        uc = rng.uniform(rng.PRNGKey(b), (n,), dev)
        u3 = rng.uniform(rng.PRNGKey(70 + b), (n, 3), dev)
        got = scene.bounce_fn(scene.params, *carry, uc, u3, True, packed=packed)
        raw = kern.launch(packed, *carry[:2])
        ref = bounce_kernel.bounce_reference(scene, scene.params, *carry, uc, u3, True)
        torch.cuda.synchronize()
        assert got["hit"].dtype == torch.bool and got["mat_id"].dtype == torch.int64
        assert torch.equal(got["hit"], (raw["flags"] & 1).to(torch.bool))
        assert torch.equal(got["entering"], (raw["flags"] & 2).to(torch.bool))
        assert torch.equal(got["evt"], raw["evt"])
        assert torch.equal(got["mat_id"], raw["mat"].to(torch.int64))
        for k in ("take_transmit", "scatter_alive", "alive2"):
            assert torch.equal(got[k], ref[k]), k
        carry = (got["o2"], got["d2"], got["thr2"], got["strength2"], got["alive2"])


@pytest.fixture(scope="module", params=["S1", "S2"])
def stress_cuda(request):
    """The full-width stress scenes S1 (256 leaves) and S2 (268 leaves)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the megasweep kernel has no CPU mode")
    from ptx_torch.scenes import builders
    world = {"S1": lambda: builders.stress_spheres(249),
             "S2": lambda: builders.stress_gadgets(112)}
    return request.param, trace.compile_scene(world[request.param](), torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [(0, 0), (1, 1)])
def test_k5_list_route_equals_the_recompute_route(stress_cuda, caps):
    """Three chained bounces of 96×96 rays: K5 with its list capacities at
    0 (every lane takes the recompute route) and at 1 (nearly every lane
    overflows one list) gives the list route's bits; on S2 some lanes read
    the live rows of a culled gadget class."""
    name, scene = stress_cuda
    dev = scene.device
    o, d = sample_rays(Camera.reference_demo(96, 96), rng.PRNGKey(5), range(96), range(96), 1,
                       dev)
    n = 96 * 96
    carry = (o.reshape(-1, 3), d.reshape(-1, 3), torch.ones((n, 3), device=dev),
             torch.ones(n, device=dev), torch.ones(n, dtype=torch.bool, device=dev))
    kern = scene.bounce_fn.kernel
    packed = kern.pack(scene.params)
    culled, over = 0, 0
    for b in range(3):
        uc = rng.uniform(rng.PRNGKey(b), (n,), dev)
        u3 = rng.uniform(rng.PRNGKey(90 + b), (n, 3), dev)
        lists = kern.launch(packed, *carry[:2], carry=(*carry[2:], uc, u3), stats=True)
        forced = kern.launch(packed, *carry[:2], carry=(*carry[2:], uc, u3), stats=True,
                             caps=caps)
        torch.cuda.synchronize()
        for k in lists:
            if k != "stats":
                assert torch.equal(lists[k], forced[k]), (b, k)
        culled += int((lists["stats"][:, 4] > 0).sum())
        over += int(((forced["stats"][:, 5] & 6) != 0).sum())
        carry = (lists["o2"], lists["d2"], lists["thr2"], lists["strength2"], lists["alive2"])
    assert over > 0
    if caps == (0, 0):
        assert over == 3 * n
    if name == "S2":
        assert culled > 0


@pytest.mark.cuda
def test_1x1_nccl_mesh_equals_the_unsharded_render(cuda_scene):
    """``render_sharded`` and one ``make_train_step`` step on a world-1 NCCL
    group (made with a ``HashStore``, so NCCL's all-reduces run) equal the
    unsharded ``trace_rays`` of the same rays under ``fold(key, 0, 0)`` and
    the step without a mesh, bit for bit."""
    import torch.distributed as dist
    from ptx_torch.parallel import mesh as pmesh
    from ptx_torch.parallel import render as prender

    scene, dev = cuda_scene, cuda_scene.device
    cam, key = Camera.reference_demo(64, 64), rng.PRNGKey(4)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh(1, 1, device=torch.device("cuda", 0))
        assert pmesh.mesh_shape(mesh) == (1, 1) and dist.get_backend() == "nccl"
        img = prender.render_sharded(scene, cam, mesh, key, spp=2, depth=8)
        target = torch.zeros_like(img)
        kw = dict(spp=2, depth=8, learning_rate=0.5)
        new_m, loss_m = prender.make_train_step(scene, cam, mesh, **kw)(scene.params, target,
                                                                         key)
    finally:
        dist.destroy_process_group()
    k = rng.fold(key, 0, 0)
    o, d = sample_rays(cam, k, range(64), range(64), 2, dev)
    with torch.no_grad():
        want = trace.trace_rays(scene, scene.params, o, d, k, 8).mean(dim=0)
    assert torch.equal(img, want)
    new, loss = prender.make_train_step(scene, cam, None, **kw)(scene.params, target, key)
    assert torch.equal(loss_m, loss)
    for name in new:
        for a, b in zip(*(x if isinstance(x, list) else [x] for x in (new_m[name], new[name]))):
            assert torch.equal(a, b), name


def _k4_hit_grads(scene, hit_fn, o, d, w, v):
    """Gradients of Σ w·t + Σ v·normal (hit lanes) through ``hit_fn`` with
    respect to the geometry params and the rays."""
    from ptx_torch.geom.fasthit import GEO_KEYS

    p = {k: scene.params[k].clone().requires_grad_(True) for k in GEO_KEYS}
    rays = [o.clone().requires_grad_(True), d.clone().requires_grad_(True)]
    out = hit_fn(dict(scene.params, **p), *rays)
    loss = (w * out["t"]).sum() + (v * torch.where(out["hit"][:, None], out["normal"],
                                                    0.0)).sum()
    grads = torch.autograd.grad(loss, [*p.values(), *rays], allow_unused=True)
    return out, dict(zip([*GEO_KEYS, "o", "d"], grads))


@pytest.mark.cuda
def test_k4_gradient_is_the_dense_hits(cuda_scene):
    """K4's wrapper differentiates through its hit replay (the JAX custom
    VJP's backward): on 64×64 primary demo rays and 1,024 rays from inside
    the spheres, the gradient of Σ w·t + Σ v·normal with respect to every
    geometry param and the rays equals the dense hit's autograd within
    1e-4 of each tensor's largest entry (lanes whose decisions differ
    weigh 0)."""
    from ptx_torch.ops import fasthit_kernel

    scene, dev = cuda_scene, cuda_scene.device
    o, d = sample_rays(Camera.reference_demo(64, 64), rng.PRNGKey(6), range(64), range(64), 1,
                       dev)
    gen = torch.Generator(dev).manual_seed(0)
    c = scene.params["sphere_center"]
    pick = torch.randint(0, c.shape[0], (1024,), device=dev, generator=gen)
    o = torch.cat([o.reshape(-1, 3), c[pick] + 0.2 * (torch.rand(
        (1024, 3), device=dev, generator=gen) - 0.5)])
    d = torch.cat([d.reshape(-1, 3), torch.randn((1024, 3), device=dev, generator=gen)])
    w = torch.rand(o.shape[0], device=dev, generator=gen) - 0.5
    v = torch.rand((o.shape[0], 3), device=dev, generator=gen) - 0.5
    with torch.no_grad():
        k, p = scene.hit_fn(scene.params, o, d), scene.plain_hit_fn(scene.params, o, d)
    same = (k["_evt"] == p["_evt"]) & (k["hit"] == p["hit"]) & (k["entering"] == p["entering"])
    w, v = torch.where(same, w, 0.0), torch.where(same[:, None], v, 0.0)
    launches = fasthit_kernel.LAUNCHES
    out_k, g_k = _k4_hit_grads(scene, scene.hit_fn, o, d, w, v)
    torch.cuda.synchronize()
    assert fasthit_kernel.LAUNCHES == launches + 1 and out_k["t"].grad_fn is not None
    _, g_p = _k4_hit_grads(scene, scene.plain_hit_fn, o, d, w, v)
    assert int(same.sum()) >= o.shape[0] - 8
    for name, want in g_p.items():
        got = g_k[name]
        if want is None or want.numel() == 0:
            assert got is None or not bool(got.any()), name
            continue
        scale = float(want.abs().max())
        assert got is not None and (name not in ("sphere_center", "o", "d") or scale > 0), name
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale + 1e-7, msg=name)


@pytest.mark.cuda
def test_autograd_route_on_k4_with_and_without_remat(cuda_scene):
    """``trace_rays(manual_vjp=False)`` on the demo's K4 at 64×64, spp 2,
    depth 8 (compacted): K4 once a bounce without ``remat`` and once more a
    bounce but the last with it; under deterministic algorithms the
    gradients with ``remat`` equal those without bit for bit, but the sky
    image's: that one is K3's histograms, whose inputs must be equal bit
    for bit and each output within ``imagegrad._hist_bound_ok`` (K3's
    float atomics add in an order that varies with the launches around
    them); the manual route's gradients (K1, K2) within 1e-4 of each
    tensor's largest entry.  The scene's sky bank is off, so that the sky's
    gradient goes through K3 (the bank's own run-to-run check is
    ``test_sky_bank_matches_its_plain_route``)."""
    import dataclasses

    from chip_smoke import _recording_hists
    from ptx_torch.ops import fasthit_kernel

    scene, dev = dataclasses.replace(cuda_scene, sky_bank=None), cuda_scene.device
    key = rng.PRNGKey(8)
    o, d = sample_rays(Camera.reference_demo(64, 64), key, range(64), range(64), 2, dev)

    def grads(**kw):
        p = {k: ([x.clone().requires_grad_(True) for x in v] if isinstance(v, list)
                 else v.clone().requires_grad_(True)) for k, v in scene.params.items()}
        launches = fasthit_kernel.LAUNCHES
        trace.trace_rays(scene, p, o, d, key, 8, compact=True, **kw).mean().backward()
        torch.cuda.synchronize()
        flat = {f"{k}{i}": x.grad for k, v in p.items()
                for i, x in enumerate(v if isinstance(v, list) else [v]) if x.grad is not None}
        return fasthit_kernel.LAUNCHES - launches, flat

    hists = {False: ([], []), True: ([], [])}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with _recording_hists(*hists[False]):
            n_off, off = grads(manual_vjp=False, remat=False)
        with _recording_hists(*hists[True]):
            n_on, on = grads(manual_vjp=False, remat=True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert (n_off, n_on) == (9, 17)
    assert off.keys() == on.keys()
    for k in off:
        if not k.startswith("images"):
            assert torch.equal(off[k], on[k]), k
    (h_off, o_off), (h_on, o_on) = hists[False], hists[True]
    assert len(h_off) == len(h_on) > 0
    for x, y, a, b in zip(h_off, h_on, o_off, o_on):
        for u, v in zip(x[:4], y[:4]):
            assert torch.equal(u, v)
        for out in (a, b):
            _hist_bound_ok("K3 (remat)", out, *x)
    _, manual = grads(manual_vjp=True)
    for k in manual:
        scale = float(manual[k].abs().max()) if manual[k].numel() else 0.0
        torch.testing.assert_close(off[k], manual[k], rtol=0, atol=1e-4 * scale + 1e-7, msg=k)


@pytest.fixture
def roofline_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the roofline kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,reps", [((8192, 128), 1), ((1000,), 3), ((1,), 2)])
def test_k10_matches_its_plain_version(roofline_card, shape, reps):
    """K10 equals its plain version bit for bit on x uniform in [0.25, 0.5]
    with c 1e-3, where every element moves; one launch."""
    from ptx_torch.ops import roofline_kernel as rk

    gen = torch.Generator(roofline_card).manual_seed(10)
    x = torch.empty(shape, device=roofline_card).uniform_(0.25, 0.5, generator=gen)
    launches = rk.FMA_LAUNCHES
    got = rk.fma_chain(x, reps, c=1e-3)
    torch.cuda.synchronize()
    assert rk.FMA_LAUNCHES == launches + 1
    want = rk.fma_chain_reference(x, reps, c=1e-3)
    assert bool((want != x).all())
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 4096 + 3, 32768 * 1024])
def test_k11_matches_its_plain_version(roofline_card, n):
    """K11 equals ``x + 1`` bit for bit, the n mod 4 tail included; one
    launch."""
    from ptx_torch.ops import roofline_kernel as rk

    gen = torch.Generator(roofline_card).manual_seed(11)
    x = torch.randn(n, device=roofline_card, generator=gen)
    launches = rk.COPY_LAUNCHES
    got = rk.copy_plus_one(x)
    torch.cuda.synchronize()
    assert rk.COPY_LAUNCHES == launches + 1
    assert torch.equal(got, rk.copy_plus_one_reference(x))


@pytest.mark.cuda
def test_roofline_wrappers_raise(roofline_card, monkeypatch):
    """A launch the card refuses (blocks of 2,048 threads) raises and counts
    nothing; so do a K11 input off 16-byte alignment and an output on the
    CPU."""
    from ptx_torch.ops import roofline_kernel as rk

    x = torch.ones(1024, device=roofline_card)
    launches = (rk.FMA_LAUNCHES, rk.COPY_LAUNCHES)
    with monkeypatch.context() as m:
        m.setattr(rk, "BLOCK", 2048)
        with pytest.raises(RuntimeError, match="launch failed"):
            rk.fma_chain(x, 1)
        with pytest.raises(RuntimeError, match="launch failed"):
            rk.copy_plus_one(x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rk.copy_plus_one(x[1:])
    with pytest.raises(ValueError, match="must be a contiguous"):
        rk.fma_chain(x, 1, out=torch.empty(1024))
    assert (rk.FMA_LAUNCHES, rk.COPY_LAUNCHES) == launches
    torch.cuda.synchronize()
    assert torch.equal(rk.copy_plus_one(x), x + 1)


@pytest.fixture
def rng_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rng kernel has no CPU mode")
    return torch.device("cuda")


# keys with words at and past 2**31 beside folded ones
_HIGH_KEYS = [(0xFFFFFFFF, 0x80000000), (0x80000000, 0), (0, 0xFFFFFFFF),
              (0x9E3779B9, 0xDEADBEEF)]


def _rng_keys(n, high=False):
    if high:
        return [_HIGH_KEYS[q % len(_HIGH_KEYS)] for q in range(n)]
    return [rng.fold(rng.PRNGKey(18), q) for q in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("nkeys,shape,high", [
    (2, (4194304,), False), (4, (1398101, 3), False), (11, (262144, 3), False),  # a demo step's phases
    (1, (), False), (3, (1,), False), (2, (3,), False), (5, (65537,), False),
    (4, (1000, 3), True), (130, (7, 3), False)])
def test_rng_kernel_matches_its_plain_version(rng_card, nkeys, shape, high):
    """``uniform_many`` on the card (the kernel: one launch per 64 keys)
    equals the int64 route bit for bit."""
    from ptx_torch.ops import rng_kernel

    keys = _rng_keys(nkeys, high)
    launches = rng_kernel.LAUNCHES
    got = rng.uniform_many(keys, shape, rng_card)
    torch.cuda.synchronize()
    assert rng_kernel.LAUNCHES == launches + -(-nkeys // rng_kernel.CAPACITY)
    want = rng.uniform_many_reference(keys, shape, rng_card)
    assert got.shape == want.shape == (nkeys,) + shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_rng_kernel_under_uniform_and_sample_square(rng_card):
    """``uniform(minval=, maxval=)`` and ``sample_square`` through the kernel
    equal their CPU draws bit for bit."""
    key = rng.fold(rng.PRNGKey(18), 99)
    for got, want in ((rng.uniform(key, (333, 2), rng_card, minval=-2.5, maxval=0.75),
                       rng.uniform(key, (333, 2), "cpu", minval=-2.5, maxval=0.75)),
                      (rng.sample_square(key, (2, 17, 19), rng_card),
                       rng.sample_square(key, (2, 17, 19), "cpu"))):
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_rng_kernel_makes_no_synchronise_and_one_launch_a_call(rng_card):
    """Under CUDA's sync debug mode "error" a draw raises nothing (no key
    tensor is copied), and each call of up to 64 keys is one launch."""
    from ptx_torch.ops import rng_kernel

    keys = _rng_keys(11)
    rng.uniform_many(keys, (4096, 3), rng_card)          # built and loaded
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(3):
            launches = rng_kernel.LAUNCHES
            rng.uniform_many(keys, (4096, 3), rng_card)
            rng.uniform(keys[i], (), rng_card)
            assert rng_kernel.LAUNCHES == launches + 2
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_rng_kernel_raises_on_a_refused_launch(rng_card, monkeypatch):
    """A launch the card refuses (blocks of 2,048 threads) raises and counts
    nothing."""
    from ptx_torch.ops import rng_kernel

    launches = rng_kernel.LAUNCHES
    monkeypatch.setattr(rng_kernel, "BLOCK", 2048)
    with pytest.raises(RuntimeError, match="launch failed"):
        rng.uniform_many(_rng_keys(2), (100,), rng_card)
    assert rng_kernel.LAUNCHES == launches


@pytest.fixture(scope="module")
def bank_scenes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sky bank has no CPU mode")
    from ptx_torch.scenes.builders import baseline_config4

    dev = torch.device("cuda")
    return {"demo": trace.compile_scene(make_world(), dev),
            "config4": trace.compile_scene(baseline_config4(), dev)}


@pytest.mark.cuda
@pytest.mark.parametrize("world,B", [("demo", 65_536), ("config4", 65_536),
                                     ("demo", 4_194_304)])
def test_sky_bank_matches_its_plain_route(bank_scenes, world, B):
    """The kernel pair against the plain route in float64, every output,
    both image regimes, and run to run (``chip_smoke.sky_bank_check``)."""
    from chip_smoke import sky_bank_check

    sky_bank_check(bank_scenes[world], B, 7, f"sky bank {world}")


@pytest.mark.cuda
def test_sky_bank_launches_and_gradients_through_trace_rays(bank_scenes):
    """A compacted 16,384-ray demo wavefront at depth 16 (three phases)
    forward and backward: 1 forward and 2 backward launches by the counts
    and the recorder's ``sky_bank_launches``, no K3 (the sky's gradient is
    the bank's); a render call 1 launch; the radiance and every gradient as
    the plain route's on the card (the scene without its bank, K3 for the
    sky) within ``rtol 1e-4``."""
    from torch.profiler import ProfilerActivity, profile

    from ptx_torch.ops import imagegrad, sky_bank
    from ptx_torch.utils import profiling

    scene = bank_scenes["demo"]
    o, d = sample_rays(Camera.reference_demo(128, 128), rng.PRNGKey(2), range(128),
                       range(128), 1, scene.device)
    leaf = lambda: {k: ([x.detach().clone().requires_grad_(True) for x in v]
                        if isinstance(v, list) else v.detach().clone().requires_grad_(True))
                    for k, v in scene.params.items()}
    wgt = torch.rand(o.shape, device=scene.device, generator=torch.Generator(
        device=scene.device).manual_seed(3))

    def run(params):
        rad = trace.trace_rays(scene, params, o, d, rng.PRNGKey(2), 16)
        (rad * wgt).sum().backward()
        return rad.detach()

    pk = leaf()
    run(pk)                                      # built and loaded
    torch.cuda.synchronize()
    pk = leaf()
    f0, b0, h0 = sky_bank.LAUNCHES, sky_bank.BWD_LAUNCHES, imagegrad.LAUNCHES
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        rad = run(pk)
        torch.cuda.synchronize()
    counted = profiling.snapshot()["counters"].get("sky_bank_launches", 0)
    profiling.reset()
    assert (sky_bank.LAUNCHES - f0, sky_bank.BWD_LAUNCHES - b0, counted) == (1, 2, 3)
    assert imagegrad.LAUNCHES == h0
    with torch.no_grad():
        trace.trace_rays(scene, scene.params, o, d, rng.PRNGKey(2), 16)
    assert (sky_bank.LAUNCHES - f0, sky_bank.BWD_LAUNCHES - b0) == (2, 2)

    bank, scene.sky_bank = scene.sky_bank, None
    try:
        pp = leaf()
        rad_p = run(pp)
    finally:
        scene.sky_bank = bank
    torch.testing.assert_close(rad, rad_p, rtol=1e-4, atol=1e-5)
    for k in pk:
        for a, b in zip(*(x if isinstance(x, list) else [x] for x in (pk[k], pp[k]))):
            assert (a.grad is None) == (b.grad is None), k
            if a.grad is not None:
                scale = float(b.grad.abs().max())
                torch.testing.assert_close(a.grad, b.grad, rtol=1e-4,
                                           atol=1e-4 * scale + 1e-7, msg=k)
    assert float(pk["images"][bank.img_id].grad.abs().sum()) > 0
