"""The sky bank (``ptx_torch/ops/sky_bank.py``): its lane arithmetic
(``ptx_torch/csrc/sky_bank_lane.cuh``, the exact source its kernels
include) built for the host with ``g++ -ffp-contract=off`` and held against
the plain route ``sky_bank.reference`` (mat-sum + sky-select), forward and
backward; and the routing that decides where the kernels run.

The lane code's contribution and the gradients of the const table, the
factor and the sky image are held under the float64 rule: each entry
within ``min(2·n·2⁻²⁴, 1e-4)·Σ|term|`` of the plain route run in float64,
``Σ|term|`` the same route on the inputs' absolute values.  Each record's
throughput gradient is one product in both, so it must be equal to the
plain route's in float32; so must the picked record and, as the sky's
positions sit at texel centres (half a texel from any boundary), its
texel.

Records (numpy, seeded) in the three phase shapes of ``trace_rays``'s
schedule (2, 4 and 11 bounces over B, B/3 and B/16 lanes): filler lanes
(no live record, as compaction leaves them), sky records with zero
throughput, lanes with two sky records (the first counts), lanes that never
reach the sky, materials whose emission is zero (their rows still get a
gradient) and, in a variant, two materials sharing a const row.  Both skies:
the demo's rotated equirect and config 4's unrotated one.  The lane tests
skip only where there is no host C++ compiler.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ptx_torch.core import rng
from ptx_torch.integrate import trace
from ptx_torch.integrate.camera import Camera
from ptx_torch.integrate.render import sample_rays
from ptx_torch.ops import emission_kernel, sky_bank
from ptx_torch.scenes import builders

torch.set_num_threads(1)

_SHIM = r'''
#include <stdint.h>
#include "sky_bank_lane.cuh"

using namespace ptx_skybank;

extern "C" void bank_forward(const float* pos, const float* thr, const int64_t* mid,
                             const bool* live, int nb, int64_t Bp, const float* xform,
                             const float* factor, const float* cst, const int64_t* const_row,
                             int M, int sky, const float* img, int H, int W, int C,
                             int mirror, float* out, int* sel) {
  const Scene s = {cst, const_row, xform, factor, img, M, sky, H, W, C, mirror};
  const Records r = {pos, thr, mid, live, nb, Bp};
  for (int64_t l = 0; l < Bp; ++l) {
    int texel;
    sel[2 * l] = lane_forward(s, r, l, out + 3 * l, &texel);
    sel[2 * l + 1] = texel;
  }
}

extern "C" void bank_backward(const float* thr, const int64_t* mid, const bool* live, int nb,
                              int64_t Bp, const float* factor, const float* cst,
                              const int64_t* const_row, int M, int sky, const float* img, int H,
                              int W, int C, const float* ct, const int* sel, float* d_thr,
                              float* q, float* pf, float* d_img) {
  const Scene s = {cst, const_row, nullptr, factor, img, M, sky, H, W, C, 0};
  const Records r = {nullptr, thr, mid, live, nb, Bp};
  for (int64_t l = 0; l < Bp; ++l) {
    float v[3];
    const int t = lane_backward(s, r, d_thr, l, ct + 3 * l, sel[2 * l], sel[2 * l + 1],
                                reinterpret_cast<float(*)[3]>(q), pf, v);
    if (t >= 0)
      for (int c = 0; c < 3; ++c) d_img[(int64_t)t * C + c] += v[c];
  }
}
'''

B = 3072
PHASES = ((2, B), (4, B // 3), (11, B // 16))     # trace_rays's schedule at depth 16
WORLDS = {"demo": builders.make_world, "config4": builders.baseline_config4}


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the sky bank's lane arithmetic")
    csrc = pathlib.Path(sky_bank.__file__).resolve().parent.parent / "csrc"
    tmp = tmp_path_factory.mktemp("sky_bank_lane")
    (tmp / "shim.cpp").write_text(_SHIM)
    so = tmp / "shim.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-ffp-contract=off",
                    f"-I{csrc}", "-o", str(so), str(tmp / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.bank_forward.argtypes = [vp] * 4 + [i, i64] + [vp] * 4 + [i, i, vp, i, i, i, i, vp, vp]
    lib.bank_backward.argtypes = [vp] * 3 + [i, i64] + [vp] * 3 + [i, i, vp, i, i, i] + [vp] * 6
    return lib


def _scene(world, shared_row=False):
    scene = trace.compile_scene(WORLDS[world](), "cpu")
    table = scene.material_fn
    if shared_row:              # the first two non-sky materials read one const row
        a, b = [m for m in range(table.n_materials) if m != scene.sky_bank.sky][:2]
        table.const_idx["emissive"][b] = table.const_idx["emissive"][a]
        table._dev.clear()
        scene.sky_bank = sky_bank.SkyBank(table)
    return scene


def _sky_positions(bank, params, H, W, n, r):
    """Float64 positions whose chain texel is a random texel's centre."""
    xi, yi = r.integers(0, W, n), r.integers(0, H, n)
    u, v = (xi + 0.5) / W, 1.0 - (yi + 0.5) / H
    theta, phi = (u - 0.5) * 2.0 * np.pi, (v - 0.5) * np.pi
    d = np.stack([np.cos(phi) * np.cos(theta), np.cos(phi) * np.sin(theta), np.sin(phi)], -1)
    d = d * r.uniform(2.0, 300.0, (n, 1))
    if bank.xform_idx is not None:
        A = params["tex_xform"][bank.xform_idx].numpy().astype(np.float64)
        d = (np.linalg.inv(A[:, :3]) @ (d - A[:, 3]).T).T
    return d


def _records(bank, params, n_mat, seed):
    """``saved`` for the three phases, as numpy-seeded tensors."""
    r = np.random.default_rng(seed)
    img = params["images"][bank.img_id]
    H, W = img.shape[0], img.shape[1]
    saved = []
    for nb, Bp in PHASES:
        mid = r.integers(0, n_mat, (nb, Bp))
        mid[:, r.uniform(size=Bp) < 0.2] = bank.sky       # lanes with several sky records
        live = r.uniform(size=(nb, Bp)) < 0.75
        thr = r.uniform(0.0, 2.0, (nb, Bp, 3)) * (r.uniform(size=(nb, Bp, 1)) < 0.9)
        thr[mid == bank.sky] *= r.uniform(size=((mid == bank.sky).sum(), 1)) < 0.7
        never = r.uniform(size=Bp) < 0.15                  # lanes that never reach the sky
        mid[:, never] = np.where(mid[:, never] == bank.sky, (bank.sky + 1) % n_mat,
                                 mid[:, never])
        filler = np.arange(Bp) >= Bp - Bp // 10            # compaction's dead tail
        live[:, filler], thr[:, filler] = False, 0.0
        pos = r.standard_normal((nb, Bp, 3)) * 50.0
        sky = mid == bank.sky
        pos[sky] = _sky_positions(bank, params, H, W, int(sky.sum()), r)
        saved.append((torch.from_numpy(pos.astype(np.float32)),
                      torch.from_numpy(thr.astype(np.float32)), torch.from_numpy(mid),
                      torch.from_numpy(live), None))
    return saved


def _plain(table, params, saved, cts, dtype, absolute=False):
    """The plain route in ``dtype``: its contributions and the gradients of
    each phase's thr, const, factor and the sky image for the cotangents
    ``cts`` (on absolute values with ``absolute``: Σ|term| of each entry)."""
    f = (lambda x: x.abs()) if absolute else (lambda x: x)
    p = dict(params)
    for k in ("const", "factor"):
        p[k] = f(params[k].to(dtype)).requires_grad_(True)
    p["tex_xform"] = params["tex_xform"].to(dtype)          # positions only pick texels
    p["images"] = [f(x.to(dtype)).requires_grad_(True) for x in params["images"]]
    sv = [(pos.to(dtype), f(thr.to(dtype)).requires_grad_(True), mid, live, o)
          for pos, thr, mid, live, o in saved]
    out = sky_bank.reference(table, p, sv)
    leaves = [t for _, t, *_ in sv] + [p["const"], p["factor"]] + p["images"]
    grads = torch.autograd.grad(out, leaves, [f(c.to(dtype)) for c in cts], allow_unused=True)
    return [o.detach() for o in out], grads


def _within(got, ref, scale, n, what):
    tol = min(2 * n * 2.0 ** -24, 1e-4)
    bad = (got.double() - ref).abs() > tol * scale + 1e-30
    assert not bad.any(), (f"{what}: {int(bad.sum())} entries off, worst "
                           f"{float(((got.double() - ref).abs() / (scale + 1e-30)).max())}")


@pytest.mark.parametrize("shared_row", [False, True])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_lanes_match_the_plain_route(lane_lib, world, shared_row):
    scene = _scene(world, shared_row)
    bank, table, params = scene.sky_bank, scene.material_fn, scene.params
    M = table.n_materials
    saved = _records(bank, params, M, seed=len(world) + 7 * shared_row)
    img = params["images"][bank.img_id]
    H, W, C = img.shape
    rows = table.const_idx["emissive"].astype(np.int64)
    xform = (params["tex_xform"][bank.xform_idx].contiguous()
             if bank.xform_idx is not None else None)
    factor = params["factor"][bank.factor_idx].contiguous()
    ptr = lambda x: None if x is None else x.data_ptr()
    r = np.random.default_rng(3)
    cts = [torch.from_numpy(r.standard_normal((Bp, 3)).astype(np.float32))
           for _, Bp in PHASES]

    got_out, got_sel, got_dthr = [], [], []
    q = np.zeros((sky_bank.MAX_MATERIALS, 3), np.float32)
    pf = np.zeros(3, np.float32)
    d_img = torch.zeros(H, W, C)
    for (pos, thr, mid, live, _), ct, (nb, Bp) in zip(saved, cts, PHASES):
        out, sel = torch.empty(Bp, 3), torch.empty(Bp, 2, dtype=torch.int32)
        lane_lib.bank_forward(ptr(pos), ptr(thr), ptr(mid), ptr(live), nb, Bp, ptr(xform),
                              ptr(factor), ptr(params["const"]), rows.ctypes.data, M, bank.sky,
                              ptr(img), H, W, C, int(bank.mirror), ptr(out), ptr(sel))
        d_thr = torch.empty(nb, Bp, 3)
        lane_lib.bank_backward(ptr(thr), ptr(mid), ptr(live), nb, Bp, ptr(factor),
                               ptr(params["const"]), rows.ctypes.data, M, bank.sky, ptr(img),
                               H, W, C, ptr(ct), ptr(sel), ptr(d_thr), q.ctypes.data,
                               pf.ctypes.data, ptr(d_img))
        got_out.append(out)
        got_sel.append(sel)
        got_dthr.append(d_thr)
    # the reduce kernel's fold: a row sums its materials in ascending order
    d_const = torch.zeros_like(params["const"])
    for m in range(M):
        if m != bank.sky:
            d_const[rows[m]] += torch.from_numpy(q[m])

    # the pick and its texel: the plain route's, exactly
    for (pos, thr, mid, live, _), sel in zip(saved, got_sel):
        is_sel = live & (mid == bank.sky) & (thr.abs().sum(-1) > 0)
        want = torch.where(is_sel.any(0), torch.argmax(is_sel.to(torch.uint8), 0), -1)
        assert torch.equal(sel[:, 0].long(), want)
        picked = want >= 0
        p = pos.gather(0, want.clamp(min=0)[None, :, None].expand(1, -1, 3))[0][picked]
        texel = emission_kernel.lanes_reference(
            emission_kernel.EmissionKernel(table, "cpu"), params["tex_xform"],
            params["const"], params["factor"], img, p,
            torch.full((len(p),), bank.sky))[1]
        assert torch.equal(sel[picked, 1], texel) and (sel[~picked, 1] == -1).all()
        assert (texel >= 0).all()
    assert any((s[:, 0] >= 0).sum() > 100 for s in got_sel)
    assert any(((mid == bank.sky) & live).sum(0).ge(2).sum() > 50
               for _, _, mid, live, _ in saved)

    out32, g32 = _plain(table, params, saved, cts, torch.float32)
    out64, g64 = _plain(table, params, saved, cts, torch.float64)
    abs64, gabs = _plain(table, params, saved, cts, torch.float64, absolute=True)
    for k, (nb, Bp) in enumerate(PHASES):
        _within(got_out[k], out64[k], abs64[k], 2 * nb + M, f"contribution, phase {k}")
        assert torch.equal(got_dthr[k], g32[k]), f"d_thr, phase {k}"
        assert (got_out[k][Bp - Bp // 10:] == 0).all()        # fillers bank nothing
    n = sum(nb * Bp for nb, Bp in PHASES)
    _within(d_const, g64[3], gabs[3], n, "d_const")
    d_factor = torch.zeros_like(params["factor"])
    d_factor[bank.factor_idx] = torch.from_numpy(pf)
    _within(d_factor, g64[4], gabs[4], n, "d_factor")
    _within(d_img, g64[5 + bank.img_id], gabs[5 + bank.img_id], n, "d_img")
    # zero-emission materials still get their row's gradient
    zero_rows = [rows[m] for m in range(M) if m != bank.sky
                 and not params["const"][rows[m]].any()]
    assert zero_rows and all(d_const[rw].abs().sum() > 0 for rw in zero_rows)
    assert d_img.abs().sum() > 0 and d_factor.abs().sum() > 0


def test_routing():
    for world in WORLDS:
        s = trace.compile_scene(WORLDS[world](), "cpu")
        assert isinstance(s.sky_bank, sky_bank.SkyBank) and s.emission_fn is None
    # S1's shape: a constant sky, no dynamic emitter
    assert trace.compile_scene(builders.stress_spheres(12), "cpu").sky_bank is None
    assert trace.compile_scene(builders.make_world(), "cpu", pallas=False).sky_bank is None


def test_emk_scene_takes_k7(monkeypatch):
    monkeypatch.setenv("PTX_EMK", "1")
    s = trace.compile_scene(builders.make_world(), "cpu")
    assert s.emission_fn is not None and s.sky_bank is None


def _demo_rays(w=16, h=32):
    return sample_rays(Camera.reference_demo(w, h), rng.PRNGKey(0), range(h), range(w), 1,
                       "cpu")


def test_skysel_off_bypasses_the_bank(monkeypatch):
    s = trace.compile_scene(builders.make_world(), "cpu")
    calls = []
    bank = s.sky_bank
    s.sky_bank = lambda *a: calls.append(1) or bank(*a)
    o, d = _demo_rays()
    trace.trace_rays(s, s.params, o, d, rng.PRNGKey(0), 4)
    assert calls == [1]
    trace.trace_rays(s, s.params, o, d, rng.PRNGKey(0), 4, skysel=False)
    assert calls == [1]


def test_no_kernel_off_cpu_and_cuda():
    s = trace.compile_scene(builders.make_world(), "cpu")
    saved = [(torch.empty(2, 4, 3, device="meta"), torch.empty(2, 4, 3, device="meta"),
              torch.empty(2, 4, dtype=torch.int64, device="meta"),
              torch.empty(2, 4, dtype=torch.bool, device="meta"), None)]
    with pytest.raises(ValueError, match="no kernel for meta"):
        s.sky_bank(s.params, saved)


def _parent_emission(scene, params, saved, skysel):
    """``trace._emission`` as it was before the sky bank, verbatim."""
    table = scene.material_fn
    term_chains = (table.terminal_dynamic_emissive
                   if skysel and scene.emission_fn is None else [])
    term_mis = {mi for mi, _ in term_chains}
    mat_sum = bool(term_chains) and set(table.dynamic_slots["emissive"]) <= term_mis
    ems = None
    if not mat_sum:
        em_eval = scene.emission_fn or (table.eval_emissive_base if term_chains
                                        else table.eval_emissive)
        em = em_eval(params, torch.cat([p.reshape(-1, 3) for p, *_ in saved]),
                     torch.cat([m.reshape(-1) for _, _, m, *_ in saved]))
        ems = em.split([m.numel() for _, _, m, *_ in saved])
    out = []
    for pi, (pos, thr, mid, live, _) in enumerate(saved):
        if mat_sum:
            em_rows = params["const"][table.const_rows("emissive", thr.device)]
            contrib = torch.zeros(thr.shape[1:], dtype=torch.float32,
                                  device=thr.device)
            for m in range(table.n_materials):
                if m in term_mis:
                    continue
                wsum = torch.where((live & (mid == m))[..., None], thr, 0.0).sum(dim=0)
                contrib = contrib + wsum * em_rows[m]
        else:
            em = ems[pi].reshape(thr.shape)
            contrib = torch.where(live[..., None], thr * em, 0.0).sum(dim=0)

        if term_chains:
            thr_nz = thr.abs().sum(dim=-1) > 0.0
        for mi, fn in term_chains:
            is_sel = live & (mid == mi) & thr_nz
            first = torch.argmax(is_sel.to(torch.uint8), dim=0)
            pick = lambda a: a.gather(0, first[None, :, None].expand(1, -1, 3))[0]
            em = fn(params, pick(pos))
            contrib = contrib + torch.where(is_sel.any(dim=0)[:, None],
                                            pick(thr) * em, 0.0)
        out.append(contrib)
    return out


@pytest.mark.parametrize("skysel", [True, False])
def test_trace_rays_matches_the_parent_route_bit_for_bit(monkeypatch, skysel):
    """On CPU tensors the bank is the plain route: ``trace_rays`` on the
    demo (compaction on: three phases) gives the radiance and every
    gradient of the route before it, bit for bit."""
    s = trace.compile_scene(builders.make_world(), "cpu")
    o, d = _demo_rays()
    w = torch.from_numpy(np.random.default_rng(0).uniform(size=o.shape).astype(np.float32))

    def run():
        p = {k: ([x.clone().requires_grad_(True) for x in v] if isinstance(v, list)
                 else v.clone().requires_grad_(True)) for k, v in s.params.items()}
        rad = trace.trace_rays(s, p, o, d, rng.PRNGKey(5), 16, compact=True, skysel=skysel)
        leaves = [x for v in p.values() for x in (v if isinstance(v, list) else [v])]
        return rad.detach(), torch.autograd.grad((rad * w).sum(), leaves, allow_unused=True)

    rad, grads = run()
    monkeypatch.setattr(trace, "_emission", _parent_emission)
    rad_p, grads_p = run()
    assert torch.equal(rad, rad_p) and rad.abs().sum() > 0
    for g, gp in zip(grads, grads_p):
        assert (g is None) == (gp is None)
        if g is not None:
            assert torch.equal(g, gp)
    assert sum(g.abs().sum() for g in grads if g is not None) > 0
