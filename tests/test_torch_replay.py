"""The replay backward (the math of K2) against the JAX package.

- ``leaf_rows`` and the hit replay against ``ptx.geom.hitreplay`` on the
  demo;
- ``bounce_bwd_reference`` (K2's plain version: autograd through the
  port's ``_bounce_replay``) against ``jax.vjp`` of
  ``ptx.integrate.trace._bounce_replay`` (``compile_scene(...,
  pallas=False)``), the function ``tests/test_bounce_kernel.py`` holds the
  JAX K2 against, on 256 lanes with compaction filler lanes among them;
- K2's raw outputs in plain PyTorch (per-lane cotangents and (L, 34)
  per-leaf sums), folded into the scene vector's cotangent and mapped to
  the params, and K2's call on the CPU (its plain version), against
  ``bounce_bwd_reference``; the fold and its static table; one pack and
  one packing VJP per ``trace_rays`` call, for K2 and for K6;
- the kernel's own adjoint source (``csrc/replay_lane.cuh``), built for the
  host with the system C++ compiler, against autograd.

Tolerance.  Both packages and the hand adjoint order the same float32
operations differently, and a gradient at a near-grazing hit is
ill-conditioned: there each float32 value carries ~1e-4 relative error
against a float64 recompute (up to 9e-5 measured on the demo).  An
element passes when within ``rtol 1e-5, atol 1e-6`` of the other value, or
when its error against the port's float64 recompute is at most twice the
other value's plus ``1e-4`` relative (``_close``).  Per-leaf sums are
compared at the scale of the sum of their terms' magnitudes.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.geom import hitreplay as jhr
from ptx.geom.fasthit import collect_leaves as jcollect
from ptx.integrate import trace as jtr
from ptx.scenes import builders as jbuilders
from ptx_torch.convert import params_from_jax, scene_from_jax
from ptx_torch.geom import hitreplay
from ptx_torch.geom.fasthit import collect_leaves
from ptx_torch.integrate import trace as ttr
from ptx_torch.ops import bounce_kernel as bk
from ptx_torch.shade.bounce import DIFF_KEYS

torch.set_num_threads(1)

B = 256
N_FILL = 32                  # compaction filler lanes at the tail
DEC = ("evt", "hit", "entering", "mat_id", "take_transmit", "scatter_alive", "u_sel")


def _np_params(params):
    return {k: ([np.asarray(x) for x in v] if isinstance(v, list) else np.asarray(v))
            for k, v in params.items()}


@pytest.fixture(scope="module")
def pair():
    root = jbuilders.make_world()
    js = jtr.compile_scene(root, pallas=False)
    ts = ttr.compile_scene(scene_from_jax(root), "cpu")
    ts.params = params_from_jax(_np_params(js.params), "cpu")
    return js, ts


def _close(got, want, truth, name, scale=None):
    got, want, truth = (np.asarray(x, np.float64) for x in (got, want, truth))
    scale = np.abs(truth) if scale is None else np.asarray(scale, np.float64)
    ok = np.isclose(got, want, rtol=1e-5, atol=1e-6) | (
        np.abs(got - truth) <= 2.0 * np.abs(want - truth) + 1e-4 * scale + 1e-6)
    assert np.isfinite(got).all(), f"{name}: not finite"
    assert ok.all(), (f"{name}: {int((~ok).sum())} elements off; got "
                      f"{got[~ok][:4]}, want {want[~ok][:4]}, float64 {truth[~ok][:4]}")


def _lanes(seed):
    """Primary demo rays fanned over the frame, and a tail of compaction
    fillers: dead, zero throughput, direction shifted by (0, 0, -1)."""
    r = np.random.default_rng(seed)
    d = np.stack([r.uniform(-0.6, 0.6, B), r.uniform(-0.5, 0.5, B),
                  -np.ones(B)], -1).astype(np.float32)
    o = np.zeros((B, 3), np.float32)
    thr = np.ones((B, 3), np.float32)
    st = np.ones(B, np.float32)
    alive = np.ones(B, bool)
    d[-N_FILL:, 2] += -1.0
    thr[-N_FILL:] = 0.0
    st[-N_FILL:] = 0.0
    alive[-N_FILL:] = False
    uc = r.random(B, dtype=np.float32)
    u3 = r.random((B, 3), dtype=np.float32)
    cts = [r.normal(size=(B, 3)).astype(np.float32) for _ in range(3)]
    return o, d, thr, st, alive, uc, u3, cts


def _jax_decisions(js, o, d, thr, st, alive, uc, u3):
    carry, dec = jax.jit(lambda p, *a: jtr._bounce_live(
        js, p, *a[:5], jax.random.PRNGKey(0), True, use_fused=False,
        u_coin=a[5], u3=a[6]))(js.params, *map(jnp.asarray, (o, d, thr, st, alive, uc, u3)))
    return {k: np.asarray(dec[k]) for k in DEC}, carry


def _torch_dec(dec, dtype=torch.float32):
    return {k: (torch.from_numpy(np.array(v)).to(dtype) if k == "u_sel"
                else torch.from_numpy(np.array(v)))
            for k, v in dec.items()}


def _f64(params):
    return {k: ([x.double() for x in v] if isinstance(v, list) else v.double())
            for k, v in params.items()}


def test_leaf_rows_match_jax(pair):
    js, ts = pair
    want = jhr.leaf_rows(jcollect(js.plan), js.params)
    got = hitreplay.leaf_rows(collect_leaves(ts.plan), ts.params)
    assert got.shape == (13, 26)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_hit_replay_matches_jax_and_the_live_hit(pair):
    """The replay on the live hit's decisions gives the live hit's t and
    normal, in both packages."""
    js, ts = pair
    o, d, *_ = _lanes(3)
    o[:16], d[:16] = (0.0, 0.0, 1000.0), (0.0, 0.0, 1.0)    # outside the sky: misses
    live = jax.jit(js.hit_fn)(js.params, jnp.asarray(o), jnp.asarray(d))
    want = js.hit_replay_fn(js.params, jnp.asarray(o), jnp.asarray(d), live["_evt"],
                            live["entering"], live["hit"])
    args = (torch.from_numpy(np.array(live[k])) for k in ("_evt", "entering", "hit"))
    t, n = ts.hit_replay_fn(ts.params, torch.from_numpy(o), torch.from_numpy(d), *args)
    np.testing.assert_allclose(t.numpy(), np.asarray(want[0]), rtol=1e-5, atol=5e-6)
    np.testing.assert_allclose(n.numpy(), np.asarray(want[1]), rtol=1e-5, atol=5e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(live["t"]), rtol=1e-5, atol=5e-6)
    hit = np.asarray(live["hit"])
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(n.numpy()[~hit], np.tile([0.0, 0.0, 1.0], ((~hit).sum(), 1)))


@pytest.mark.parametrize("seed", [0, 1])
def test_bounce_bwd_reference_matches_jax_vjp(pair, seed):
    js, ts = pair
    o, d, thr, st, alive, uc, u3, cts = _lanes(seed)
    dec, _ = _jax_decisions(js, o, d, thr, st, alive, uc, u3)
    assert dec["take_transmit"].any() and dec["scatter_alive"].any()

    def rep(params, o, d, thr):
        return jtr._bounce_replay(js, params, o, d, thr, jnp.asarray(st),
                                  jnp.asarray(alive), {k: jnp.asarray(v) for k, v in dec.items()})[:3]

    _, vjp = jax.vjp(rep, js.params, *map(jnp.asarray, (o, d, thr)))
    jp, jo, jd, jt = vjp(tuple(jnp.asarray(c) for c in cts))

    t = lambda x, dt=torch.float32: torch.from_numpy(x).to(dt)
    got = bk.bounce_bwd_reference(ts, ts.params, t(o), t(d), t(thr), _torch_dec(dec),
                                  *map(t, cts))
    truth = bk.bounce_bwd_reference(
        ts, _f64(ts.params), *(t(x, torch.float64) for x in (o, d, thr)),
        _torch_dec(dec, torch.float64), *(t(c, torch.float64) for c in cts))
    for name, g, w, tr in zip(("d_o", "d_d", "d_thr"), got[:3], (jo, jd, jt), truth[:3]):
        _close(g.numpy(), w, tr.numpy(), name)
        # filler lanes pass their cotangents through, exactly
        np.testing.assert_array_equal(g.numpy()[-N_FILL:], cts[("d_o", "d_d", "d_thr").index(name)][-N_FILL:])
    for k in DIFF_KEYS:
        _close(got[3][k].numpy(), np.asarray(jp[k]), truth[3][k].numpy(), k)
    assert np.abs(got[3]["sphere_radius"].numpy()).sum() > 0
    assert np.abs(got[3]["ior"].numpy()).sum() > 0


def test_k2_lanes_reference_maps_to_bounce_bwd_reference(pair):
    """K2's raw outputs in plain PyTorch, folded into the scene vector's
    cotangent (``fold_packed``) and taken to the params by the packing's
    VJP (``BounceBwdKernel.params_grad``), equal the whole-bounce plain
    backward."""
    _, ts = pair
    js, _ = pair
    o, d, thr, st, alive, uc, u3, cts = _lanes(2)
    dec = _torch_dec(_jax_decisions(js, o, d, thr, st, alive, uc, u3)[0])
    t = torch.from_numpy
    kern = bk.BounceBwdKernel(ts)
    packed, leaves = kern.pack_leaves(ts.params)
    lo, ld, lt, acc, acc_abs = bk.bounce_bwd_lanes_reference(
        packed.detach(), kern.aux, t(o), t(d), t(thr), dec, *map(t, cts))
    want = bk.bounce_bwd_reference(ts, ts.params, t(o), t(d), t(thr), dec, *map(t, cts))
    for g, w in zip((lo, ld, lt), want[:3]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    got = kern.params_grad(packed, leaves, bk.fold_packed(acc, kern.leaf_mat,
                                                          kern.n_materials))
    for k in DIFF_KEYS:
        torch.testing.assert_close(got[k], want[3][k], rtol=1e-4, atol=1e-5)
    assert float(acc_abs.sum()) > 0


@pytest.mark.parametrize("seed", [6, 7])
def test_k2_call_on_the_cpu_gives_the_packed_cotangent(pair, seed):
    """K2's per-bounce call on CPU tensors runs its plain version (counted)
    and returns ``d_packed``: mapped through ``params_grad`` it equals
    ``bounce_bwd_reference``'s ``d_params`` at the tolerances above; per
    lane ``_close`` against that reference and its float64 recompute (a
    near-grazing lane is ill-conditioned, module docstring)."""
    js, ts = pair
    o, d, thr, st, alive, uc, u3, cts = _lanes(seed)
    dec = _torch_dec(_jax_decisions(js, o, d, thr, st, alive, uc, u3)[0])
    t = torch.from_numpy
    kern = bk.BounceBwdKernel(ts)
    packed, leaves = kern.pack_leaves(ts.params)
    calls = bk.BWD_REFERENCE_CALLS
    d_o, d_d, d_thr, d_packed = kern(packed.detach(), t(o), t(d), t(thr), dec,
                                     *map(t, cts))
    assert bk.BWD_REFERENCE_CALLS == calls + 1
    assert d_packed.shape == packed.shape
    want = bk.bounce_bwd_reference(ts, ts.params, t(o), t(d), t(thr), dec, *map(t, cts))
    truth = bk.bounce_bwd_reference(
        ts, _f64(ts.params), *(t(x).double() for x in (o, d, thr)),
        _torch_dec(_jax_decisions(js, o, d, thr, st, alive, uc, u3)[0], torch.float64),
        *(t(c).double() for c in cts))
    for name, g, w, tr in zip(("d_o", "d_d", "d_thr"), (d_o, d_d, d_thr), want[:3], truth[:3]):
        _close(g.numpy(), w.numpy(), tr.numpy(), name)
    got = kern.params_grad(packed, leaves, d_packed)
    for k in DIFF_KEYS:
        torch.testing.assert_close(got[k], want[3][k], rtol=1e-4, atol=1e-5)


def test_fold_sums_shared_materials_and_zeroes_leafless_ones(pair):
    """``fold_packed`` adds the material columns of the leaves that share a
    material in ascending leaf order and gives a material without leaves an
    exact 0; the static table the kernel folds with (``fold_table``) lists
    each material's leaves in that order.  On the demo (its six sky planes
    share one material) and on a synthetic table where materials 1 and 4
    have no leaf."""
    _, ts = pair
    kern = bk.BounceBwdKernel(ts)
    demo = kern.leaf_mat.tolist()
    assert max(demo.count(m) for m in set(demo)) > 1
    r = np.random.default_rng(8)
    for leaf_mat, M in ((demo, kern.n_materials), ([2, 0, 2, 2, 3, 0, 2], 5)):
        L = len(leaf_mat)
        acc = torch.from_numpy(r.normal(size=(L, 34)).astype(np.float32))
        got = bk.fold_packed(acc, torch.tensor(leaf_mat), M)
        assert got.shape == (L * 26 + M * 8,)
        assert torch.equal(got[:L * 26], acc[:, :26].reshape(-1))
        start, order = bk.fold_table(leaf_mat, M)
        mats = got[L * 26:].reshape(M, 8)
        for m in range(M):
            mine = [k for k in range(L) if leaf_mat[k] == m]
            assert order[start[m]:start[m + 1]] == mine
            want = torch.zeros(8)
            for k in mine:                      # the kernel's order
                want = want + acc[k, 26:]
            assert torch.equal(mats[m], want)
            if not mine:
                assert not bool(mats[m].any())
    start, _ = bk.fold_table([2, 0, 2, 2, 3, 0, 2], 5)
    assert start == [0, 2, 2, 6, 7, 7]


def _packs_per_trace_rays_call(ts, K):
    """``trace_rays`` at depth 16 (17 bounces, 16 backward) on 8×8 demo
    camera rays: no pack without a param that needs a gradient; with one,
    one pack of the replay backward's scene vector, one VJP of the packing
    and a plain replay backward call per backward bounce."""
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera, sample_rays

    o, d = sample_rays(Camera.reference_demo(8, 8), rng.PRNGKey(0), range(8), range(8), 1,
                       "cpu")
    before = (K.PACKS, K.PACK_VJPS, bk.BWD_REFERENCE_CALLS)
    with torch.no_grad():
        ttr.trace_rays(ts, ts.params, o, d, rng.PRNGKey(0), 16)
    ttr.trace_rays(ts, ts.params, o, d, rng.PRNGKey(0), 16)      # no param needs a gradient
    assert (K.PACKS, K.PACK_VJPS, bk.BWD_REFERENCE_CALLS) == before
    p = {k: ([x.clone().requires_grad_(True) for x in v] if isinstance(v, list)
             else v.clone().requires_grad_(True)) for k, v in ts.params.items()}
    ttr.trace_rays(ts, p, o, d, rng.PRNGKey(0), 16).mean().backward()
    assert (K.PACKS, K.PACK_VJPS, bk.BWD_REFERENCE_CALLS) == (
        before[0] + 1, before[1] + 1, before[2] + 16)
    assert float(p["sphere_radius"].grad.abs().sum()) > 0


def test_pack_and_its_vjp_run_once_per_trace_rays_call(pair):
    """On the demo (K2): :func:`_packs_per_trace_rays_call`."""
    _packs_per_trace_rays_call(pair[1], bk.BounceBwdKernel)


def test_k6_pack_and_its_vjp_run_once_per_trace_rays_call():
    """On ``stress_spheres(25)`` (32 leaves: K6, ``RowFedReplayBwd``, with
    its own counts): :func:`_packs_per_trace_rays_call`; K2 packs nothing."""
    from ptx_torch.ops.replay_bwd import RowFedReplayBwd
    from ptx_torch.scenes.builders import stress_spheres

    ts = ttr.compile_scene(stress_spheres(25), "cpu")
    assert type(ts.bounce_bwd_fn) is RowFedReplayBwd
    k2 = (bk.BounceBwdKernel.PACKS, bk.BounceBwdKernel.PACK_VJPS)
    _packs_per_trace_rays_call(ts, RowFedReplayBwd)
    assert (bk.BounceBwdKernel.PACKS, bk.BounceBwdKernel.PACK_VJPS) == k2


_SHIM = r'''
#include <stdint.h>
#include "replay_lane.cuh"
extern "C" void lanes(const float* scene, int L, const float* aux, const float* o,
    const float* d, const float* thr, const int* evt, const uint8_t* hit,
    const uint8_t* ent, const uint8_t* tt, const uint8_t* sa, const float* u,
    const float* co, const float* cd, const float* ct, int B, float* go, float* gd,
    float* gt, float* lane34) {
  using namespace ptx_replay;
  for (int i = 0; i < B; ++i) {
    const int e = evt[i], k = e >= L ? e - L : e;
    const float* a = aux + 3 * k;
    auto l3 = [&](const float* p) { return V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]}; };
    V3 ro, rd, rt;
    float* g = lane34 + i * kCols;
    for (int c = 0; c < kCols; ++c) g[c] = 0.f;
    replay_lane_vjp(scene + kRow * k, scene + kRow * L + kMat * (int)a[2], a[0] != 0.f,
                    a[1], e < L, hit[i], ent[i], tt[i], sa[i], l3(o), l3(d), l3(thr),
                    l3(u), l3(co), l3(cd), l3(ct), ro, rd, rt, g, g + kRow);
    const V3 outs[3] = {ro, rd, rt};
    float* dst[3] = {go, gd, gt};
    for (int j = 0; j < 3; ++j) {
      dst[j][3 * i] = outs[j].x; dst[j][3 * i + 1] = outs[j].y; dst[j][3 * i + 2] = outs[j].z;
    }
  }
}
'''


def test_k2_lane_adjoint_host_build(pair, tmp_path):
    """The kernel's hand-written adjoint (``csrc/replay_lane.cuh``, the
    exact source K2 compiles), built for the host without multiply-add
    contraction, against autograd through ``replay_lane_math``."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel's lane math")
    import pathlib
    csrc = pathlib.Path(bk.__file__).resolve().parent.parent / "csrc"
    (tmp_path / "shim.cpp").write_text(_SHIM)
    so = tmp_path / "shim.so"
    subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-ffp-contract=off", f"-I{csrc}",
                    "-o", str(so), str(tmp_path / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.lanes.argtypes = [vp, ctypes.c_int] + [vp] * 13 + [ctypes.c_int] + [vp] * 4

    js, ts = pair
    kern = bk.BounceBwdKernel(ts)
    packed = kern.pack(ts.params).detach()
    L = kern.aux.shape[0]
    for seed in (4, 5):
        o, d, thr, st, alive, uc, u3, cts = _lanes(seed)
        dec = _torch_dec(_jax_decisions(js, o, d, thr, st, alive, uc, u3)[0])
        t = torch.from_numpy
        ref = bk.bounce_bwd_lanes_reference(packed, kern.aux, t(o), t(d), t(thr), dec,
                                            *map(t, cts))
        ref64 = bk.bounce_bwd_lanes_reference(
            packed.double(), kern.aux.double(), *(t(x).double() for x in (o, d, thr)),
            dict(dec, u_sel=dec["u_sel"].double()), *(t(c).double() for c in cts))
        c = lambda x: np.ascontiguousarray(x)
        ins = [c(kern.aux.numpy()), o, d, thr, c(dec["evt"].numpy().astype(np.int32))]
        ins += [c(dec[k].numpy().astype(np.uint8))
                for k in ("hit", "entering", "take_transmit", "scatter_alive")]
        ins += [c(dec["u_sel"].numpy())] + cts
        outs = [np.zeros((B, 3), np.float32) for _ in range(3)] + [np.zeros((B, 34), np.float32)]
        p = lambda a: a.ctypes.data_as(vp)
        lib.lanes(p(c(packed.numpy())), L, *map(p, ins), B, *map(p, outs))
        leaf = torch.where(dec["evt"] >= L, dec["evt"] - L, dec["evt"]).long()
        acc = torch.zeros(L, 34).index_add_(0, leaf, t(outs[3])).numpy()
        for name, g, w, tr in zip(("d_o", "d_d", "d_thr"), outs[:3], ref[:3], ref64[:3]):
            _close(g, w.numpy(), tr.numpy(), f"seed {seed} {name}")
        _close(acc, ref[3].numpy(), ref64[3].numpy(), f"seed {seed} acc",
               scale=ref64[4].numpy())
