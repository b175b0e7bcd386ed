"""The CSG fold of K1 and K4 (``ptx_torch/csrc/hit_fold.cuh``, the exact
source the kernels compile) built for the host with ``g++
-ffp-contract=off`` and held against the plain fold of
``ptx_torch/geom/fasthit.py`` (``DenseHit``, the dense hit) under
K1's gate on the card: the decisions (event, hit, entering) equal except
at near-ties that a float64 recompute adjudicates, ``t`` and the normal
within ``rtol 1e-5, atol 5e-6``.  Both round each operation once in the
same order, so the largest difference is 0 but for the rare lane where
PyTorch's CPU square root (vectorised, within 0.5001 ulp) does not round
as the correctly rounded ``sqrtf`` does: there ``t`` moves by an ulp
(1e-8 to 3e-7 here; on the card both sides call the same ``sqrtf``).

The fold is the walk in time order (``first_hit_walk``).  The decisions
include ``mat_id``, K4's material lookup (``hit_material``: the winning
leaf record's material word, 0 on a miss).

Scenes: the demo, BASELINE configs 1-4, and seeded random CSG trees of
1-24 leaves (spheres, planes, transformed leaves; unions,
intersections, differences) with coincident boundaries (leaves that
repeat another's geometry) and leaf counts at the fold's bucket edges
(8, 9, 16, 17, 24).  Skips only where there is no host C++ compiler.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ptx_torch.core import linalg
from ptx_torch.core.constants import EPS, MAX_VALUE
from ptx_torch.geom import fasthit
from ptx_torch.geom.tape import Difference, Intersection, Plane, Sphere, Transformed, Union
from ptx_torch.integrate import trace
from ptx_torch.ops import fasthit_kernel
from ptx_torch.scenes import builders
from ptx_torch.shade.materials import Material

torch.set_num_threads(1)

B = 2048
_CPU = torch.device("cpu")
TIE_REL = 1e-5               # a near-tie: within 1e-5·max(1, |t|), as chip_smoke.py

_SHIM = r'''
#include <stdint.h>
#include "hit_fold.cuh"
using namespace ptx_hit;

extern "C" void fold(const float* s, int L, int off, int len, const float* o,
                     const float* d, int n, float* t, int* evt, uint8_t* ent,
                     uint8_t* hit, float* nrm, int64_t* mat) {
  const int lb = leaf_bucket(L);
  for (int i = 0; i < n; ++i) {
    const Vec3 oo = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
    const Vec3 dd = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    const FirstHit h = lb == 8 ? first_hit_walk<8>(s, L, off, len, oo, dd)
                     : lb == 16 ? first_hit_walk<16>(s, L, off, len, oo, dd)
                                : first_hit_walk<24>(s, L, off, len, oo, dd);
    t[i] = h.hit ? h.t : 0.f;
    evt[i] = h.hit ? h.event : 0;
    ent[i] = h.entering;
    hit[i] = h.hit;
    nrm[3 * i] = h.normal.x;
    nrm[3 * i + 1] = h.normal.y;
    nrm[3 * i + 2] = h.normal.z;
    mat[i] = hit_material(s, h);
  }
}
'''


@pytest.fixture(scope="module")
def fold_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' fold")
    csrc = pathlib.Path(fasthit_kernel.__file__).resolve().parent.parent / "csrc"
    tmp = tmp_path_factory.mktemp("hit_fold")
    (tmp / "shim.cpp").write_text(_SHIM)
    so = tmp / "shim.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-ffp-contract=off",
                    f"-I{csrc}", "-o", str(so), str(tmp / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.fold.argtypes = [vp, i, i, i, vp, vp, i] + [vp] * 6
    return lib


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def _random_tree(n_leaves, seed):
    """A seeded random CSG tree of ``n_leaves`` leaves: spheres and planes
    (a few transformed), some repeating an earlier leaf's geometry (a
    coincident boundary), joined by random unions, intersections and
    differences."""
    rng = np.random.default_rng(seed)
    mats = [Material(reflect=(0.8, 0.3, 0.3), scatter=1.0),
            Material(reflect=0.9, scatter=0.0, transmit=0.5, ior=1.4, transmit_reflect=0.5)]
    made = []

    def leaf():
        mat = mats[int(rng.integers(len(mats)))]
        if made and rng.random() < 0.2:
            kind, geo = made[int(rng.integers(len(made)))]     # coincident boundary
        elif rng.random() < 0.25:
            n = rng.normal(size=3).astype(np.float32)
            kind, geo = "plane", (n / np.linalg.norm(n), float(rng.uniform(-1.0, 3.0)))
        else:
            c = np.array([rng.uniform(-2, 2), rng.uniform(-1.5, 1.5), rng.uniform(-7, -2)],
                         np.float32)
            kind, geo = "sphere", (c, float(rng.uniform(0.3, 1.6)))
        made.append((kind, geo))
        obj = Sphere(geo[0], geo[1], mat) if kind == "sphere" else Plane(geo[0], geo[1], mat)
        if rng.random() < 0.15:
            t = linalg.compose(linalg.translate(rng.uniform(-0.3, 0.3, 3), _CPU),
                               linalg.rotate_y(float(rng.uniform(0, 6.28)), _CPU))
            obj = Transformed(obj, t.numpy())
        return obj

    def tree(n):
        if n == 1:
            return leaf()
        k = int(rng.integers(1, n))
        a, b = tree(k), tree(n - k)
        op = rng.choice(["union", "intersection", "difference"], p=[0.5, 0.25, 0.25])
        if op == "union":
            return Union(a, b)
        return Intersection(a, b) if op == "intersection" else Difference(a, b)

    return tree(n_leaves)


_SCENES = {"demo": builders.make_world, "config1": builders.baseline_config1,
           "config2": builders.baseline_config2, "config3": builders.baseline_config3,
           "config4": builders.baseline_config4}
# (leaves, seed): the bucket edges 8 | 9, 16 | 17 and 24, and a few between
_TREES = [(1, 0), (2, 1), (5, 2), (8, 3), (9, 4), (13, 5), (16, 6), (17, 7), (20, 8),
          (24, 9), (24, 10)]


def _rays(seed):
    """Rays from a camera-like origin, from random points of the scene's
    region (some inside solids) and toward random points."""
    rng = np.random.default_rng(100 + seed)
    o = np.zeros((B, 3), np.float32)
    o[B // 2:] = rng.uniform((-2.5, -2, -7), (2.5, 2, -1), (B // 2, 3))
    target = rng.uniform((-2.5, -2, -7), (2.5, 2, -2), (B, 3)).astype(np.float32)
    d = target - o
    d[B // 4: B // 2] = rng.normal(size=(B // 4, 3))
    d[:4] = 0.0                                # a zero direction never hits
    return o.astype(np.float32), d.astype(np.float32)


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def _host_fold(lib, plan, params, o, d):
    """The header's fold on the host: the dense hit's dict."""
    buf, (L, off, length) = fasthit_kernel.pack_geometry(plan, params)
    assert fasthit_kernel.stack_below_top(plan) < 32
    s = np.ascontiguousarray(buf.numpy(), np.float32)
    out = {"t": np.zeros(B, np.float32), "_evt": np.zeros(B, np.int32),
           "entering": np.zeros(B, np.uint8), "hit": np.zeros(B, np.uint8),
           "normal": np.zeros((B, 3), np.float32), "mat_id": np.zeros(B, np.int64)}
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.fold(p(s), L, off, length, p(o), p(d), B,
             *(p(out[k]) for k in ("t", "_evt", "entering", "hit", "normal", "mat_id")))
    return {k: torch.from_numpy(v.astype(bool) if v.dtype == np.uint8 else v)
            for k, v in out.items()}


def _near_tie(plan, params, o, d, lanes, evt_a, evt_b):
    """Per lane of ``lanes``: whether a float64 recompute puts the winning
    event of either side within ``TIE_REL·max(1, |t|)`` of another finite
    boundary or of EPS (but not exactly on a boundary: equal times round
    alike on both sides, and the event order breaks that tie)."""
    p64 = {k: ([x.double() for x in v] if isinstance(v, list) else v.double())
           for k, v in params.items()}
    leaves = fasthit.collect_leaves(plan)
    o64, d64 = torch.from_numpy(o).double()[lanes], torch.from_numpy(d).double()[lanes]
    t0, t1, _, _ = fasthit._leaf_intervals(leaves, p64, *o64.unbind(-1), *d64.unbind(-1))
    t_evt = torch.cat([t0, t1])
    idx = torch.arange(lanes.numel())

    def tied(evt):
        te = t_evt[evt[lanes].long(), idx]
        tol = TIE_REL * torch.clamp(te.abs(), min=1.0)
        gap = (t_evt - te[None]).abs()
        near = (gap > 0) & (gap <= tol) & (t_evt.abs() < MAX_VALUE)
        return (te.abs() < MAX_VALUE) & (near.any(0) | ((te - EPS).abs() <= tol))
    return tied(evt_a) | tied(evt_b)


def _check(lib, plan, params, seed, name):
    o, d = _rays(seed)
    got = _host_fold(lib, plan, params, o, d)
    want = trace.compile_fast_hit(plan, candidate_block=0)(
        params, torch.from_numpy(o), torch.from_numpy(d))
    differ = torch.zeros(B, dtype=torch.bool)
    for k in ("_evt", "hit", "entering", "mat_id"):
        differ |= got[k] != want[k]
    lanes = differ.nonzero().flatten()
    if lanes.numel():
        ok = _near_tie(plan, params, o, d, lanes, got["_evt"], want["_evt"])
        assert bool(ok.all()), f"{name}: unexplained decision flips at lanes {lanes[~ok][:8]}"
    agree = ~differ
    worst = 0.0
    for k, keep in (("t", agree), ("normal", agree & want["hit"])):
        a, b = got[k][keep], want[k][keep]
        torch.testing.assert_close(a, b, rtol=1e-5, atol=5e-6, msg=lambda m: f"{name} {k}: {m}")
        worst = max(worst, float((a - b).abs().max()) if a.numel() else 0.0)
    print(f"{name}: L={len(fasthit.collect_leaves(plan))} hit {int(want['hit'].sum())} of {B}, "
          f"flips {lanes.numel()} (near-ties), largest difference {worst:.3g}")
    return worst, int(want["hit"].sum())


@pytest.mark.parametrize("name", sorted(_SCENES))
def test_host_fold_matches_the_plain_fold_on_the_configs(fold_lib, name):
    scene = trace.compile_scene(_SCENES[name](), "cpu")
    _, hits = _check(fold_lib, scene.plan, scene.params, 0, name)
    assert hits > 0


@pytest.mark.parametrize("n_leaves,seed", _TREES)
def test_host_fold_matches_the_plain_fold_on_random_trees(fold_lib, n_leaves, seed):
    scene = trace.compile_scene(_random_tree(n_leaves, seed), "cpu")
    assert len(fasthit.collect_leaves(scene.plan)) == n_leaves
    _check(fold_lib, scene.plan, scene.params, seed, f"tree L={n_leaves} seed {seed}")
