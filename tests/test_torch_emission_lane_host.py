"""K7's lane arithmetic (``ptx_torch/csrc/emission_lane.cuh``, the exact
source its forward kernel includes) built for the host with ``g++
-ffp-contract=off`` and held against K7's plain forward
``lanes_reference``: the bin of every lane (the chain's texel ``y·W + x``,
``-1`` out of the image, ``H·W + row`` for another material's lane).

The map runs the plain version's float32 operations in its order, so the
bins must be equal wherever a float64 recompute puts the chain's texel
coordinates further than 1e-6 (in uv units) from a texel boundary.  Within
it the host's libm rounds ``atan2f`` / ``asinf`` one ulp apart from
PyTorch's CPU kernels on some inputs, so either neighbouring texel is
right: there the bins must be the same texel or neighbours (x wrapping
around the seam).  Both worlds K7 takes in the tests: the demo's rotated
equirect sky and a mirror-ball probe (its map has no wrap: a lane past the
ball's rim lands in bounds or, at the far pole, on the fixed centre).

Positions (numpy, seeded): random directions at random distances; lanes
on the boundaries (texel corners mapped back through the chain, so that
the float32 coordinates land within rounding of a corner); the zero
vector, the six axes, the poles, the mirror's far pole; lanes of every
other material.  Skips only where there is no host C++ compiler.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ptx_torch.geom.tape import Sphere
from ptx_torch.integrate import trace
from ptx_torch.ops import emission_kernel as ek
from ptx_torch.scenes import builders
from ptx_torch.shade.materials import Material

torch.set_num_threads(1)

_SHIM = r'''
#include <stdint.h>
#include "emission_lane.cuh"

extern "C" void lane_bins(const float* w, int mirror, int H, int W, const float* pos,
                          const int64_t* mid, int N, int dyn_mi, const int* const_row,
                          int* bin) {
  for (int i = 0; i < N; ++i) {
    const bool chain = mid[i] == dyn_mi;
    const int texel = chain ? ptx_emission::chain_texel(w, mirror, H, W, pos[3 * i],
                                                        pos[3 * i + 1], pos[3 * i + 2])
                            : -1;
    bin[i] = ptx_emission::lane_bin(chain, texel, H * W, const_row[mid[i]]);
  }
}
'''


def _mirror_world():
    probe = np.random.default_rng(7).uniform(0.0, 2.0, (16, 32, 4)).astype(np.float32)
    sky = builders.make_sky_mirror_sphere(probe, scale=(1.5, 1.0, 0.5))
    return builders.union_array([Sphere((0.0, 0.0, -4.0), 1.0,
                                        Material(reflect=0.8, scatter=1.0))]
                                + builders.sky_planes(sky))


WORLDS = {"demo": builders.make_world, "mirror-ball": _mirror_world}


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build K7's lane arithmetic")
    csrc = pathlib.Path(ek.__file__).resolve().parent.parent / "csrc"
    tmp = tmp_path_factory.mktemp("emission_lane")
    (tmp / "shim.cpp").write_text(_SHIM)
    so = tmp / "shim.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-ffp-contract=off",
                    f"-I{csrc}", "-o", str(so), str(tmp / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.lane_bins.argtypes = [vp, i, i, i, vp, vp, i, i, vp, vp]
    return lib


def _chain_dirs(kern, A, u, w):
    """Float64 positions whose chain coordinates (before the flip) are
    (u, w), at random distances (the map inverted)."""
    if kern.mirror:                  # nz = 1 − 2ρ², d = 2√(1 − ρ²)
        a, b = 2.0 * u - 1.0, 2.0 * w - 1.0
        rho2 = np.minimum(a * a + b * b, 1.0)
        dd = 2.0 * np.sqrt(1.0 - rho2)
        d = np.stack([a * dd, b * dd, 1.0 - 2.0 * rho2], -1)
    else:
        theta, phi = (u - 0.5) * 2.0 * np.pi, (w - 0.5) * np.pi
        d = np.stack([np.cos(phi) * np.cos(theta), np.cos(phi) * np.sin(theta),
                      np.sin(phi)], -1)
    d = d * np.random.default_rng(len(u)).uniform(2.0, 60.0, (len(u), 1))
    if A is not None:
        d = (np.linalg.inv(A[:, :3]) @ (d - A[:, 3]).T).T
    return d


def _positions(kern, A, H, W, seed):
    r = np.random.default_rng(seed)
    n = 4096
    rand = r.standard_normal((n, 3)) * r.uniform(0.1, 80.0, (n, 1))
    # texel corners and edges: u on multiples of 1/W, w of 1/H
    m = 1024
    cu = r.integers(0, W + 1, m) / W
    cw = r.integers(0, H + 1, m) / H
    if kern.mirror:                  # inside the ball's disc
        keep = (2 * cu - 1) ** 2 + (2 * cw - 1) ** 2 < 0.97
        cu, cw = cu[keep], cw[keep]
    corners = _chain_dirs(kern, A, cu, cw)
    special = np.array([[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                        [0, 0, 1], [0, 0, -1], [0, 0, 1e-30], [3, 0, 0], [0, -7, 0]],
                       np.float64)
    if A is not None:                # the same directions in chain space
        special = np.concatenate([special, (np.linalg.inv(A[:, :3]) @ (
            special[1:] * 5.0 - A[:, 3]).T).T])
    pos = np.concatenate([rand, corners, special]).astype(np.float32)
    return pos, len(special)


def _near_boundary(kern, A, pos, H, W, tol=1e-6):
    """Lanes whose float64 chain coordinates lie within ``tol`` of a texel
    boundary (either texel is right there)."""
    from ptx_torch.shade.textures import _mirror_ball_uv, _spherical_uv

    q = torch.from_numpy(pos.astype(np.float64))
    if A is not None:
        At = torch.from_numpy(A)
        q = q @ At[:, :3].T + At[:, 3]
    uv = (_mirror_ball_uv if kern.mirror else _spherical_uv)(q)
    x = (uv[:, 0] - torch.floor(uv[:, 0])) * W
    y = (1.0 - (uv[:, 1] - torch.floor(uv[:, 1]))) * H
    return (((x - torch.round(x)).abs() <= tol * W)
            | ((y - torch.round(y)).abs() <= tol * H)).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_lane_bins_match_the_plain_version(lane_lib, world, seed):
    scene = trace.compile_scene(WORLDS[world](), "cpu")
    assert ek.supported(scene.material_fn)
    kern = ek.EmissionKernel(scene.material_fn, "cpu")
    p = scene.params
    img = p["images"][kern.img_id]
    H, W = img.shape[0], img.shape[1]
    A = (p["tex_xform"][kern.xform_idx].numpy().astype(np.float64)
         if kern.xform_idx is not None else None)
    pos, n_special = _positions(kern, A, H, W, seed)
    N = pos.shape[0]
    r = np.random.default_rng(100 + seed)
    mid = np.where(r.uniform(size=N) < 0.8, kern.dyn_mi,
                   r.integers(0, scene.material_fn.n_materials, N)).astype(np.int64)
    mid[-n_special:] = kern.dyn_mi   # the special lanes are the chain's
    w = (np.ascontiguousarray(p["tex_xform"][kern.xform_idx].numpy().reshape(12))
         if kern.xform_idx is not None else None)
    rows = kern.const_rows.numpy().astype(np.int32)
    got = np.empty(N, np.int32)
    lane_lib.lane_bins(None if w is None else w.ctypes.data, int(kern.mirror), H, W,
                       pos.ctypes.data, mid.ctypes.data, N, kern.dyn_mi, rows.ctypes.data,
                       got.ctypes.data)
    want = ek.lanes_reference(kern, p["tex_xform"], p["const"], p["factor"], img,
                              torch.from_numpy(pos), torch.from_numpy(mid))[1].numpy()
    chain = mid == kern.dyn_mi
    near = _near_boundary(kern, A, pos, H, W) & chain
    far = ~near
    assert chain.sum() > N // 2 and (~chain).sum() > 100 and near.sum() > 100
    np.testing.assert_array_equal(got[far], want[far])
    # at a boundary: the same texel or a neighbour (x wraps around the seam)
    g, t = got[near], want[near]
    assert ((g >= 0) == (t >= 0)).all()
    gy, gx, ty, tx = g // W, g % W, t // W, t % W
    dx = np.minimum(np.abs(gx - tx), W - np.abs(gx - tx))
    assert (np.abs(gy - ty) <= 1).all() and (dx <= 1).all()
    # the zero vector and the axes are exact in both: equal bins
    np.testing.assert_array_equal(got[-n_special:], want[-n_special:])
