"""The segment arithmetic of the sweep-select kernel K9
(``ptx_torch/csrc/sweep_lane.cuh``, the exact source both of its CUDA
kernels include) built for the host with ``g++ -ffp-contract=off`` and held
bit for bit against K9's plain version ``sweep_select_reference``.

The shim composes the header's functions as ``csrc/sweep_kernel.cu`` does
across a block's threads: a lane's sorted rows in chunks, each chunk split
into g segments (segment maxima, the exclusive max-scan over the segments
from the prefix carried from the chunks before, the re-walk of each
segment, the minima combined over the segments), then the payload split
over the same g segments, strided, each folding its matches into the
lane's least and reading no row past the least known.  Only
compares, selects, max and min, so all five outputs must be equal exactly,
for every split: segment counts 1, 2, 8 and 32 (the kernels use 8, 16 and
32 at 256 threads a block), each split as the sort = 1 kernel sweeps a
column (``segment``, over all rows or chunks of 16) and as the sort = 0
kernel loads registers (``segment_max_regs`` / ``segment_sweep_regs``: g
segments of 16 rows a chunk, and of 4).

Inputs (numpy, seeded): random intervals; tie-heavy ones (starts on a grid
of quarters, duplicated starts, touching intervals, starts equal to the
running prefix); all rows invalid; S = 1; L > S; S not a multiple of g.
Skips only where there is no host C++ compiler.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ptx_torch.core.constants import EPS
from ptx_torch.ops import sweep_kernel

torch.set_num_threads(1)

B = 512
NAMES = ("t_star", "entering", "m_start", "m_end", "found")

_SHIM = r'''
#include <stdint.h>
#include <vector>
#include "sweep_lane.cuh"
using namespace ptx_sweep;

static float eps_;

// Segment y's rows [k0, k0 + R) of a lane (column b) in registers, padded
// past S, as the sort = 0 kernel loads them.
template <int R>
static void load(const float* s, const float* e, int S, int B, int b, int k0, float (&a)[R],
                 float (&c)[R]) {
  for (int j = 0; j < R; ++j) {
    const bool in = k0 + j < S;
    a[j] = in ? s[(size_t)(k0 + j) * B + b] : kPad;
    c[j] = in ? e[(size_t)(k0 + j) * B + b] : kNeg;
  }
}

// One chunk of g segments of R rows in registers (the sort = 0 kernel).
template <int R>
static void regs_chunk(const float* s, const float* e, int S, int B, int b, int c0, int g,
                       float* m, float* te, float* tx, float& P) {
  float total = P;
  for (int y = 0; y < g; ++y) {
    float a[R], c[R];
    load<R>(s, e, S, B, b, c0 + y * R, a, c);
    m[y] = segment_max_regs<R>(c);
    total = fmaxf(total, m[y]);
  }
  for (int y = 0; y < g; ++y) {
    float a[R], c[R];
    load<R>(s, e, S, B, b, c0 + y * R, a, c);
    float pin = P;
    for (int j = 0; j < y; ++j) pin = fmaxf(pin, m[j]);
    segment_sweep_regs<R>(a, c, pin, eps_, te[y], tx[y]);
  }
  P = total;
}

// regs = 0: chunks of `chunk` rows split by segment() and swept from
// memory (the sort = 1 kernel's columns); regs = R: chunks of g segments of
// R rows in registers (the sort = 0 kernel).
extern "C" void sweep_select(const float* s, const float* e, int S, const float* t0,
                             const float* t1, int L, int B, float eps, int g, int chunk,
                             int regs, float* t_star, uint8_t* entering, int* m_start,
                             int* m_end, uint8_t* found) {
  std::vector<float> m(g), te(g), tx(g);
  eps_ = eps;
  for (int b = 0; b < B; ++b) {
    float P = kNeg;
    for (int y = 0; y < g; ++y) te[y] = tx[y] = kPad;
    if (regs) {
      for (int c0 = 0; c0 < S; c0 += g * regs) {
        if (regs == 4) regs_chunk<4>(s, e, S, B, b, c0, g, m.data(), te.data(), tx.data(), P);
        else regs_chunk<16>(s, e, S, B, b, c0, g, m.data(), te.data(), tx.data(), P);
      }
    }
    for (int c0 = 0; !regs && c0 < S; c0 += chunk) {
      const int rows = S - c0 < chunk ? S - c0 : chunk;
      const float* sc = s + (size_t)c0 * B + b;
      const float* ec = e + (size_t)c0 * B + b;
      float total = P;
      for (int y = 0; y < g; ++y) {
        int k0, k1;
        segment(rows, g, y, k0, k1);
        m[y] = segment_max(ec, k0, k1, (size_t)B);
        total = fmaxf(total, m[y]);
      }
      for (int y = 0; y < g; ++y) {
        int k0, k1;
        segment(rows, g, y, k0, k1);
        float pin = P;
        for (int j = 0; j < y; ++j) pin = fmaxf(pin, m[j]);
        segment_sweep(sc, ec, k0, k1, (size_t)B, pin, eps, te[y], tx[y]);
      }
      P = total;
    }
    float te_all = kPad, tx_all = kPad;
    for (int y = 0; y < g; ++y) {
      te_all = fminf(te_all, te[y]);
      tx_all = fminf(tx_all, tx[y]);
    }
    float ts;
    bool ent, fo;
    finish(te_all, tx_all, P, eps, ts, ent, fo);
    int ms = L, me = L;
    for (int y = 0; y < g; ++y) payload_first(t0 + b, t1 + b, y, g, L, (size_t)B, ts, &ms, &me);
    t_star[b] = ts;
    entering[b] = ent;
    m_start[b] = ms;
    m_end[b] = me;
    found[b] = fo;
  }
}
'''


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the sweep's segment arithmetic")
    csrc = pathlib.Path(sweep_kernel.__file__).resolve().parent.parent / "csrc"
    tmp = tmp_path_factory.mktemp("sweep_lane")
    (tmp / "shim.cpp").write_text(_SHIM)
    so = tmp / "shim.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-ffp-contract=off",
                    f"-I{csrc}", "-o", str(so), str(tmp / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.sweep_select.argtypes = [vp, vp, i, vp, vp, i, i, ctypes.c_float, i, i, i] + [vp] * 5
    return lib


def _inputs(case, S, L, seed):
    """(s, e, t0, t1) as numpy float32: the valid-masked pooled intervals
    (the first S leaf rows) and the raw leaf intervals."""
    r = np.random.default_rng(seed)
    ahead = (np.arange(B) % 2 == 1).astype(np.float32)       # odd lanes: an entry
    t0 = (r.uniform(0, 1, (L, B)) * (7.0 - 5.5 * ahead) - 1.0 + 2.5 * ahead).astype(np.float32)
    t1 = (t0 + r.uniform(0.05, 2.0, (L, B))).astype(np.float32)
    if case == "ties":
        t0 = np.round(t0 * 4.0) / 4.0
        t1 = t0 + np.round(r.uniform(0, 8, (L, B))) / 4.0 + 0.25
        t0[1::3] = t0[0::3][:len(t0[1::3])]                  # duplicated starts
        t0[2::5] = t1[:len(t0[2::5])]                        # touching: s == an earlier e
        t1[2::5] = t0[2::5] + 0.5
        t0, t1 = t0.astype(np.float32), t1.astype(np.float32)
    miss = r.uniform(size=(L, B)) < (1.0 if case == "invalid" else 0.25)
    t0[miss], t1[miss] = 3e20, 3e20
    s, e = t0[:S].copy(), t1[:S].copy()
    valid = (s < e) & (e >= EPS)
    s = np.where(valid, s, np.float32(3e20)).astype(np.float32)
    e = np.where(valid, e, np.float32(-3e20)).astype(np.float32)
    order = np.argsort(s, axis=0, kind="stable")                 # the kernels' input order
    s, e = np.take_along_axis(s, order, 0), np.take_along_axis(e, order, 0)
    return (np.ascontiguousarray(x, np.float32) for x in (s, e, t0, t1))


def _host(lib, s, e, t0, t1, g, chunk, regs):
    S, L = s.shape[0], t0.shape[0]
    out = (np.zeros(B, np.float32), np.zeros(B, np.uint8), np.zeros(B, np.int32),
           np.zeros(B, np.int32), np.zeros(B, np.uint8))
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.sweep_select(p(s), p(e), S, p(t0), p(t1), L, B, float(EPS), g, chunk, regs,
                     *(p(a) for a in out))
    return [torch.from_numpy(a.astype(bool) if a.dtype == np.uint8 else a) for a in out]


# (case, S, L): every case at each segment count and chunking
_CASES = [("random", 64, 64), ("ties", 64, 64), ("invalid", 40, 40), ("random", 1, 5),
          ("random", 10, 40), ("ties", 37, 37)]


# (chunk rows, register rows a segment): the sort = 1 kernel's split of one
# column, and of chunks of 16; the sort = 0 kernel's register segments of 16
# rows, and of 4 (several chunks at these S)
_LAYOUTS = {"columns": (0, 0), "columns-chunks-of-16": (16, 0), "registers-16": (0, 16),
            "registers-4": (0, 4)}


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
@pytest.mark.parametrize("g", [1, 2, 8, 32])
@pytest.mark.parametrize("case,S,L", _CASES,
                         ids=["random", "tie-heavy", "all-invalid", "S=1", "L>S", "S=37"])
def test_segment_sweep_matches_the_plain_version(lane_lib, case, S, L, g, layout):
    s, e, t0, t1 = _inputs(case, S, L, seed=S + 7 * L)
    chunk, regs = _LAYOUTS[layout]
    got = _host(lane_lib, s, e, t0, t1, g, chunk or S, regs)
    want = sweep_kernel.sweep_select_reference(*(torch.from_numpy(x) for x in (s, e, t0, t1)),
                                               L, EPS, sort=False)
    for name, a, w in zip(NAMES, got, want):
        assert a.dtype == w.dtype and torch.equal(a, w), (name, torch.nonzero(a != w)[:8])
    if case == "invalid":
        assert not bool(want[4].any())
    elif S > 1:
        assert 0 < int(want[1].sum()) < B and int((want[2] < L).sum()) > 0
