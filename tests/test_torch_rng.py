"""ptx_torch.core.rng against jax.random: every draw bit for bit.

The port re-implements threefry2x32 (jax 0.9.0, partitionable layout);
keys, folds and float32 uniforms must be identical words, so the port
traces the same paths as the JAX package from the same seed.

On a card ``uniform_many`` is the rng kernel (``ptx_torch/ops/rng_kernel.py``).
Here, without one: its draw (``csrc/rng_lane.cuh``, built with the host
compiler) against the plain int64 route bit for bit, over a row at each
16-byte offset the kernel's threads may find and at counters past 2**32;
the wrapper's key packing and chunking against a stand-in for the C entry
point that fills its rows from the plain route; and the CPU route, which
launches nothing.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ptx.core import rng as jrng
from ptx_torch.core import rng
from ptx_torch.integrate.trace import _phase_uniforms
from ptx_torch.ops import rng_kernel
from ptx_torch.utils import profiling

torch.set_num_threads(1)


def _key_words(k):
    return tuple(int(x) for x in np.asarray(k))


def _same_bits(a, b):
    a = np.asarray(a, np.float32)
    b = b.numpy()
    assert a.shape == b.shape
    assert (a.view(np.uint32) == b.view(np.uint32)).all()


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 - 1, -1, -7])
def test_prngkey(seed):
    assert rng.PRNGKey(seed) == _key_words(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("data", [(0,), (7,), (1, 2, 3), (0x00C0, 2),
                                  (2 ** 32 - 1,), (16, 384, 1)])
def test_fold_chains(data):
    for seed in (0, 42):
        want = jrng.fold(jax.random.PRNGKey(seed), *data)
        assert rng.fold(rng.PRNGKey(seed), *data) == _key_words(want)


@pytest.mark.parametrize("shape", [(), (1,), (5,), (300,), (257, 3),
                                   (2, 12, 16, 2)])
def test_uniform_shapes(shape):
    """Scalars (the compaction phase offset), lanes (u_coin), lane
    triples (u3) and the camera jitter (spp, rows, W, 2)."""
    k = jrng.fold(jax.random.PRNGKey(3), 11)
    _same_bits(jax.random.uniform(k, shape),
               rng.uniform(rng.fold(rng.PRNGKey(3), 11), shape, "cpu"))


def test_phase_draw_pattern():
    """trace_rays's per-phase draws: vmap over fold(key, b) of uniforms
    keyed fold(kb, 1) (width,) and fold(kb, 2) (width, 3)."""
    key = jrng.fold(jax.random.PRNGKey(0), 0, 16)
    ks = jnp.stack([jrng.fold(key, b) for b in range(2, 6)])
    want_c = jax.vmap(lambda kb: jax.random.uniform(jrng.fold(kb, 1), (96,)))(ks)
    want_3 = jax.vmap(lambda kb: jax.random.uniform(jrng.fold(kb, 2), (96, 3)))(ks)

    got_c, got_3 = _phase_uniforms(rng.fold(rng.PRNGKey(0), 0, 16), 2, 6, 96,
                                   "cpu")
    _same_bits(want_c, got_c)
    _same_bits(want_3, got_3)


def test_compaction_phase_offset():
    """The scalar draw behind the systematic-resampling phase."""
    key = jax.random.PRNGKey(5)
    for pi in (1, 2):
        _same_bits(jax.random.uniform(jrng.fold(key, 0x00C0, pi), ()),
                   rng.uniform(rng.fold(rng.PRNGKey(5), 0x00C0, pi), (), "cpu"))


def test_threefry_known_answer():
    """The Threefry-2x32 (20 rounds) test vector of Salmon et al. 2011,
    which jax's own tests use: key = counter = 0."""
    assert rng.threefry2x32(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)


# keys with words at and past 2**31 beside folded ones
_HIGH = [(0xFFFFFFFF, 0x80000000), (0x80000000, 0), (0, 0xFFFFFFFF), (0x9E3779B9, 0xDEADBEEF)]


def _keys(n):
    return [_HIGH[q] if q < len(_HIGH) else rng.fold(rng.PRNGKey(7), q) for q in range(n)]


_LANE_SHIM = r'''
#include "rng_lane.cuh"

// The kernel's threads over one row of n draws that starts `head` floats
// past a 16-byte boundary (csrc/rng_kernel.cu: i0 = 4 t - head).
extern "C" void draw_row(uint32_t k1, uint32_t k2, int64_t n, int head, float* row) {
  using ptx_rng::kPerThread;
  for (int64_t t = 0; t < (n + 3) / kPerThread + 1; ++t) {
    const int64_t i0 = t * kPerThread - head;
    if (i0 >= n) continue;
    float r[kPerThread];
    ptx_rng::row_vector(k1, k2, n, i0, r);
    for (int e = 0; e < kPerThread; ++e)
      if (i0 + e >= 0 && i0 + e < n) row[i0 + e] = r[e];
  }
}

extern "C" float uniform_at(uint32_t k1, uint32_t k2, uint64_t i) {
  return ptx_rng::uniform_at(k1, k2, i);
}
'''


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the rng kernel's draw")
    csrc = pathlib.Path(rng_kernel.__file__).resolve().parent.parent / "csrc"
    tmp = tmp_path_factory.mktemp("rng_lane")
    (tmp / "shim.cpp").write_text(_LANE_SHIM)
    so = tmp / "shim.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{csrc}", "-o", str(so),
                    str(tmp / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    u32 = ctypes.c_uint32
    lib.draw_row.argtypes = [u32, u32, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.uniform_at.argtypes = [u32, u32, ctypes.c_uint64]
    lib.uniform_at.restype = ctypes.c_float
    return lib


@pytest.mark.parametrize("n", [1, 3, 4, 5, 65537])
def test_kernel_draw_matches_the_int64_route(lane_lib, n):
    """Every key's row, at each of the four offsets from a 16-byte boundary,
    written once and bit for bit the plain route's."""
    keys = _keys(6)
    want = rng.uniform_many_reference(keys, (n,), "cpu")
    for head in range(4):
        got = torch.full((len(keys), n), float("nan"))
        for q, (k1, k2) in enumerate(keys):
            lane_lib.draw_row(k1, k2, n, head, got[q].data_ptr())
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), head


def test_kernel_draw_at_counters_past_2_32(lane_lib):
    """The counter's high word: flat indices at and past 2**32 against
    threefry2x32 on Python ints."""
    for k1, k2 in _keys(6):
        for i in (2 ** 32 - 1, 2 ** 32, 2 ** 32 + 5, 3 * 2 ** 33 + 12345, 2 ** 63 - 1):
            b1, b2 = rng.threefry2x32(k1, k2, i >> 32, i & 0xFFFFFFFF)
            want = np.array([((b1 ^ b2) >> 9) | 0x3F800000], np.uint32).view(np.float32)[0] - 1
            got = np.float32(lane_lib.uniform_at(k1, k2, i))
            assert got.view(np.uint32) == np.float32(want).view(np.uint32), (k1, k2, i)


class _FakeLib:
    """A stand-in for the C entry point: reads its chunk's words as the C
    side does and fills the chunk's rows from the plain route."""

    def __init__(self):
        self.calls = []

    def ptx_uniform_many(self, keys, nkeys, n, out, block, stream):
        words = list(keys)
        assert len(words) == 2 * nkeys and 1 <= nkeys <= rng_kernel.CAPACITY
        rows = rng.uniform_many_reference(list(zip(words[0::2], words[1::2])), (n,), "cpu")
        ctypes.memmove(out, rows.data_ptr(), 4 * nkeys * n)
        self.calls.append((nkeys, n, out, block, stream))
        return 0


@pytest.mark.parametrize("nkeys,shape", [(1, ()), (2, (5,)), (11, (7, 3)),
                                         (64, (3,)), (65, (2, 3)), (130, (1,))])
def test_kernel_launches_pack_and_chunk_the_keys(monkeypatch, nkeys, shape):
    """One entry-point call a run of up to ``CAPACITY`` keys, each with its
    chunk's words and its first row's address: the rows equal the plain
    route's; each call counted in ``LAUNCHES`` and by the recorder."""
    monkeypatch.setattr(rng_kernel, "LAUNCHES", 0)
    keys = _keys(nkeys)
    n = int(np.prod(shape))
    out = torch.full((nkeys,) + shape, float("nan"))
    lib = _FakeLib()
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            rng_kernel.launch(lib, keys, n, out, "stream")
        counted = profiling.snapshot()["counters"]["rng_kernel_launches"]
    finally:
        profiling.reset()
    chunks = -(-nkeys // rng_kernel.CAPACITY)
    cap = rng_kernel.CAPACITY
    assert lib.calls == [(min(cap, nkeys - s), n, out.data_ptr() + 4 * s * n, rng_kernel.BLOCK,
                          "stream") for s in range(0, nkeys, cap)]
    assert rng_kernel.LAUNCHES == counted == chunks
    want = rng.uniform_many(keys, shape, "cpu")
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_cpu_route_launches_nothing(monkeypatch):
    """On the CPU every draw runs the plain route: the kernel's wrapper is
    never reached and ``LAUNCHES`` stays 0."""
    monkeypatch.setattr(rng_kernel, "LAUNCHES", 0)

    def no_kernel(*args):
        raise AssertionError("the CPU route reached the kernel's wrapper")
    monkeypatch.setattr(rng_kernel, "uniform_many", no_kernel)
    key = rng.PRNGKey(9)
    rng.uniform_many(_keys(3), (4, 3), "cpu")
    rng.uniform(key, (), torch.device("cpu"), minval=-1.0, maxval=2.0)
    rng.sample_square(key, (2, 3), "cpu")
    _phase_uniforms(key, 0, 2, 8, "cpu")
    assert rng_kernel.LAUNCHES == 0
    monkeypatch.undo()
    with pytest.raises(ValueError, match="no kernel for cpu"):
        rng_kernel.uniform_many(_keys(1), (3,), "cpu")
