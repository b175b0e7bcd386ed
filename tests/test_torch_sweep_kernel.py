"""The sweep-select kernel K9's plain version against the JAX package's K9.

``ptx_torch.ops.sweep_kernel.sweep_select_reference`` (what the wrapper
runs on CPU tensors, and the union sweep's ``sort`` mode) against one
interpret-mode call of ``ptx.ops.sweep_kernel.build_sweep_select`` per
``sort`` flag, on identical numpy inputs from a seed: S = L = 40 leaf
intervals, B = 512 rays, with duplicated starts, touching intervals,
intervals that start behind the ray and missed leaves.  The arithmetic is
compares, selects, max and min, so all five outputs must be equal
exactly.  The CUDA kernel is held against the same plain version on the
card (tests/test_torch_kernel_cuda.py, chip_smoke.py path E).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ptx.ops.sweep_kernel import build_sweep_select
from ptx_torch.core.constants import EPS
from ptx_torch.ops import sweep_kernel

torch.set_num_threads(1)

S = L = 40
B = 512


def _inputs(seed=0):
    """(s, e, t0, t1): leaf intervals as the sweep pools its leaf groups,
    valid-masked, with ties."""
    r = np.random.default_rng(seed)
    t0 = r.uniform(-1.0, 6.0, (L, B)).astype(np.float32)
    t1 = (t0 + r.uniform(0.05, 2.0, (L, B))).astype(np.float32)
    t0[5:9] = t0[0:4]                        # duplicated starts
    t0[12:15] = t1[20:23]                    # touching intervals
    t1[30] = t1[31]                          # duplicated ends
    miss = r.uniform(size=(L, B)) < 0.25
    t0[miss], t1[miss] = 3e20, 3e20
    s, e = t0[:S].copy(), t1[:S].copy()
    valid = (s < e) & (e >= EPS)
    s = np.where(valid, s, np.float32(3e20)).astype(np.float32)
    e = np.where(valid, e, np.float32(-3e20)).astype(np.float32)
    return s, e, t0, t1


def _check_equal(got, want):
    names = ("t_star", "entering", "m_start", "m_end", "found")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (B,), name
        assert np.array_equal(g, w.astype(g.dtype)), (name, np.nonzero(g != w)[0][:8])


@pytest.mark.parametrize("sort", [False, True], ids=["presorted", "in-kernel-sort"])
def test_plain_version_matches_the_jax_kernel(sort):
    s, e, t0, t1 = _inputs()
    if not sort:                             # the kernel mode's call: sorted by s
        order = np.argsort(s, axis=0, kind="stable")
        s, e = np.take_along_axis(s, order, 0), np.take_along_axis(e, order, 0)
    want = build_sweep_select(S, L, float(EPS), interpret=True, sort=sort)(
        *(jnp.asarray(x) for x in (s, e, t0, t1)))
    got = sweep_kernel.sweep_select_reference(
        *(torch.from_numpy(x) for x in (s, e, t0, t1)), L, EPS, sort)
    _check_equal(got, want)
    t_star, entering, m_start, m_end, found = got
    # the inputs reach every branch: entries, exits, both payload kinds
    assert bool(found.all()) and 0 < int(entering.sum()) < B
    assert int((m_start < L).sum()) > 0 and int(((m_start == L) & (m_end < L)).sum()) > 0


def test_the_sort_flag_gives_the_same_answer():
    """Sorting outside and inside agree (the sweep's outputs do not depend
    on the order of equal starts), and the wrapper runs the plain version on
    CPU tensors, counting it, not a launch."""
    s, e, t0, t1 = (torch.from_numpy(x) for x in _inputs(seed=1))
    s_s, idx = torch.sort(s, dim=0, stable=True)
    calls, launches = sweep_kernel.REFERENCE_CALLS, sweep_kernel.LAUNCHES
    a = sweep_kernel.sweep_select(s_s, e.gather(0, idx), t0, t1, L, EPS)
    b = sweep_kernel.sweep_select(s, e, t0, t1, L, EPS, sort=True)
    assert sweep_kernel.REFERENCE_CALLS == calls + 2 and sweep_kernel.LAUNCHES == launches
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[0].dtype == torch.float32 and a[2].dtype == torch.int32
    assert a[1].dtype == a[4].dtype == torch.bool


def test_tile_and_row_sizing():
    """The sort=True kernel pads S to a power of 2 (at least 8; it sorts
    columns of at least 32) and takes the widest tile of up to 16 lanes
    whose (s, e) columns fit 72 KB, up to 1,024 rows (a warp's register
    sort); past that the wrapper raises.  The sort=False kernel takes 32,
    16 or 8 lanes a block by the width, and kernel mode sorts inside K9 up
    to ``SORT_INSIDE_ROWS`` padded rows."""
    assert [sweep_kernel.padded_rows(n) for n in (1, 8, 9, 256, 268)] == [8, 8, 16, 256, 512]
    assert [sweep_kernel.tile_width(n) for n in (8, 256, 512, 1024, 2048, 4096)] == \
        [16, 16, 16, 8, None, None]
    assert [sweep_kernel.lane_tile(b) for b in (1, 4096, 8448, 16895, 16896, 1 << 20)] == \
        [8, 8, 16, 16, 32, 32]
    limit = sweep_kernel.SORT_INSIDE_ROWS
    assert sweep_kernel.sort_inside(limit) and not sweep_kernel.sort_inside(limit + 1)


def test_wrapper_refuses_other_devices():
    s = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sweep_kernel.sweep_select(s, s, s, s, 4, EPS)
