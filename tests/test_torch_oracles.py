"""The port's copies of the JAX package's small oracles and helpers against
the JAX package:

- ``ReferenceLCG`` / ``lcg_stream`` (the reference's own generator) bit
  for bit against JAX's and against a big-int transcription;
- ``split`` / ``pixel_keys`` bit for bit against ``jax.random.split``,
  ``uniform(minval=, maxval=)`` bit for bit against ``jax.random.uniform``
  where the span is a power of two (within one ulp elsewhere);
- ``normal`` within ``rtol 1e-5, atol 1e-6`` of ``jax.random.normal`` (the
  same uniform bits; ``torch.erfinv`` is not XLA's polynomial: at most
  5.7e-6 relative over 100,000 draws, in the tails) and
  ``sample_unit_ball`` within ``atol 1e-5``, plus its moments;
- ``select_scatter_dir`` on ``ReferenceLCG`` streams: the same accepted
  draw as JAX's, the direction within ``rtol 1e-6``;
  ``sample_scatter_dir_rejection`` on the same key as JAX's, and against
  the exact sampler ``sample_scatter_dir`` in distribution
  (tests/test_integrator.py's moments);
- ``make_lens_pointed_at``, ``vec3``, ``cross``, ``identity_affine``,
  ``determinant``, ``spans.empty``; ``profiling.timed``.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.core import linalg as jlinalg
from ptx.core import rng as jrng
from ptx.geom import spans as jspans
from ptx.integrate import trace as jtr
from ptx.scenes import builders as jbuilders
from ptx.shade.materials import Material as JMaterial
from ptx_torch.core import linalg, rng
from ptx_torch.core.constants import EPS
from ptx_torch.geom import spans
from ptx_torch.integrate import trace
from ptx_torch.scenes import builders
from ptx_torch.shade import bounce
from ptx_torch.shade.materials import Material
from ptx_torch.utils import profiling

torch.set_num_threads(1)
SEEDS = (0, 1, 0xDEADBEEF)


def _lcg_bigint(seed, count):
    v = (seed ^ 0x12476242) & 0xFFFFFFFFFFFFFFFF
    out = []
    for _ in range(count):
        v = (214013 * v + 2531011) & 0xFFFFFFFFFFFFFFFF
        out.append(v >> 32)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_lcg_matches_jax_and_bigint(seed):
    want = _lcg_bigint(seed, 64)
    eng, jeng = rng.ReferenceLCG(seed), jrng.ReferenceLCG(seed)
    assert [eng() for _ in range(64)] == want == [jeng() for _ in range(64)]
    np.testing.assert_array_equal(rng.lcg_stream(seed, 64), np.array(want, np.uint32))
    np.testing.assert_array_equal(rng.lcg_stream(seed, 64), jrng.lcg_stream(seed, 64))
    eng.discard(5)
    jeng.discard(5)
    assert [eng.uniform(-1.0, 1.0) for _ in range(32)] == \
        [jeng.uniform(-1.0, 1.0) for _ in range(32)]


@pytest.mark.parametrize("n", [1, 2, 7, 1000])
def test_split_and_pixel_keys_match_jax(n):
    for seed in (0, 12345, -7):
        key, jkey = rng.PRNGKey(seed), jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.split(jkey, n)).astype(np.int64)
        assert rng.split(key, n) == [tuple(r) for r in want.tolist()]
        np.testing.assert_array_equal(rng.pixel_keys(key, n, "cpu").numpy(), want)
        np.testing.assert_array_equal(rng.pixel_keys(key, n, "cpu").numpy(),
                                      np.asarray(jrng.pixel_keys(jkey, n)))
        # the i-th key of a split is the i-th fold
        assert rng.split(key, n)[n - 1] == rng.fold(key, n - 1)


def test_uniform_range_matches_jax():
    """Bit for bit where ``maxval - minval`` is a power of two (the scaling
    is exact: the rejection sampler's [-1, 1), ``normal``'s (-1, 1));
    elsewhere XLA on the CPU fuses the scaling into one multiply-add, one
    rounding fewer, so a draw may sit one ulp apart."""
    key, jkey = rng.fold(rng.PRNGKey(3), 9), jax.random.fold_in(jax.random.PRNGKey(3), 9)
    draw = lambda lo, hi: (rng.uniform(key, (517, 3), "cpu", minval=lo, maxval=hi).numpy(),
                           np.asarray(jax.random.uniform(jkey, (517, 3), minval=lo,
                                                         maxval=hi)))
    for lo, hi in ((-1.0, 1.0), (0.25, 2.25), (0.0, 1.0)):
        np.testing.assert_array_equal(*draw(lo, hi))
    np.testing.assert_allclose(*draw(0.25, 3.5), rtol=2.4e-7, atol=0)


def test_normal_matches_jax():
    key, jkey = rng.PRNGKey(456789), jax.random.PRNGKey(456789)
    got = rng.normal(key, (20000,), "cpu").numpy()
    want = np.asarray(jax.random.normal(jkey, (20000,)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert abs(got.mean()) < 0.03 and abs(got.std() - 1.0) < 0.03


def test_sample_unit_ball_matches_jax_and_its_moments():
    key, jkey = rng.PRNGKey(0), jax.random.PRNGKey(0)
    v = rng.sample_unit_ball(key, (20000,), "cpu").numpy()
    np.testing.assert_allclose(v, np.asarray(jrng.sample_unit_ball(jkey, (20000,))),
                               rtol=0, atol=1e-5)
    r = np.linalg.norm(v, axis=-1)
    assert r.max() <= 1.0 + 1e-6
    np.testing.assert_allclose(v.mean(axis=0), 0.0, atol=0.02)
    np.testing.assert_allclose((r ** 2).mean(), 0.6, atol=0.02)
    np.testing.assert_allclose(np.sort(r ** 3)[10000], 0.5, atol=0.03)


def _lcg_candidates(lcg, d, n, sc, tries):
    """The reference's cube draws (``Vector3D::rand``) from one LCG stream
    until the first one in the ball and above the surface, padded with
    draws outside the ball (tests/test_rng.py's transcription)."""
    reflected = d - 2 * np.dot(d, n) * n
    draws = []
    while len(draws) < tries:
        v = np.array([lcg.uniform(-1, 1) for _ in range(3)], np.float32)
        draws.append(v)
        if np.sum(v * v) <= 1.0 and np.dot(n, v + np.float32(1.0 / sc - 1.0) * reflected) > EPS:
            break
    u = np.full((tries, 3), 2.0, np.float32)
    u[:len(draws)] = np.stack(draws)
    return u


def test_select_scatter_dir_on_lcg_streams_matches_jax():
    g = np.random.default_rng(7)
    T = 64
    rows = []
    for case in range(40):
        d = g.normal(size=3).astype(np.float32)
        d /= np.linalg.norm(d)
        n = g.normal(size=3).astype(np.float32)
        n /= np.linalg.norm(n)
        if np.dot(d, n) > -0.05:
            n = -np.sign(np.dot(d, n)) * n
        sc = np.float32(g.uniform(0.05, 1.0))
        rows.append((_lcg_candidates(rng.ReferenceLCG(1234 + case), d, n, sc, T), d, n, sc))
    u, d, n, sc = (np.stack(x) for x in zip(*rows))
    want, ok_j, raw_j = (np.asarray(x) for x in jtr.select_scatter_dir(
        jnp.asarray(u), jnp.asarray(d), jnp.asarray(n), jnp.asarray(sc), return_raw=True))
    got, ok_t, raw_t = (x.numpy() for x in bounce.select_scatter_dir(
        *(torch.from_numpy(x) for x in (u, d, n, sc)), return_raw=True))
    assert ok_j.sum() >= 30
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(raw_t, raw_j)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_rejection_sampler_draws_as_jax_does():
    g = np.random.default_rng(1)
    d = g.normal(size=(512, 3)).astype(np.float32)
    n = g.normal(size=(512, 3)).astype(np.float32)
    sc = g.uniform(0.0, 1.0, 512).astype(np.float32)
    sc[:16] = 0.0                                   # specular lanes
    key, jkey = rng.PRNGKey(11), jax.random.PRNGKey(11)
    got, ok_t, raw_t = (x.numpy() for x in bounce.sample_scatter_dir_rejection(
        key, *(torch.from_numpy(x) for x in (d, n, sc)), return_raw=True))
    want, ok_j, raw_j = (np.asarray(x) for x in jtr.sample_scatter_dir_rejection(
        jkey, jnp.asarray(d), jnp.asarray(n), jnp.asarray(sc), return_raw=True))
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(raw_t, raw_j)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


CASES = [
    ([0.0, 0.0, -1.0], [0.0, 0.0, 1.0], 1.0),        # fully diffuse
    ([0.0, 0.0, -1.0], [0.0, 0.0, 1.0], 0.55),       # biased
    ([0.6, -0.4, -0.69], [0.1, 0.2, 0.97], 0.85),    # oblique
    ([0.6, -0.4, -0.69], [0.0, 0.0, -1.0], 0.7),     # down normal (frame)
    ([1.0, 0.0, -0.05], [0.0, 0.0, 1.0], 0.95),      # grazing
    ([0.0, 0.0, -1.0], [0.0, 0.0, 1.0], 0.12),       # strong bias, small cap
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_rejection_sampler_matches_the_exact_sampler(case):
    """tests/test_integrator.py's moments (its limits; 32,768 draws each,
    a component's Monte-Carlo error ~0.0055)."""
    N = 32768
    d, n, sc = CASES[case]
    d = torch.tensor(d, dtype=torch.float32).expand(N, 3)
    n = torch.tensor(np.asarray(n) / np.linalg.norm(n), dtype=torch.float32).expand(N, 3)
    s = torch.full((N,), sc)
    da, oka, _ = bounce.sample_scatter_dir(d, n, s, rng.uniform(rng.PRNGKey(100 + case),
                                                               (N, 3), "cpu"))
    db, okb = bounce.sample_scatter_dir_rejection(rng.PRNGKey(200 + case), d, n, s)
    assert bool(oka.all()) and float(okb.float().mean()) > 0.99
    da, db = da[oka].numpy(), db[okb].numpy()
    np.testing.assert_allclose(da.mean(0), db.mean(0), atol=0.02)
    np.testing.assert_allclose(da.T @ da / len(da), db.T @ db / len(db), atol=0.02)
    assert (np.einsum("ij,ij->i", da, n.numpy()[:len(da)]) > 0).all()


def test_rejection_sampler_abandons_an_empty_cap():
    d = torch.tensor([0.0, 0.0, 1.0]).expand(64, 3)
    _, ok = bounce.sample_scatter_dir_rejection(rng.PRNGKey(1), d, d, torch.full((64,), 0.4))
    assert not bool(ok.any())


def test_make_lens_pointed_at_matches_jax():
    args = ((0.5, -1.0, 2.0), (3.0, 1.0, -4.0), 0.8, 0.6)
    got = builders.make_lens_pointed_at(*args, Material(ior=1.5))
    want = jbuilders.make_lens_pointed_at(*args, JMaterial(ior=1.5))
    for a, b in zip(got.objects, want.objects):
        np.testing.assert_array_equal(np.asarray(a.center), np.asarray(b.center))
        assert np.float32(a.radius) == np.float32(b.radius)
    with pytest.raises(AssertionError):
        builders.make_lens_pointed_at(*args, Material(ior=1.0))


def test_linalg_helpers_match_jax():
    g = np.random.default_rng(5)
    a, b = g.normal(size=(7, 3)).astype(np.float32), g.normal(size=(3,)).astype(np.float32)
    np.testing.assert_array_equal(linalg.vec3(a[:, 0], 2.0, b[2]).numpy(),
                                  np.asarray(jlinalg.vec3(a[:, 0], 2.0, b[2])))
    np.testing.assert_allclose(linalg.cross(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jlinalg.cross(a, b)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(linalg.identity_affine().numpy(),
                                  np.asarray(jlinalg.identity_affine()))
    A = g.normal(size=(5, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(linalg.determinant(torch.from_numpy(A)).numpy(),
                               np.asarray(jlinalg.determinant(A)), rtol=1e-5, atol=1e-6)


def test_empty_span_list_matches_jax():
    got, want = spans.empty((4, 3), 2), jspans.empty((4, 3), 2)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape and a.dtype.is_floating_point == (b.dtype.kind == "f")
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.capacity == 2


def test_timed_logs_its_seconds(capsys):
    with profiling.timed("block") as rec:
        sum(range(1000))
    rec_line = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert rec_line["event"] == "timed" and rec_line["label"] == "block"
    assert rec["seconds"] >= 0 and rec_line["seconds"] == round(rec["seconds"], 4)
