"""ptx_torch.core.rng against jax.random: every draw bit for bit.

The port re-implements threefry2x32 (jax 0.9.0, partitionable layout);
keys, folds and float32 uniforms must be identical words, so the port
traces the same paths as the JAX package from the same seed.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.core import rng as jrng
from ptx_torch.core import rng

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

    from ptx_torch.integrate.trace import _phase_uniforms
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
