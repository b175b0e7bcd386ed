"""The port's span algebra (``ptx_torch.geom.spans``, ``primitives``, the
tape's ``span_evaluator``) and ``spans.first_hit`` against the JAX
package's, on the CPU.

- union (n-ary), intersection and difference on seeded span lists whose
  events collide: times drawn from a small grid that holds both ``-0.0``
  and ``0.0``, touching and zero-length spans, invalid slots with a time
  and padded slots (``PAD_T``): every field equal bit for bit, which holds
  only if the port's two stable sorts order equal keys as ``lax.sort``
  does (it maps ``-0.0`` to ``0.0`` in its keys);
- ``transform_normals`` and the primitives on random rays: within
  ``rtol 1e-6, atol 1e-6`` (float32 sums in another order), the masks
  equal;
- ``spans_fn`` and ``first_hit`` on BASELINE configs 1-4: decisions equal
  and floats within ``rtol 1e-5, atol 1e-5`` except where some span
  boundary lies within 1e-4 of the ``EPS`` or ``MAX_VALUE`` thresholds;
- ``first_hit(spans_fn)`` against the port's fast hit, as
  ``tests/test_fasthit.py`` holds the JAX pair (``compare_paths``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.geom import primitives as jprim
from ptx.geom import spans as jspans
from ptx.integrate import trace as jtr
from ptx.scenes import builders as jb
from ptx_torch.convert import scene_from_jax
from ptx_torch.geom import primitives, spans
from ptx_torch.integrate import trace

torch.set_num_threads(1)
GRID = np.array([-2.0, -0.0, 0.0, 0.5, 1.0, 1.0, 2.0, 3.0], np.float32)


def _random_list(rng, n, k):
    """A (n, k) span list with colliding events, as numpy arrays."""
    t = np.sort(rng.choice(GRID, (n, 2 * k)), axis=-1)
    # sort keeps -0.0 / 0.0 in draw order: both signs reach t0 and t1
    valid = rng.uniform(size=(n, k)) < 0.75
    t0, t1 = t[:, 0::2].copy(), t[:, 1::2].copy()
    pad = ~valid & (rng.uniform(size=(n, k)) < 0.5)
    t0[pad] = t1[pad] = spans.PAD_T
    nrm = lambda: rng.normal(size=(n, k, 3)).astype(np.float32)
    mat = lambda: rng.integers(0, 6, (n, k)).astype(np.int32)
    return dict(t0=t0, n0=nrm(), m0=mat(), t1=t1, n1=nrm(), m1=mat(), valid=valid)


def _pair(d):
    j = jspans.SpanList(**{k: jnp.asarray(v) for k, v in d.items()})
    t = spans.SpanList(**{k: torch.from_numpy(v.astype(np.int64) if k in ("m0", "m1") else v)
                          for k, v in d.items()})
    return j, t


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x.astype(np.int64)


def _assert_same(got, want):
    for name in spans.SpanList._fields:
        np.testing.assert_array_equal(_bits(getattr(got, name).numpy()),
                                      _bits(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("op", ["union2", "union3", "intersection2", "intersection3",
                                "difference"])
def test_merge_matches_jax_bit_for_bit(seed, op):
    rng = np.random.default_rng(seed)
    n_ops = int(op[-1]) if op[-1].isdigit() else 2
    lists = [_pair(_random_list(rng, 64, k)) for k in (2, 3, 1)[:n_ops]]
    jl, tl = [p[0] for p in lists], [p[1] for p in lists]
    name = op.rstrip("23")
    got, want = getattr(spans, name)(*tl), getattr(jspans, name)(*jl)
    _assert_same(got, want)
    assert got.valid.any() and (~got.valid).any()


def test_merge_sees_both_zeros_and_ties():
    """The grid's edge cases reach the merge: signed zeros in valid slots,
    and events of two operands at one time."""
    d = _random_list(np.random.default_rng(0), 64, 3)
    zero = (d["t0"] == 0) & d["valid"]
    assert (zero & np.signbit(d["t0"])).any() and (zero & ~np.signbit(d["t0"])).any()
    a, b = _pair(d), _pair(_random_list(np.random.default_rng(1), 64, 3))
    _assert_same(spans.union(a[1], b[1]), jspans.union(a[0], b[0]))


def test_transform_normals_and_primitives_match_jax():
    rng = np.random.default_rng(3)
    o = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d[:8] = 0.0                                    # degenerate rays
    d[8:16] = [1.0, 0.0, 0.0]                      # parallel to the planes below
    m = rng.normal(size=(3, 3)).astype(np.float32)
    c, r = np.float32([0.3, -0.2, 0.5]), np.float32(1.1)
    pn, pd = np.float32([0.0, 0.0, 2.0]), np.float32(-0.5)
    T = torch.as_tensor
    cases = [
        (primitives.sphere_spans(T(o), T(d), T(c), T(r), 2),
         jprim.sphere_spans(jnp.asarray(o), jnp.asarray(d), c, r, 2)),
        (primitives.plane_spans(T(o), T(d), T(pn), T(pd), 1),
         jprim.plane_spans(jnp.asarray(o), jnp.asarray(d), pn, pd, 1)),
    ]
    cases.append((spans.transform_normals(cases[0][0], T(m)),
                  jspans.transform_normals(cases[0][1], jnp.asarray(m))))
    for got, want in cases:
        for name in spans.SpanList._fields:
            g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            if g.dtype == np.float32:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)
        assert got.valid.any() and (~got.valid).any()


CONFIGS = {f"config{i}": getattr(jb, f"baseline_config{i}") for i in range(1, 5)}


def _rays(n=512, seed=0):
    rng = np.random.default_rng(seed)
    d = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), -np.ones(n)], -1)
    o = rng.uniform(-0.5, 0.5, (n, 3))
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    root = CONFIGS[request.param]()
    return (jtr.compile_scene(root, pallas=False),
            trace.compile_scene(scene_from_jax(root), "cpu"))


def test_spans_fn_and_first_hit_match_jax(pair):
    js, ts = pair
    o, d = _rays()
    jsl = jax.jit(js.spans_fn)(js.params, jnp.asarray(o), jnp.asarray(d))
    tsl = ts.spans_fn(ts.params, torch.from_numpy(o), torch.from_numpy(d))
    bounds = np.concatenate([np.asarray(jsl.t0), np.asarray(jsl.t1)], -1)
    near = lambda x: np.abs(x - np.float32(1e-3)) < 1e-4
    unstable = (near(bounds) | near(np.abs(bounds) / 1e20)).any(-1)
    for name in spans.SpanList._fields:
        g, w = getattr(tsl, name).numpy(), np.asarray(getattr(jsl, name))
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    got = spans.first_hit(tsl)
    want = jax.tree.map(np.asarray, jtr.first_hit(jsl))
    for k in ("hit", "entering", "mat_id"):
        np.testing.assert_array_equal(got[k].numpy()[~unstable], want[k][~unstable], err_msg=k)
    for k in ("t", "normal"):
        np.testing.assert_allclose(got[k].numpy()[~unstable], want[k][~unstable], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert got["hit"].any() and got["t"].dtype == torch.float32


def test_first_hit_of_spans_agrees_with_the_fast_hit(pair):
    """``tests/test_fasthit.py::compare_paths`` on the port's pair."""
    _, ts = pair
    o, d = (torch.from_numpy(x) for x in _rays(seed=1))
    fast = {k: v.numpy() for k, v in ts.plain_hit_fn(ts.params, o, d).items()}
    slow = {k: v.numpy() for k, v in spans.first_hit(ts.spans_fn(ts.params, o, d)).items()}
    agree = fast["hit"] == slow["hit"]
    assert agree.mean() > 0.98
    both = fast["hit"] & slow["hit"]
    close_t = np.abs(fast["t"][both] - slow["t"][both]) < 2e-3 * (1.0 + np.abs(slow["t"][both]))
    assert close_t.mean() > 0.98
    stable = both & (np.abs(fast["t"] - slow["t"]) < 1e-5)
    assert stable.any()
    np.testing.assert_array_equal(fast["mat_id"][stable], slow["mat_id"][stable])
    np.testing.assert_array_equal(fast["entering"][stable], slow["entering"][stable])
    np.testing.assert_allclose(fast["normal"][stable], slow["normal"][stable], atol=1e-4)


def test_coincident_boundary_payload_follows_each_path():
    """The demo's two spheres of one centre and radius (materials 0 and 2):
    the span merge takes the payload of the first operand's event among
    equal times, the fast hit the leaf order's (the deeper leaf), in the
    JAX package as in the port."""
    root = jb.make_world()
    js = jtr.compile_scene(root, pallas=False)
    ts = trace.compile_scene(scene_from_jax(root), "cpu")
    rng = np.random.default_rng(4)
    # random rays about the bulb (centre (1, 0, -4)), inside and outside it
    o = (np.float32([1.0, 0.0, -4.0])
         + rng.uniform(-1.2, 1.2, (4096, 3))).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    jo, jd, to, td = jnp.asarray(o), jnp.asarray(d), torch.from_numpy(o), torch.from_numpy(d)
    j_spans = np.asarray(jtr.first_hit(js.spans_fn(js.params, jo, jd))["mat_id"])
    j_fast = np.asarray(js.hit_fn(js.params, jo, jd)["mat_id"])
    t_spans = spans.first_hit(ts.spans_fn(ts.params, to, td))["mat_id"].numpy()
    t_fast = ts.plain_hit_fn(ts.params, to, td)["mat_id"].numpy()
    np.testing.assert_array_equal(t_spans, j_spans)
    np.testing.assert_array_equal(t_fast, j_fast)
    differ = j_spans != j_fast
    assert differ.sum() >= 10            # 20 of these 4,096 rays
    assert (j_spans[differ] == 0).all() and (j_fast[differ] == 2).all()
