"""The megasweep K5's plain side: the port's union-sweep first hit
(``megasweep_reference``, which K5's wrappers run on CPU tensors) against
the JAX package's sweep (``compile_fast_hit(..., sweep=True)``: the
fixpoint mode, with the local-fold gadget path), and the bounce mode
against one interpret-mode call of the JAX K5 (``build_mega_sweep(...,
bounce_meta=...)``).

Same scene, params and rays: the winning event, hit, entering and
material must be equal except on lanes a float64 recompute puts at a
near-tie (two boundaries within 1e-5 relative, or one at EPS): XLA on the
CPU contracts multiply-adds and computes plane boundaries as a matrix
product, PyTorch does neither.  ``t`` and the normal agree within ``rtol
1e-5, atol 5e-6`` elsewhere, or within twice the JAX value's error
against a float64 recompute (as tests/test_torch_hitkernel.py), or, on
near-grazing lanes where the JAX value is itself off that recompute
beyond the tolerance, within 1e-4 of it, or within 16 times the float64
value's change under a last-ulp change of the ray (a near-grazing sphere
boundary is ill-conditioned, and XLA's fused multiply-adds round it
otherwise).  Culling must not change any output.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.geom import fasthit as jfast
from ptx.integrate import trace as jtr
from ptx.ops import megasweep as jmega
from ptx.scenes import builders as jbuilders
from ptx_torch.convert import params_from_jax, scene_from_jax
from ptx_torch.core import rng
from ptx_torch.core.constants import EPS, MAX_VALUE
from ptx_torch.geom import fasthit
from ptx_torch.integrate import trace
from ptx_torch.integrate.camera import Camera, sample_rays
from ptx_torch.ops import megasweep

torch.set_num_threads(1)

TIE_REL = 1e-5
SCENES = {
    "spheres25": lambda: jbuilders.stress_spheres(25),
    "gadgets12": lambda: jbuilders.stress_gadgets(12, seed=4),
    "ellipsoids16": lambda: jbuilders.stress_spheres(16, seed=7, transformed=True),
}


def pair_for(name):
    root = SCENES[name]()
    js = jtr.compile_scene(root, pallas=False)
    ts = trace.compile_scene(scene_from_jax(root), "cpu")
    ts.params = params_from_jax(jax.tree.map(np.asarray, js.params), "cpu")
    return js, ts


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    return (request.param, *pair_for(request.param))


def frame_rays(ts, n_inside=256, seed=0):
    """Every pixel of a 64×32 frame of the demo camera (2,048 rays), then
    ``n_inside`` rays started inside spheres (gadget members included) in
    random directions."""
    o, d = sample_rays(Camera.reference_demo(64, 32), rng.PRNGKey(seed), range(32),
                       range(64), 1, "cpu")
    r = np.random.default_rng(seed)
    c = ts.params["sphere_center"].numpy()
    rad = ts.params["sphere_radius"].numpy()
    pick = r.integers(0, len(c), n_inside)
    oi = c[pick] + 0.3 * rad[pick, None] * r.uniform(-1, 1, (n_inside, 3))
    di = r.normal(size=(n_inside, 3))
    return (torch.cat([o.reshape(-1, 3), torch.from_numpy(oi.astype(np.float32))]),
            torch.cat([d.reshape(-1, 3), torch.from_numpy(di.astype(np.float32))]))


def f64(params):
    return {k: ([x.double() for x in v] if isinstance(v, list) else v.double())
            for k, v in params.items()}


def winner_tied(ts, o, d, evts, lanes):
    """Per lane of ``lanes``: whether any of the events ``evts`` sits, in
    float64, within ``TIE_REL·max(1, |t|)`` of EPS or of another finite
    boundary of the scene."""
    lanes = torch.as_tensor(lanes, dtype=torch.int64)
    if lanes.numel() == 0:
        return torch.zeros(0, dtype=torch.bool)
    o64, d64 = o[lanes].double(), d[lanes].double()
    t0, t1, _, _ = fasthit._leaf_intervals(fasthit.collect_leaves(ts.plan), f64(ts.params),
                                           *o64.unbind(-1), *d64.unbind(-1))
    t_evt = torch.cat([t0, t1])
    idx = torch.arange(lanes.numel())
    ok = torch.zeros(lanes.numel(), dtype=torch.bool)
    for evt in evts:
        te = t_evt[torch.as_tensor(evt)[lanes].long(), idx]
        tol = TIE_REL * torch.clamp(te.abs(), min=1.0)
        gap = (t_evt - te[None]).abs()
        near = (gap > 0) & (gap <= tol) & (t_evt.abs() < MAX_VALUE)
        ok |= (te.abs() < MAX_VALUE) & (near.any(0) | ((te - EPS).abs() <= tol))
    return ok


def compare_hits(ts, o, d, got, want, keys=("_evt", "hit", "entering", "mat_id"),
                 floats=("t", "normal")):
    """``got`` (torch) vs ``want`` (numpy): decisions equal but for
    adjudicated near-ties; ``t`` / normal within tolerance elsewhere.
    Returns the number of adjudicated lanes."""
    differ = np.zeros(o.shape[0], bool)
    for k in keys:
        differ |= got[k].numpy() != np.asarray(want[k])
    lanes = np.nonzero(differ)[0]
    ok = winner_tied(ts, o, d, (got["_evt"].numpy(), np.asarray(want["_evt"])), lanes)
    assert bool(ok.all()), f"unexplained flips at lanes {lanes[~ok.numpy()][:8]}"
    keep = ~differ
    hit = keep & np.asarray(want["hit"])
    truth = port_sweep(ts)(f64(ts.params), o.double(), d.double())
    for k, m in (("t", keep), ("normal", hit)):
        if k not in floats:
            continue
        g, w, t = (np.asarray(x, np.float64)[m] for x in (got[k], want[k], truth[k]))
        off = ~np.isclose(g, w, rtol=1e-5, atol=5e-6)
        worse = np.abs(g - t) > 2.0 * np.abs(w - t) + 5e-6 + 1e-5 * np.abs(t)
        # near-grazing lanes, where the JAX value itself is off the float64
        # recompute beyond the tolerance: within 1e-4 of |t| (or of the unit
        # normal) of the float64 value
        ill = np.abs(w - t) > 5e-6 + 1e-5 * np.abs(t)
        scale = np.abs(t) if k == "t" else 1.0
        bad = off & worse & ~(ill & (np.abs(g - t) <= 1e-4 * scale))
        if bad.any():
            # or within 16 times the float64 value's change under a
            # last-ulp change of the ray: the conditioning of a near-grazing
            # sphere boundary (its formula rounds ~16 times in float32)
            lanes_m = np.nonzero(m)[0]
            rows = np.unique(np.nonzero(bad)[0])
            sel = torch.as_tensor(lanes_m[rows])
            cond = np.zeros(len(rows))
            for sgn in (1.0, -1.0):
                o2 = o[sel].double() * (1 + sgn * 2.0 ** -23)
                d2 = d[sel].double() * (1 - sgn * 2.0 ** -23)
                t2 = port_sweep(ts)(f64(ts.params), o2, d2)[k].numpy()
                ch = np.abs(t2 - truth[k].numpy()[lanes_m[rows]])
                cond = np.maximum(cond, ch if ch.ndim == 1 else ch.max(-1))
            lim = np.zeros(bad.shape[0])
            lim[rows] = 16 * cond
            lim = lim if bad.ndim == 1 else lim[:, None]
            bad &= ~(np.abs(g - t) <= lim + 5e-6 + 1e-5 * np.abs(t))
        assert not bad.any(), (k, g[bad], w[bad], t[bad])
    return len(lanes)


def port_sweep(ts):
    """The port's sweep on ``ts`` (the ellipsoid scene has 23 leaves, below
    the sweep's routing threshold: its sweep is built directly, as the JAX
    side's ``sweep=True``)."""
    if isinstance(ts.plain_hit_fn, megasweep.SweepHit):
        return ts.plain_hit_fn
    return megasweep.SweepHit(ts.plan, fasthit.collect_leaves(ts.plan), ts.params)


def test_sweep_hit_matches_the_jax_sweep(pair):
    name, js, ts = pair
    o, d = frame_rays(ts)
    want = jfast.compile_fast_hit(js.plan, params_ref=js.params, sweep=True)(
        js.params, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    want = {k: np.asarray(v) for k, v in want.items()}
    sweep = port_sweep(ts)
    calls = megasweep.REFERENCE_CALLS
    got = sweep(ts.params, o, d)
    assert megasweep.REFERENCE_CALLS == calls + 1
    assert want["hit"].mean() > 0.5
    flips = compare_hits(ts, o, d, got, want)
    assert flips <= 4, flips
    # culling is a pure skip: bit for bit the same outputs
    culled = sweep(ts.params, o, d, cull=True)
    for k in got:
        assert torch.equal(got[k], culled[k]), k


def test_eligibility_and_slot_counts_match_jax(pair):
    name, js, ts = pair
    jl = jfast.collect_leaves(js.plan)
    tl = fasthit.collect_leaves(ts.plan)
    assert megasweep.mega_eligible(ts.plan, tl) == jmega.mega_eligible(js.plan, jl) is True
    jg, tg = jfast.union_decompose(js.plan), fasthit.union_decompose(ts.plan)
    assert len(jg) == len(tg)
    for a, b in zip(jg, tg):
        if isinstance(b, fasthit.tape._LeafPlan):
            continue
        ja = jmega._slot_algebra(a, {id(lf): j for j, (lf, _) in
                                     enumerate(jfast.collect_leaves(a))})
        tb = megasweep._slot_algebra(b, {id(lf): j for j, (lf, _) in
                                         enumerate(fasthit.collect_leaves(b))})
        assert ja == tb
    lay = port_sweep(ts).layout
    assert sorted(int(x) for x in lay.lid if x < lay.L) == list(range(lay.L))


def test_bounce_mode_matches_the_tpu_kernel_interpreted():
    """One interpret-mode call of the JAX K5 in bounce mode on
    stress_gadgets(12) at B = 512, aimed rays, against the port's plain
    bounce mode (the sweep hit + the plain shading)."""
    js, ts = pair_for("gadgets12")
    B = 512
    r = np.random.default_rng(1)
    o = np.stack([r.uniform(-3, 3, B), r.uniform(-1, 3, B), np.full(B, 12.0)], -1)
    tgt = np.stack([r.uniform(-3, 3, B), r.uniform(-1.0, -0.3, B), r.uniform(-9, -3, B)], -1)
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    thr = r.uniform(0.2, 1.0, (B, 3)).astype(np.float32)
    strength = r.uniform(0.5, 1.0, B).astype(np.float32)
    alive = r.uniform(size=B) < 0.9
    u_coin = r.uniform(size=B).astype(np.float32)
    u3 = r.uniform(size=(B, 3)).astype(np.float32)

    leaves = jfast.collect_leaves(js.plan)
    mf = js.material_fn
    kern = jmega.build_mega_sweep(js.plan, leaves, params_ref=js.params, interpret=True,
                                  bounce_meta=(mf.const_idx, mf.n_materials,
                                               [lf.mat_id for lf, _ in leaves]))
    col = lambda a, i: jnp.asarray(a[:, i])
    out = kern(js.params, col(o, 0), col(o, 1), col(o, 2), col(d, 0), col(d, 1), col(d, 2),
               col(thr, 0), col(thr, 1), col(thr, 2), jnp.asarray(strength),
               jnp.asarray(alive.astype(np.float32)), jnp.asarray(u_coin),
               col(u3, 0), col(u3, 1), col(u3, 2), True)
    (t_star, entering, m_start, m_end, found, t_rep, normal, kmat, hit,
     o2, d2, thr2, st2, bflags, u_sel) = (np.asarray(x) for x in out)
    L = len(leaves)
    use_start = m_start < L
    leaf = np.where(use_start, m_start, np.minimum(m_end, L - 1))
    want = {"_evt": np.where(hit, np.where(use_start, leaf, L + leaf), 0), "hit": hit,
            "entering": entering, "mat_id": np.where(hit, kmat, 0), "t": t_rep,
            "normal": normal, "take_transmit": (bflags >> 2) & 1 == 1,
            "scatter_alive": (bflags >> 3) & 1 == 1, "alive2": (bflags >> 4) & 1 == 1}

    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = ts.bounce_fn(ts.params, tt(o), tt(d), tt(thr), tt(strength), tt(alive),
                       tt(u_coin), tt(u3), True)
    got = dict(got, _evt=got["evt"])
    assert int(want["take_transmit"].sum()) >= 8 and want["hit"].mean() > 0.5
    keys = ("_evt", "hit", "entering", "mat_id", "take_transmit", "scatter_alive", "alive2")
    flips = compare_hits(ts, tt(o), tt(d), got, want, keys, floats=("t",))
    assert flips <= 2, flips
    agree = np.ones(B, bool)
    for k in keys:
        agree &= got[k].numpy() == np.asarray(want[k])
    # the carries inherit the boundary's rounding: a small sphere's normal
    # carries t's last-ulp error times |d| / r (~1e-4 at the emissive cores,
    # r ≈ 0.1, 16 units away; XLA's fused multiply-adds round it otherwise),
    # and the scatter direction follows the normal.  As in
    # tests/test_mega_bounce.py, at most 1% of the agreeing lanes beyond
    # rtol 1e-3, atol 2e-4
    for k, w in (("o2", o2), ("d2", d2), ("thr2", thr2), ("strength2", st2)):
        g = got[k].numpy()[agree]
        far = ~np.isclose(g, w[agree], rtol=1e-3, atol=2e-4)
        assert float(far.reshape(len(g), -1).any(-1).mean()) < 0.01, k
    h = agree & want["hit"]
    # u_sel: the acos sampler amplifies a last-ulp normal without bound at
    # exact tangency, so the fraction beyond 5e-4 is bounded, as in
    # tests/test_mega_bounce.py
    du = np.abs(got["u_sel"].numpy()[h] - u_sel[h])
    assert float((du > 5e-4).mean()) < 0.01
