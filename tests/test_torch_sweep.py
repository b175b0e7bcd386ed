"""The union sweep's fixpoint / sort / kernel modes, the candidate-blocked
hit and their routing against the JAX package.

- The port's sweep (``compile_fast_hit(plan, sweep=True, sweep_mode=m)``,
  :class:`~ptx_torch.geom.fasthit.UnionSweepHit`, on the CPU: ``kernel``
  mode runs K9's plain version) against the JAX sweep in the same mode
  (``kernel`` with the JAX K9 interpreted) on four scenes: the
  coincident-boundary scene of tests/test_large_scenes.py:333-365,
  ``stress_spheres(57)``, ``stress_gadgets(9, seed=4)``, a 57-leaf union
  of bitten spheres (four spherical bites each: past the megasweep's slot
  algebra, so the local membership fold) and a chain of six overlapping
  spheres seen from inside the first, whose fixpoint takes a pass a hop
  (asserted: more than one).  Tolerance: ``_evt``, ``hit``
  and ``entering`` equal except on lanes a float64 recompute puts at a
  near-tie (two boundaries within 1e-5 relative, or one at EPS: XLA on the
  CPU contracts multiply-adds, PyTorch does not); on agreeing hit lanes
  ``t`` within ``rtol 2e-5`` and the normal within ``rtol 1e-4, atol
  3e-4`` (tests/test_large_scenes.py:25-38).  Within the port the three
  modes read the same intervals and must agree bit for bit.
- The candidate-blocked hit (``candidate_block=32``) against the JAX one on
  ``stress_spheres(57)`` and a carved 72-leaf tape (an intersection of a
  sphere with 64 spheres: no union of small groups), with the same
  tolerance; blocked ≡ dense ``_evt`` in the port.
- Loss and every gradient of ``trace_rays`` (8×16 pixels, spp 1, depth 4)
  against the JAX package's ``compile_scene(pallas=False)`` on the bitten
  union (the fixpoint sweep) and the carved tape (the blocked hit), within
  1e-4 of each tensor's largest entry, as tests/test_torch_large_scenes.py.
- The mode resolution and ``PTX_MEGAB``.
"""

import math
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.geom import fasthit as jfast
from ptx.geom.tape import Difference as JDifference, Intersection as JIntersection
from ptx.geom.tape import Plane as JPlane, Sphere as JSphere, Union as JUnion
from ptx.integrate import trace as jtr
from ptx.integrate.camera import Camera as JCamera, sample_rays as jax_sample_rays
from ptx.scenes import builders as jbuilders
from ptx.shade.materials import Material as JMaterial
from ptx_torch.convert import grads_to_numpy, params_from_jax, scene_from_jax
from ptx_torch.core import rng
from ptx_torch.geom import fasthit
from ptx_torch.integrate import trace
from ptx_torch.integrate.camera import Camera, sample_rays
from ptx_torch.ops import megasweep, sweep_kernel
from ptx_torch.ops.replay_bwd import RowFedReplayBwd
from ptx_torch.scenes import builders
from ptx_torch.shade.bounce import UnfusedBounce

from test_torch_large_scenes import _close_grads
from test_torch_megasweep import winner_tied

torch.set_num_threads(1)

_SKY = JMaterial(reflect=0.0, scatter=0.0, emissive=(0.7, 0.8, 1.0))
_GROUND = JMaterial(reflect=0.6, scatter=1.0)


def bitten_union(n):
    """``n`` spheres with four spherical bites each (``Difference(sphere,
    Union(4 bites))``: 5 leaves, past the megasweep's slot algebra) over the
    ground plane under the stress sky: ``5n + 7`` leaves."""
    diffuse = [JMaterial(reflect=(0.8, 0.3, 0.3), scatter=1.0),
               JMaterial(reflect=(0.3, 0.8, 0.3), scatter=1.0)]
    r = np.random.default_rng(5)
    side = max(1, int(math.ceil(math.sqrt(n))))
    gadgets = []
    for i in range(n):
        rad = r.uniform(0.3, 0.5)
        c = np.array([(i % side - (side - 1) / 2) * 1.4 + r.uniform(-0.2, 0.2), -1.0 + rad,
                      -3.0 - (i // side) * 1.4 + r.uniform(-0.2, 0.2)])
        bites = [JSphere(c + 0.8 * rad * np.array([math.cos(a), 0.4, math.sin(a)]),
                         0.45 * rad, diffuse[(i + 1) % 2])
                 for a in (0.3, 1.9, 3.5, 5.1)]
        gadgets.append(JDifference(JSphere(c, rad, diffuse[i % 2]), JUnion(*bites)))
    return jbuilders.union_array([*gadgets, JPlane((0.0, 1.0, 0.0), 1.0, _GROUND),
                                  *jbuilders.sky_planes(_SKY)])


def carved_tape():
    """``Union(Intersection(big sphere, union_array(64 spheres)), ground,
    sky planes)``: 72 leaves, no union of small groups."""
    m = JMaterial(reflect=(0.7, 0.5, 0.3), scatter=0.5)
    r = np.random.default_rng(9)
    balls = [JSphere((r.uniform(-2, 2), r.uniform(-1, 1.5), r.uniform(-7, -3)),
                     r.uniform(0.3, 0.7), m) for _ in range(64)]
    return JUnion(JIntersection(JSphere((0.0, 0.0, -5.0), 2.2, m), jbuilders.union_array(balls)),
                  JPlane((0.0, 1.0, 0.0), 1.0, _GROUND), *jbuilders.sky_planes(_SKY))


def coincident():
    """tests/test_large_scenes.py:333-365: two identical spheres, a third
    overlapping them, a fourth behind, the ground, the sky."""
    m1 = JMaterial(reflect=(0.8, 0.3, 0.3), scatter=1.0)
    m2 = JMaterial(reflect=(0.3, 0.8, 0.3), scatter=1.0)
    return jbuilders.union_array([
        JSphere((0.0, 0.0, -3.0), 1.0, m1), JSphere((0.0, 0.0, -3.0), 1.0, m2),
        JSphere((0.5, 0.0, -3.5), 1.0, m2), JSphere((0.0, 0.0, -5.0), 1.0, m1),
        JPlane((0.0, 1.0, 0.0), 1.0, m1), *jbuilders.sky_planes(_SKY)])


def chain(n=6):
    """``n`` unit spheres in a row, each overlapping the next, over the
    ground under the stress sky: a ray from inside the first crosses every
    overlap, one fixpoint pass a hop."""
    m = [JMaterial(reflect=(0.8, 0.3, 0.3), scatter=1.0),
         JMaterial(reflect=(0.3, 0.8, 0.3), scatter=1.0)]
    return jbuilders.union_array([JSphere((0.3 * i, 0.0, -2.0 - 1.6 * i), 1.0, m[i % 2])
                                  for i in range(n)]
                                 + [JPlane((0.0, 1.0, 0.0), 1.0, _GROUND),
                                    *jbuilders.sky_planes(_SKY)])


SCENES = {"coincident": coincident, "chain": chain,
          "spheres57": lambda: jbuilders.stress_spheres(57),
          "gadgets9": lambda: jbuilders.stress_gadgets(9, seed=4),
          "bitten57": lambda: bitten_union(10),
          "carved72": carved_tape}
MODES = ("fixpoint", "sort", "kernel")


def _pair(name):
    root = SCENES[name]()
    js = jtr.compile_scene(root, pallas=False)
    ts = trace.compile_scene(scene_from_jax(root), "cpu")
    ts.params = params_from_jax(jax.tree.map(np.asarray, js.params), "cpu")
    return js, ts


def _rays(name, seed=0):
    """The coincident scene's rays of tests/test_large_scenes.py:351-360
    (from the origin, from the spheres' shared centre, from inside the
    box); elsewhere a 32×16 frame of the demo camera and 128 rays from
    inside the spheres in random directions."""
    g = np.random.default_rng(seed)
    if name == "chain":                  # from inside the first sphere, down the row
        n = 256
        o = np.array([0.0, 0.0, -2.0]) + g.uniform(-0.3, 0.3, (n, 3))
        d = np.stack([g.uniform(0.1, 0.25, n), g.uniform(-0.05, 0.05, n), -np.ones(n)], -1)
        return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))
    if name == "coincident":
        o = np.concatenate([np.zeros((128, 3)), np.array([[0.0, 0.0, -3.0]] * 64),
                            g.uniform(-2, 2, (64, 3))])
        d = np.concatenate([np.stack([g.uniform(-1, 1, 128), g.uniform(-1, 1, 128),
                                      np.full(128, -1.0)], -1),
                            np.array([[0.0, 0.0, -1.0]] * 64), g.normal(size=(64, 3))])
        return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))
    o, d = sample_rays(Camera.reference_demo(32, 16), rng.PRNGKey(seed), range(16), range(32),
                       1, "cpu")
    return o, d


def _inside_rays(ts, n=128, seed=0):
    g = np.random.default_rng(seed)
    c = ts.params["sphere_center"].numpy()
    rad = ts.params["sphere_radius"].numpy()
    pick = g.integers(0, len(c), n)
    o = c[pick] + 0.3 * rad[pick, None] * g.uniform(-1, 1, (n, 3))
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32)))


def _scene_rays(name, ts):
    o, d = _rays(name)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    if name not in ("coincident", "chain"):
        oi, di = _inside_rays(ts)
        o, d = torch.cat([o, oi]), torch.cat([d, di])
    return o, d


def compare_with_jax(ts, o, d, got, want, max_flips=4):
    """Decisions equal but for adjudicated near-ties; ``t`` and the normal
    within the stated tolerance on agreeing hit lanes."""
    want = {k: np.asarray(v) for k, v in want.items()}
    differ = np.zeros(o.shape[0], bool)
    for k in ("_evt", "hit", "entering"):
        differ |= got[k].numpy() != want[k]
    lanes = np.nonzero(differ)[0]
    ok = winner_tied(ts, o, d, (got["_evt"].numpy(), want["_evt"]), lanes)
    assert bool(ok.all()), f"unexplained flips at lanes {lanes[~ok.numpy()][:8]}"
    assert len(lanes) <= max_flips, len(lanes)
    keep = ~differ & want["hit"]
    assert keep.mean() > 0.3
    np.testing.assert_allclose(got["t"].numpy()[keep], want["t"][keep], rtol=2e-5)
    np.testing.assert_allclose(got["normal"].numpy()[keep], want["normal"][keep], rtol=1e-4,
                               atol=3e-4)
    assert np.array_equal(got["mat_id"].numpy()[keep], want["mat_id"][keep])
    return len(lanes)


@pytest.fixture(scope="module",
                params=["coincident", "spheres57", "gadgets9", "bitten57", "chain"])
def sweep_case(request):
    """A scene, its rays and the port's sweep in every mode."""
    name = request.param
    js, ts = _pair(name)
    o, d = _scene_rays(name, ts)
    got = {m: trace.compile_fast_hit(ts.plan, sweep=True, sweep_mode=m)(ts.params, o, d)
           for m in MODES}
    return name, js, ts, o, d, got


@pytest.mark.parametrize("mode", MODES)
def test_sweep_modes_match_jax(sweep_case, mode):
    name, js, ts, o, d, got = sweep_case
    hit_fn = jfast.compile_fast_hit(js.plan, params_ref=js.params, sweep=True, sweep_mode=mode,
                                    sweep_kernel="interpret" if mode == "kernel" else None)
    want = jax.jit(hit_fn)(js.params, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    compare_with_jax(ts, o, d, got[mode], want)
    # the three modes of the port: bit for bit the same outputs
    for k, v in got["fixpoint"].items():
        assert torch.equal(got[mode][k], v), k


def test_fixpoint_takes_chain_hops():
    """On the chain the fixpoint needs a pass a hop (more than one), and the
    three modes (kernel: K9's plain version with the sort inside) agree bit
    for bit; test_sweep_modes_match_jax holds them against the JAX sweep."""
    _, ts = _pair("chain")
    o, d = _scene_rays("chain", ts)
    hits = {m: trace.compile_fast_hit(ts.plan, sweep=True, sweep_mode=m) for m in MODES}
    got = {m: h(ts.params, o, d) for m, h in hits.items()}
    assert hits["fixpoint"].last_passes > 1
    assert bool(got["fixpoint"]["hit"].all())
    for m in ("sort", "kernel"):
        for k, v in got["fixpoint"].items():
            assert torch.equal(got[m][k], v), (m, k)


def test_bitten_union_is_past_the_slot_algebra():
    """Four bites exceed the megasweep's slot algebra (the default mode is
    then the fixpoint sweep, with every gadget through the local fold);
    two give an eligible tape."""
    js, ts = _pair("bitten57")
    leaves = fasthit.collect_leaves(ts.plan)
    assert len(leaves) == 57
    assert not megasweep.mega_eligible(ts.plan, leaves)
    hit = trace.compile_fast_hit(ts.plan, ts.params)
    assert isinstance(hit, fasthit.UnionSweepHit) and hit.mode == "fixpoint"
    assert [rows.shape for _, _, rows in hit.classes] == [(10, 5)]
    two = scene_from_jax(JUnion(*(JDifference(JSphere((i, 0.0, -4.0), 0.4, _GROUND),
                                              JUnion(JSphere((i + 0.3, 0.2, -4.0), 0.2, _GROUND),
                                                     JSphere((i - 0.3, 0.2, -4.0), 0.2, _GROUND)))
                                  for i in range(9))))
    plan = trace.compile_scene(two, "cpu").plan
    assert megasweep.mega_eligible(plan, fasthit.collect_leaves(plan))


@pytest.mark.parametrize("name", ["spheres57", "carved72"])
def test_blocked_hit_matches_jax(name):
    js, ts = _pair(name)
    o, d = _scene_rays(name, ts)
    got = trace.compile_fast_hit(ts.plan, candidate_block=32)
    assert isinstance(got, fasthit.BlockedHit)
    want = jax.jit(jfast.compile_fast_hit(js.plan, candidate_block=32))(
        js.params, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    compare_with_jax(ts, o, d, got(ts.params, o, d), want)


def test_blocked_equals_dense_in_the_port():
    """stress_spheres(20) (27 leaves): the blocked scan (block 8, ragged
    last block) and the dense fold pick the same event on every lane."""
    ts = trace.compile_scene(builders.stress_spheres(20), "cpu")
    o, d = _scene_rays("spheres20", ts)
    a = trace.compile_fast_hit(ts.plan, candidate_block=8)(ts.params, o, d)
    b = trace.compile_fast_hit(ts.plan, candidate_block=0)(ts.params, o, d)
    assert a["hit"].float().mean() > 0.5
    assert torch.equal(a["_evt"], b["_evt"]) and torch.equal(a["hit"], b["hit"])
    assert torch.equal(a["entering"], b["entering"]) and torch.equal(a["mat_id"], b["mat_id"])
    torch.testing.assert_close(a["t"], b["t"], rtol=2e-5, atol=0.0)
    torch.testing.assert_close(a["normal"], b["normal"], rtol=1e-4, atol=3e-4)


@pytest.mark.parametrize("name", ["bitten57", "carved72"])
def test_trace_rays_loss_and_gradients_match_jax(name):
    """8×16 pixels, spp 1, depth 4: the fixpoint sweep (bitten) and the
    blocked hit (carved), each with the unfused bounce and K6's CPU path."""
    js, ts = _pair(name)
    hit = {"bitten57": fasthit.UnionSweepHit, "carved72": fasthit.BlockedHit}[name]
    assert isinstance(ts.hit_fn, hit) and isinstance(ts.bounce_fn, UnfusedBounce)
    assert isinstance(ts.bounce_bwd_fn, RowFedReplayBwd)
    W, H, DEPTH = 16, 8, 4
    kj = jax.random.PRNGKey(0)
    o, d = jax_sample_rays(JCamera.reference_demo(W, H), kj, jnp.arange(H), jnp.arange(W), 1)
    loss_j, g_j = jax.jit(jax.value_and_grad(lambda p: jnp.mean(
        jtr.trace_rays(js, p, o, d, kj, DEPTH))))(js.params)
    ot, dt = sample_rays(Camera.reference_demo(W, H), rng.PRNGKey(0), range(H), range(W), 1,
                         "cpu")
    p = {k: ([x.clone().requires_grad_(True) for x in v] if isinstance(v, list)
             else v.clone().requires_grad_(True)) for k, v in ts.params.items()}
    loss_t = trace.trace_rays(ts, p, ot, dt, rng.PRNGKey(0), DEPTH).mean()
    loss_t.backward()
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    g_t = grads_to_numpy(p)
    _close_grads(g_t, jax.tree.map(np.asarray, g_j))
    assert np.abs(g_t["sphere_center"]).sum() > 0 and np.abs(g_t["const"]).sum() > 0


def test_kernel_mode_scene_calls_k9_once_per_bounce(monkeypatch):
    """Under ``PTX_SWEEP_MODE=kernel`` a trace goes through K9's wrapper
    once per bounce (its plain version on the CPU) and equals the fixpoint
    trace bit for bit."""
    js, ts = _pair("bitten57")
    o, d = sample_rays(Camera.reference_demo(16, 8), rng.PRNGKey(1), range(8), range(16), 1,
                       "cpu")
    want = trace.trace_rays(ts, ts.params, o, d, rng.PRNGKey(1), 4)
    monkeypatch.setenv("PTX_SWEEP_MODE", "kernel")
    tk = trace.compile_scene(scene_from_jax(bitten_union(10)), "cpu")
    assert tk.hit_fn.mode == "kernel" and tk.hit_fn.replay is not None
    calls = sweep_kernel.REFERENCE_CALLS
    got = trace.trace_rays(tk, ts.params, o, d, rng.PRNGKey(1), 4)
    assert sweep_kernel.REFERENCE_CALLS == calls + 5
    assert torch.equal(got, want)


def test_mode_resolution(monkeypatch):
    eligible = trace.compile_scene(builders.stress_spheres(25), "cpu").plan
    bitten = trace.compile_scene(scene_from_jax(bitten_union(10)), "cpu").plan
    mode = lambda plan, **kw: trace.resolve_sweep_mode(plan, fasthit.collect_leaves(plan),
                                                         **kw)
    for v in ("PTX_SWEEP_MODE", "PTX_SWEEP_KERNEL"):
        monkeypatch.delenv(v, raising=False)
    assert mode(eligible) == "mega" and mode(bitten) == "fixpoint"
    assert mode(eligible, sweep_kernel=True) == "kernel"
    assert mode(eligible, sweep_kernel=False) == "sort"
    monkeypatch.setenv("PTX_SWEEP_MODE", "sort")
    assert mode(eligible) == "sort" and mode(bitten) == "sort"
    monkeypatch.setenv("PTX_SWEEP_KERNEL", "1")          # wins over PTX_SWEEP_MODE
    assert mode(eligible) == "kernel"
    assert mode(eligible, sweep_kernel=False) == "sort"   # the argument wins
    assert mode(eligible, sweep_kernel=False, sweep_mode="fixpoint") == "fixpoint"
    monkeypatch.delenv("PTX_SWEEP_KERNEL")
    monkeypatch.setenv("PTX_SWEEP_MODE", "mega")
    assert mode(eligible) == "mega" and mode(bitten) == "fixpoint"   # the fallback
    assert mode(bitten, sweep_mode="mega") == "fixpoint"
    with pytest.raises(ValueError, match="unknown sweep mode"):
        mode(eligible, sweep_mode="bitonic")
    with pytest.raises(ValueError, match="sweep_kernel"):
        mode(eligible, sweep_kernel="interpret")
    for m, cls in (("mega", megasweep.SweepHit), ("kernel", fasthit.UnionSweepHit)):
        assert isinstance(trace.compile_fast_hit(eligible, sweep_mode=m), cls)


def test_megab_knob_routes_the_bounce(monkeypatch):
    """``PTX_MEGAB=0`` keeps K5's hit mode under the unfused bounce; a mode
    other than ``mega`` always takes the unfused bounce; K6 either way."""
    for v in ("PTX_SWEEP_MODE", "PTX_SWEEP_KERNEL", "PTX_MEGAB"):
        monkeypatch.delenv(v, raising=False)
    world = lambda: builders.stress_spheres(25)
    sc = trace.compile_scene(world(), "cpu")
    assert isinstance(sc.bounce_fn, megasweep.MegaBounce)
    monkeypatch.setenv("PTX_MEGAB", "0")
    sc = trace.compile_scene(world(), "cpu")
    assert isinstance(sc.bounce_fn, UnfusedBounce) and isinstance(sc.hit_fn, megasweep.MegaHit)
    assert isinstance(sc.bounce_bwd_fn, RowFedReplayBwd)
    monkeypatch.setenv("PTX_MEGAB", "1")
    monkeypatch.setenv("PTX_SWEEP_MODE", "kernel")
    sc = trace.compile_scene(world(), "cpu")
    assert isinstance(sc.bounce_fn, UnfusedBounce)
    assert isinstance(sc.hit_fn, fasthit.UnionSweepHit) and sc.hit_fn.mode == "kernel"
    assert sc.bounce_fn.pack(sc.params) is None
    assert isinstance(sc.bounce_bwd_fn, RowFedReplayBwd)
