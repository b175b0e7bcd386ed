"""The port's scene compile against the JAX package's, on the demo world.

ptx_torch builds the demo with its own builders; the compiled tables must
equal the JAX package's: geometry exactly, transform-derived entries
(texture lookup transforms) within 1e-6, leaf order and difference
parity identical, and the material table's slot routing identical.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.geom.fasthit import collect_leaves as jax_collect_leaves
from ptx.integrate import trace as jtr
from ptx.scenes import builders as jbuilders
from ptx_torch.convert import params_from_jax, scene_from_jax
from ptx_torch.geom.fasthit import collect_leaves
from ptx_torch.integrate import trace as ttr
from ptx_torch.ops.bounce_kernel import pack_scene
from ptx_torch.ops.fasthit_kernel import tape_program
from ptx_torch.scenes.builders import make_world
from ptx_torch.geom.fasthit import _bits_at

torch.set_num_threads(1)

_GEOMETRY = ("sphere_center", "sphere_radius", "plane_normal", "plane_d",
             "xform", "ior", "const", "factor")


@pytest.fixture(scope="module")
def scenes():
    js = jtr.compile_scene(jbuilders.make_world(), pallas=False)
    ts = ttr.compile_scene(make_world(), "cpu")
    return js, ts


@pytest.mark.parametrize("name", _GEOMETRY)
def test_tables_exact(scenes, name):
    js, ts = scenes
    a = np.asarray(js.params[name])
    b = ts.params[name].numpy()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_texture_tables(scenes):
    """The sky's lookup transform is rotate_x(π/2) from each package's own
    f32 cos/sin: equal within 1e-6.  Images are exact."""
    js, ts = scenes
    np.testing.assert_allclose(np.asarray(js.params["tex_xform"]),
                               ts.params["tex_xform"].numpy(), atol=1e-6)
    assert len(js.params["images"]) == len(ts.params["images"]) == 1
    for a, b in zip(js.params["images"], ts.params["images"]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_leaf_order_and_parity(scenes):
    js, ts = scenes
    jl = jax_collect_leaves(js.plan)
    tl = collect_leaves(ts.plan)
    assert len(tl) == len(jl) == 13
    assert ([(lf.kind, lf.index, lf.mat_id, lf.xform_chain, p) for lf, p in tl]
            == [(lf.kind, lf.index, lf.mat_id, lf.xform_chain, p) for lf, p in jl])


def test_material_routing(scenes):
    js, ts = scenes
    jm, tm = js.material_fn, ts.material_fn
    assert tm.n_materials == jm.n_materials == 5
    for s, idx in jm.const_idx.items():
        np.testing.assert_array_equal(np.asarray(idx), tm.const_idx[s])
    assert tm.dynamic_slots == jm.dynamic_slots
    assert ([mi for mi, _ in tm.terminal_dynamic_emissive]
            == [mi for mi, _ in jm.terminal_dynamic_emissive])


def test_emission_matches(scenes):
    """eval_emissive (constant rows + the rotated equirect sky chain) and
    eval_emissive_base on the same positions and material ids."""
    js, ts = scenes
    r = np.random.default_rng(0)
    pos = r.uniform(-200, 200, (512, 3)).astype(np.float32)
    mid = r.integers(0, 5, 512).astype(np.int32)
    for name in ("eval_emissive", "eval_emissive_base"):
        want = np.asarray(jax.jit(getattr(js.material_fn, name))(
            js.params, jnp.asarray(pos), jnp.asarray(mid)))
        got = getattr(ts.material_fn, name)(
            ts.params, torch.from_numpy(pos), torch.from_numpy(mid).long())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_params_from_jax_round_trip(scenes):
    js, _ = scenes
    np_params = {k: ([np.asarray(x) for x in v] if isinstance(v, list)
                     else np.asarray(v)) for k, v in js.params.items()}
    back = params_from_jax(np_params, "cpu")
    assert back.keys() == np_params.keys()
    for k, v in np_params.items():
        if k == "images":
            for a, b in zip(v, back[k]):
                np.testing.assert_array_equal(a, b.numpy())
        else:
            assert back[k].dtype == torch.float32
            np.testing.assert_array_equal(v, back[k].numpy())


def test_scene_from_jax_matches_port_builder(scenes):
    """The converted JAX tree compiles to the port builder's tables."""
    _, ts = scenes
    conv = ttr.compile_scene(scene_from_jax(jbuilders.make_world()), "cpu")
    for k in _GEOMETRY + ("tex_xform",):
        np.testing.assert_allclose(conv.params[k].numpy(),
                                   ts.params[k].numpy(), atol=1e-6)


@pytest.mark.parametrize("scene_name", ["demo", "config2", "gadgets"])
def test_tape_program_folds_like_the_plan(scene_name):
    """The kernel's postfix tape over membership masks computes the same
    root membership as fasthit._bits_at on the plan."""
    root = {"demo": jbuilders.make_world,
            "config2": jbuilders.baseline_config2,
            "gadgets": lambda: jbuilders.stress_gadgets(4)}[scene_name]()
    plan = ttr.compile_scene(scene_from_jax(root), "cpu").plan
    leaves = collect_leaves(plan)
    leaf_pos = {id(lf): i for i, (lf, _) in enumerate(leaves)}
    bits = torch.from_numpy(
        np.random.default_rng(1).integers(0, 2, (len(leaves), 4096)).astype(bool))
    stack = []
    for op in tape_program(plan, leaf_pos):
        if op >= 0:
            stack.append(bits[op])
            continue
        b = stack.pop()
        a = stack.pop()
        stack.append({-1: a | b, -2: a & b, -3: a & ~b}[op])
    assert len(stack) == 1
    assert torch.equal(stack[0], _bits_at(plan, leaf_pos, bits))


def test_pack_scene_layout(scenes):
    """Leaf records point at each leaf's geometry; the tape follows the
    geometry (K4's buffer); material rows hold the constant slots and
    close the buffer."""
    _, ts = scenes
    buf, (L, mat_off, tape_off, tape_len) = pack_scene(
        ts.plan, ts.material_fn, ts.params)
    buf = buf.numpy()
    p = ts.params
    for k, (lf, parity) in enumerate(collect_leaves(ts.plan)):
        kind, off, xf, mat, par = buf[5 * k:5 * k + 5]
        assert (kind, xf, mat, par) == (lf.kind == "plane", 0, lf.mat_id, parity)
        off = int(off)
        if lf.kind == "sphere":
            np.testing.assert_array_equal(buf[off:off + 3],
                                          p["sphere_center"][lf.index].numpy())
            assert buf[off + 3] == p["sphere_radius"][lf.index].item()
        else:
            np.testing.assert_array_equal(buf[off:off + 3],
                                          p["plane_normal"][lf.index].numpy())
            assert buf[off + 3] == p["plane_d"][lf.index].item()
    glass = buf[mat_off + 9 * 1:mat_off + 9 * 2]     # material 1: the glass
    np.testing.assert_allclose(glass, [0.7, 0.7, 0.7, 0, 0.9, 0.9, 0.9, 1, 1.3],
                               rtol=1e-7)
    assert tape_off + tape_len == mat_off
    assert mat_off + 9 * ts.material_fn.n_materials == buf.size
