"""Config 4 (a textured surface under an equirect sky) in the benchmark:
its scene document compiles to `baseline_config4`'s scene, the widened plain
reference (``benchmark/reference/textures.py``) takes the port's training
step's loss and gradients, the checks fail the bfloat16 control and a
texture read as a constant, the port records the unfused route's spans and
counter, and the two readers that read them."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import compare, harness, inputs, tracing
from benchmark.reference import scene as rscene
from benchmark.reference import textures, tracer

SMALL_IMAGES = {"sky.hdr": {"formula": "procedural_sky", "height": 64, "width": 128},
                "checker.hdr": {"formula": "checker", "size": 64, "squares": 8}}
TINY = {"frame": {"width": 16, "height": 8}, "depth": 3, "images": SMALL_IMAGES}


def _config(**over):
    config = inputs.load_json("configs", "config4")
    config.update(over)
    return config


def _port_scene(config, seed, tmp_path):
    from ptx_torch.integrate.trace import compile_scene
    from ptx_torch.scenes.spec import SceneSpec

    inputs.write_images(config, str(tmp_path))
    doc = inputs.scene_doc(config, seed)
    world, cam, _ = SceneSpec(doc, base_dir=str(tmp_path)).build()
    return compile_scene(world, "cpu"), cam, doc


def test_spec_compiles_to_baseline_config4(tmp_path):
    from ptx_torch.geom.fasthit import collect_leaves
    from ptx_torch.integrate.trace import compile_scene
    from ptx_torch.ops.fasthit_kernel import HitKernel
    from ptx_torch.scenes.builders import baseline_config4
    from ptx_torch.shade.bounce import TEXTURE_KEYS, UnfusedBounce

    from ptx_torch.scenes.spec import SceneSpec

    config = _config(images=SMALL_IMAGES)
    inputs.write_images(config, str(tmp_path))
    # the scene as the configuration states it, before the seed's emission scale
    doc = dict(config["scene"], camera={"width": 512, "height": 512, "reference_demo": True})
    a = compile_scene(SceneSpec(doc, base_dir=str(tmp_path)).build()[0], "cpu")
    b = compile_scene(baseline_config4(), "cpu")
    assert a.params.keys() == b.params.keys()
    for k in a.params:
        if k == "images":           # contents and sizes are the configuration's own
            assert len(a.params[k]) == len(b.params[k]) == 2
            continue
        assert torch.equal(a.params[k], b.params[k]), k
    order = lambda s: [(lf.kind, lf.index, lf.mat_id) for lf, _ in collect_leaves(s.plan)]
    assert order(a) == order(b) and len(order(a)) == 9
    ta, tb = a.material_fn, b.material_fn
    assert all(np.array_equal(ta.const_idx[s], tb.const_idx[s]) for s in ta.const_idx)
    assert ta.dynamic_slots == tb.dynamic_slots == {
        "reflect": [0], "scatter": [], "emissive": [2], "transmit": [], "transmit_reflect": []}
    assert a.params["tex_xform"].tolist() == [[[0.25, 0, 0, 0], [0, 0.25, 0, 0],
                                               [0, 0, 0.25, 0]]]
    for s in (a, b):
        assert isinstance(s.bounce_fn, UnfusedBounce) and isinstance(s.hit_fn, HitKernel)
        assert s.diff_keys[-len(TEXTURE_KEYS):] == TEXTURE_KEYS and s.emission_fn is None


def test_reference_reads_the_ports_tables_in_the_ports_order(tmp_path):
    scene, _, doc = _port_scene(_config(images=SMALL_IMAGES), 11, tmp_path)
    rs = rscene.parse(doc, str(tmp_path))
    assert isinstance(rs, textures.TexturedScene)
    assert [(mi, s) for mi, s, _ in rs.surface_chains] == [(0, "reflect")]
    P = rscene.params(rs, "cpu")
    for k, v in tracer.leaves_of(P).items():
        port = (scene.params["images"][int(k.split(".")[1])] if k.startswith("images.")
                else scene.params[k])
        assert torch.equal(v, port), k
    # the demo and S1 go to the functions textures.install replaced
    for name in ("demo", "S1"):
        cfg = inputs.load_json("configs", name)
        inputs.write_images(cfg, str(tmp_path))
        d = inputs.scene_doc(cfg, 5)
        assert not textures.textured_surfaces(d)
        assert type(textures.parse(d, str(tmp_path))) is rscene.RefScene


def test_other_surface_textures_still_raise(tmp_path):
    config = _config(images=SMALL_IMAGES)
    inputs.write_images(config, str(tmp_path))
    doc = inputs.scene_doc(config, 1)
    doc["materials"]["textured"]["scatter"] = {
        "type": "spherical", "child": {"type": "image", "file": "sky.hdr"}}
    with pytest.raises(NotImplementedError, match="surface slot"):
        textures.parse(doc, str(tmp_path))


def _port_grads(scene, cam, target, key, spp, depth):
    """The port's loss and gradient by leaf name, as ``make_train_step``
    takes them (its band under ``fold(key, 0, 0)``)."""
    from ptx_torch.parallel.render import _local_render

    names, xs = [], []
    params = {}
    for k, v in scene.params.items():
        if isinstance(v, list):
            params[k] = [x.detach().requires_grad_(True) for x in v]
            names += [f"{k}.{i}" for i in range(len(v))]
            xs += params[k]
        else:
            params[k] = v.detach().requires_grad_(True)
            if v.numel():
                names.append(k)
                xs.append(params[k])
    band = _local_render(scene, cam, depth, spp, params, key, 0, cam.height)
    loss = torch.mean((band - target) ** 2)
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    return float(loss.detach()), {n: torch.zeros_like(x) if g is None else g
                         for n, g, x in zip(names, grads, xs)}


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7])
def test_port_train_step_against_the_widened_reference(seed, tmp_path):
    config = _config(**TINY)
    scene, cam, doc = _port_scene(config, seed, tmp_path)
    target = inputs.target(seed, 8, 16, "cpu")
    key = inputs.step_key(seed, 0)
    loss_p, g_p = _port_grads(scene, cam, target, key, 1, 3)
    rs = rscene.parse(doc, str(tmp_path))
    _, loss_r, g_r = tracer.train_step(rs, rscene.params(rs, "cpu"), target, key, 1, 3,
                                       1e-4, "cpu")
    assert abs(loss_p - float(loss_r)) <= 1e-6 * abs(float(loss_r))
    g_r = {k: v for k, v in g_r.items() if v.numel()}
    assert set(g_p) == set(g_r)
    for k in g_r:
        ref = float(torch.linalg.vector_norm(g_r[k].double()))
        gap = float(torch.linalg.vector_norm((g_p[k] - g_r[k]).double()))
        assert gap <= 1e-4 * ref + 1e-12, (k, gap, ref)
    # the checker (image 0) and the sky (image 1) both take a gradient; the
    # nearest-texel lookup gives the texture's transform none
    assert float(g_r["images.0"].abs().sum()) > 0 and float(g_r["images.1"].abs().sum()) > 0
    assert not g_r["tex_xform"].any() and not g_p["tex_xform"].any()


def test_bf16_control_and_a_constant_texture_fail_a_limit(monkeypatch):
    from benchmark.kinds import train

    def constant_texture(scene, P, mat_id, pos):
        m = tracer.material(scene, P, mat_id)
        for mi, s, chain in scene.surface_chains:
            mean = P["images"][chain[2][1]][..., :3].mean(dim=(0, 1)).detach()
            m[s] = torch.where((mat_id == mi)[:, None], mean, m[s])
        m["scatter_f"] = tracer.mean3(m["scatter"])
        m["transmit_reflect_f"] = tracer.mean3(m["transmit_reflect"])
        return m

    def readings(drv):      # run while the run's images are on disk
        side = lambda dtype: train.reference_side(drv, drv.ref_scene(), dtype, drv.spp)
        got["control"] = train.numbers(side(torch.bfloat16), drv.ref, drv.lr)
        monkeypatch.setattr(textures, "material_at", constant_texture)
        got["constant"] = train.numbers(drv.checked, side(torch.float32), drv.lr)

    got = {}
    out = harness.run("config4.train", 2 ** 31 + 19, 0.2, False, "cpu", time.perf_counter(),
                      overrides=dict(TINY, spp=2), log=lambda m: None, hook=readings)
    assert out["correct"] is True
    limits = inputs.load_json("limits", "config4.train")
    for name in ("control", "constant"):
        ok, checks = compare.judge(got[name], limits)
        assert ok is False, (name, checks)


def _profiled_step(name, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from ptx_torch.core import rng
    from ptx_torch.parallel.render import make_train_step
    from ptx_torch.utils import profiling

    config = inputs.load_json("configs", name)
    config.update(TINY, images=SMALL_IMAGES if name == "config4" else config["images"])
    scene, cam, _ = _port_scene(config, 2, tmp_path)
    step = make_train_step(scene, cam, spp=1, depth=3)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        step(scene.params, torch.zeros(8, 16, 3), rng.PRNGKey(0))
    snap = profiling.snapshot()
    profiling.reset()
    return snap


def test_profiled_step_records_the_unfused_route(tmp_path):
    from ptx_torch.utils import profiling

    s = _profiled_step("config4", tmp_path)
    assert s["units"] == 1 and s["counters"]["unfused_bounces"] == 4     # depth 3: 4 bounces
    sp = s["spans"]
    assert set(profiling.UNFUSED_SPANS) <= set(sp)
    assert sp["unfused_bounce"]["calls"] == sp["bounce"]["calls"] == 4
    # the last bounce only records its hit: no cotangent reaches it
    assert sp["replay_vjp"]["calls"] == sp["bounce_bwd"]["calls"] == 3
    assert sp["tex_hist"]["calls"] == 3 and sp["sky_hist"]["calls"] == 1
    assert sp["tex_hist"]["host_ms"] <= sp["replay_vjp"]["host_ms"]
    d = _profiled_step("demo", tmp_path)
    assert "unfused_bounces" not in d["counters"]
    assert not set(profiling.UNFUSED_SPANS) & set(d["spans"])


@pytest.mark.parametrize("name", ["config4", "demo"])
def test_a_step_copies_no_index_rows_from_the_host(name, tmp_path, monkeypatch):
    """After the first step, the material table's index rows and the hit
    replay's leaf kinds and parities are on the device: a step builds no
    tensor from host values in those modules (on a card each such copy is
    a host-device synchronise)."""
    from ptx_torch.core import rng
    from ptx_torch.parallel.render import make_train_step

    config = inputs.load_json("configs", name)
    config.update(TINY, images=SMALL_IMAGES if name == "config4" else config["images"])
    scene, cam, _ = _port_scene(config, 2, tmp_path)
    step = make_train_step(scene, cam, spp=1, depth=3)
    target = torch.zeros(8, 16, 3)
    params, _ = step(scene.params, target, rng.PRNGKey(0))
    watched = ("materials.py", "hitreplay.py", "bounce_kernel.py")
    made = []

    def recording(make):
        def f(*a, **kw):
            where = os.path.basename(sys._getframe(1).f_code.co_filename)
            if where in watched:
                made.append(where)
            return make(*a, **kw)
        return f

    for fn in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, fn, recording(getattr(torch, fn)))
    step(params, target, rng.PRNGKey(1))
    assert made == []


def _kernel(name, ts, dur, corr):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts - 5,
             "dur": 1, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
             "args": {"correlation": corr}}]


def test_k4_roofline_on_a_trace_worked_by_hand():
    read = harness.load_reader("k4_roofline.train")
    ctx = lambda events, units: {"summary": tracing.summarize(events), "units": units,
                                 "lanes": 48, "depth": 3, "n_leaves": 9,
                                 "root": harness.ROOT}
    # 48 lanes at depth 3, no compaction: 4 calls a step of 54 B a lane
    events = []
    for i in range(8):
        events += _kernel("void first_hit_kernel<16>(float const*)", 100 + 10 * i, 2.0, i)
    events += _kernel("index_add_kernel", 300, 50.0, 99)
    # two steps: 8 calls, 16 µs on the card, 2 · 4 · 54 · 48 B at 3.35 TB/s
    want = 100 * (2 * 4 * 54 * 48 / 3.35e12) / 16e-6
    assert read(ctx(events, 2)) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(0.0386866, rel=1e-6)
    assert read(ctx(events, 3)) is None          # not one call a bounce
    assert read(ctx([], 1)) is None              # an empty trace


def test_unfused_host_ms_on_a_snapshot_made_by_hand(monkeypatch):
    from ptx_torch.utils import profiling

    read = harness.load_reader("unfused_host_ms.train")
    span = lambda ms: {"calls": 1, "host_ms": ms, "self_ms": ms / 2, "syncs": 0, "gc_ms": 0.0}
    snap = {"units": 3, "cuda": True, "outside": {"syncs": 0, "gc_ms": 0.0},
            "spans": {"unfused_bounce": span(30.0), "replay_vjp": span(90.0),
                      "tex_hist": span(12.0), "bounce": span(40.0)},
            "counters": {"unfused_bounces": 51, "lane_bounces": 1}}
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    assert read({"units": 3}) == pytest.approx(40.0)     # (30 + 90) / 3
    monkeypatch.setattr(profiling, "snapshot", lambda: dict(snap, counters={}))
    assert read({"units": 3}) is None                    # no bounce on the route
    monkeypatch.setattr(profiling, "snapshot", lambda: dict(snap, cuda=False))
    assert read({"units": 3}) is None                    # a capture without a card
    monkeypatch.setattr(profiling, "snapshot", lambda: dict(snap, units=0, spans={}))
    assert read({"units": 3}) is None                    # an empty capture


def test_reference_runs_config4_without_the_port_or_jax(tmp_path):
    code = f"""
import json, sys, torch
sys.path.insert(0, {harness.REPO!r})
from benchmark import inputs
from benchmark.reference import scene as rscene, tracer
config = inputs.load_json("configs", "config4")
config.update(frame={{"width": 8, "height": 4}}, images={SMALL_IMAGES!r})
inputs.write_images(config, {str(tmp_path)!r})
doc = inputs.scene_doc(config, 9)
rs = rscene.parse(doc, {str(tmp_path)!r})
P = rscene.params(rs, "cpu")
_, loss, g = tracer.train_step(rs, P, torch.zeros(4, 8, 3), inputs.step_key(9, 0), 1, 2,
                               1e-4, "cpu")
print(json.dumps({{"scene": type(rs).__name__, "loss": float(loss),
                   "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=str(tmp_path), timeout=120,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["scene"] == "TexturedScene" and out["loss"] > 0
    assert not set(out["modules"]) & {"jax", "jaxlib", "flax", "ptx", "ptx_torch"}
