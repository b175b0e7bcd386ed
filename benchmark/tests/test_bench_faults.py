"""The check must fail what it exists to catch: a run with the timed path
broken underneath reads ``correct`` false, and so does the control (the
reference computed in bfloat16 in the program's place).  At a tiny size on
the CPU; the card's readings at the cells' sizes are ``benchmark.calibrate``'s."""

import time

import pytest
import torch

from benchmark import calibrate, compare, harness, inputs
from benchmark.tests.test_bench_run import run, tiny


def _patch_train(monkeypatch, fault):
    import ptx_torch.parallel.render as pr

    real = pr.make_train_step

    def make(scene, cam, spp=16, **kw):
        if fault == "half_batch":          # half of the samples, the mean over the rest
            return real(scene, cam, spp=max(1, spp // 2), **kw)
        step = real(scene, cam, spp=spp, **kw)

        def broken(params, target, key):
            new, loss = step(params, target, key)
            if fault == "state_unchanged":
                return params, loss
            return new, loss * 1.01        # the answer altered where it is made
        return broken
    monkeypatch.setattr(pr, "make_train_step", make)


def _patch_render(monkeypatch, fault):
    import ptx_torch.integrate.render as ir

    real = ir.render_rows

    def broken(scene, params, cam, key, y0, rows, spp_chunk, n_chunks, depth):
        if fault == "half_batch":
            return real(scene, params, cam, key, y0, rows, spp_chunk, max(1, n_chunks // 2),
                        depth)
        band = real(scene, params, cam, key, y0, rows, spp_chunk, n_chunks, depth).clone()
        band[0] = 0.0                      # the answer altered where it is made
        return band
    monkeypatch.setattr(ir, "render_rows", broken)


@pytest.mark.parametrize("cell,fault", [
    ("demo.train", "state_unchanged"), ("demo.train", "half_batch"),
    ("demo.train", "answer_altered"), ("S1.train", "state_unchanged"),
    ("S1.train", "half_batch"), ("S1.train", "answer_altered"),
    ("demo.render", "half_batch"), ("demo.render", "answer_altered"),
])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    if cell.endswith("train"):
        _patch_train(monkeypatch, fault)
        overrides = dict(tiny(cell), spp=2)
    else:
        _patch_render(monkeypatch, fault)
        overrides = dict(tiny(cell), spp=4)
    out = run(cell, False, overrides=overrides)
    assert out["correct"] is False, out["checks"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell", ["demo.train", "S1.train", "demo.render"])
def test_control_in_bfloat16_fails_a_limit(cell):
    spec = harness.cell_spec(harness.load_benchmark(), cell)
    limits = inputs.load_json("limits", cell)
    ov = dict(tiny(cell), spp=2 if spec["traffic"] == "train" else 4)
    out, readings = calibrate.controls(cell, 2 ** 31 + 9, "cpu", ov)
    assert out["correct"] is True, out["checks"]
    ok, checks = compare.judge(readings["control"], limits)
    assert not ok, checks
    ok, checks = compare.judge(readings["half_batch"], limits)
    assert not ok, checks


def test_sound_runs_agree_on_another_seed():
    t = time.perf_counter()
    for cell in ("demo.train", "demo.render"):
        out = harness.run(cell, 12345, 0.2, False, "cpu", t, log=lambda m: None,
                          overrides=dict(tiny(cell), spp=2))
        assert out["correct"] is True, out["checks"]


def test_change_and_window_gaps_read_the_median_leaf():
    """One leaf a rounding step off moves only the worst leaf's gap; a
    step skipped moves every leaf, and the median with them."""
    lr = 1e-4
    p0 = {"a": torch.ones(4), "b": torch.ones(4), "c": torch.ones(4)}
    step = {k: v - 1e-3 for k, v in p0.items()}
    ref = {"losses": [1.0] * 3, "p0": p0, "p1": step, "p3": step,
           "grad_norms": {k: 1.0 for k in p0}}
    nudged = dict(step, a=step["a"] + torch.tensor([6e-8, 0.0, 0.0, 0.0]))
    prog = dict(ref, p3=nudged)
    assert compare.train_numbers(prog, ref, lr)["change_gap"] == 0.0
    skipped = dict(ref, p3={k: v.clone() for k, v in p0.items()})
    assert compare.train_numbers(skipped, ref, lr)["change_gap"] == pytest.approx(1.0)
    w_ref = {"loss": 1.0, "before": p0, "after": step, "grad_norms": ref["grad_norms"]}
    assert compare.window_numbers(dict(w_ref, after=nudged), w_ref, lr) == {
        "window_loss_gap": 0.0, "window_grad_gap": 0.0}
    w_skip = dict(w_ref, after=skipped["p3"])
    assert compare.window_numbers(w_skip, w_ref, lr)["window_grad_gap"] == pytest.approx(1.0)
