"""The port's own spans and counters (``ptx_torch.utils.profiling``), on
the CPU:

- off (no profiler), a span enters no ``record_function`` and leaves
  nothing in the recorder;
- under ``torch.profiler`` spans nest under their parents and their self
  time is the host time less their children's (a fake clock); the
  globals the recorder sets are restored when the capture stops;
- the backward's spans open inside the backward;
- every range of the benchmark's ``layer_ranges`` / ``backward_ranges``
  encloses a port span of its name, and every op inside the range lies
  inside that span;
- the filler counter on a forced-compaction wavefront against a count by
  hand; a synchronise (the CUDA warning, injected: the CPU makes none) is
  charged to the innermost span;
- the benchmark's readers of the recorder: nothing on an empty recorder,
  the right number on one filled by hand.
"""

import gc
import json
import warnings

import pytest
import torch
import torch.autograd.profiler as tprof
from torch.profiler import ProfilerActivity, profile

from ptx_torch.core import rng
from ptx_torch.integrate import render, trace
from ptx_torch.integrate.camera import Camera, sample_rays
from ptx_torch.parallel.render import make_train_step
from ptx_torch.scenes.builders import make_world
from ptx_torch.utils import profiling

torch.set_num_threads(1)
CPU = [ProfilerActivity.CPU]


@pytest.fixture(scope="module")
def scene():
    return trace.compile_scene(make_world(), "cpu")


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset()
    yield
    profiling.reset()


def _params(scene):
    return {k: ([x.clone().requires_grad_(True) for x in v] if isinstance(v, list)
                else v.clone().requires_grad_(True)) for k, v in scene.params.items()}


def _records():
    return profiling._rec.records


def test_off_enters_no_range_and_records_nothing(scene, monkeypatch):
    entered = []
    real = tprof.record_function
    monkeypatch.setattr(tprof, "record_function",
                        lambda *a, **k: entered.append(a) or real(*a, **k))
    callbacks, show = list(gc.callbacks), warnings.showwarning
    step = make_train_step(scene, Camera.reference_demo(8, 6), spp=1, depth=3)
    step(scene.params, torch.zeros(6, 8, 3), rng.PRNGKey(0))
    with profiling.span("bounce"):
        pass
    profiling.count("lane_bounces", 5)
    profiling.count_fillers(4, 2, torch.tensor(1))
    assert entered == [] and profiling.span("bounce") is profiling.span("camera")
    assert profiling._rec is None
    assert profiling.snapshot() == {"units": 0, "cuda": False, "spans": {},
                                    "outside": {"syncs": 0, "gc_ms": 0.0}, "counters": {}}
    assert gc.callbacks == callbacks and warnings.showwarning is show


class _Clock:
    """``time`` for the recorder: each read 10 ms after the last."""

    def __init__(self):
        self.t = 0

    def perf_counter_ns(self):
        self.t += 10_000_000
        return self.t


def test_spans_nest_and_self_time_by_hand(monkeypatch):
    monkeypatch.setattr(profiling, "time", _Clock())
    gc.disable()
    try:
        stop, callbacks = tprof._run_on_profiler_stop, list(gc.callbacks)
        with profile(activities=CPU) as prof:
            with profiling.span("train_step"):             # t 10 .. 80
                with profiling.span("forward"):            # t 20 .. 50
                    with profiling.span("camera"):         # t 30 .. 40
                        pass
                with profiling.span("update"):             # t 60 .. 70
                    assert warnings.showwarning is not None
                    assert tprof._run_on_profiler_stop is not stop
            with profiling.span("train_step"):             # a second unit
                pass
        assert tprof._run_on_profiler_stop is stop and gc.callbacks == callbacks
    finally:
        gc.enable()
    names = [r[0] for r in _records()]
    parents = [None if r[1] is None else names[r[1]] for r in _records()]
    assert names == ["train_step", "forward", "camera", "update", "train_step"]
    assert parents == [None, "train_step", "forward", "train_step", None]
    assert [r[2] for r in _records()] == [0, 0, 0, 0, 1]
    s = profiling.snapshot()
    assert s["units"] == 2 and s["cuda"] is False
    sp = s["spans"]
    # train_step: 70 ms and 10 ms; its children forward 30 and update 10
    assert sp["train_step"] == {"calls": 2, "host_ms": 80.0, "self_ms": 40.0,
                                "syncs": 0, "gc_ms": 0.0}
    assert sp["forward"]["host_ms"] == 30.0 and sp["forward"]["self_ms"] == 20.0
    assert sp["camera"]["self_ms"] == sp["update"]["self_ms"] == 10.0
    # the capture holds them as ranges, each inside its parent
    ev = {e.name: e for e in prof.events() if e.name in ("forward", "camera")}
    assert ev["forward"].time_range.start <= ev["camera"].time_range.start
    assert ev["camera"].time_range.end <= ev["forward"].time_range.end
    # reading clears nothing; reset does
    assert profiling.snapshot() == s
    profiling.reset()
    assert profiling.snapshot()["units"] == 0


def test_backward_spans_open_in_the_backward(scene):
    step = make_train_step(scene, Camera.reference_demo(16, 12), spp=1, depth=8,
                           compact=True)
    with profile(activities=CPU):
        step(scene.params, torch.zeros(12, 16, 3), rng.PRNGKey(0))
    recs = _records()
    names = [r[0] for r in recs]
    assert set(profiling.BACKWARD_SPANS) <= set(names)

    def ancestors(i):
        while recs[i][1] is not None:
            i = recs[i][1]
            yield recs[i][0]
    for i, n in enumerate(names):
        if n in profiling.BACKWARD_SPANS:
            assert "backward" in ancestors(i), n
    s = profiling.snapshot()
    assert s["units"] == 1 and set(s["spans"]) == set(profiling.SPANS) - {"render_rows"}


def _annotations(prof, path):
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    return ([e for e in ev if e.get("cat") == "user_annotation"],
            [e for e in ev if e.get("cat") == "cpu_op"])


def _inside(a, b):
    return (a.get("tid") == b.get("tid") and b["ts"] <= a["ts"]
            and a["ts"] + a["dur"] <= b["ts"] + b["dur"])


def test_every_benchmark_range_encloses_the_port_span_of_its_name(scene, tmp_path):
    """A train step under both benchmark wrappers and a band under its
    layer ranges: each benchmark range holds one port span of its name,
    and every op the range holds lies inside that span."""
    from benchmark import tracing

    cam = Camera.reference_demo(16, 12)
    step = make_train_step(scene, cam, spp=1, depth=8, compact=True)
    target = torch.zeros(12, 16, 3)

    def work():
        step(scene.params, target, rng.PRNGKey(0))

    def band():
        with torch.no_grad():
            render.render_rows(scene, scene.params, cam, rng.PRNGKey(1), 0, 12, 1, 1, 8)

    with profile(activities=CPU) as alone:
        work()
        band()
    port, _ = _annotations(alone, tmp_path / "alone.json")
    with tracing.layer_ranges():
        with tracing.backward_ranges(), profile(activities=CPU) as both:
            work()
        with profile(activities=CPU) as both_band:
            band()
    ranges, ops = _annotations(both, tmp_path / "both.json")
    more, more_ops = _annotations(both_band, tmp_path / "both_band.json")
    ranges, ops = ranges + more, ops + more_ops
    checked = 0
    for name in tracing.RANGE_NAMES:
        mine = [e for e in ranges if e["name"] == name]
        n_bench = len(mine) - sum(e["name"] == name for e in port)
        assert n_bench > 0, name
        outer = [e for e in mine if any(o is not e and _inside(o, e) for o in mine)]
        assert len(outer) == n_bench, name
        for b in outer:
            inner = [o for o in mine if o is not b and _inside(o, b)]
            assert len(inner) == 1, name
            held = [op for op in ops if _inside(op, b)]
            assert all(_inside(op, inner[0]) for op in held), name
            checked += len(held)
    assert checked > 1000


def test_filler_counter_against_a_count_by_hand(scene, monkeypatch):
    calls = []
    compact = trace._compact_wavefront

    def spy(carry, orig, cap, key=None, bounces=1):
        calls.append((cap, bounces, int(carry[4].sum())))
        return compact(carry, orig, cap, key=key, bounces=bounces)
    monkeypatch.setattr(trace, "_compact_wavefront", spy)
    o, d = sample_rays(Camera.reference_demo(16, 6), rng.PRNGKey(3), range(6), range(16), 1,
                       "cpu")
    with torch.no_grad(), profile(activities=CPU):
        trace.trace_rays(scene, scene.params, o, d, rng.PRNGKey(3), 8, compact=True)
    # B = 96 at depth 8: bounces 0-1 at 96 lanes, 2-5 at 96 // 3, 6-8 at 96 // 16
    assert [(c, b) for c, b, _ in calls] == [(32, 4), (6, 3)]
    c = profiling.snapshot()["counters"]
    assert c["lane_bounces"] == 96 * 2 + 32 * 4 + 6 * 3
    assert c["filler_lane_bounces"] == sum((cap - min(n, cap)) * b for cap, b, n in calls)
    assert c["filler_lane_bounces"] > 0


def test_a_sync_is_charged_to_the_innermost_span():
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        with profile(activities=CPU):
            with profiling.span("train_step"):
                with profiling.span("rng_draws"):
                    warnings.warn(profiling.SYNC_WARNING, UserWarning)
                    warnings.warn(profiling.SYNC_WARNING, UserWarning)
                warnings.warn(profiling.SYNC_WARNING + " (Triggered internally)", UserWarning)
                warnings.warn("something else", UserWarning)
            warnings.warn(profiling.SYNC_WARNING, UserWarning)
        warnings.warn(profiling.SYNC_WARNING, UserWarning)     # after the capture: shown
    s = profiling.snapshot()
    assert s["spans"]["rng_draws"]["syncs"] == 2 and s["spans"]["train_step"]["syncs"] == 1
    assert s["outside"]["syncs"] == 1
    assert [str(w.message) for w in shown] == ["something else", profiling.SYNC_WARNING]


def _ctx(units):
    from benchmark import tracing
    return {"summary": tracing.summarize([]), "units": units, "unit_wall_ms": 10.0,
            "lanes": 65_536, "depth": 16, "n_leaves": 13}


READERS = ("syncs_per_step.train", "syncs_per_wavefront.render", "filler_share.train",
           "filler_share.render", "rng_host_ms.render")


@pytest.mark.parametrize("name", READERS)
def test_recorder_readers(name, monkeypatch):
    from benchmark import harness

    read = harness.load_reader(name)
    assert read(_ctx(4)) is None                # empty recorder
    monkeypatch.setattr(profiling, "time", _Clock())
    gc.disable()
    try:
        with profile(activities=CPU):
            for alive in (3, 7):
                with profiling.span("render_rows"):
                    with profiling.span("rng_draws"):       # 10 ms
                        warnings.warn(profiling.SYNC_WARNING, UserWarning)
                    profiling.count("lane_bounces", 40)
                    profiling.count_fillers(8, 2, torch.tensor(alive))
                    with profiling.span("camera"):
                        warnings.warn(profiling.SYNC_WARNING, UserWarning)
                        warnings.warn(profiling.SYNC_WARNING, UserWarning)
            warnings.warn(profiling.SYNC_WARNING, UserWarning)     # outside: not read
    finally:
        gc.enable()
    assert read(_ctx(4)) is None                # the CPU counts no synchronise
    profiling._rec.cuda = True
    want = {"syncs_per_step.train": 6 / 4, "syncs_per_wavefront.render": 6 / 4,
            "filler_share.train": ((8 - 3) * 2 + (8 - 7) * 2) / 80,
            "filler_share.render": ((8 - 3) * 2 + (8 - 7) * 2) / 80,
            "rng_host_ms.render": 20.0 / 4}[name]
    assert read(_ctx(4)) == pytest.approx(want)
    monkeypatch.delattr(profiling, "snapshot")  # a program without the recorder
    assert read(_ctx(4)) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA's sync debug mode counts the synchronises")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_item_counts_one_and_a_launch_none(card):
    x = torch.ones(4096, device=card)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as shown, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        warnings.simplefilter("always")
        with profiling.span("train_step"):
            with profiling.span("bounce"):
                y = x * 2.0 + 1.0                              # launches only
            with profiling.span("rng_draws"):
                assert y.sum().item() == 3 * 4096              # one synchronise
            with profiling.span("camera"):
                torch.tensor([1.0, 2.0], device=card)          # a pageable copy
        float(y[0])                                            # outside every span
    s = profiling.snapshot()
    assert s["cuda"] is True and s["units"] == 1
    sp = s["spans"]
    assert (sp["bounce"]["syncs"], sp["rng_draws"]["syncs"], sp["camera"]["syncs"],
            sp["train_step"]["syncs"]) == (0, 1, 1, 0)
    assert s["outside"]["syncs"] >= 1
    assert torch.cuda.get_sync_debug_mode() == mode
    assert not [w for w in shown if "ynchroniz" in str(w.message)]


class _SyncInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2.0

    @staticmethod
    def backward(ctx, g):
        assert g.sum().item() != 0.0                          # a synchronise
        return g * 2.0


@pytest.mark.cuda
def test_card_backward_sync_is_charged_to_the_backward_span(card):
    x = torch.ones(1024, device=card, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profiling.span("train_step"):
            with profiling.span("forward"):
                y = _SyncInBackward.apply(x).sum()
            with profiling.span("backward"):
                torch.autograd.grad(y, x)
    sp = profiling.snapshot()["spans"]
    assert sp["forward"]["syncs"] == 0 and sp["backward"]["syncs"] >= 1
