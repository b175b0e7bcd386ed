"""The frozen trace reading, the kernels' counts and the roofline shares on
figures worked by hand."""

import pytest

from benchmark import harness, roofline, schedule, tracing


def _trace():
    """Two layer ranges on the host; three kernels launched inside them and
    one outside; a memcpy; device busy 0-10, 12-20 and 30-34 µs."""
    ev = [
        {"cat": "user_annotation", "name": "rng_draws", "ts": 0.0, "dur": 5.0},
        {"cat": "user_annotation", "name": "bounce", "ts": 6.0, "dur": 6.0},
        {"cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 40.0},
    ]
    launches = [(1, 1.0, 0.0, 10.0, "threefry_kernel"), (2, 7.0, 12.0, 6.0,
                                                         "bounce_forward_kernel<16>"),
                (3, 8.0, 18.0, 2.0, "bounce_forward_kernel<16>"), (4, 25.0, 30.0, 3.0,
                                                                   "other_kernel")]
    for corr, host_ts, dev_ts, dur, name in launches:
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": host_ts,
                   "dur": 0.5, "args": {"correlation": corr}})
        ev.append({"cat": "kernel", "name": name, "ts": dev_ts, "dur": dur,
                   "args": {"correlation": corr}})
    ev.append({"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 33.0, "dur": 1.0})
    return ev


def test_summarize_on_a_trace_worked_by_hand():
    s = tracing.summarize(_trace())
    assert s["kernels"] == 4
    assert s["busy_ms"] == pytest.approx(22.0 / 1e3)
    assert s["host_ms"] == pytest.approx(40.0 / 1e3)
    assert s["layers"]["rng_draws"] == {"kernels": 1, "device_ms": 0.010,
                                        "host_share": 5.0 / 40.0}
    assert s["layers"]["bounce"]["kernels"] == 2
    assert s["layers"]["bounce"]["device_ms"] == pytest.approx(0.008)
    assert s["k1_calls"] == 2 and s["k1_mean_us"] == pytest.approx(4.0)
    assert s["k5_calls"] == 0


def test_breakdown_names_kernels_and_gaps():
    b = tracing.breakdown(_trace())
    assert b["device_ops"][0] == ["threefry_kernel", pytest.approx(10e-6)]
    assert [n for n, _ in b["device_ops"]] == ["threefry_kernel", "bounce_forward_kernel<16>",
                                                "other_kernel"]
    # gaps 20-30 µs (the host outside any layer) and 10-12 µs (in bounce)
    assert b["idle_gaps"] == [["outside_layers", pytest.approx(10e-6)],
                              ["bounce", pytest.approx(2e-6)]]


def test_widths_of_a_step_and_a_wavefront():
    assert schedule.widths(4_194_304, 16) == [4_194_304] * 2 + [1_398_101] * 4 + [262_144] * 11
    assert schedule.widths(65_536, 16) == [65_536] * 2 + [21_845] * 4 + [4_096] * 11
    assert schedule.widths(256, 16) == [256] * 17          # below the compaction batch
    assert schedule.widths(65_536, 4) == [65_536] * 5      # too shallow to compact


def test_counts_on_shapes_worked_by_hand():
    k1, k5 = roofline.counts("k1"), roofline.counts("k5")
    assert k1.bytes_moved(65_536) == 126 * 65_536 and k1.operations(65_536, 13) is None
    assert k5.bytes_moved(10) == 1_260 and k5.operations(10, 256) is None
    # a step's bytes bound: 126 B · Σ widths over 3.35 TB/s
    step = sum(schedule.widths(4_194_304, 16))
    assert step == 2 * 4_194_304 + 4 * 1_398_101 + 11 * 262_144
    assert 126 * step / 3.35e12 * 1e3 == pytest.approx(0.6343, abs=1e-4)


def _ctx(kernel, calls, mean_us, lanes=4_194_304, n_leaves=256, units=1):
    return {"summary": {f"{kernel}_calls": calls, f"{kernel}_mean_us": mean_us},
            "lanes": lanes, "depth": 16, "units": units, "n_leaves": n_leaves}


def test_roofline_shares():
    step = sum(schedule.widths(4_194_304, 16))
    # K1 on bytes alone: 126 B a lane over 3.35 TB/s, against 17 calls of 250 µs
    share = roofline.share("k1", _ctx("k1", 17, 250.0))
    assert share == pytest.approx(100 * 126 * step / 3.35e12 / (17 * 250e-6))
    # K5 on bytes alone too, over two steps
    share = roofline.share("k5", _ctx("k5", 34, 570.0, units=2))
    assert share == pytest.approx(100 * 2 * 126 * step / 3.35e12 / (34 * 570e-6))
    # another launch count than one a bounce reads nothing
    assert roofline.share("k1", _ctx("k1", 16, 250.0)) is None
    assert roofline.share("k5", _ctx("k5", 0, 0.0)) is None


@pytest.mark.parametrize("name,expect", [
    ("launches_per_step.train", 1_000 / 4),
    ("rng_ms.train", 2.0),
    ("bounce_bwd_ms.train", (3.0 + 1.0 + 0.5) / 4),
    ("emission_bwd_ms.train", (2.0 + 0.25) / 4),
    ("idle_share.train", 1 - (80.0 / 4) / 25.0),
])
def test_layer_readers(name, expect):
    layers = {n: {"kernels": 0, "device_ms": 0.0, "host_share": 0.0}
              for n in tracing.RANGE_NAMES}
    for n, ms in (("rng_draws", 8.0), ("bounce_bwd", 3.0), ("replay_pack", 1.0),
                  ("replay_pack_bwd", 0.5), ("emission_bwd", 2.0), ("sky_hist", 0.25)):
        layers[n]["device_ms"] = ms
    ctx = {"summary": {"kernels": 1_000, "busy_ms": 80.0, "layers": layers}, "units": 4,
           "unit_wall_ms": 25.0}
    assert harness.load_reader(name)(ctx) == pytest.approx(expect)


def test_readers_find_nothing_in_an_empty_trace():
    s = tracing.summarize([])
    ctx = {"summary": s, "units": 3, "unit_wall_ms": 10.0, "lanes": 65_536, "depth": 16,
           "n_leaves": 13}
    for m in harness.load_benchmark()["per_layer"]:
        assert harness.load_reader(m["name"])(ctx) is None, m["name"]
