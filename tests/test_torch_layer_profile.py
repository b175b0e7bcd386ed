"""The layer profile's trace parser on a small hand-made Chrome trace."""

import pytest

from ptx_torch.layer_profile import summarize


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_summarize_attributes_kernels_to_layers():
    events = [
        _x("cpu_op", "aten::add", 0.0, 1.0),
        _x("user_annotation", "rng_draws", 10.0, 30.0),
        _x("cuda_runtime", "cudaLaunchKernel", 12.0, 2.0, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 20.0, 2.0, correlation=2),
        _x("user_annotation", "bounce", 50.0, 40.0),
        _x("cuda_runtime", "cudaLaunchKernel", 60.0, 2.0, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 95.0, 5.0, correlation=4),
        # device side: two overlapping kernels, one K1, one outside any range
        _x("kernel", "threefry_add", 100.0, 10.0, correlation=1),
        _x("kernel", "threefry_xor", 105.0, 10.0, correlation=2),
        _x("kernel", "bounce_forward_kernel(float const*)", 120.0, 6.0, correlation=3),
        _x("kernel", "fill", 130.0, 4.0, correlation=4),
        _x("gpu_memset", "Memset (Device)", 140.0, 1.0, correlation=5),
    ]
    s = summarize(events, ("rng_draws", "bounce"))
    assert s["kernels"] == 4
    assert s["busy_ms"] == pytest.approx((15.0 + 6.0 + 4.0 + 1.0) / 1e3)
    assert s["host_ms"] == pytest.approx(100.0 / 1e3)
    assert s["k1_launches"] == 1 and s["k1_mean_us"] == pytest.approx(6.0)
    assert s["layers"]["rng_draws"] == pytest.approx(
        {"kernels": 2, "device_ms": 0.02, "host_share": 0.3})
    assert s["layers"]["bounce"] == pytest.approx(
        {"kernels": 1, "device_ms": 0.006, "host_share": 0.4})


def test_summarize_empty_trace():
    s = summarize([], ("bounce",))
    assert s["kernels"] == 0 and s["busy_ms"] == 0.0 and s["k1_launches"] == 0
    assert s["layers"]["bounce"]["kernels"] == 0
