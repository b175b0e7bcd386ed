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
    assert s["k1_calls"] == 1 and s["k1_mean_us"] == pytest.approx(6.0)
    assert s["layers"]["rng_draws"] == pytest.approx(
        {"kernels": 2, "device_ms": 0.02, "host_share": 0.3})
    assert s["layers"]["bounce"] == pytest.approx(
        {"kernels": 1, "device_ms": 0.006, "host_share": 0.4})
    assert s["top"][0] == {"name": "threefry_add", "calls": 1, "device_ms": 0.01}
    assert [t["name"] for t in s["top"]][1:3] == ["threefry_xor",
                                                 "bounce_forward_kernel(float const*)"]


def test_summarize_empty_trace():
    s = summarize([], ("bounce",))
    assert s["kernels"] == 0 and s["busy_ms"] == 0.0 and s["k1_calls"] == 0
    assert all(s[f"k{i}_calls"] == 0 for i in range(1, 10))
    assert s["layers"]["bounce"]["kernels"] == 0


def test_summarize_backward_ranges_and_kernels():
    """The --grad mode's ranges (opened in autograd hooks) attribute the
    backward's launches (the packing's VJP among them), and K2 / K3 are
    counted by name: a K2 call is its two launches."""
    from ptx_torch.layer_profile import GRAD_LAYERS, SKY_HIST

    names = tuple(g for *_, g in GRAD_LAYERS) + (SKY_HIST,)
    assert names == ("replay_pack_bwd", "bounce_bwd", "compaction_bwd", "emission_bwd",
                     "sky_hist")
    events = [
        _x("user_annotation", "replay_pack_bwd", 60.0, 10.0),
        _x("cuda_runtime", "cudaLaunchKernel", 62.0, 1.0, correlation=5),
        _x("kernel", "index_add_kernel", 140.0, 3.0, correlation=5),
        _x("user_annotation", "bounce_bwd", 0.0, 20.0),
        _x("cuda_runtime", "cudaLaunchKernel", 5.0, 1.0, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 8.0, 1.0, correlation=2),
        _x("user_annotation", "sky_hist", 30.0, 10.0),
        _x("cuda_runtime", "cudaLaunchKernel", 32.0, 1.0, correlation=3),
        _x("user_annotation", "compaction_bwd", 50.0, 10.0),
        _x("cuda_runtime", "cudaLaunchKernel", 52.0, 1.0, correlation=4),
        _x("kernel", "bounce_bwd_kernel(float const*)", 100.0, 8.0, correlation=1),
        _x("kernel", "reduce_partials_kernel(float const*)", 110.0, 2.0, correlation=2),
        _x("kernel", "hist_shared_kernel(long const*)", 120.0, 4.0, correlation=3),
        _x("kernel", "index_elementwise", 130.0, 1.0, correlation=4),
    ]
    s = summarize(events, names)
    assert s["k2_calls"] == 1 and s["k2_mean_us"] == pytest.approx(10.0)
    assert s["k3_calls"] == 1 and s["k3_mean_us"] == pytest.approx(4.0)
    assert s["k1_calls"] == 0
    assert s["layers"]["bounce_bwd"]["kernels"] == 2
    assert s["layers"]["bounce_bwd"]["device_ms"] == pytest.approx(0.010)
    assert s["layers"]["sky_hist"]["kernels"] == 1
    assert s["layers"]["compaction_bwd"]["kernels"] == 1
    assert s["layers"]["replay_pack_bwd"]["kernels"] == 1
    assert s["layers"]["replay_pack_bwd"]["device_ms"] == pytest.approx(0.003)
    assert s["layers"]["emission_bwd"] == {"kernels": 0, "device_ms": 0.0,
                                           "host_share": 0.0}


def test_backward_ranges_tag_the_layers_nodes():
    """On the CPU: a forward + backward under the --grad hooks opens each
    backward range, and removes its wrappers afterwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ptx_torch.core import rng
    from ptx_torch.integrate import trace
    from ptx_torch.integrate.camera import Camera, sample_rays
    from ptx_torch.layer_profile import _backward_ranges
    from ptx_torch.scenes.builders import make_world

    torch.set_num_threads(1)
    scene = trace.compile_scene(make_world(), "cpu")
    o, d = sample_rays(Camera.reference_demo(8, 6), rng.PRNGKey(0), range(6),
                       range(8), 1, "cpu")
    params = {k: ([x.clone().requires_grad_(True) for x in v] if isinstance(v, list)
                  else v.clone().requires_grad_(True)) for k, v in scene.params.items()}
    before = trace._bounce
    with _backward_ranges(), profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.trace_rays(scene, params, o, d, rng.PRNGKey(0), 3, compact=False).mean().backward()
    assert trace._bounce is before
    names = {e.name for e in prof.events()}
    assert {"replay_pack_bwd", "bounce_bwd", "emission_bwd", "sky_hist"} <= names


def test_summarize_counts_the_large_scene_kernels_apart_from_k2():
    """K5, K6 and K9 are counted by their own names: K6's two launches (the
    replay and its reduction) apart from K2's."""
    events = [
        _x("kernel", "(anonymous namespace)::megasweep_kernel(Args)", 0.0, 8.0),
        _x("kernel", "(anonymous namespace)::replay_bwd_kernel(float const*)", 10.0, 6.0),
        _x("kernel", "(anonymous namespace)::replay_bwd_reduce_kernel(float const*)", 20.0,
           2.0),
        _x("kernel", "(anonymous namespace)::bounce_bwd_kernel(float const*)", 30.0, 3.0),
        _x("kernel", "(anonymous namespace)::reduce_partials_kernel(float const*)", 40.0, 1.0),
        _x("kernel", "(anonymous namespace)::sweep_select_kernel(float const*)", 50.0, 5.0),
    ]
    s = summarize(events, ())
    assert s["k9_calls"] == 1 and s["k9_mean_us"] == pytest.approx(5.0)
    assert s["k5_calls"] == 1 and s["k5_mean_us"] == pytest.approx(8.0)
    assert s["k6_calls"] == 1 and s["k6_mean_us"] == pytest.approx(8.0)
    assert s["k2_calls"] == 1 and s["k2_mean_us"] == pytest.approx(4.0)


def test_layer_profile_runs_a_large_scene_on_the_cpu(tmp_path, capsys):
    """The S2 gadget scene (268 leaves) forward and backward at 16²: the
    rehearsal of the card's profile (no device figures on the CPU)."""
    import json

    from ptx_torch.layer_profile import main

    assert main(["--device", "cpu", "--size", "16", "--chunks", "1", "--large", "S2",
                 "--grad", "--out", str(tmp_path)]) == 0
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s["scene"] == "S2" and s["peak_gib"] is None and s["rays_per_chunk"] == 16 * 16
    assert s["layers"]["bounce"]["host_share"] > 0
    assert (tmp_path / "trace_S2_grad.json").exists()
