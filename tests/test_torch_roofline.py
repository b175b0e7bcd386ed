"""The roofline kernels K10 and K11 and ``python -m ptx_torch.roofline`` on
the CPU.

K10's plain version (``fma_chain_reference``, what its wrapper runs on CPU
tensors) against the Pallas kernel of ``tools/roofline.py:62-76``, rebuilt
here with the same body and ``BlockSpec``s (the tool's closure cannot be
imported) and run with ``interpret=True``, at GRID 2, ROWS 8, K 256, R 2,
c 1e-3, on x uniform in [0.25, 0.5] from a numpy seed: both within 1e-5
relative of a float64 chain and of each other.  They need not be equal:
XLA on the CPU contracts some of the multiplies and adds into fused ones
(91 % of the elements come out equal), the port never does.  K11's plain
version against the interpreted copy of ``tools/roofline.py:124-125``, bit
for bit.  The CUDA kernels are held against the same plain versions on
the card, bit for bit (tests/test_torch_kernel_cuda.py, chip_smoke.py path
I).  Then every measurement of ``ptx_torch.roofline`` runs on the CPU at a
tiny size: each line's documented fields, and the plain calls the card's
run turns into launches (chip_smoke.py path I holds them exactly).
"""

import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ptx_torch import roofline
from ptx_torch.ops import bounce_kernel, fasthit_kernel, roofline_kernel

torch.set_num_threads(1)

GRID, ROWS, K, R, C = 2, 8, 256, 2, 1e-3


def _pallas_chain(x):
    """``tools/roofline.py:62-76`` with c a parameter: R passes of K
    unrolled steps in a ``fori_loop``, (ROWS, 128) blocks in VMEM."""
    def kernel(x_ref, o_ref):
        def body(_, v):
            c = jnp.float32(C)
            for _i in range(K):
                v = v + v * v * c
            return v
        o_ref[...] = jax.lax.fori_loop(0, R, body, x_ref[...])

    return np.asarray(pl.pallas_call(
        kernel, grid=(GRID,),
        in_specs=[pl.BlockSpec((ROWS, 128), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((ROWS, 128), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((GRID * ROWS, 128), jnp.float32),
        interpret=True)(x))


def _pallas_copy(x, rows):
    """``tools/roofline.py:124-134``: ``o = x + 1`` in (rows, lanes) blocks."""
    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1.0

    lanes = x.shape[1]
    return np.asarray(pl.pallas_call(
        kernel, grid=(x.shape[0] // rows,),
        in_specs=[pl.BlockSpec((rows, lanes), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((rows, lanes), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32), interpret=True)(x))


def test_k10_plain_version_matches_the_pallas_kernel():
    x = np.random.default_rng(14).uniform(0.25, 0.5, (GRID * ROWS, 128)).astype(np.float32)
    want = _pallas_chain(x)
    got = roofline_kernel.fma_chain_reference(torch.from_numpy(x), R, C).numpy()
    x64 = x.astype(np.float64)
    for _ in range(R * K):
        x64 = x64 + x64 * x64 * C
    assert np.abs(x64 / x - 1).min() > 0.05          # the chain moved every element
    for name, v in (("pallas", want), ("port", got)):
        np.testing.assert_allclose(v, x64, rtol=1e-5, atol=0, err_msg=name)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_k11_plain_version_matches_the_pallas_copy():
    x = np.random.default_rng(15).standard_normal((4 * ROWS, 1024)).astype(np.float32)
    want = _pallas_copy(x, ROWS)
    got = roofline_kernel.copy_plus_one_reference(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrappers_run_the_plain_version_on_cpu_tensors_only():
    """On a CPU tensor each wrapper runs its plain version (into ``out``
    where given) and launches nothing; a tensor on another device that is
    not CUDA raises."""
    x = torch.from_numpy(np.random.default_rng(16).uniform(0.25, 0.5, (3, 37))
                         .astype(np.float32))
    calls, launches = roofline_kernel.REFERENCE_CALLS, (roofline_kernel.FMA_LAUNCHES,
                                                        roofline_kernel.COPY_LAUNCHES)
    out = torch.empty_like(x)
    assert roofline_kernel.fma_chain(x, 1, C, out=out) is out
    assert torch.equal(out, roofline_kernel.fma_chain_reference(x, 1, C))
    assert torch.equal(roofline_kernel.copy_plus_one(x), x + 1)
    assert roofline_kernel.REFERENCE_CALLS == calls + 2
    meta = torch.empty((4, 4), device="meta")
    for fn in (lambda: roofline_kernel.fma_chain(meta, 1),
               lambda: roofline_kernel.copy_plus_one(meta)):
        with pytest.raises(ValueError, match="no kernel for meta"):
            fn()
    assert (roofline_kernel.FMA_LAUNCHES, roofline_kernel.COPY_LAUNCHES) == launches


def test_op_model_reads_3536_on_the_demo():
    """The tool's model at the demo's 13 leaves and its hard-coded 14 tape
    nodes (``tools/roofline.py:197-199``)."""
    from ptx_torch.geom.fasthit import collect_leaves
    from ptx_torch.integrate.trace import compile_scene
    from ptx_torch.scenes.builders import make_world

    L = len(collect_leaves(compile_scene(make_world(), "cpu").plan))
    assert L == 13
    assert roofline.hit_ops_per_ray(L) == 3536


# every measure at a tiny size, and the plain calls that become launches on the card
TINY = {"fp32_chain": dict(rows=8, lanes=128, r1=1, r2=3),
        "hbm_torch_loop": dict(numel=1 << 16, r1=2, r2=8),
        "hbm_copy_kernel": dict(rows=64, lanes=256, r1=2, r2=8),
        "tensor_bf16_matmul": dict(n=64, r1=2, r2=8),
        "hit_kernel": dict(rows=4, width=16, r1=1, r2=4),
        "trace_forward": dict(rows=2, width=16, depth=2, iters=2)}
COMMON = ("measure", "device", "card")
FIELDS = {
    "fp32_chain": ("kernel", "fp32_ops_per_s", "fp32_tops_per_s", "share_of_unfused_peak",
                   "share_of_published_peak", "d_r1_ms", "d_r3_ms", "clocks"),
    "hbm_torch_loop": ("hbm_bytes_per_s", "hbm_gb_per_s", "share_of_published_peak",
                       "d_r2_ms", "d_r8_ms", "clocks"),
    "hbm_copy_kernel": ("kernel", "hbm_bytes_per_s", "hbm_gb_per_s",
                        "share_of_published_peak", "d_r2_ms", "d_r8_ms", "clocks"),
    "tensor_bf16_matmul": ("bf16_flops_per_s", "bf16_tflops_per_s", "share_of_published_peak",
                           "bounds", "d_r2_ms", "d_r8_ms", "clocks"),
    "hit_kernel": ("B", "L", "seconds_per_call", "rays_per_s", "analytic_ops_per_ray",
                   "ops_per_s", "bytes_per_ray", "bytes_per_s", "share_of_published_fp32",
                   "share_of_fp32_chain", "hbm_share", "d_r1_ms", "d_r4_ms",
                   "launch_queued_seconds"),
    "trace_forward": ("B", "depth", "compact", "seconds", "segments_per_s",
                      "hit_kernel_fraction_at_full_width"),
}


@pytest.fixture(scope="module")
def cpu_run():
    before = (roofline_kernel.REFERENCE_CALLS, fasthit_kernel.REFERENCE_CALLS,
              bounce_kernel.REFERENCE_CALLS)
    lines = list(roofline.run("cpu", TINY))
    after = (roofline_kernel.REFERENCE_CALLS, fasthit_kernel.REFERENCE_CALLS,
             bounce_kernel.REFERENCE_CALLS)
    return lines, [a - b for a, b in zip(after, before)]


@pytest.mark.parametrize("i,name", list(enumerate(
    ["fp32_chain", "hbm_torch_loop", "hbm_copy_kernel", "tensor_bf16_matmul", "hit_kernel",
     "trace_forward", "trace_forward"])), ids=lambda v: str(v))
def test_each_measure_prints_its_fields_on_the_cpu(cpu_run, i, name):
    line = cpu_run[0][i]
    assert line["measure"] == name
    assert line["device"] == "cpu"
    for key in COMMON + FIELDS[name]:
        assert key in line, key
    for key, v in line.items():
        if isinstance(v, float):
            assert math.isfinite(v) and v > 0, key
    if name == "hit_kernel":
        assert (line["B"], line["L"], line["analytic_ops_per_ray"]) == (64, 13, 3536)
    if name == "trace_forward":
        assert line["compact"] == (i == 6) and line["B"] == 32


def test_the_run_calls_each_plain_version_as_often_as_the_card_launches(cpu_run):
    """K10 once a window (its R loop is inside the kernel), K11 and K4 once
    an R; K1 once a bounce of each forward and its warm-up."""
    lines, (k10_k11, k4, k1) = cpu_run
    assert len(lines) == 7
    windows = 1 + roofline.REPS
    fp, cp, hk, tf = (TINY[k] for k in ("fp32_chain", "hbm_copy_kernel", "hit_kernel",
                                         "trace_forward"))
    assert k10_k11 == 2 * windows + (cp["r1"] + cp["r2"]) * windows
    assert k4 == (hk["r1"] + hk["r2"]) * windows
    assert k1 == 2 * (tf["iters"] + 1) * (tf["depth"] + 1)


def test_main_without_a_card_exits_with_a_message(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert roofline.main([]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_a_slope_that_is_not_positive_raises():
    with pytest.raises(RuntimeError, match="no positive slope"):
        roofline._slope(torch.device("cpu"), lambda r: time.sleep(0.002 * (3 - r)), 1, 2)


def test_clock_sampler_measures_nothing_on_the_cpu():
    with roofline.ClockSampler("cpu") as clocks:
        pass
    assert clocks.summary() == {"clocks": "not measured"}
