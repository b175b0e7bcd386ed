"""One run of one cell: set-up, the measured window, the traced segment,
the check, and the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration is ``benchmark/configs/<config>.json``, its mix
``benchmark/traffic/<traffic>.json`` (whose ``kind`` names its driver,
``benchmark/kinds/<kind>.py``), its limits ``benchmark/limits/<cell>.json``,
and each per-layer metric ``benchmark/metrics/<metric>.py``.  Adding a
cell, a configuration, a mix, a kind of mix or a metric is adding files
and entries.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import sys
import tempfile
import time

from benchmark import compare, inputs, load_module, tracing

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "ptx")
GIB = float(2 ** 30)


def load_benchmark(path=None) -> dict:
    with open(path or os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str, e2e: set) -> bool:
    """Whether ``metric`` is reported in ``cell`` (whose end-to-end metric
    names are ``e2e``)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e


def load_reader(name: str, root: str = ROOT):
    return load_module("metrics", name, root).read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _finite(x):
    return x if math.isfinite(x) else 1e308


def _device(dev):
    import torch

    if dev.type != "cuda":
        return {"platform": dev.type, "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run(cell: str, seed: int, seconds: float, trace: bool, device, t_start: float,
        bench: dict | None = None, overrides: dict | None = None, log=None,
        root: str = ROOT, hook=None) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's
    object.  ``t_start`` is the process's start on ``time.perf_counter``.
    The tests' hooks: ``overrides`` replaces keys of the configuration and
    the mix, ``bench`` stands for the contents of ``BENCHMARK.json``, and
    ``root`` for the benchmark's folder the files are found in;
    :mod:`benchmark.calibrate`'s: ``hook`` is called with the driver once
    its run is checked."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = bench or load_benchmark()
    spec = cell_spec(bench, cell)
    config = inputs.load_json("configs", spec["config"], root)
    traffic = inputs.load_json("traffic", spec["traffic"], root)
    limits = inputs.load_json("limits", cell, root)
    for k, v in (overrides or {}).items():
        (config if k in config else traffic)[k] = v
    device = torch.device(device)
    workdir = tempfile.mkdtemp(prefix="bench-", dir=os.environ.get("TMPDIR"))
    try:
        drv = load_module("kinds", traffic["kind"], root).Driver(config, traffic, seed, device, workdir, root)
        drv.setup()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s; window {seconds} s")
        win = drv.window(seconds)
        u = sorted(win["unit_s"])
        log(f"window: {len(u)} {drv.unit_name}s, seconds each min {u[0]:.4f} median "
            f"{u[len(u) // 2]:.4f} max {u[-1]:.4f}")
        e2e = dict(win["metrics"], setup_s=setup_s)
        dev_info = _device(device)
        e2e["peak_mem_gib"] = dev_info["memory_peak_bytes"] / GIB
        e2e_names = {m["name"] for m in bench["end_to_end"] if applies(m, cell, set())}
        metrics = {}
        if not trace:
            for m in bench["end_to_end"]:
                if m["name"] in e2e_names:
                    metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        else:
            ctx, brk, busy, window_s = _traced(drv, device, workdir)
            ctx.update(lanes=drv.lanes, depth=drv.depth, unit_wall_ms=drv.unit_wall_ms,
                       n_leaves=len(drv.ref_scene().leaves), root=root)
            for m in bench["per_layer"]:
                if applies(m, cell, e2e_names):
                    v = load_reader(m["name"], root)(ctx)
                    if v is not None:
                        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            dev_info.update(busy_s=busy, window_s=window_s)
        drv.release()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        numbers = drv.check()
        log(f"reference check {time.perf_counter() - t0:.3f} s")
        if hook is not None:
            hook(drv)
        ok, checks = compare.judge(numbers, limits)
        out = {"correct": ok and win["failed"] == 0 and win["attempted"] > 0,
               "attempted": win["attempted"], "failed": win["failed"], "metrics": metrics,
               "device": dev_info}
        if trace:
            out["breakdown"] = brk
        out["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                         for k, v in checks.items()}
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _traced(drv, device, workdir):
    """Profile a segment of the driver's units under the layer ranges;
    returns the readers' context, the breakdown, device busy seconds and
    the segment's wall seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                     else [])
    path = os.path.join(workdir, "trace.json")
    drv.before_profile()
    grad = tracing.backward_ranges() if drv.grad else contextlib.nullcontext()
    with tracing.layer_ranges(), grad:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            units = drv.profile_units()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    summary = tracing.summarize(events)
    return ({"summary": summary, "units": units}, tracing.breakdown(events),
            summary["busy_ms"] / 1e3, window_s)
