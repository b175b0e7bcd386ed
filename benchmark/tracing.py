"""Layer spans and the reading of a Chrome trace, for the traced run.

Frozen copy of ``ptx_torch/layer_profile.py`` at commit 4da45c6:
``LAYERS`` / ``GRAD_LAYERS`` (the port's functions each layer range
wraps), ``_layer_ranges`` (a ``record_function`` range around each call),
``_backward_ranges`` (hooks on the autograd nodes a layer's call creates,
so that their backward runs inside a range of the layer's backward name),
and ``summarize`` (kernels matched to host ranges by correlation id,
device busy as the union of kernel, memcpy and memset intervals).  The
ranges wrap private functions of the port, so they live here, in the
benchmark, until the port records its own spans.  :func:`breakdown` is
new: the kernels that took the most device time, and the longest device
idle gaps named by the layer range the host was in.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib

LAYERS = (                      # (range name, module, function)
    ("camera", "ptx_torch.integrate.render", "sample_rays"),
    ("rng_draws", "ptx_torch.integrate.trace", "_phase_uniforms"),
    ("replay_pack", "ptx_torch.integrate.trace", "_replay_pack"),
    ("bounce", "ptx_torch.integrate.trace", "_bounce"),
    ("compaction", "ptx_torch.integrate.trace", "_compact_wavefront"),
    ("emission", "ptx_torch.integrate.trace", "_emission"),
)
GRAD_LAYERS = (                 # (range name, module, function, its backward range)
    ("replay_pack", "ptx_torch.integrate.trace", "_replay_pack", "replay_pack_bwd"),
    ("bounce", "ptx_torch.integrate.trace", "_bounce", "bounce_bwd"),
    ("compaction", "ptx_torch.integrate.trace", "_compact_wavefront", "compaction_bwd"),
    ("emission", "ptx_torch.integrate.trace", "_emission", "emission_bwd"),
)
SKY_HIST = "sky_hist"           # the image gather's backward node, inside emission
RANGE_NAMES = (tuple(n for n, _, _ in LAYERS) + tuple(g for *_, g in GRAD_LAYERS)
               + (SKY_HIST,))
# per kernel: the names of the launch that starts a call, and of the launch
# that follows it in the same call, if any
KERNELS = {"k1": (("bounce_forward_kernel",), None),
           "k2": (("bounce_bwd_kernel",), "reduce_partials_kernel"),
           "k3": (("hist_direct_kernel", "hist_private_kernel"), None),
           "k4": (("first_hit_kernel",), None),
           "k5": (("megasweep_kernel",), None),
           "k6": (("replay_bwd_kernel",), "reduce_partials_kernel"),
           "k7": (("emission_forward_kernel",), None),
           "k7_bwd": (("emission_backward_kernel",), None),
           "k8": (("hist_atomic_kernel",), None),
           "k9": (("sweep_select_kernel", "sweep_sort_select_kernel"), None)}
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def summarize(events, layers=RANGE_NAMES):
    """The layer figures of a Chrome trace's ``traceEvents``: ``kernels``
    (launches), ``busy_ms`` (device), ``host_ms`` (profiled host wall),
    ``<k>_calls`` and ``<k>_mean_us`` for each of ``KERNELS``, and per
    layer ``kernels``, ``device_ms`` and ``host_share``."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"] in layers)
    starts = [r[0] for r in ranges]
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime",
                                                  "user_annotation")]
    host_us = (max(e["ts"] + e["dur"] for e in host) - min(e["ts"] for e in host)
               if host else 0.0)

    per = {n: {"kernels": 0, "device_ms": 0.0, "host_share": 0.0} for n in layers}
    for a, b, name in ranges:
        per[name]["host_share"] += (b - a) / host_us
    for k in kernels:
        ts = launch_ts.get(k["args"].get("correlation"))
        i = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
        if i >= 0 and ts <= ranges[i][1]:
            per[ranges[i][2]]["kernels"] += 1
            per[ranges[i][2]]["device_ms"] += k["dur"] / 1e3
    out = {"kernels": len(kernels),
           "busy_ms": _union_us((e["ts"], e["ts"] + e["dur"]) for e in device) / 1e3,
           "host_ms": host_us / 1e3}
    ordered = sorted(kernels, key=lambda k: k["ts"])
    for tag, (starts_call, follower) in KERNELS.items():
        calls, dur, second = 0, 0.0, 0.0
        for i, k in enumerate(ordered):
            if any(n in k["name"] for n in starts_call):
                calls, dur = calls + 1, dur + k["dur"]
                nxt = ordered[i + 1] if i + 1 < len(ordered) else None
                if follower and nxt is not None and follower in nxt["name"]:
                    second += nxt["dur"]
        out[f"{tag}_calls"] = calls
        out[f"{tag}_mean_us"] = (dur + second) / calls if calls else 0.0
    out["layers"] = per
    return out


def breakdown(events, layers=RANGE_NAMES, top=TOP):
    """``{"device_ops": [[kernel, seconds]], "idle_gaps": [[what the host
    was in, seconds]]}``: the ``top`` kernels by total device time, and
    the ``top`` longest gaps between device work, each named by the
    latest-opened layer range still open on the host at the gap's midpoint
    (or ``outside_layers``)."""
    by_name: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in _DEVICE_CATS)
    merged = []
    for a, b in busy:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"] in layers)
    starts = [r[0] for r in ranges]
    gaps = []
    for (_, b), (a, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = ranges[i][2] if i >= 0 and mid <= ranges[i][1] else "outside_layers"
        gaps.append([name, (a - b) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": gaps[:top]}


@contextlib.contextmanager
def layer_ranges():
    """Wrap each layer's function in a ``record_function`` range of its
    name for the duration of the block."""
    from torch.profiler import record_function

    saved = []
    for label, mod_name, fn_name in LAYERS:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)

        def ranged(*a, _fn=fn, _label=label, **k):
            with record_function(_label):
                return _fn(*a, **k)
        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, functools.wraps(fn)(ranged))
    try:
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def _sequence_nr():
    import torch

    return (torch.zeros((), requires_grad=True) * 1.0).grad_fn._sequence_nr()


@contextlib.contextmanager
def backward_ranges():
    """While active, each GRAD_LAYERS function tags the autograd nodes its
    call creates, so that their backward runs inside a range named after
    the layer (the image gather's node, inside emission, gets
    ``SKY_HIST``)."""
    import torch
    from torch.profiler import record_function

    open_ranges = {}

    def tag(node, label):
        def pre(_grads):
            rf = record_function(label)
            rf.__enter__()
            open_ranges[node] = rf

        def post(_gin, _gout):
            open_ranges.pop(node).__exit__(None, None, None)

        node.register_prehook(pre)
        node.register_hook(post)

    def tag_between(outputs, lo, hi, label):
        stack = [t.grad_fn for t in outputs
                 if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        seen = set()
        while stack:
            node = stack.pop()
            if node is None or node in seen or not lo < node._sequence_nr() < hi:
                continue
            seen.add(node)
            tag(node, SKY_HIST if "ImageGather" in type(node).__name__ else label)
            stack += [n for n, _ in node.next_functions]

    saved = []
    for _, mod_name, fn_name, label in GRAD_LAYERS:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)

        def tagged(*a, _fn=fn, _label=label, **k):
            lo = _sequence_nr()
            out = _fn(*a, **k)
            flat = []
            for x in (out if isinstance(out, tuple) else (out,)):
                flat += list(x) if isinstance(x, (tuple, list)) else (
                    list(x.values()) if isinstance(x, dict) else [x])
            tag_between(flat, lo, _sequence_nr(), _label)
            return out
        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, functools.wraps(fn)(tagged))
    try:
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)
