"""A kernel's share of its roofline in a traced segment.

The least time the card could take for the kernel's work is the larger
of the bytes it must move over the HBM peak and the float32 operations it
must do over the float32 peak outside the tensor cores (NVIDIA's data
sheet for the H100 SXM at 700 W: 3.35 TB/s, 67 TFLOP/s); the share is that
time over the kernel's device time in the trace, in percent.  The counts
come from ``benchmark/counts/<kernel>.py``, per call, at the widths of
:func:`benchmark.schedule.widths`.  The port builds with ``-fmad=false``:
an operation-bound kernel tops out near half of the float32 peak.
"""

from __future__ import annotations

import os

from benchmark import load_module, schedule

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def counts(kernel: str, root: str = os.path.dirname(__file__)):
    """``<root>/counts/<kernel>.py``."""
    return load_module("counts", kernel, root)


def share(kernel: str, ctx: dict):
    """Percent of the roofline, or None where the segment launched the
    kernel another number of times than one call a bounce."""
    s = ctx["summary"]
    calls = s.get(f"{kernel}_calls", 0)
    ws = schedule.widths(ctx["lanes"], ctx["depth"])
    if not calls or calls != len(ws) * ctx["units"]:
        return None
    device_s = calls * s[f"{kernel}_mean_us"] / 1e6
    c = counts(kernel, ctx.get("root", os.path.dirname(__file__)))
    nbytes = sum(c.bytes_moved(w) for w in ws) * ctx["units"]
    ops = [c.operations(w, ctx["n_leaves"]) for w in ws]
    t = nbytes / HBM_BYTES_PER_S
    if all(o is not None for o in ops):
        t = max(t, sum(ops) * ctx["units"] / F32_OPS_PER_S)
    return 100.0 * t / device_s
