"""The host cost of the port's spans (``ptx_torch.utils.profiling``), off
and on.

    python scripts/span_cost.py [--n 200000]

Off (no profiler running): a ``with profiling.span(...)`` block and a
call through a ``profiling.spanned`` function, each less the same work
without the span, in ns a span, the best of five rounds of ``--n``.  On
(under ``torch.profiler`` with the CPU activity): the same, with the
``record_function`` range and the record in memory.  Prints the host's
CPU model and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import platform
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ptx_torch.utils import profiling


def _cpu_model():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def _plain(x):
    return x


_spanned = profiling.spanned("bounce")(_plain)


def _ns(fn, n):
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        fn(n)
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def _with_span(n):
    for _ in range(n):
        with profiling.span("bounce"):
            pass


def _without(n):
    for _ in range(n):
        pass


def _call_spanned(n):
    for i in range(n):
        _spanned(i)


def _call_plain(n):
    for i in range(n):
        _plain(i)


def measure(n):
    out = {"off_span_ns": _ns(_with_span, n) - _ns(_without, n),
           "off_spanned_ns": _ns(_call_spanned, n) - _ns(_call_plain, n)}
    m = max(1, n // 20)
    with profile(activities=[ProfilerActivity.CPU]):
        out["on_span_ns"] = _ns(_with_span, m) - _ns(_without, m)
        out["on_spanned_ns"] = _ns(_call_spanned, m) - _ns(_call_plain, m)
    profiling.reset()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python scripts/span_cost.py")
    ap.add_argument("--n", type=int, default=200_000)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    out = dict(measure(args.n), cpu=_cpu_model(), n=args.n, torch=torch.__version__)
    print(f"{out['cpu']}: a span off {out['off_span_ns']:.1f} ns (with), "
          f"{out['off_spanned_ns']:.1f} ns (decorator); on {out['on_span_ns']:.0f} ns, "
          f"{out['on_spanned_ns']:.0f} ns")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
