"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The port is measured as it runs by
default: a ``PTX_*`` variable in the environment stops the run.  It needs
CUDA and as many cards as the cell asks for, and never falls back to the
CPU.  The last line of standard output is the result as one JSON object;
the numbers compared with the reference, each beside its limit, are the
last lines of standard error and the result's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0 or args.seed < 0:
        ap.error("--seconds must be positive and --seed a whole number")
    knobs = sorted(k for k in os.environ if k.startswith("PTX_"))
    if knobs:
        print(f"the benchmark measures the port at its defaults; unset {knobs}",
              file=sys.stderr)
        return 2

    import torch

    from benchmark import harness

    bench = harness.load_benchmark()
    chips = harness.cell_spec(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", T_START, bench=bench)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
