"""The readings the limits of ``benchmark/limits/<cell>.json`` are set from.

    python -m benchmark.calibrate --workload <cell> --seeds <n> [--first <seed>]
        [--seconds <s>] [--controls <k>]

In one process, on the card:

- the program's readings: a run of the cell (:func:`benchmark.harness.run`
  with a window of ``--seconds``) on each of ``n`` seeds from ``--first``;
  the largest over the seeds is a number's lower reading;
- on the first ``k`` of those seeds, from the same run: the control and
  the faults of the cell's kind (``controls`` of
  ``benchmark/kinds/<kind>.py``): the reference computed in bfloat16 (the
  precision below the configuration's float32) in the program's place,
  and the reference over half of the batch, each judged against the
  reference in float32 by the same comparison.

Each reading is one JSON line on standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def controls(cell: str, seed: int, device, overrides=None, seconds: float = 0.2) -> tuple:
    """``(run, readings)``: a run of ``cell`` on ``seed``, and its kind's
    control and fault readings ``{"control": numbers, "half_batch":
    numbers, ...}``; ``overrides`` as :func:`benchmark.harness.run` takes
    them."""
    from benchmark import harness, inputs, load_module

    spec = harness.cell_spec(harness.load_benchmark(), cell)
    kind = load_module("kinds", inputs.load_json("traffic", spec["traffic"])["kind"])
    got = {}
    out = harness.run(cell, seed, seconds, False, device, time.perf_counter(),
                      overrides=overrides, log=lambda m: None,
                      hook=lambda drv: got.update(kind.controls(drv)))
    return out, got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=4_000_000_001)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("the readings need CUDA", file=sys.stderr)
        return 3
    for i in range(args.seeds):
        seed = args.first + i
        t0 = time.perf_counter()
        if i < args.controls:
            out, readings = controls(args.workload, seed, "cuda:0", seconds=args.seconds)
        else:
            out, readings = harness.run(args.workload, seed, args.seconds, False, "cuda:0",
                                        t0, log=lambda m: None), {}
        print(json.dumps({"seed": seed, "program": out["checks"], "correct": out["correct"],
                          "attempted": out["attempted"], "failed": out["failed"], **readings,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
