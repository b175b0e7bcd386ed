"""The device kernels inside the emission ranges of a layer-profile trace,
by name: calls and device microseconds.

    python scripts/layer_ranges.py build/layer_profile/trace_demo_train.json

Reads the Chrome trace ``python -m ptx_torch.layer_profile`` writes and
attributes each kernel, memset and memcpy to the ``emission``,
``emission_bwd`` or ``sky_hist`` range its launch call lies in (by
correlation id, as ``layer_profile.summarize`` attributes layers).
"""

import bisect
import json
import sys

RANGES = ("emission", "emission_bwd", "sky_hist")


def main(path):
    ev = json.load(open(path))["traceEvents"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in ev
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                    if e.get("cat") == "user_annotation" and e["name"] in RANGES)
    starts = [r[0] for r in ranges]
    per = {}
    for k in ev:
        if k.get("cat") not in ("kernel", "gpu_memset", "gpu_memcpy"):
            continue
        ts = launch_ts.get(k.get("args", {}).get("correlation"))
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= ranges[i][1]:
            d = per.setdefault(ranges[i][2], {})
            c, us = d.get(k["name"][:70], (0, 0.0))
            d[k["name"][:70]] = (c + 1, us + k["dur"])
    for r, d in per.items():
        tot = sum(us for _, us in d.values())
        print(f"range {r}: {sum(c for c, _ in d.values())} kernels, {tot:.2f} us")
        for n, (c, us) in sorted(d.items(), key=lambda kv: -kv[1][1]):
            print(f"   {us:10.2f} us {c:5d}x  {n}")


if __name__ == "__main__":
    main(sys.argv[1])
