"""A later change adds a configuration, a mix, a kind of mix, a per-layer
metric or a kernel's counts as new files and entries, editing no file
that exists: here they come from a throwaway folder beside copies of the
benchmark's own files, and the harness finds them by name."""

import copy
import json
import os
import shutil
import time

from benchmark import harness, roofline


def test_new_files_and_entries_are_found_by_name(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    # a new configuration: the demo's scene under another name, its frame cut
    cfg = json.load(open(root / "configs" / "demo.json"))
    cfg["frame"] = {"width": 16, "height": 8}
    cfg["depth"] = 3
    json.dump(cfg, open(root / "configs" / "demo_small.json", "w"))
    # a new mix of a known kind
    json.dump({"kind": "render", "spp": 2, "spp_chunk": 1, "rays_per_chunk": 128,
               "checked_bands": 1}, open(root / "traffic" / "preview.json", "w"))
    json.dump({"band_gap": 1e-3}, open(root / "limits" / "demo_small.preview.json", "w"))
    # a new per-layer metric and a new kernel's counts
    (root / "metrics" / "units_seen.preview.py").write_text(
        "def read(ctx):\n    return float(ctx['units'])\n")
    (root / "counts" / "k99.py").write_text(
        "def bytes_moved(lanes):\n    return 4 * lanes\n\n\n"
        "def operations(lanes, n_leaves):\n    return None\n")
    bench = copy.deepcopy(harness.load_benchmark())
    bench["configs"].append({"name": "demo_small", "source": "a test", "reduced": ["frame"],
                             "file": "benchmark/configs/demo_small.json", "why": "a test"})
    bench["workloads"].append({"name": "demo_small.preview", "config": "demo_small",
                               "traffic": "preview", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "units_seen.preview", "unit": "wavefronts",
                               "better": "lower", "source": "program_counter",
                               "layer": "dispatch", "moves": "render_mrays_per_s",
                               "workloads": ["demo_small.preview"]})
    out = harness.run("demo_small.preview", 7, 0.2, True, "cpu", time.perf_counter(),
                      bench=bench, root=str(root), log=lambda m: None)
    assert out["correct"] is True
    assert out["metrics"] == {"units_seen.preview": {"value": 2.0, "unit": "wavefronts"}}
    assert roofline.counts("k99", str(root)).bytes_moved(10) == 40
    # the benchmark's own folder is unchanged by all of it
    assert not os.path.exists(os.path.join(harness.ROOT, "configs", "demo_small.json"))


STILL = '''"""A throwaway kind: the same whole frame, rendered again and again."""
import time

import torch

from benchmark import compare, drivers, inputs
from benchmark.reference import scene as rscene
from benchmark.reference import tracer


class Driver(drivers.Driver):
    unit_name, grad = "frame", False

    def setup(self):
        from ptx_torch.integrate.render import render_rows

        self.build()
        self.render_rows, self.lanes = render_rows, self.width * self.height
        self.key, self.frames = inputs.frame_key(self.seed, 0), []

    def _one(self):
        with torch.no_grad():
            return self.render_rows(self.scene, self.scene.params, self.cam, self.key, 0,
                                    self.height, 1, 1, self.depth).cpu()

    def window(self, seconds):
        t0 = time.perf_counter()
        while not self.frames or time.perf_counter() - t0 < seconds:
            self.frames.append(self._one())
        wall = time.perf_counter() - t0
        return {"attempted": len(self.frames), "failed": 0, "unit_s": [wall],
                "metrics": {"render_mrays_per_s": len(self.frames) / wall}}

    def release(self):
        del self.scene

    def check(self):
        rs = self.ref_scene()
        ref = tracer.render_rows(rs, rscene.params(rs, self.device), self.key, 0,
                                 self.height, 1, 1, self.depth, self.device)
        return {"band_gap": compare.band_gap(self.frames[-1], ref.cpu())}
'''


def test_a_new_kind_of_mix_is_found_by_name(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "kinds" / "still.py").write_text(STILL)
    json.dump({"kind": "still"}, open(root / "traffic" / "still.json", "w"))
    json.dump({"band_gap": 1e-3}, open(root / "limits" / "demo.still.json", "w"))
    bench = copy.deepcopy(harness.load_benchmark())
    bench["workloads"].append({"name": "demo.still", "config": "demo", "traffic": "still",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "render_mrays_per_s":
            m["workloads"].append("demo.still")
    out = harness.run("demo.still", 11, 0.1, False, "cpu", time.perf_counter(), bench=bench,
                      root=str(root), log=lambda m: None,
                      overrides={"frame": {"width": 8, "height": 4}, "depth": 2})
    assert out["correct"] is True and out["attempted"] >= 1
    assert set(out["metrics"]) == {"setup_s", "render_mrays_per_s", "peak_mem_gib"}
    assert not os.path.exists(os.path.join(harness.ROOT, "kinds", "still.py"))
