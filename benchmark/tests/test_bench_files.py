"""BENCHMARK.json and the files it names: every piece is found by name,
parses, and keeps to the limits the benchmark's contract sets."""

import json
import os
import re

import pytest

from benchmark import harness, inputs, load_module

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(harness.REPO, "BENCHMARK.json")) <= 64 * 1024
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][:3] == ["python3", "-m", "benchmark.run"]


def test_budget_of_a_full_check_fits():
    s = BENCH["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert e2e == {"setup_s", "train_step_ms", "train_step_p95_ms", "render_mrays_per_s",
                   "peak_mem_gib"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    by_name = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        # each cell a layer metric lists reports the metric it moves
        assert all(harness.applies(by_name[m["moves"]], c, set()) for c in m["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_e2e_metric_and_a_layer(cell):
    e2e = {m["name"] for m in BENCH["end_to_end"] if harness.applies(m, cell, set())}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(harness.applies(m, cell, e2e) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    spec = harness.cell_spec(BENCH, cell)
    config = inputs.load_json("configs", spec["config"])
    traffic = inputs.load_json("traffic", spec["traffic"])
    limits = inputs.load_json("limits", cell)
    assert {"frame", "depth", "scene", "source", "reduced", "assumed"} <= set(config)
    assert os.path.isfile(os.path.join(harness.ROOT, "kinds", traffic["kind"] + ".py"))
    assert callable(load_module("kinds", traffic["kind"]).Driver)
    assert limits and all(v > 0 for v in limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_layer_metric_has_a_reader(metric):
    assert callable(harness.load_reader(metric))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_matches_its_entry(config):
    with open(os.path.join(harness.REPO, config["file"])) as f:
        doc = json.load(f)
    assert doc["reduced"] == config["reduced"] and doc["source"].startswith(config["source"][:60])
