"""Each cell driven end to end on the CPU at a tiny size through the
harness's test hook, and the command's refusals.  The result line must
keep to the benchmark's contract; the card's own runs are the chip's."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import harness

BENCH = harness.load_benchmark()
TINY = {"frame": {"width": 16, "height": 8}, "depth": 3}
MIX = {"train": {"spp": 1}, "render": {"spp": 2, "rays_per_chunk": 64}}


def tiny(cell):
    kind = harness.cell_spec(BENCH, cell)["traffic"]
    return dict(TINY, **MIX[kind])


def run(cell, trace, seed=2 ** 31 + 3, **kw):
    return harness.run(cell, seed, 0.2, trace, "cpu", time.perf_counter(),
                       overrides=kw.pop("overrides", tiny(cell)), log=lambda m: None, **kw)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_its_line_keeps_to_the_contract(cell, trace):
    out = run(cell, trace)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and ("breakdown" in keys) == trace
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    e2e = {m["name"] for m in BENCH["end_to_end"] if harness.applies(m, cell, set())}
    if not trace:
        assert set(out["metrics"]) == e2e
        units = {m["name"]: m["unit"] for m in BENCH["end_to_end"]}
        assert all(v["unit"] == units[k] and v["value"] >= 0 for k, v in out["metrics"].items())
    else:
        # the CPU's trace has no kernels: every device reader finds nothing
        assert out["metrics"] == {}
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(out, allow_nan=False)
    assert harness.forbidden_modules() == []


def _cmd(args, env=None, cwd=None):
    env = dict(os.environ if env is None else env)
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args], capture_output=True,
                          text=True, env=env, cwd=cwd or harness.REPO, timeout=120)


ARGS = ["--workload", "demo.train", "--seed", "3000000000", "--seconds", "1", "--trace", "0"]


def test_command_without_a_card_fails_and_prints_no_result():
    p = _cmd(ARGS)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_command_refuses_a_ptx_knob():
    p = _cmd(ARGS, env=dict(os.environ, PTX_FUSED="0"))
    assert p.returncode != 0 and p.stdout.strip() == "" and "PTX_FUSED" in p.stderr


def test_command_alone_in_a_bare_checkout_fails(tmp_path):
    shutil.copytree(harness.ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.REPO, "BENCHMARK.json"), tmp_path)
    p = _cmd(ARGS, cwd=str(tmp_path))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_runs_write_only_under_tmpdir(tmp_path, monkeypatch):
    """The run's scratch (the sky file, the trace) goes under TMPDIR and is
    gone after it; nothing is written in the benchmark's folder or in
    /dev/shm."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    shm = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    before = {p for p, _, _ in os.walk(harness.ROOT) if "__pycache__" not in p}
    seen = []
    import tempfile

    real = tempfile.mkdtemp

    def spy(*a, **k):
        d = real(*a, **k)
        seen.append(d)
        return d
    monkeypatch.setattr(tempfile, "mkdtemp", spy)
    run("demo.train", True)
    assert seen and all(d.startswith(str(tmp_path)) for d in seen)
    assert os.listdir(tmp_path) == []
    after = {p for p, _, _ in os.walk(harness.ROOT) if "__pycache__" not in p}
    assert after == before
    assert (set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()) <= shm
