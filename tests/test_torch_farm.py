"""The port's native runtime (``ptx_torch.runtime``, built with the host
``g++`` from ``ptx_torch/runtime/src``) and the ``serve`` / ``farm``
commands, on the CPU over loopback.

- the library builds from the port's own sources; its RGBE codec writes
  the bytes of the port's Python codec and reads them back;
- ``WorkPool`` runs its tasks;
- a port ``serve`` (a subprocess, 16×16 demo, ``--chunk-rows 4``) and the
  port's client: the frame equals the direct ``render_tile`` of every
  served band with the client's seeds (``seed + (y0 << 20) + x0``) bit
  for bit, and the rows stream a band at a time;
- the JAX package's ``farm`` (a subprocess under ``PTX_CPU=1``: the two
  packages' libraries export the same symbols, so they never share a
  process) gets the same frame from a port server as the port's client;
- garbage bytes get the busy byte;
- ``serve --adaptive``: every band equals ``render_adaptive_tile`` at its
  seed and meets its sample budget;
- a render callback that raises prints its traceback and ends the tile
  with the error frame, so a bounded client fails instead of hanging.
"""

import os
import shutil
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from ptx_torch import io
from ptx_torch.core import rng
from ptx_torch.integrate import adaptive, render, trace
from ptx_torch.integrate.camera import Camera
from ptx_torch.scenes.builders import make_world

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
W = H = 16
TILE, SPP, DEPTH, SEED, CHUNK = 8, 2, 2, 5, 4
FRAME = ["--width", str(W), "--height", str(H)]


@pytest.fixture(scope="module")
def runtime():
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler: the native runtime cannot build")
    from ptx_torch import runtime
    runtime.load_library()
    return runtime


def _serve(extra, cwd):
    proc = subprocess.Popen(
        # --foreground: SIGINT reaches the server once, not again through
        # timeout's process group
        ["timeout", "--foreground", "300", sys.executable, "-m", "ptx_torch", "serve",
         "--device", "cpu",
         *FRAME, "--port", "0", "--chunk-rows", str(CHUNK), *extra],
        cwd=cwd, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if "render-farm server on :" not in line:
        proc.kill()
        raise AssertionError(f"server did not start: {line!r} {proc.stderr.read()}")
    return proc, int(line.split("on :")[1].split()[0])


def _stop(proc):
    proc.send_signal(signal.SIGINT)
    try:
        err = proc.communicate(timeout=60)[1]
    except subprocess.TimeoutExpired:
        proc.kill()
        err = proc.communicate()[1]
    return err


@pytest.fixture(scope="module")
def servers(runtime, tmp_path_factory):
    """A plain and an adaptive port server, started together."""
    cwd = tmp_path_factory.mktemp("serve")
    plain, adapt = _serve([], cwd), _serve(["--adaptive"], cwd)
    yield {"plain": plain[1], "adaptive": adapt[1]}
    logs = [_stop(plain[0]), _stop(adapt[0])]
    assert all("tile_done" in e for e in logs), logs


@pytest.fixture(scope="module")
def scene():
    return trace.compile_scene(make_world(), "cpu")


def _client(runtime, port):
    return runtime.RenderFarmClient([f"127.0.0.1:{port}"], retry_ms=50, max_attempts=3,
                                    io_timeout_ms=60000)


def _bands():
    for y0 in range(0, H, TILE):
        for x0 in range(0, W, TILE):
            for off in range(0, TILE, CHUNK):
                yield x0, y0, off, rng.PRNGKey((SEED + (y0 << 20) + x0) & 0x7FFFFFFF)


def test_runtime_builds_from_the_ports_sources(runtime):
    from ptx_torch.runtime import api
    path = api._build()
    assert path.parent.name == "ptx_torch" and path.parent.parent.name == "build"
    assert path.name.startswith("libptxrt-") and path.exists()
    assert {p.name for p in api._SRC.iterdir()} >= {"rgbe.cc", "pool.cc", "net.cc", "pool.h"}


def test_native_rgbe_equals_the_python_codec(runtime):
    r = np.random.default_rng(0)
    img = (r.uniform(0, 1, (13, 57, 3)) * 20).astype(np.float32)
    img[:, 10:30] = 1.5                        # runs
    rgbe = io.float_to_rgbe(img)
    py = b"".join(bytes([2, 2, 0, 57]) + b"".join(io._rle_encode(rgbe[y, :, c])
                                                   for c in range(4)) for y in range(13))
    assert runtime.rgbe_encode(rgbe) == py
    np.testing.assert_array_equal(runtime.rgbe_decode(py, 57, 13), rgbe)


def test_work_pool_runs_tasks(runtime):
    with runtime.WorkPool(4) as pool:
        assert pool.width == 4
        results, lock = [], threading.Lock()
        for i in range(32):
            def task(i=i):
                with lock:
                    results.append(i)
            pool.submit(task)
        pool.wait()
    assert sorted(results) == list(range(32))


def test_farmed_frame_equals_the_direct_tiles(runtime, servers, scene):
    rows_seen = []
    with _client(runtime, servers["plain"]) as cli:
        img = cli.render_image(W, H, tile=TILE, spp=SPP, depth=DEPTH, seed=SEED,
                               parallel=4, row_progress=lambda n, t: rows_seen.append((n, t)))
    cam = Camera.reference_demo(W, H)
    for x0, y0, off, key in _bands():
        band = render.render_tile(scene, scene.params, cam, key, x0, y0 + off, TILE, CHUNK,
                                  SPP, DEPTH)
        np.testing.assert_array_equal(img[y0 + off:y0 + off + CHUNK, x0:x0 + TILE],
                                      band.numpy(), err_msg=f"tile ({x0}, {y0}) band {off}")
    # one event a streamed band, each a band of CHUNK rows more
    assert len(rows_seen) == len(list(_bands()))
    assert sorted(n for n, _ in rows_seen) == list(range(CHUNK, W // TILE * H + 1, CHUNK))
    assert img.mean() > 0


def test_jax_farm_client_gets_the_ports_frame(runtime, servers, tmp_path):
    port = servers["plain"]
    args = ["farm", f"127.0.0.1:{port}", *FRAME, "--spp", str(SPP), "--depth", str(DEPTH),
            "--tile", str(TILE), "--seed", str(SEED)]
    proc = subprocess.run(["timeout", "300", sys.executable, "-m", "ptx", *args, "--out",
                           str(tmp_path / "jax")], cwd=tmp_path, capture_output=True,
                          text=True, env=dict(ENV, PTX_CPU="1",
                                              PTX_CACHE_DIR=str(tmp_path / "cache")))
    assert proc.returncode == 0, proc.stderr
    with _client(runtime, port) as cli:
        img = cli.render_image(W, H, tile=TILE, spp=SPP, depth=DEPTH, seed=SEED)
    io.write_hdr(tmp_path / "port.hdr", img)
    io.write_bmp(tmp_path / "port.bmp", img)
    for ext in ("hdr", "bmp"):
        assert (tmp_path / f"jax.{ext}").read_bytes() == (tmp_path / f"port.{ext}").read_bytes()


def test_port_farm_command(runtime, servers, tmp_path):
    proc = subprocess.run(
        ["timeout", "300", sys.executable, "-m", "ptx_torch", "farm",
         f"127.0.0.1:{servers['plain']}", *FRAME, "--spp", str(SPP), "--depth", str(DEPTH),
         "--tile", str(TILE), "--seed", str(SEED), "--out", str(tmp_path / "f")],
        cwd=tmp_path, env=ENV, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert f"{W // TILE * H}/{W // TILE * H} rows]" in proc.stdout     # the live line
    with _client(runtime, servers["plain"]) as cli:
        img = cli.render_image(W, H, tile=TILE, spp=SPP, depth=DEPTH, seed=SEED)
    io.write_hdr(tmp_path / "c.hdr", img)
    assert (tmp_path / "f.hdr").read_bytes() == (tmp_path / "c.hdr").read_bytes()


def test_garbage_gets_the_busy_byte(servers):
    for payload in (b"GARBAGE!" * 8, b"PTXR" + b"\x09" * 40):    # bad magic; bad version
        with socket.create_connection(("127.0.0.1", servers["plain"]), timeout=30) as s:
            s.sendall(payload)
            assert s.recv(1) == b"\x00"


def test_adaptive_serve(runtime, servers, scene):
    with _client(runtime, servers["adaptive"]) as cli:
        img = cli.render_image(W, H, tile=TILE, spp=SPP, depth=DEPTH, seed=SEED)
    assert np.isfinite(img).all() and img.mean() > 0
    cam = Camera.reference_demo(W, H)
    for x0, y0, off, key in _bands():
        s1, _, count = adaptive.adaptive_tile_moments(scene, scene.params, cam, key, x0,
                                                      y0 + off, TILE, CHUNK, SPP, DEPTH)
        assert float(count.sum()) == SPP * TILE * CHUNK
        np.testing.assert_array_equal(img[y0 + off:y0 + off + CHUNK, x0:x0 + TILE],
                                      (s1 / count[..., None]).numpy())


def test_failing_render_reports_and_fails_the_tile(runtime, capsys):
    def render_fn(x0, y0, w, h, spp, depth, seed):
        raise RuntimeError("kernel failed on the card")

    with runtime.RenderFarmServer(render_fn, port=0) as srv:
        with runtime.RenderFarmClient([f"127.0.0.1:{srv.port}"], retry_ms=10,
                                      max_attempts=2, io_timeout_ms=10000) as cli:
            with pytest.raises(OSError, match="max attempts"):
                cli.render_tile(0, 0, 4, 4, 1, 1, 0)
    err = capsys.readouterr().err
    assert "Traceback" in err and "kernel failed on the card" in err
