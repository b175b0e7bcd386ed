"""ctypes bindings for the port's native runtime (port of
``ptx/runtime/api.py``).

The C++ sources under ``ptx_torch/runtime/src`` are the port's copies of
the JAX package's runtime.  The host ``g++`` builds them at first use
into ``build/ptx_torch/libptxrt-<hash>.so`` under the repository root,
keyed by a hash of the sources and flags, and a library already built
from the same sources is reused.  A build that fails raises with the
compiler's output: the pool, the server and the client have no Python
fallback.  Only the HDR codec of :mod:`ptx_torch.io` asks
:func:`runtime_available` and keeps its Python codec where the library
does not build (a host file codec, as in the JAX package).

- :func:`rgbe_decode` / :func:`rgbe_encode` — RGBE scanline RLE;
- :class:`WorkPool` — native task pool;
- :class:`RenderFarmServer` / :class:`RenderFarmClient` — the TCP tile
  farm; the server calls back into Python, where the render runs.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import threading
import traceback

import numpy as np

from ptx_torch.ops._build import _BUILD

_SRC = pathlib.Path(__file__).resolve().parent / "src"
SOURCES = ("rgbe.cc", "pool.cc", "net.cc")
# the JAX package's Makefile flags (ptx/runtime/Makefile)
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared"]

_lib = None
_error = None               # the failed build's message, raised again on each call
_lib_lock = threading.Lock()

# emit(ctx, y_off, nrows, data) -> 0 ok / nonzero client-gone
EMIT_FN = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
    ctypes.POINTER(ctypes.c_float))

RENDER_CB = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
    ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64,
    EMIT_FN, ctypes.c_void_p, ctypes.c_void_p)

# progress(ctx, rows_done, rows_total)
PROGRESS_FN = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32)

TASK_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def _build() -> pathlib.Path:
    """The library built from the sources, building it if no process has
    (an exclusive file lock makes concurrent processes build it once)."""
    srcs = [_SRC / n for n in SOURCES]
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in srcs + [_SRC / "pool.h"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = _BUILD / f"libptxrt-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the native runtime is built from {_SRC} at "
                           "first use and needs a host C++ compiler")
    _BUILD.mkdir(parents=True, exist_ok=True)
    with open(_BUILD / "libptxrt.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *CXX_FLAGS, *map(str, srcs), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode:
                raise RuntimeError(f"g++ failed to build the native runtime from {_SRC}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
    return out


def load_library():
    """The runtime's C entry points, building the library at first use;
    raises ``RuntimeError`` (with the compiler's output) where it does
    not build."""
    global _lib, _error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            lib = ctypes.CDLL(str(_build()))
        except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
            _error = str(e)
            raise RuntimeError(_error) from e

        lib.ptx_rgbe_decode.restype = ctypes.c_int
        lib.ptx_rgbe_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.ptx_rgbe_encode.restype = ctypes.c_int
        lib.ptx_rgbe_encode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t)]

        lib.ptx_pool_create.restype = ctypes.c_void_p
        lib.ptx_pool_create.argtypes = [ctypes.c_int]
        lib.ptx_pool_submit.argtypes = [ctypes.c_void_p, TASK_FN, ctypes.c_void_p]
        lib.ptx_pool_wait.argtypes = [ctypes.c_void_p]
        lib.ptx_pool_width.restype = ctypes.c_int
        lib.ptx_pool_width.argtypes = [ctypes.c_void_p]
        lib.ptx_pool_destroy.argtypes = [ctypes.c_void_p]

        lib.ptx_server_start.restype = ctypes.c_void_p
        lib.ptx_server_start.argtypes = [
            ctypes.c_char_p, ctypes.c_int, RENDER_CB, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int]
        lib.ptx_server_port.restype = ctypes.c_int
        lib.ptx_server_port.argtypes = [ctypes.c_void_p]
        lib.ptx_server_stop.argtypes = [ctypes.c_void_p]

        lib.ptx_client_create.restype = ctypes.c_void_p
        lib.ptx_client_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.ptx_client_render_tile.restype = ctypes.c_int
        lib.ptx_client_render_tile.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float), PROGRESS_FN, ctypes.c_void_p]
        lib.ptx_client_destroy.argtypes = [ctypes.c_void_p]

        _lib = lib
        return _lib


def runtime_available() -> bool:
    """Whether the library is built and loaded (building it at first use)."""
    try:
        load_library()
    except RuntimeError:
        return False
    return True


# ---------------------------------------------------------------------------
# RGBE
# ---------------------------------------------------------------------------

def rgbe_decode(data: bytes, w: int, h: int) -> np.ndarray:
    """RLE scanline bytes → uint8 (h, w, 4)."""
    lib = load_library()
    out = np.empty((h, w, 4), np.uint8)
    rc = lib.ptx_rgbe_decode(
        data, len(data), w, h,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise ValueError(f"rgbe decode failed ({rc})")
    return out


def rgbe_encode(rgbe: np.ndarray) -> bytes:
    """uint8 (h, w, 4) → the new-style RLE scanlines."""
    lib = load_library()
    rgbe = np.ascontiguousarray(rgbe, np.uint8)
    h, w = rgbe.shape[:2]
    out_len = ctypes.c_size_t()
    src = rgbe.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    lib.ptx_rgbe_encode(src, w, h, None, 0, ctypes.byref(out_len))
    buf = (ctypes.c_uint8 * out_len.value)()
    rc = lib.ptx_rgbe_encode(src, w, h, buf, out_len.value,
                             ctypes.byref(out_len))
    if rc != 0:
        raise ValueError(f"rgbe encode failed ({rc})")
    return bytes(buf[:out_len.value])


# ---------------------------------------------------------------------------
# pool
# ---------------------------------------------------------------------------

class WorkPool:
    """Native thread pool for host-side tasks (IO, tile assembly)."""

    def __init__(self, nthreads: int = 0):
        self._lib = load_library()
        self._pool = self._lib.ptx_pool_create(nthreads)
        self._keep = []          # keep callbacks alive

    @property
    def width(self) -> int:
        return self._lib.ptx_pool_width(self._pool)

    def submit(self, fn) -> None:
        cb = TASK_FN(lambda _arg: fn())
        self._keep.append(cb)
        self._lib.ptx_pool_submit(self._pool, cb, None)

    def wait(self) -> None:
        self._lib.ptx_pool_wait(self._pool)
        self._keep.clear()

    def close(self) -> None:
        if self._pool:
            self._lib.ptx_pool_destroy(self._pool)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
        self.close()


# ---------------------------------------------------------------------------
# render farm
# ---------------------------------------------------------------------------

class RenderFarmServer:
    """Serves tile render requests over TCP (the reference's ``--server``
    mode).  ``render_fn(x0, y0, w, h, spp, depth, seed)`` returns a float32
    (h, w, 3) array; the server's pool threads call it, up to twice the
    hardware width at once, so it must be thread-safe.

    ``chunk_rows > 0`` streams the tile incrementally: ``render_fn`` is
    called once per row band of at most ``chunk_rows`` rows and each band
    is sent as soon as it finishes.  A band that fails is reported on
    stderr with its traceback and ends the tile with the protocol's error
    frame; the client then retries the tile."""

    def __init__(self, render_fn, port: int = 12346, bind: str = "127.0.0.1",
                 threads: int = 0, max_inflight: int = 0,
                 chunk_rows: int = 0):
        # default bind is loopback: the tile protocol is unauthenticated and
        # the request geometry is peer-controlled, so exposing it must be an
        # explicit choice (bind="0.0.0.0" / "")
        self._lib = load_library()

        def cb(x0, y0, w, h, spp, depth, seed, emit, emit_ctx, _user):
            try:
                step = h if chunk_rows <= 0 else max(1, chunk_rows)
                off = 0
                while off < h:
                    n = min(step, h - off)
                    img = np.ascontiguousarray(
                        render_fn(x0, y0 + off, w, n, spp, depth, seed),
                        np.float32)
                    if img.shape != (n, w, 3):
                        print(f"render farm: the band at ({x0}, {y0 + off}) is "
                              f"{img.shape}, not {(n, w, 3)}", file=sys.stderr, flush=True)
                        return 2
                    rc = emit(emit_ctx, off, n,
                              img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
                    if rc != 0:
                        return 3          # client gone: abort the tile
                    off += n
                return 0
            except Exception:             # the wire protocol's error frame
                traceback.print_exc()
                sys.stderr.flush()
                return 1

        self._cb = RENDER_CB(cb)      # must outlive the server
        self._srv = self._lib.ptx_server_start(bind.encode(), port, self._cb, None,
                                               threads, max_inflight)
        if not self._srv:
            raise OSError(f"cannot bind render farm server on port {port}")

    @property
    def port(self) -> int:
        return self._lib.ptx_server_port(self._srv)

    def stop(self) -> None:
        if self._srv:
            self._lib.ptx_server_stop(self._srv)
            self._srv = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class RenderFarmClient:
    """Farms tiles to servers (the reference's ``--client addr...`` mode):
    server rotation, stateless retry with backoff.  ``max_attempts`` 0
    retries a tile forever (the reference's behaviour); ``io_timeout_ms``
    bounds a stalled read (0: the library's 120 s)."""

    def __init__(self, addresses, default_port: int = 12346,
                 retry_ms: int = 1000, max_attempts: int = 0,
                 io_timeout_ms: int = 0):
        self._lib = load_library()
        hosts, ports = [], []
        for a in addresses:
            host, _, port = str(a).partition(":")
            hosts.append(host.encode())
            ports.append(int(port) if port else default_port)
        arr_h = (ctypes.c_char_p * len(hosts))(*hosts)
        arr_p = (ctypes.c_int * len(ports))(*ports)
        self._cli = self._lib.ptx_client_create(arr_h, arr_p, len(hosts),
                                                retry_ms, max_attempts,
                                                io_timeout_ms)

    def render_tile(self, x0, y0, w, h, spp, depth, seed,
                    progress=None) -> np.ndarray:
        """Render one tile; ``progress(rows_done, rows_total)`` observes the
        incremental row stream while the server renders."""
        out = np.empty((h, w, 3), np.float32)
        if progress is not None:
            pcb = PROGRESS_FN(lambda _ctx, rows, total: progress(rows, total))
        else:
            pcb = ctypes.cast(None, PROGRESS_FN)
        rc = self._lib.ptx_client_render_tile(
            self._cli, x0, y0, w, h, spp, depth, seed,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pcb, None)
        if rc != 0:
            raise OSError("tile render failed after max attempts")
        return out

    def render_image(self, width, height, tile: int = 64, spp: int = 16,
                     depth: int = 16, seed: int = 0,
                     parallel: int = 8, progress=None,
                     row_progress=None) -> np.ndarray:
        """Assemble a full frame from farmed tiles using a local thread
        fan-out (one in-flight request per thread).  Tile ``(x0, y0)`` is
        requested with the seed ``seed + (y0 << 20) + x0``.

        ``progress(tiles_done, tiles_total)`` fires per completed tile;
        ``row_progress(rows_done, rows_total)`` additionally fires as row
        bands stream in from in-progress tiles (whole-frame row counts)."""
        import concurrent.futures as cf

        img = np.zeros((height, width, 3), np.float32)
        jobs = [(x0, y0, min(tile, width - x0), min(tile, height - y0))
                for y0 in range(0, height, tile) for x0 in range(0, width, tile)]
        total_rows = sum(h for _, _, _, h in jobs)
        done = 0
        rows_acc = {"n": 0}
        lock = threading.Lock()

        def tile_progress_fn():
            # a retried tile re-streams from row 0: the delta vs this tile's
            # previous contribution keeps the frame-wide count exact
            last = {"r": 0}

            def fn(rows, _total):
                with lock:
                    rows_acc["n"] += rows - last["r"]
                    last["r"] = rows
                    n = rows_acc["n"]
                row_progress(n, total_rows)
            return fn

        with cf.ThreadPoolExecutor(parallel) as ex:
            futs = {ex.submit(self.render_tile, x0, y0, w, h, spp, depth,
                              seed + (y0 << 20) + x0,
                              tile_progress_fn() if row_progress else None):
                    (x0, y0, w, h)
                    for x0, y0, w, h in jobs}
            for fut in cf.as_completed(futs):
                x0, y0, w, h = futs[fut]
                img[y0:y0 + h, x0:x0 + w] = fut.result()
                done += 1
                if progress is not None:
                    progress(done, len(jobs))
        return img

    def close(self) -> None:
        if self._cli:
            self._lib.ptx_client_destroy(self._cli)
            self._cli = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
