"""Observability: structured progress logs, throughput counters and the
PyTorch profiler (port of ``ptx/utils/profiling.py``).

- :func:`log` — timestamped JSON-line records on stderr, the same records
  as the JAX package's (``render_start``, ``render_done``, ``tile_done``,
  the :class:`Meter` line);
- :class:`Meter` — rays/s, samples and tiles counters with periodic
  emission;
- :func:`timed` — the seconds a block takes, as a ``timed`` record;
- :func:`trace` — a ``torch.profiler`` capture of the CPU and, where
  there is a card, its kernels, written as a Chrome trace (the layer
  profile's and the smoke run's).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


def log(event: str, **fields) -> None:
    rec = {"t": round(time.time(), 3), "event": event}
    rec.update(fields)
    print(json.dumps(rec), file=sys.stderr, flush=True)


class Meter:
    """Throughput meter with periodic emission."""

    def __init__(self, name: str = "render", every_s: float = 5.0):
        self.name = name
        self.every_s = every_s
        self.t0 = time.perf_counter()
        self.last_emit = self.t0
        self.rays = 0
        self.samples = 0
        self.tiles = 0

    def add(self, rays: int = 0, samples: int = 0, tiles: int = 0) -> None:
        self.rays += rays
        self.samples += samples
        self.tiles += tiles
        now = time.perf_counter()
        if now - self.last_emit >= self.every_s:
            self.emit()
            self.last_emit = now

    def emit(self) -> None:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        log(self.name, rays=self.rays, rays_per_sec=round(self.rays / dt, 1),
            samples=self.samples, tiles=self.tiles, elapsed_s=round(dt, 2))


@contextlib.contextmanager
def timed(label: str):
    """Log the block's wall seconds as ``{"event": "timed", "label": ...,
    "seconds": ...}``, rounded to 0.1 ms as the JAX package logs them.
    Yields a dict that holds the unrounded ``seconds`` after the block.
    Nothing here synchronises a device: time a device's work with a
    synchronisation inside the block."""
    rec = {}
    t0 = time.perf_counter()
    yield rec
    rec["seconds"] = time.perf_counter() - t0
    log("timed", label=label, seconds=round(rec["seconds"], 4))


@contextlib.contextmanager
def trace(path: str, cuda: bool | None = None):
    """Profile the block with ``torch.profiler`` (the card's kernels too
    when ``cuda``, by default where CUDA is available) and write the
    capture to ``path`` as a Chrome trace; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
