"""Observability: structured progress logs, throughput counters, the
PyTorch profiler, and the port's own spans and counters (port of
``ptx/utils/profiling.py``, plus the recorder).

- :func:`log` — timestamped JSON-line records on stderr, the same records
  as the JAX package's (``render_start``, ``render_done``, ``tile_done``,
  the :class:`Meter` line);
- :class:`Meter` — rays/s, samples and tiles counters with periodic
  emission;
- :func:`timed` — the seconds a block takes, as a ``timed`` record;
- :func:`trace` — a ``torch.profiler`` capture of the CPU and, where
  there is a card, its kernels, written as a Chrome trace (the layer
  profile's and the smoke run's);
- :func:`span`, :func:`spanned`, :func:`count`, :func:`count_fillers` —
  the port's layer boundaries and counters, recorded while a
  ``torch.profiler`` capture is on; :func:`snapshot` reads what the last
  capture recorded, :func:`reset` clears it.

The recorder is on exactly while a capture is
(``torch.autograd.profiler._is_profiler_enabled``): no knob turns it on.
Off, a span costs that one check and returns a shared null context.  On,
a span opens a ``record_function`` range of its name, so it sits in the
capture on the profiler's clock beside the kernels, and appends a record:
its name, its parent span, its unit (the ``train_step`` or
``render_rows`` root it runs under), its start and end on
``time.perf_counter_ns``, the synchronises and the collector's time
charged to it.  While recording, and only then:

- every host-device synchronise on a CUDA device is charged to the
  innermost open span (``outside`` if none): CUDA's sync debug mode is
  set to "warn" and its warnings are caught, not shown.  Those of
  autograd's worker thread reach the thread that called the backward
  when it returns, and are charged there;
- the time in Python's garbage collector is charged the same way;
- a layer whose forward builds a graph (:func:`spanned` with
  ``backward=``) tags the autograd nodes it created, so that their
  backward runs inside a span of the backward name.  A node's closing
  hook is registered at once and its opening one at the next span
  boundary: a range another tool opens around the same node from outside
  the layer's function then encloses the span.

Turning the recorder on adds no device work: a compaction's kept count
stays a reference to the tensor the compaction computed and is read once,
by :func:`snapshot`, after the capture.  Every global the recorder sets
is restored when the capture stops.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import sys
import time
import warnings

import torch
import torch.autograd.profiler as _tprof

# the roots a unit of work is counted by, and every span the port opens on
# every route
UNIT_SPANS = ("train_step", "render_rows")
BACKWARD_SPANS = ("replay_pack_bwd", "bounce_bwd", "compaction_bwd", "emission_bwd",
                  "sky_hist")
SPANS = (UNIT_SPANS + ("forward", "backward", "update", "camera", "trace_rays",
                       "scene_pack", "replay_pack", "rng_draws", "bounce", "compaction",
                       "emission") + BACKWARD_SPANS)
# the spans only the unfused bounce's route opens (a textured surface slot,
# or a knob that drops the fused bounce): its forward, its replay VJP, and
# the surface textures' gather transposes inside that VJP
UNFUSED_SPANS = ("unfused_bounce", "replay_vjp", "tex_hist")
SYNC_WARNING = "called a synchronizing CUDA operation"


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
    capture to ``path`` as a Chrome trace; yields the profiler.  The
    port's spans record while it runs (:func:`snapshot`)."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

# a record: [name, parent, unit, start ns, end ns, syncs, gc ns]
_NAME, _PARENT, _UNIT, _T0, _T1, _SYNCS, _GC = range(7)


_NULL = contextlib.nullcontext()  # the span while nothing records
_rec = None                     # the capture's recorder, kept after it stops


class _Recorder:
    """What one capture records, and the globals it sets meanwhile."""

    def __init__(self):
        self.records = []
        self.stack = []             # the open records, innermost last
        self.units = 0
        self.counters = {}
        self.fillers = []           # (cap, bounces, alive count: a tensor until read)
        self.outside = [0, 0]       # syncs, gc ns outside every span
        self.pending = []           # (owner record, node, opening hook)
        self.gc_t0 = None
        self.active = True
        self.cuda = torch.cuda.is_initialized()
        gc.callbacks.append(self._on_gc)
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING, category=UserWarning)
        self._showwarning = warnings.showwarning
        warnings.showwarning = self._on_warning
        if self.cuda:
            self._sync_mode = torch.cuda.get_sync_debug_mode()
            _set_sync_debug_mode("warn")
        self._profiler_stop = getattr(_tprof, "_run_on_profiler_stop", None)
        if self._profiler_stop is not None:
            self._stop_hook = self._on_profiler_stop
            _tprof._run_on_profiler_stop = self._stop_hook

    def stop(self):
        if not self.active:
            return
        self.active = False
        self.pending.clear()
        if self._profiler_stop is not None and _tprof._run_on_profiler_stop is self._stop_hook:
            _tprof._run_on_profiler_stop = self._profiler_stop
        if self.cuda:
            _set_sync_debug_mode(self._sync_mode)
        self._warnings.__exit__(None, None, None)
        gc.callbacks.remove(self._on_gc)

    def _on_profiler_stop(self):
        self._profiler_stop()
        self.stop()

    def _charge(self, slot, amount):
        if self.stack:
            self.records[self.stack[-1]][slot] += amount
        else:
            self.outside[slot - _SYNCS] += amount

    def _on_warning(self, message, category, filename, lineno, file=None, line=None):
        if issubclass(category, UserWarning) and str(message).startswith(SYNC_WARNING):
            self._charge(_SYNCS, 1)
        else:
            self._showwarning(message, category, filename, lineno, file, line)

    def _on_gc(self, phase, _info):
        if phase == "start":
            self.gc_t0 = time.perf_counter_ns()
        elif self.gc_t0 is not None:
            self._charge(_GC, time.perf_counter_ns() - self.gc_t0)
            self.gc_t0 = None

    def open(self, name):
        parent = self.stack[-1] if self.stack else None
        unit = self.records[parent][_UNIT] if parent is not None else None
        if unit is None and name in UNIT_SPANS:
            unit, self.units = self.units, self.units + 1
        self.records.append([name, parent, unit, time.perf_counter_ns(), None, 0, 0])
        self.stack.append(len(self.records) - 1)
        return len(self.records) - 1

    def close(self, i):
        self.records[i][_T1] = time.perf_counter_ns()
        if self.stack and self.stack[-1] == i:
            self.stack.pop()
        elif i in self.stack:
            self.stack.remove(i)

    def flush(self, keep=None):
        """Register the opening hooks that wait, but those of record
        ``keep`` (a layer's own, until its function has returned)."""
        wait = []
        for owner, node, hook in self.pending:
            if owner == keep:
                wait.append((owner, node, hook))
            else:
                node.register_prehook(hook)
        self.pending = wait

    def tag(self, owner, outputs, lo, label):
        """Each node that a call made (sequence numbers between ``lo`` and
        now) and ``outputs`` reach runs its backward in a span ``label``,
        or in the one a custom function names (its ``backward_span``)."""
        hi = _sequence_nr()
        flat = []
        for x in (outputs if isinstance(outputs, (tuple, list)) else (outputs,)):
            flat += list(x) if isinstance(x, (tuple, list)) else (
                list(x.values()) if isinstance(x, dict) else [x])
        stack = [t.grad_fn for t in flat if isinstance(t, torch.Tensor)]
        seen = set()
        while stack:
            node = stack.pop()
            if node is None or node in seen or not lo < node._sequence_nr() < hi:
                continue
            seen.add(node)
            stack += [n for n, _ in node.next_functions]
            cls = getattr(type(node), "_forward_cls", None)
            self._tag_node(owner, node, getattr(cls, "backward_span", None) or label)

    def _tag_node(self, owner, node, label):
        opened = []

        def pre(_grads):
            if self.active:
                sp = _Span(self, label)
                sp.__enter__()
                opened.append(sp)

        def post(_grad_in, _grad_out):
            if opened:
                opened.pop().__exit__(None, None, None)

        node.register_hook(post)
        self.pending.append((owner, node, pre))

    def read_fillers(self):
        """The kept counts as ints: one read of the device, once."""
        todo = [i for i, f in enumerate(self.fillers) if isinstance(f[2], torch.Tensor)]
        if todo:
            vals = torch.stack([self.fillers[i][2].reshape(()) for i in todo]).tolist()
            for i, v in zip(todo, vals):
                cap, bounces, _ = self.fillers[i]
                self.fillers[i] = (cap, bounces, int(v))


class _Span:
    __slots__ = ("rec", "name", "i", "rf")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        if rec.pending:
            rec.flush()
        self.rf = _tprof.record_function(self.name)
        self.rf.__enter__()
        self.i = rec.open(self.name)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.close(self.i)
        self.rf.__exit__(*exc)
        if rec.pending:
            rec.flush(keep=self.i)
        return False


def _set_sync_debug_mode(mode):
    """CUDA's sync debug mode, without the warning that it is a prototype."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode(mode)


def _recorder():
    """The capture's recorder, started by the first span or count in it."""
    global _rec
    if _rec is None or not _rec.active:
        _rec = _Recorder()
    return _rec


def _sequence_nr():
    """The autograd node counter's current value (a throwaway node's)."""
    return (torch.zeros((), requires_grad=True) * 1.0).grad_fn._sequence_nr()


def span(name: str):
    """A context manager: the port's span ``name`` around the block while a
    capture records (module docstring), else nothing."""
    if not _tprof._is_profiler_enabled:
        return _NULL
    return _Span(_recorder(), name)


def spanned(name: str, backward: str | None = None):
    """Decorator: the function's whole body in span ``name``.  With
    ``backward``, the autograd nodes its call makes (under grad mode)
    run their backward in a span of that name."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _tprof._is_profiler_enabled:
                return fn(*args, **kwargs)
            rec = _recorder()
            with _Span(rec, name) as sp:
                if backward is None or not torch.is_grad_enabled():
                    return fn(*args, **kwargs)
                lo = _sequence_nr()
                out = fn(*args, **kwargs)
                rec.tag(sp.i, out, lo, backward)
                return out
        return inner
    return wrap


def count(name: str, value: int) -> None:
    """Add ``value`` to the capture's counter ``name``."""
    if not _tprof._is_profiler_enabled:
        return
    c = _recorder().counters
    c[name] = c.get(name, 0) + value


def count_fillers(cap: int, bounces: int, alive) -> None:
    """A compaction to width ``cap`` before a phase of ``bounces`` bounces,
    with ``alive`` (a 0-d tensor, read by :func:`snapshot`) lanes alive:
    ``cap − min(alive, cap)`` filler rows traced through each bounce."""
    if not _tprof._is_profiler_enabled:
        return
    _recorder().fillers.append((cap, bounces, alive))


def snapshot() -> dict:
    """What the last capture recorded (read after it; reading clears
    nothing).  ``units``: the ``train_step`` / ``render_rows`` roots;
    ``cuda``: whether the capture ran on an initialised CUDA, so that its
    synchronises were counted; ``spans``: per name ``calls``, ``host_ms``,
    ``self_ms`` (less the time its child spans cover), ``syncs`` and
    ``gc_ms`` charged to it; ``outside``: ``syncs`` and ``gc_ms`` outside
    every span; ``counters``: :func:`count`'s, with
    ``filler_lane_bounces`` (Σ filler rows × the phase's bounces)."""
    rec = _rec
    if rec is None:
        return {"units": 0, "cuda": False, "spans": {}, "outside": {"syncs": 0, "gc_ms": 0.0},
                "counters": {}}
    if rec.active and not _tprof._is_profiler_enabled:
        rec.stop()
    rec.read_fillers()
    child = [0] * len(rec.records)
    for r in rec.records:
        if r[_T1] is not None and r[_PARENT] is not None:
            child[r[_PARENT]] += r[_T1] - r[_T0]
    spans = {}
    for r, c in zip(rec.records, child):
        if r[_T1] is None:
            continue
        s = spans.setdefault(r[_NAME], {"calls": 0, "host_ms": 0.0, "self_ms": 0.0,
                                        "syncs": 0, "gc_ms": 0.0})
        s["calls"] += 1
        s["host_ms"] += (r[_T1] - r[_T0]) / 1e6
        s["self_ms"] += (r[_T1] - r[_T0] - c) / 1e6
        s["syncs"] += r[_SYNCS]
        s["gc_ms"] += r[_GC] / 1e6
    counters = dict(rec.counters)
    counters["filler_lane_bounces"] = sum((cap - min(n, cap)) * nb
                                          for cap, nb, n in rec.fillers)
    return {"units": rec.units, "cuda": rec.cuda, "spans": spans,
            "outside": {"syncs": rec.outside[0], "gc_ms": rec.outside[1] / 1e6},
            "counters": counters}


def reset() -> None:
    """Clear what the recorder holds (and stop it, if a capture is on: the
    next span starts it again)."""
    global _rec
    if _rec is not None:
        _rec.stop()
    _rec = None
