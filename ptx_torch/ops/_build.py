"""Build the port's CUDA kernels and load them with ctypes.

``nvcc`` compiles each ``ptx_torch/csrc/<name>.cu`` into a shared library
with a plain C interface, ``build/ptx_torch/<name>-<hash>.so`` under the
repository root, keyed by a hash of the sources and flags; libraries
already built from the same sources are reused.  The
sources compile in parallel, one ``nvcc`` each, all started together.
Nothing here includes PyTorch's headers, so a build takes seconds, not
minutes.  :func:`library` returns the C entry points of all of them.

Imported only when a CUDA tensor reaches a kernel wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import types

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "ptx_torch"

# -fmad=false: no multiply-add contraction, so each expression rounds once
# per operation in the order written — as the plain PyTorch version's
# separate ops do.  No --use_fast_math (IEEE division, sqrt, denormals).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""              # nvcc's output (ptxas register / spill report)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built from "
                       "ptx_torch/csrc at first use and need the CUDA toolkit")


def _entry_points():
    """(name, argtypes, restype) of every C entry point."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    return [
        ("ptx_bounce_forward",
         [vp, i, i, i, i, i]            # scene buffer, words, layout
         + [vp] * 7 + [i, i]            # inputs, in_depth, B
         + [vp] * 8 + [vp], i),         # outputs, stream
        ("ptx_bounce_backward_smem", [i, i], i),
        ("ptx_bounce_backward",
         [vp, i, i, vp]                 # scene buffer, words, L, leaf aux
         + [vp] * 12 + [i]              # inputs, cotangents, B
         + [vp] * 4 + [i]               # d_o d_d d_thr partial, blocks
         + [vp, vp, i, vp, vp], i),     # mat_start mat_leaves M, d_packed, stream
        ("ptx_image_hist", [vp] * 4 + [i] * 4 + [vp, vp], i),
        ("ptx_image_hist_atomic", [vp] * 4 + [i] * 4 + [vp, vp], i),
        ("ptx_first_hit",
         [vp, i, i, i, i, vp, vp, i]      # scene buffer, words, layout, o, d, B
         + [vp] * 4 + [vp], i),           # t normal flags evt, stream
        ("ptx_emission_forward",
         [vp, vp, i, vp, i, i, i]         # params, const rows, M, image, H, W, C
         + [vp, vp, i, i, i, i]           # pos, mid, N, dyn material, xform, mirror
         + [vp] * 6 + [vp], i),           # em texel xi yi flags row, stream
        ("ptx_megasweep_smem", [i, i, i], i),
        ("ptx_megasweep",
         [vp, i, vp, i]                   # scene floats, words, int table, words
         + [i] * 11                       # L Lp ns n_rows tw n_flags offsets classes cull
         + [vp, vp, i]                    # o, d, B
         + [vp] * 5 + [i]                 # bounce-mode carry (or null), in_depth
         + [vp] * 11 + [vp], i),          # outputs (null where unused), stream
        ("ptx_replay_bwd_smem", [i], i),
        ("ptx_replay_bwd",
         [vp, i]                          # pack36 scene, L
         + [vp] * 12 + [i]                # inputs, cotangents, B
         + [vp] * 4 + [i, vp, vp], i),    # d_o d_d d_thr partial, blocks, acc, stream
        ("ptx_sweep_select_smem", [i, i], i),
        ("ptx_sweep_select",
         [vp, vp, i, vp, vp, i, i]        # s, e, S, t0, t1, L, B
         + [ctypes.c_float, i, i, i]      # eps, sort, Sp, tile width
         + [vp] * 5 + [vp], i),           # t_star entering m_start m_end found, stream
        ("ptx_cuda_error_name", [i], ctypes.c_char_p),
    ]


def library():
    """The kernels' C entry points, as attributes, building the libraries
    on first use."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(_CSRC.glob("*.cu"))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources + sorted(_CSRC.glob("*.cuh")):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        outs = [_BUILD / f"{src.stem}-{h.hexdigest()[:16]}.so" for src in sources]
        if not all(out.exists() for out in outs):
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmps = [out.with_suffix(f".{os.getpid()}.tmp") for out in outs]
            procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for src, tmp in zip(sources, tmps)]
            BUILD_LOG = "".join(p.communicate()[0] for p in procs)
            failed = [str(src) for src, p in zip(sources, procs) if p.returncode]
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
            for tmp, out in zip(tmps, outs):
                os.replace(tmp, out)
        libs = [ctypes.CDLL(str(out)) for out in outs]
        _lib = types.SimpleNamespace()
        for name, argtypes, restype in _entry_points():
            fn = next(getattr(lib, name) for lib in libs if hasattr(lib, name))
            fn.argtypes, fn.restype = argtypes, restype
            setattr(_lib, name, fn)
        return _lib
