"""Build the port's CUDA kernels and load them with ctypes.

``nvcc`` compiles each ``ptx_torch/csrc/<name>.cu`` into a shared library
with a plain C interface, ``build/ptx_torch/<name>-<hash>.so`` under the
repository root, keyed by a hash of the sources and flags; libraries
already built from the same sources are reused.  The
sources compile in parallel, one ``nvcc`` each, all started together.
Nothing here includes PyTorch's headers, so a build takes seconds, not
minutes.  :func:`library` returns the C entry points of all of them.

Nothing is built or loaded until a CUDA tensor reaches a kernel wrapper.
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
    replay_bwd = ([vp, i, i, vp]        # scene vector, words, L, leaf aux
                  + [vp] * 12 + [i]     # inputs, cotangents, B
                  + [vp] * 4 + [i]      # d_o d_d d_thr partial, blocks
                  + [vp, vp, i, vp, vp])   # mat_start mat_leaves M, d_packed, stream
    return [
        ("ptx_bounce_forward",
         [vp, i, i, i, i, i]            # scene buffer, words, layout
         + [vp] * 7 + [i, i]            # inputs, in_depth, B
         + [vp] * 13 + [vp], i),        # outputs, stream
        ("ptx_bounce_backward_smem", [i, i], i),
        ("ptx_bounce_backward", replay_bwd, i),
        ("ptx_image_hist", [vp] * 4 + [i] * 4 + [vp, i, i, vp], i),   # out, private, blocks
        ("ptx_image_hist_atomic", [vp] * 4 + [i] * 4 + [vp, vp], i),
        ("ptx_first_hit",
         [vp, i, i, i, i, vp, vp, i]      # scene buffer, words, layout, o, d, B
         + [vp] * 6 + [vp], i),           # t normal mat_id entering hit evt, stream
        ("ptx_emission_forward",
         [vp, vp, vp, vp, vp, i, i, i]    # xform, factor, const, const rows, image, H W C
         + [vp, vp, i, i, i]              # pos, mid, N, dyn material, mirror
         + [vp, vp, vp], i),              # em, bin, stream
        ("ptx_emission_backward",
         [vp, vp, i, vp, i, i, i, i, vp]  # ct, bin, N, image, H W C, R, factor
         + [vp, vp, vp, i, i, i, vp], i),  # d_img d_const d_factor, words, offset, private, stream
        ("ptx_emission_backward_private_fits", [i, i, i, vp], i),   # H W R, fits
        ("ptx_sky_bank_forward",
         [i, vp, vp]                      # phases, their pointers, their sizes
         + [vp] * 4 + [i, i]              # xform, factor, const, const rows, M, sky
         + [vp, i, i, i, i, vp, vp], i),  # image, H W C, mirror, sel, stream
        ("ptx_sky_bank_backward",
         [i, vp, vp]                      # phases, their pointers, their sizes
         + [vp] * 3 + [i, i, i]           # factor, const, const rows, M, sky, R
         + [vp, i, i, i, vp]              # image, H W C, sel
         + [vp] * 3 + [i, i]              # d_img d_const d_factor, words, offset
         + [vp, i, vp], i),               # partial, its blocks, stream
        ("ptx_megasweep_smem", [i] * 9, i),
        ("ptx_megasweep",
         [vp, i, vp, i]                   # scene floats, words, int table, words
         + [i] * 15                       # L Lp ns n_rows tw n_flags offsets classes cull,
                                          # list capacities, gadget scratch columns
         + [vp, vp, i]                    # o, d, B
         + [vp] * 5 + [i]                 # bounce-mode carry (or null), in_depth
         + [vp] * 17 + [vp], i),          # outputs (null where unused), stream
        ("ptx_replay_bwd_smem", [i, i], i),
        ("ptx_replay_bwd", replay_bwd, i),
        ("ptx_sweep_select",
         [vp, vp, i, vp, vp, i, i]        # s, e, S, t0, t1, L, B
         + [ctypes.c_float, i, i, i]      # eps, sort, Sp, tile width
         + [vp] * 5 + [vp], i),           # t_star entering m_start m_end found, stream
        ("ptx_fma_chain", [vp, vp, i, i, ctypes.c_float, i, vp], i),   # x o n reps c block stream
        ("ptx_copy_plus_one", [vp, vp, ctypes.c_int64, i, vp], i),    # x o n block stream
        ("ptx_uniform_many", [vp, i, ctypes.c_int64, vp, i, vp], i),  # keys nkeys n out block stream
        ("ptx_cuda_error_name", [i], ctypes.c_char_p),
    ]


def library():
    """The kernels' C entry points, as attributes, building the libraries
    on first use."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
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
