"""Build the port's CUDA kernels and load them with ctypes.

``nvcc`` compiles every ``ptx_torch/csrc/*.cu`` into one shared library
with a plain C interface, ``build/ptx_torch/libptx_torch_kernels-<hash>.so``
under the repository root, keyed by a hash of the sources and flags; a
library already built from the same sources is reused.  Nothing here
includes PyTorch's headers, so a build takes seconds, not minutes.

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


def _declare(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ptx_bounce_forward.argtypes = (
        [vp, i, i, i, i, i]             # scene buffer, words, layout
        + [vp] * 7 + [i, i]             # inputs, in_depth, B
        + [vp] * 8 + [vp])              # outputs, stream
    lib.ptx_bounce_forward.restype = i
    lib.ptx_cuda_error_name.argtypes = [i]
    lib.ptx_cuda_error_name.restype = ctypes.c_char_p
    return lib


def library():
    """The loaded kernel library, building it on first use."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(_CSRC.glob("*.cu"))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources + sorted(_CSRC.glob("*.cuh")):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        out = _BUILD / f"libptx_torch_kernels-{h.hexdigest()[:16]}.so"
        if not out.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
            BUILD_LOG = proc.stdout + proc.stderr
        _lib = _declare(ctypes.CDLL(str(out)))
        return _lib
