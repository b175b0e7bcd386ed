"""Load the JAX package's numpy-only modules without importing the package.

``ptx/core/constants.py`` and ``ptx/io/{bmp,hdr}.py`` import only numpy,
but importing them as ``ptx.core.constants`` or ``ptx.io.bmp`` first runs
``ptx/core/__init__.py``, which imports ``linalg`` and ``rng`` and with
them jax.  The port runs where jax is not installed, so it loads these
files by path, under private module names, and shares their single
source instead of copying them.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

_PTX = pathlib.Path(__file__).resolve().parent.parent / "ptx"


def load(relpath: str):
    """Load ``ptx/<relpath>`` as a stand-alone module (cached)."""
    name = "ptx_torch._reused_" + relpath.removesuffix(".py").replace("/", "_")
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, _PTX / relpath)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod
