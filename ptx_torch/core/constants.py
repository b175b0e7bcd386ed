"""The JAX package's numeric constants (``ptx/core/constants.py``), shared
by path so both packages read one source (see :mod:`ptx_torch._reuse`)."""

from ptx_torch._reuse import load

_c = load("core/constants.py")

EPS = _c.EPS
MAX_VALUE = _c.MAX_VALUE
DEFAULT_RAY_DEPTH = _c.DEFAULT_RAY_DEPTH
DEFAULT_SCREEN_WIDTH = _c.DEFAULT_SCREEN_WIDTH
DEFAULT_SCREEN_HEIGHT = _c.DEFAULT_SCREEN_HEIGHT
DEFAULT_SCREEN_DISTANCE = _c.DEFAULT_SCREEN_DISTANCE
