"""Framework-wide numeric constants (the port's copy of ``ptx/core/constants.py``).

``EPS`` is the geometric tolerance for self-intersection offsets and
degenerate-ray tests; ``MAX_VALUE`` the finite "infinity" of half-infinite
plane spans: a ray whose nearest boundary is at ``t >= MAX_VALUE`` has
escaped the scene (the reference's ``misc.h:7-8``, ``path-trace.h:68-71``).
"""

EPS = 1e-3
MAX_VALUE = 1e20

# Default integrator settings (reference: path-trace.h:57,167-170).
DEFAULT_RAY_DEPTH = 16
DEFAULT_SAMPLE_COUNT = 200
DEFAULT_SCREEN_WIDTH = 4.0 / 3.0
DEFAULT_SCREEN_HEIGHT = 1.0
DEFAULT_SCREEN_DISTANCE = 2.0
