"""The benchmark of ``ptx_torch`` on the H100 (``python3 -m benchmark.run``).

Each piece a cell names is a file found by name under this folder, or
under the folder a test gives in its place: configurations, mixes and
limits as JSON (:func:`benchmark.inputs.load_json`), kinds of mix,
per-layer metrics, kernel counts and image formulas as Python
(:func:`load_module`).
"""

import importlib.util
import os

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_module(folder: str, name: str, root: str = ROOT):
    """``<root>/<folder>/<name>.py`` as a module."""
    path = os.path.join(root, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
