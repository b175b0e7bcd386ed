"""The port stands alone: no module of ``ptx_torch`` and no line of
``chip_smoke.py`` imports the JAX package or names a path into it."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted(ROOT.glob("ptx_torch/**/*.py")) + [ROOT / "chip_smoke.py"]


def _offences(path):
    tree = ast.parse(path.read_text(), str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names
                    if a.name == "ptx" or a.name.startswith("ptx.")]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if node.module == "ptx" or node.module.startswith("ptx."):
                out.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # a path into the JAX package; "ptx/...py:123" is a reference
            # to a line (a kernel's "replaces"), prose has spaces
            v = node.value
            if v.startswith("ptx/") and " " not in v and ":" not in v:
                out.append(v)
        elif isinstance(node, ast.Call):        # os.path.join(root, "ptx"), ...
            out += [a.value for a in node.args
                    if isinstance(a, ast.Constant) and a.value == "ptx"]
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            if isinstance(node.right, ast.Constant) and node.right.value == "ptx":
                out.append("/ 'ptx'")
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_the_jax_package(path):
    assert _offences(path) == []


def test_the_walk_sees_an_offence(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import ptx.core\nfrom ptx.io import bmp\n"
                   "p = ROOT / 'ptx'\nq = 'ptx/io/bmp.py'\n"
                   "r = os.path.join(ROOT, 'ptx')\n")
    assert len(_offences(bad)) == 5
