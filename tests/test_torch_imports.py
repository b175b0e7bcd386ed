"""The port stands alone: no module of ``ptx_torch`` and no line of
``chip_smoke.py`` imports the JAX package or names a path into it.  And the
port is layered: every module file sits in a box, imports only from its box
and the boxes before it, and (in ``core/``, ``geom/``, ``shade/``, ``ops/``
and ``integrate/``) imports the package only at module level."""

import ast
import pathlib
import subprocess
import sys

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


# ---------------------------------------------------------------------------
# the layering of the port: each box imports only from boxes before it
# ---------------------------------------------------------------------------

# Every module file of the package in its box.  Box 0: the recorder, the
# build and launch ABI, the leaf kernels that take only tensors, the
# runtime and the image codecs; 1 core; 2 plain geometry and plain hits;
# 3 materials, textures, the plain bounce and what builds scenes from
# them; 4 the scene kernels, each with its plain version; 5 the integrator
# and its routing; 6 the mesh, the CLI and the tools on top.
BOXES = {
    0: ("__init__.py", "utils/__init__.py", "utils/profiling.py", "ops/__init__.py",
        "ops/_build.py", "ops/rng_kernel.py", "ops/imagegrad.py", "ops/sweep_kernel.py",
        "ops/roofline_kernel.py", "runtime/__init__.py", "runtime/api.py", "io.py"),
    1: ("core/__init__.py", "core/constants.py", "core/linalg.py", "core/rng.py"),
    2: ("geom/__init__.py", "geom/primitives.py", "geom/spans.py", "geom/tape.py",
        "geom/hitreplay.py", "geom/fasthit.py"),
    3: ("shade/__init__.py", "shade/textures.py", "shade/materials.py", "shade/bounce.py",
        "convert.py", "scenes/__init__.py", "scenes/builders.py"),
    4: ("ops/fasthit_kernel.py", "ops/bounce_kernel.py", "ops/megasweep.py",
        "ops/replay_bwd.py", "ops/emission_kernel.py", "ops/sky_bank.py"),
    5: ("integrate/__init__.py", "integrate/camera.py", "integrate/trace.py",
        "integrate/render.py", "integrate/adaptive.py", "scenes/spec.py"),
    6: ("parallel/__init__.py", "parallel/mesh.py", "parallel/dist.py",
        "parallel/render.py", "parallel/checkpoint.py", "cli.py", "__main__.py",
        "layer_profile.py", "roofline.py"),
}
PKG = ROOT / "ptx_torch"
BOX_OF = {rel: box for box, rels in BOXES.items() for rel in rels}
# no import of the package inside a function of these directories
NO_LOCAL_IMPORTS = ("core/", "geom/", "shade/", "ops/", "integrate/")


def _module_of(rel):
    """``ptx_torch.a.b`` of the file ``a/b.py`` (``a/__init__.py``: ``ptx_torch.a``)."""
    parts = ["ptx_torch", *pathlib.PurePosixPath(rel).with_suffix("").parts]
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


FILE_OF = {_module_of(rel): rel for rel in BOX_OF}


def _imports(tree):
    """``(module, in_function)`` for every module of the package a tree
    imports: ``from ptx_torch.a import b`` names ``ptx_torch.a.b`` where that
    is a module, else ``ptx_torch.a``."""
    out = []

    def visit(node, in_function):
        for child in ast.iter_child_nodes(node):
            inner = in_function or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
            if isinstance(child, ast.Import):
                out.extend((a.name, inner) for a in child.names
                           if a.name.split(".")[0] == "ptx_torch")
            elif (isinstance(child, ast.ImportFrom) and child.level == 0 and child.module
                  and child.module.split(".")[0] == "ptx_torch"):
                for a in child.names:
                    sub = f"{child.module}.{a.name}"
                    out.append((sub if sub in FILE_OF else child.module, inner))
            visit(child, inner)

    visit(tree, False)
    return out


def _layer_offences(rel, source):
    """What the module file ``rel`` (its text ``source``) does against the
    layering: imports from a later box, and imports of the package inside
    a function where :data:`NO_LOCAL_IMPORTS` forbids them."""
    out = []
    for mod, in_function in _imports(ast.parse(source, rel)):
        target = FILE_OF.get(mod)
        if target is None:
            out.append(f"{mod}: not a module file of the package")
        elif BOX_OF[target] > BOX_OF[rel]:
            out.append(f"{mod} is in box {BOX_OF[target]}, after box {BOX_OF[rel]}")
        if in_function and rel.startswith(NO_LOCAL_IMPORTS):
            out.append(f"{mod} imported inside a function")
    return out


def test_every_module_file_is_in_one_box():
    files = sorted(str(p.relative_to(PKG)) for p in PKG.rglob("*.py"))
    listed = [rel for rels in BOXES.values() for rel in rels]
    assert sorted(listed) == files and len(set(listed)) == len(listed)


@pytest.mark.parametrize("rel", sorted(BOX_OF))
def test_imports_point_to_earlier_boxes(rel):
    assert _layer_offences(rel, (PKG / rel).read_text()) == []


def test_the_import_graph_has_no_cycle():
    graph = {rel: {FILE_OF[m] for m, _ in _imports(ast.parse((PKG / rel).read_text()))
                   if m in FILE_OF} - {rel} for rel in BOX_OF}
    done, path = set(), []

    def walk(rel):
        if rel in path:
            raise AssertionError(" -> ".join(path[path.index(rel):] + [rel]))
        if rel not in done:
            path.append(rel)
            for nxt in sorted(graph[rel]):
                walk(nxt)
            path.pop()
            done.add(rel)

    for rel in sorted(graph):
        walk(rel)


def test_the_layer_walk_sees_an_offence():
    bad = ("from ptx_torch.integrate import trace\n"
           "from ptx_torch.ops import megasweep\n"
           "def f():\n    from ptx_torch.core import rng\n")
    assert _layer_offences("geom/fasthit.py", bad) == [
        "ptx_torch.integrate.trace is in box 5, after box 2",
        "ptx_torch.ops.megasweep is in box 4, after box 2",
        "ptx_torch.core.rng imported inside a function"]
    # a tool on top may import inside a function
    assert _layer_offences("roofline.py", bad) == []


def test_leaf_kernels_load_no_integrator():
    code = ("import sys\n"
            "import ptx_torch.ops.imagegrad, ptx_torch.ops.rng_kernel\n"
            "import ptx_torch.ops.roofline_kernel\n"
            "print(sorted(m for m in sys.modules if m.startswith('ptx_torch.integrate')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip() == "[]"
