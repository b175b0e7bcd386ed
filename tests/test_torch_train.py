"""The port's training step (``ptx_torch.parallel.render.make_train_step``)
against the JAX package's on a 1×1 mesh, and its independence from the
JAX package.

One SGD step on a perturbed demo (sphere radii ×1.05, const row 0
lowered by 0.1, as ``examples/inverse_render.py`` perturbs config1 but
milder), small camera, spp 2, depth 4: the loss and every new param
tensor.  The step's gradient is ``trace_rays``'s, held against JAX in
``tests/test_torch_grad.py``; the tolerance here is that file's, taken
on the update ``lr · g``.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ptx.integrate import trace as jtr
from ptx.integrate.camera import Camera as JCamera
from ptx.parallel import mesh as pmesh
from ptx.parallel.render import make_train_step as jax_make_train_step
from ptx.parallel.render import render_sharded
from ptx.scenes.builders import make_world as jax_make_world
from ptx_torch.convert import params_from_jax, scene_from_jax
from ptx_torch.core import rng
from ptx_torch.integrate import trace
from ptx_torch.integrate.camera import Camera
from ptx_torch.parallel.render import make_train_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPP, DEPTH, LR = 12, 8, 2, 4, 0.5


def _perturb(params, scale, shift):
    out = dict(params)
    out["sphere_radius"] = params["sphere_radius"] * scale
    out["const"] = params["const"] + shift
    return out


def test_train_step_matches_jax_on_a_1x1_mesh():
    root = jax_make_world()
    js = jtr.compile_scene(root, pallas=False)
    mesh = pmesh.make_mesh(devices=jax.devices()[:1], tiles=1, samples=1)
    target_key, key = jax.random.PRNGKey(7), jax.random.PRNGKey(2)
    cam_j = JCamera.reference_demo(W, H)
    target = render_sharded(js, cam_j, mesh, target_key, spp=SPP, depth=DEPTH)
    row0 = np.zeros((int(js.params["const"].shape[0]), 3), np.float32)
    row0[0] = -0.1
    p0 = _perturb(js.params, 1.05, jnp.asarray(row0))
    step_j = jax_make_train_step(js, cam_j, mesh, spp=SPP, depth=DEPTH, learning_rate=LR)
    new_j, loss_j = step_j(p0, target, key)

    ts = trace.compile_scene(scene_from_jax(root), "cpu")
    tp0 = params_from_jax(jax.tree.map(np.asarray, p0), "cpu")
    step_t = make_train_step(ts, Camera.reference_demo(W, H), spp=SPP, depth=DEPTH,
                             learning_rate=LR)
    new_t, loss_t = step_t(tp0, torch.from_numpy(np.array(target)), rng.PRNGKey(2))

    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-4)
    new_j = jax.tree.map(np.asarray, new_j)
    p0 = jax.tree.map(np.asarray, p0)
    for k in new_j:
        for a, b, start in zip(*(x if isinstance(x, list) else [x]
                                 for x in (new_t[k], new_j[k], p0[k]))):
            a = a.numpy()
            assert a.shape == b.shape and np.isfinite(a).all(), k
            step = np.abs(b - start).max() if b.size else 0.0
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * step + 1e-6, err_msg=k)
    assert not np.allclose(new_t["sphere_radius"].numpy(), p0["sphere_radius"])


_PROBE = """
import sys
import torch
from ptx_torch.core import rng
from ptx_torch.integrate.camera import Camera
from ptx_torch.integrate.trace import compile_scene
from ptx_torch.parallel.render import make_train_step
from ptx_torch.scenes.builders import make_world
scene = compile_scene(make_world(), "cpu")
step = make_train_step(scene, Camera.reference_demo(6, 4), spp=1, depth=3)
params, loss = step(scene.params, torch.zeros(4, 6, 3), rng.PRNGKey(0))
assert torch.isfinite(loss) and float(loss) > 0
print("JAX_IMPORTED", "jax" in sys.modules)
print("PTX_FILES", [m for m, mod in list(sys.modules.items())
                    if "/ptx/" in (getattr(mod, "__file__", None) or "")])
"""


def test_cpu_train_step_never_imports_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_IMPORTED False" in proc.stdout
    assert "PTX_FILES []" in proc.stdout
