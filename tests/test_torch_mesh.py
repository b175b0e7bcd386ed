"""The port's mesh (``ptx_torch.parallel.{mesh,dist,render}``) on the CPU.

- ``make_mesh``'s shapes and errors, the rank's device, and
  ``dist.initialize``'s rules for its arguments and torchrun's
  environment (the process group calls recorded, not made);
- the 1×1 mesh (no process group) against the unsharded render, moments,
  train step and adaptive render, bit for bit;
- gloo worlds of 2 ranks (2×1 and 1×2 meshes) and of 4 (2×2, where a
  sample group is not the world): each rank's frame, moments, one train
  step's params and loss, and ``render_adaptive_sharded`` equal, bit for
  bit, the port's per-(tile, sample) band renders and gradients of one
  process combined in the JAX order: each band's sample mean, the loss's
  cotangent on every band of a tile, the gradients averaged over tiles,
  then over samples.  Every group here holds at most two ranks, and a sum
  of two floats does not depend on the order.

The rank worker is this file run as a script (``__main__`` below), so no
rank imports JAX; ``tests/test_torch_mesh_jax.py`` holds its results
against the JAX package's mesh.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from ptx_torch.core import rng  # noqa: E402
from ptx_torch.integrate import adaptive, trace  # noqa: E402
from ptx_torch.integrate.camera import Camera, sample_rays  # noqa: E402
from ptx_torch.parallel import dist as pdist  # noqa: E402
from ptx_torch.parallel import mesh as pmesh  # noqa: E402
from ptx_torch.parallel import render as prender  # noqa: E402
from ptx_torch.scenes.builders import baseline_config1  # noqa: E402

torch.set_num_threads(1)
W, H, SPP, DEPTH, LR = 16, 8, 4, 3, 0.5
RENDER_SEED, STEP_SEED, ADAPT_SEED = 0, 2, 3
ADAPT = dict(spp_base=4, rounds=1, frac=0.25, spp_refine=4, depth=DEPTH)
SHAPES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
OUTPUTS = ("img", "s1", "s2", "loss", "params", "a_img", "a_count", "a_s1", "a_s2")


def target():
    return torch.from_numpy(np.random.default_rng(0).uniform(0.0, 1.0, (H, W, 3))
                            .astype(np.float32))


def flat(params):
    return torch.cat([x.reshape(-1) for _, _, x in prender._leaves(params)])


def workload(scene, mesh):
    """Everything a rank (or one process on the 1×1 mesh) computes, as
    numpy arrays named ``OUTPUTS``."""
    cam = Camera(W, H)
    params = pmesh.shard_params(scene.params, mesh)
    img = prender.render_sharded(scene, cam, mesh, rng.PRNGKey(RENDER_SEED), spp=SPP,
                                 depth=DEPTH, params=params)
    s1, s2 = prender.render_sharded_moments(scene, cam, mesh, rng.PRNGKey(RENDER_SEED),
                                            spp=SPP, depth=DEPTH, params=params)
    step = prender.make_train_step(scene, cam, mesh, spp=SPP, depth=DEPTH, learning_rate=LR)
    new, loss = step(params, target(), rng.PRNGKey(STEP_SEED))
    base = []
    a_img, a_count, _ = prender.render_adaptive_sharded(
        scene, cam, mesh, rng.PRNGKey(ADAPT_SEED), **ADAPT, params=params,
        on_round=lambda s1, s2, c, r: base.extend([s1.clone(), s2.clone()]) if r == 0 else None)
    out = (img, s1, s2, loss, flat(new), a_img, a_count, *base)
    return dict(zip(OUTPUTS, (x.numpy() for x in out)))


def moments(scene, key, tiles, samples):
    """``render_sharded_moments`` from one process: each tile's per-sample
    sums added over the samples."""
    cam, rows, spp = Camera(W, H), H // tiles, SPP // samples
    s1, s2 = [], []
    for t in range(tiles):
        m1, m2 = [], []
        for s in range(samples):
            k = rng.fold(key, t, s)
            o, d = sample_rays(cam, k, range(t * rows, (t + 1) * rows), range(W), spp, "cpu")
            rad = trace.trace_rays(scene, scene.params, o, d, k, DEPTH)
            m1.append(rad.sum(dim=0))
            m2.append((rad ** 2).sum(dim=0))
        s1.append(sum(m1[1:], m1[0]))
        s2.append(sum(m2[1:], m2[0]))
    return torch.cat(s1), torch.cat(s2)


def reference(scene, tiles, samples):
    """The mesh's results from one process: the per-(tile, sample) bands,
    combined in the JAX order."""
    cam, key = Camera(W, H), rng.PRNGKey(RENDER_SEED)
    rows, spp = H // tiles, SPP // samples
    leaves = prender._leaves(scene.params)
    img, grads, losses = [], [], []
    for t in range(tiles):
        y0 = t * rows
        bands = [prender._local_render(scene, cam, DEPTH, spp, scene.params, key, y0, rows,
                                       t, s) for s in range(samples)]
        img.append(sum(bands[1:], bands[0]) / samples)
        # the train step: every band of the tile gets the cotangent of the
        # loss on the tile's sample mean
        xs = [[x.detach().requires_grad_(True) for _, _, x in leaves] for _ in range(samples)]
        bands = [prender._local_render(scene, cam, DEPTH, spp,
                                       prender._rebuild(scene.params, leaves, xs[s]),
                                       rng.PRNGKey(STEP_SEED), y0, rows, t, s)
                 for s in range(samples)]
        mean = (sum((b.detach() for b in bands[1:]), bands[0].detach()) / samples)
        mean.requires_grad_(True)
        loss = torch.mean((mean - target()[y0:y0 + rows]) ** 2)
        (ct,) = torch.autograd.grad(loss, mean)
        losses.append(loss.detach())
        grads.append([torch.cat([(torch.zeros_like(x) if g is None else g).reshape(-1)
                                 for x, g in zip(xs[s], torch.autograd.grad(
                                     bands[s], xs[s], ct, allow_unused=True))])
                      for s in range(samples)])
    by_sample = [sum((grads[t][s] for t in range(1, tiles)), grads[0][s]) / tiles
                 for s in range(samples)]
    g = sum(by_sample[1:], by_sample[0]) / samples
    loss = sum(losses[1:], losses[0]) / tiles        # the same on every sample rank
    new = flat(scene.params) - LR * g
    a1, a2 = moments(scene, rng.PRNGKey(ADAPT_SEED), tiles, samples)
    base = (a1, a2, torch.full((H, W), float(ADAPT["spp_base"])), 0)
    a_img, a_count, _ = adaptive.render_adaptive(scene, cam, rng.PRNGKey(ADAPT_SEED),
                                                 **ADAPT, state=base)
    out = (torch.cat(img), *moments(scene, key, tiles, samples), loss, new, a_img, a_count,
           a1, a2)
    return dict(zip(OUTPUTS, (x.numpy() for x in out)))


def _free_port():
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def launch(world, out_dir):
    """Run ``world`` gloo ranks of the worker below; returns
    ``{(tiles, samples): [rank 0's outputs, rank 1's, ...]}``."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(out_dir),
                               str(r), str(world), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world}:\n{log}"
        assert "JAX_IMPORTED False" in log, log
    return {shape: [dict(np.load(os.path.join(out_dir, f"{shape[0]}x{shape[1]}_{r}.npz")))
                    for r in range(world)] for shape in SHAPES[world]}


@pytest.fixture(scope="module")
def scene():
    return trace.compile_scene(baseline_config1(), "cpu")


@pytest.fixture(scope="module", params=sorted(SHAPES))
def ranks(request, tmp_path_factory):
    return launch(request.param, tmp_path_factory.mktemp(f"world{request.param}"))


# ---------------------------------------------------------------------------
# the mesh and the process group, without a group
# ---------------------------------------------------------------------------

def test_make_mesh_without_a_process_group(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    m = pmesh.make_mesh()
    assert isinstance(m, pmesh.LocalMesh) and m.device == torch.device("cuda", 3)
    assert pmesh.mesh_shape(m) == (1, 1) and pmesh.coordinate(m) == (0, 0)
    assert m.mesh_dim_names == (pmesh.TILE_AXIS, pmesh.SAMPLE_AXIS) == ("tiles", "samples")
    assert pmesh.make_mesh(device="cpu").device == torch.device("cpu")
    assert pmesh.image_rows(m, 8) == (0, 8)
    for tiles, samples in ((2, 1), (1, 2), (None, 2), (0, 1)):
        with pytest.raises(ValueError, match="mesh != 1 devices"):
            pmesh.make_mesh(tiles, samples, device="cpu")


def test_rank_device(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert pmesh.rank_device() == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "5")
    assert pmesh.rank_device() == torch.device("cuda", 5)
    assert pmesh.rank_device("cpu") == torch.device("cpu")


@pytest.fixture()
def recorded(monkeypatch):
    calls = []
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(pdist.torch.cuda, "set_device", lambda d: calls.append(("set", d)))
    monkeypatch.setattr(pdist.dist, "init_process_group",
                        lambda backend, **kw: calls.append(("init", backend, kw)))
    return calls


def test_initialize_is_a_no_op_for_one_process(recorded, monkeypatch):
    pdist.initialize()
    pdist.initialize("h:1", 1, 0)
    monkeypatch.setenv("MASTER_ADDR", "h")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    pdist.initialize()
    assert recorded == []


@pytest.mark.parametrize("env", [{"WORLD_SIZE": "2"}, {"RANK": "1"},
                                 {"MASTER_ADDR": "h", "MASTER_PORT": "1", "RANK": "0"},
                                 {"MASTER_ADDR": "h", "WORLD_SIZE": "2", "RANK": "0"}])
def test_initialize_needs_all_three(recorded, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="needs all of"):
        pdist.initialize()
    assert recorded == []


def test_initialize_sets_the_device_before_the_group(recorded, monkeypatch):
    for k, v in {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500", "WORLD_SIZE": "4",
                 "RANK": "2", "LOCAL_RANK": "2"}.items():
        monkeypatch.setenv(k, v)
    pdist.initialize()
    assert recorded == [("set", torch.device("cuda", 2)),
                        ("init", "nccl", {"init_method": "tcp://10.0.0.1:29500",
                                          "world_size": 4, "rank": 2})]
    recorded.clear()
    pdist.initialize("h:7", 2, 1, device="cpu")      # the arguments win; gloo on the CPU
    assert recorded == [("init", "gloo", {"init_method": "tcp://h:7", "world_size": 2,
                                          "rank": 1})]


# ---------------------------------------------------------------------------
# the 1×1 mesh and the gloo worlds
# ---------------------------------------------------------------------------

def test_1x1_mesh_equals_the_unsharded_render_and_step(scene):
    got = workload(scene, pmesh.make_mesh(device="cpu"))
    want = reference(scene, 1, 1)
    for name in OUTPUTS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # the unsharded step: one autograd pass through the whole frame's loss
    cam, k = Camera(W, H), rng.fold(rng.PRNGKey(STEP_SEED), 0, 0)
    xs = [x.detach().requires_grad_(True) for _, _, x in prender._leaves(scene.params)]
    o, d = sample_rays(cam, k, range(H), range(W), SPP, "cpu")
    img = trace.trace_rays(scene, prender._rebuild(scene.params, prender._leaves(scene.params),
                                                   xs), o, d, k, DEPTH).mean(dim=0)
    loss = torch.mean((img - target()) ** 2)
    gs = torch.autograd.grad(loss, xs, allow_unused=True)
    new = torch.cat([(x.detach() if g is None else x.detach() - LR * g).reshape(-1)
                     for x, g in zip(xs, gs)])
    np.testing.assert_array_equal(got["params"], new.numpy())
    assert float(got["loss"]) == float(loss.detach())
    assert np.abs(got["params"] - flat(scene.params).numpy()).max() > 0


def test_gloo_ranks_equal_the_per_band_renders(scene, ranks):
    for (tiles, samples), per_rank in ranks.items():
        want = reference(scene, tiles, samples)
        for r, got in enumerate(per_rank):
            for name in OUTPUTS:
                np.testing.assert_array_equal(got[name], want[name],
                                              err_msg=f"{tiles}x{samples} rank {r}: {name}")
        assert np.isfinite(want["img"]).all() and want["img"].mean() > 0.01


def test_mesh_errors(scene):
    for cam, shape in ((Camera(W, 7), _Shape(2, 1)), (Camera(W, H), _Shape(1, 3))):
        with pytest.raises(ValueError, match="height/spp must divide"):
            prender._split(scene, cam, shape, SPP)
    with pytest.raises(ValueError, match="compiled for cpu"):
        prender.render_sharded(scene, Camera(W, H), pmesh.LocalMesh(torch.device("cuda", 0)),
                               rng.PRNGKey(0), spp=1, depth=1)
    assert prender._split(scene, Camera(W, H), pmesh.make_mesh(device="cpu"), SPP) == \
        (0, 0, 0, H, SPP)


class _Shape(pmesh.LocalMesh):
    """A mesh of another shape on the CPU, for the divisibility checks."""

    def __init__(self, tiles, samples):
        super().__init__(torch.device("cpu"))
        object.__setattr__(self, "shape", (tiles, samples))


# ---------------------------------------------------------------------------
# the rank worker
# ---------------------------------------------------------------------------

def _worker(out_dir, rank, world, port):
    pdist.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    scene = trace.compile_scene(baseline_config1(), "cpu")
    with pytest.raises(ValueError, match=f"mesh != {world} devices"):
        pmesh.make_mesh(world + 1, 1, device="cpu")
    for tiles, samples in SHAPES[world]:
        mesh = pdist.global_mesh(tiles, samples, device="cpu")
        assert mesh.mesh_dim_names == ("tiles", "samples")
        assert pmesh.mesh_shape(mesh) == (tiles, samples)
        assert pmesh.coordinate(mesh) == divmod(rank, samples)
        np.savez(os.path.join(out_dir, f"{tiles}x{samples}_{rank}.npz"),
                 **workload(scene, mesh))
    pdist.dist.destroy_process_group()
    print("JAX_IMPORTED", "jax" in sys.modules)


if __name__ == "__main__":
    _worker(sys.argv[1], *(int(a) for a in sys.argv[2:]))
