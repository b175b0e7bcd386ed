"""The port's checkpoints (``ptx_torch.parallel.checkpoint``) and the
CLI's ``--checkpoint`` / ``--preview`` render against the JAX package's.

- ``RenderAccumulator``, ``AdaptiveCheckpoint`` and ``save_params`` /
  ``load_params``: a file written by either package reads in the other,
  equal bit for bit (params and key included);
- the CLI on the CPU (demo, 8×8, depth 2): the port resumes a checkpoint
  the JAX CLI wrote at spp 2 up to spp 4, and the image equals the JAX
  CLI's uninterrupted spp 4 render within ``rtol 1e-4, atol 1e-5`` (the
  tolerance of ``tests/test_torch_trace.py``: float32 reassociation and
  last-ulp transcendentals between XLA and PyTorch); the port's resumed,
  uninterrupted and fast-path renders agree within ``rtol 1e-6, atol
  1e-7`` (same keys, same operations; only the fast path's float32
  running mean against the checkpoint's float64 sums differs);
- ``--preview`` writes its ANSI half-block frame and renders the
  checkpoint path's image.
"""

import numpy as np
import jax
import pytest
import torch

from ptx import cli as jcli
from ptx.integrate import trace as jtr
from ptx.parallel import checkpoint as jck
from ptx.scenes.builders import make_world as jax_make_world
from ptx_torch import cli
from ptx_torch.convert import params_from_jax
from ptx_torch.core import rng
from ptx_torch.integrate import trace
from ptx_torch.parallel import checkpoint as ck
from ptx_torch.scenes.builders import make_world

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5
ARGS = ["render", "--demo", "demo", "--width", "8", "--height", "8", "--depth", "2"]


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jtr.compile_scene(jax_make_world(), pallas=False).params)


def test_render_accumulator_both_ways(tmp_path):
    r = np.random.default_rng(0)
    img = r.uniform(0, 2, (5, 7, 3)).astype(np.float32)
    a = jck.RenderAccumulator(5, 7, str(tmp_path / "j.npz"))
    a.add(img, 3, 0)
    a.add(img[:2] * 0.5, 1, 3)
    a.save()
    b = ck.RenderAccumulator(5, 7, str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(b.sum, a.sum)
    np.testing.assert_array_equal(b.count, a.count)
    assert b.samples_done == a.samples_done == 3
    np.testing.assert_array_equal(b.image(), a.image())

    b.add(torch.from_numpy(img), 2, 0)
    b.save(str(tmp_path / "t.npz"))
    c = jck.RenderAccumulator(5, 7, str(tmp_path / "t.npz"))
    assert c.sum.dtype == np.float64 and c.count.dtype == np.int64
    np.testing.assert_array_equal(c.sum, b.sum)
    np.testing.assert_array_equal(c.count, b.count)


def test_adaptive_checkpoint_both_ways(tmp_path):
    r = np.random.default_rng(1)
    s1, s2 = (r.uniform(0, 4, (4, 6, 3)).astype(np.float32) for _ in range(2))
    count = r.integers(2, 9, (4, 6)).astype(np.float32)
    jck.AdaptiveCheckpoint(4, 6, str(tmp_path / "j.npz")).update(s1, s2, count, 2)
    got = ck.AdaptiveCheckpoint(4, 6, str(tmp_path / "j.npz"))
    assert got.state[3] == 2
    for a, b in zip(got.state[:3], (s1, s2, count)):
        np.testing.assert_array_equal(a, b)

    assert ck.AdaptiveCheckpoint(4, 6, str(tmp_path / "none.npz")).state is None
    ck.AdaptiveCheckpoint(4, 6, str(tmp_path / "t.npz")).update(
        torch.from_numpy(s1 * 2), torch.from_numpy(s2), torch.from_numpy(count), 3)
    back = jck.AdaptiveCheckpoint(4, 6, str(tmp_path / "t.npz"))
    assert back.rounds_done == 3
    np.testing.assert_array_equal(back.s1, s1 * 2)
    np.testing.assert_array_equal(back.count, count)


def test_params_both_ways(tmp_path, jax_params):
    """``leaf_i`` follows ``jax.tree.flatten``'s order (dict keys sorted),
    which is not the port's insertion order: the two map explicitly."""
    order = list(trace.compile_scene(make_world(), "cpu").params)    # the port's
    assert order != sorted(order)
    conv = params_from_jax(jax_params, "cpu")
    template = {k: conv[k] for k in order}
    jkey = jax.random.fold_in(jax.random.PRNGKey(5), 7)
    jck.save_params(str(tmp_path / "j.npz"), jax_params, 11, jkey)
    got, step, key = ck.load_params(str(tmp_path / "j.npz"), template)
    assert step == 11 and key == rng.fold(rng.PRNGKey(5), 7)
    assert list(got) == list(template)
    for k, v in template.items():
        for a, b in zip(*(x if isinstance(x, list) else [x] for x in (got[k], v))):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), b.numpy())

    moved = {k: ([x + 1 for x in v] if isinstance(v, list) else v * 2)
             for k, v in template.items()}
    ck.save_params(str(tmp_path / "t.npz"), moved, 12, key)
    back, step, bkey = jck.load_params(str(tmp_path / "t.npz"), jax_params)
    assert step == 12
    assert np.asarray(bkey).dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(bkey), np.asarray(jkey))
    for k in jax_params:
        for a, b in zip(*(x if isinstance(x, list) else [x] for x in (back[k], moved[k]))):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_port_resumes_a_jax_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jck_path, jfull = str(tmp_path / "j.npz"), str(tmp_path / "jfull.npz")
    jcli.main(ARGS + ["--spp", "2", "--checkpoint", jck_path, "--out", str(tmp_path / "j2")])
    jcli.main(ARGS + ["--spp", "4", "--checkpoint", jfull, "--out", str(tmp_path / "j4")])
    resumed = cli.main(ARGS + ["--spp", "4", "--device", "cpu", "--checkpoint", jck_path,
                               "--out", str(tmp_path / "t4")])
    assert ck.RenderAccumulator(8, 8, jck_path).samples_done == 4
    want = jck.RenderAccumulator(8, 8, jfull).image()
    np.testing.assert_allclose(resumed, want, rtol=RTOL, atol=ATOL)
    assert resumed.mean() > 0


def test_resume_equals_uninterrupted_equals_fast_path(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    cli.main(ARGS + ["--spp", "2", "--device", "cpu", "--checkpoint", a, "--out", "x"])
    resumed = cli.main(ARGS + ["--spp", "4", "--device", "cpu", "--checkpoint", a,
                               "--out", "x"])
    whole = cli.main(ARGS + ["--spp", "4", "--device", "cpu", "--checkpoint", b,
                             "--out", "x"])
    fast = cli.main(ARGS + ["--spp", "4", "--device", "cpu", "--out", "x"])
    np.testing.assert_array_equal(resumed, whole)
    np.testing.assert_allclose(fast, whole, rtol=1e-6, atol=1e-7)
    capsys.readouterr()
    again = cli.main(ARGS + ["--spp", "4", "--device", "cpu", "--checkpoint", a,
                             "--out", "x"])
    assert "checkpoint already has 4/4 spp" in capsys.readouterr().out
    np.testing.assert_array_equal(again, whole)


def test_preview_writes_its_ansi_frame(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    frame = cli.main(ARGS + ["--spp", "2", "--device", "cpu", "--preview", "--out", "p"])
    out = capsys.readouterr().out
    assert out.count("\x1b[H\x1b[2J") == 2          # one redraw a band × sample chunk
    assert "\x1b[38;2;" in out and "▀" in out
    ckpt = cli.main(ARGS + ["--spp", "2", "--device", "cpu", "--checkpoint",
                            str(tmp_path / "c.npz"), "--out", "c"])
    np.testing.assert_array_equal(frame, ckpt)
