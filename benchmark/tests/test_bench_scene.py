"""The configurations' scene documents: the port compiles each to the
scene of its builder, and the reference reads the same tables from it."""

import numpy as np
import pytest
import torch

from benchmark import hdr, inputs
from benchmark.reference import scene as rscene


def _port_params(root_world):
    from ptx_torch.integrate.trace import compile_scene

    return compile_scene(root_world, "cpu")


def _spec_world(name, tmp_path):
    from ptx_torch.scenes.spec import SceneSpec

    config = inputs.load_json("configs", name)
    inputs.write_images(config, str(tmp_path))
    doc = dict(config["scene"], camera={"width": 512, "height": 512, "reference_demo": True})
    return SceneSpec(doc, base_dir=str(tmp_path)).build()[0], doc


def _builder_world(name, tmp_path):
    from ptx_torch import io
    from ptx_torch.scenes import builders

    if name == "demo":
        return builders.make_world(io.load(str(tmp_path / "sky.hdr")))
    return builders.stress_spheres(249)


@pytest.mark.parametrize("name", ["demo", "S1"])
def test_spec_compiles_to_the_builders_scene(name, tmp_path):
    from ptx_torch.geom.fasthit import collect_leaves

    world, _ = _spec_world(name, tmp_path)
    a, b = _port_params(world), _port_params(_builder_world(name, tmp_path))
    assert a.params.keys() == b.params.keys()
    for k in a.params:
        xs = a.params[k] if isinstance(a.params[k], list) else [a.params[k]]
        ys = b.params[k] if isinstance(b.params[k], list) else [b.params[k]]
        assert all(torch.equal(x, y) for x, y in zip(xs, ys)), k
    order = lambda s: [(lf.kind, lf.index, lf.mat_id) for lf, _ in collect_leaves(s.plan)]
    assert order(a) == order(b)
    assert len(order(a)) == {"demo": 13, "S1": 256}[name]
    assert type(a.bounce_fn).__name__ == {"demo": "BounceKernel", "S1": "MegaBounce"}[name]


@pytest.mark.parametrize("name", ["demo", "S1"])
def test_reference_reads_the_same_tables(name, tmp_path):
    world, doc = _spec_world(name, tmp_path)
    port = _port_params(world)
    ref = rscene.parse(doc, str(tmp_path))
    for k in ("sphere_center", "sphere_radius", "plane_normal", "plane_d", "ior", "factor",
              "tex_xform"):
        assert np.array_equal(ref.tables[k], port.params[k].numpy()), k
    # the same constant colours, one row per constant slot (the port adds a
    # zero row where a slot is an image chain)
    rows = lambda t: sorted(map(tuple, t.tolist()))
    port_rows = rows(port.params["const"])
    assert all(r in port_rows for r in rows(torch.from_numpy(ref.tables["const"])))
    assert [im.shape for im in ref.images] == [tuple(x.shape) for x in port.params["images"]]
    for x, y in zip(ref.images, port.params["images"]):
        assert np.array_equal(x, y.numpy())
    assert ref.flat_union == (name == "S1")
    assert len(ref.leaves) == {"demo": 13, "S1": 256}[name]


def test_sky_file_round_trips_and_is_the_frozen_formula(tmp_path):
    from ptx_torch.scenes.builders import procedural_sky_image

    img = hdr.formula("procedural_sky")(64, 128)
    assert np.array_equal(img, procedural_sky_image(64, 128))
    path = tmp_path / "sky.hdr"
    hdr.write_flat(str(path), img)
    from ptx_torch import io

    assert np.array_equal(hdr.read_flat(str(path)), io.load(str(path)))
    # RGBE keeps 8 bits of mantissa, under the pixel's largest channel
    err = np.abs(hdr.read_flat(str(path))[..., :3] - img[..., :3])
    assert (err <= img[..., :3].max(axis=-1, keepdims=True) / 128).all()


def test_emission_is_all_the_seed_changes():
    config = inputs.load_json("configs", "S1")
    a, b = inputs.scene_doc(config, 1), inputs.scene_doc(config, 2)
    assert a["world"] == b["world"] == config["scene"]["world"]
    for name, m in a["materials"].items():
        for slot in ("reflect", "scatter", "transmit", "transmit_reflect", "ior"):
            assert m[slot] == config["scene"]["materials"][name][slot]
    assert a["materials"]["emissive_gold"]["emissive"] != b["materials"]["emissive_gold"]["emissive"]
    assert inputs.scene_doc(config, 2 ** 31 + 5) == inputs.scene_doc(config, 2 ** 31 + 5)
