"""The scene buffers the kernels read, for the benchmark's scenes: dump them,
or compare two dumps bit for bit.

For each of the benchmark's configurations ``demo``, ``S1`` and
``config4`` (``benchmark/configs``, emission scaled from seed 0), the
scene is compiled on ``--device`` and every buffer its hit, bounce and
replay backward pack for one ``trace_rays`` call is saved: K4's buffer
(the demo's and config 4's hit), K1's buffer and K2's vector (the demo's
bounce and backward), K5's hit-mode and bounce-mode scenes and K6's
vector (S1), and config 4's unfused bounce's (K4's buffer again).  An
object that packs nothing is left out.

    python scripts/scene_buffers.py --device cuda --out build/buf.npz
    python scripts/scene_buffers.py --root build/parent --out build/buf_parent.npz
    python scripts/scene_buffers.py --compare build/buf_parent.npz build/buf.npz

``--root`` puts another checkout's ``ptx_torch`` and ``benchmark`` first
on the import path (a parent commit, to compare against).  The compare
prints one JSON line with the keys of each dump and the keys whose arrays
differ in shape, dtype or any bit, and exits 1 where any differs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

CONFIGS = ("demo", "S1", "config4")
ROLES = ("hit_fn", "bounce_fn", "bounce_bwd_fn")


def _arrays(name, role, packed):
    """``packed`` (a tensor, or K5's ``(scene, mat_off, bnd_off)``) as named
    numpy arrays."""
    if isinstance(packed, tuple):
        buf, *offsets = packed
        return {f"{name}.{role}": buf.detach().cpu().numpy(),
                f"{name}.{role}.offsets": np.asarray(offsets, np.int64)}
    return {f"{name}.{role}": packed.detach().cpu().numpy()}


def dump(device, out):
    import torch

    from benchmark import inputs
    from ptx_torch.integrate.trace import compile_scene
    from ptx_torch.scenes.spec import SceneSpec

    arrays = {}
    with tempfile.TemporaryDirectory() as work:
        for name in CONFIGS:
            config = inputs.load_json("configs", name)
            inputs.write_images(config, work)
            world, _, _ = SceneSpec(inputs.scene_doc(config, 0), base_dir=work).build()
            scene = compile_scene(world, device)
            for role in ROLES:
                pack = getattr(getattr(scene, role), "pack", None)
                packed = pack(scene.params) if pack is not None else None
                if packed is not None:
                    arrays.update(_arrays(name, role, packed))
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **arrays)
    print(json.dumps({"out": out, "device": str(device),
                      "buffers": {k: list(v.shape) for k, v in arrays.items()}}))


def compare(a, b):
    with np.load(a) as fa, np.load(b) as fb:
        ka, kb = sorted(fa.files), sorted(fb.files)
        differ = [k for k in ka if k in fb.files and not (
            fa[k].shape == fb[k].shape and fa[k].dtype == fb[k].dtype
            and fa[k].tobytes() == fb[k].tobytes())]
    same = ka == kb and not differ
    print(json.dumps({"equal": same, "keys": ka, "only_in_first": sorted(set(ka) - set(kb)),
                      "only_in_second": sorted(set(kb) - set(ka)), "differ": differ}))
    return 0 if same else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="build/scene_buffers.npz")
    ap.add_argument("--root", default=None, help="a checkout to import ptx_torch from")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    root = os.path.abspath(args.root or os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    dump(args.device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
