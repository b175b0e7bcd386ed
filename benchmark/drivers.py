"""What every traffic driver shares.

A mix is a data file, ``benchmark/traffic/<mix>.json``; its ``kind`` names
the driver that reads it, ``benchmark/kinds/<kind>.py``.  A kind module
holds:

- ``Driver``, a subclass of :class:`Driver`: ``setup`` builds the
  program's objects from the inputs and warms up the cell's shapes,
  ``window`` runs the timed loop, ``before_profile`` and
  ``profile_units`` run the traced segment's work unprofiled and
  profiled, ``release`` frees the program's state, and ``check`` returns
  the numbers :mod:`benchmark.compare` names;
- ``controls(driver)``, the readings the limits are set from: the control
  and the faults, worked out from a driver whose run is checked (see
  :mod:`benchmark.calibrate`).

A new kind of mix is a new file there, found by name
(:func:`benchmark.load_module`).
"""

from __future__ import annotations

import torch

from benchmark import inputs
from benchmark.reference import scene as rscene


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def leaves(params) -> dict:
    """The program's parameter tensors by leaf name (lists by index),
    empty ones left out, copied to the CPU."""
    out = {}
    for k, v in params.items():
        for name, x in ([(f"{k}.{i}", x) for i, x in enumerate(v)] if isinstance(v, list)
                        else [(k, v)]):
            if x.numel():
                out[name] = x.detach().to("cpu", copy=True)
    return out


class Driver:
    def __init__(self, config, traffic, seed, device, workdir, root=inputs.ROOT):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.workdir = device, workdir
        self.depth = int(config["depth"])
        self.width = int(config["frame"]["width"])
        self.height = int(config["frame"]["height"])
        self.doc = inputs.scene_doc(config, seed)
        inputs.write_images(config, workdir, root)

    def build(self):
        from ptx_torch.integrate.trace import compile_scene
        from ptx_torch.scenes.spec import SceneSpec

        world, self.cam, _ = SceneSpec(self.doc, base_dir=self.workdir).build()
        self.scene = compile_scene(world, self.device)

    def ref_scene(self):
        return rscene.parse(self.doc, self.workdir)
