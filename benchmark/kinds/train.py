"""The ``train`` kind: a closed loop of one optimising user.

``make_train_step`` at the mix's ``spp`` and ``learning_rate`` over the
whole frame, one wavefront a step; step ``i`` keyed
``fold(root_key(seed), i)``; steps chained (each takes the previous
params), with a synchronise and the loss read after each step.

Set-up runs the mix's ``setup_steps`` steps of the chain through the same
step: they warm it up, and the check holds them against the reference.
The check also holds one step of the window, step ``setup_steps + k``
with ``k`` drawn from the seed below ``checked_within``: the program's
parameters are copied before and after it, and the reference takes the
same step from the copy before.  Where the window closes first, the chain
goes on, untimed, until that step is taken.
"""

from __future__ import annotations

import math
import random
import statistics
import time

import torch

from benchmark import compare, drivers, inputs
from benchmark.reference import scene as rscene
from benchmark.reference import tracer


class Driver(drivers.Driver):
    unit_name, grad = "step", True

    def setup(self):
        from ptx_torch.parallel.render import make_train_step

        self.build()
        t = self.traffic
        self.spp, self.lr = int(t["spp"]), float(t["learning_rate"])
        self.lanes = self.width * self.height * self.spp
        self.n_setup = int(t["setup_steps"])
        self.checked_step = self.n_setup + random.Random(self.seed).randrange(
            int(t["checked_within"]))
        self.target = inputs.target(self.seed, self.height, self.width, self.device)
        self.step = make_train_step(self.scene, self.cam, spp=self.spp, depth=self.depth,
                                    learning_rate=self.lr)
        params = self.scene.params
        self.checked = {"p0": drivers.leaves(params), "losses": []}
        for i in range(self.n_setup):
            params, loss = self.step(params, self.target, inputs.step_key(self.seed, i))
            self.checked["losses"].append(float(loss))
            if i == 0:
                self.checked["p1"] = drivers.leaves(params)
        self.checked["p3"] = drivers.leaves(params)
        self.params, self.i = params, self.n_setup
        drivers.sync(self.device)

    def _one(self):
        before = drivers.leaves(self.params) if self.i == self.checked_step else None
        self.params, loss = self.step(self.params, self.target,
                                      inputs.step_key(self.seed, self.i))
        drivers.sync(self.device)
        loss = float(loss)
        if before is not None:
            self.checked["window"] = {"i": self.i, "before": before, "loss": loss,
                                      "after": drivers.leaves(self.params)}
        self.i += 1
        return loss

    def window(self, seconds):
        times, failed = [], 0
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            if not math.isfinite(self._one()):
                failed += 1
            b = time.perf_counter()
            times.append(b - a)
            if b - t0 >= seconds:
                break
        wall = b - t0
        while "window" not in self.checked:
            self._one()
        ms = sorted(x * 1e3 for x in times)
        p95 = statistics.quantiles(ms, n=20)[18] if len(ms) >= 2 else ms[0]
        self.unit_wall_ms = wall * 1e3 / len(times)
        return {"attempted": len(times), "failed": failed, "unit_s": times,
                "metrics": {"train_step_ms": self.unit_wall_ms, "train_step_p95_ms": p95}}

    def before_profile(self):
        pass

    def profile_units(self):
        for _ in range(int(self.traffic["profile_steps"])):
            self._one()
        return int(self.traffic["profile_steps"])

    def release(self):
        del self.step, self.params, self.scene
        self.target = self.target.to("cpu")

    def check(self):
        self.ref = reference_side(self, self.ref_scene(), torch.float32, self.spp)
        return numbers(self.checked, self.ref, self.lr)


def numbers(side: dict, ref: dict, learning_rate: float) -> dict:
    return dict(compare.train_numbers(side, ref, learning_rate),
                **compare.window_numbers(side["window"], ref["window"], learning_rate))


def _leaves(P) -> dict:
    return {k: v.detach().float().cpu() for k, v in tracer.leaves_of(P).items() if v.numel()}


def _grad_norms(g) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in g.items() if v.numel()}


def reference_side(drv, rs, dtype, spp) -> dict:
    """The reference's readings in ``dtype`` at ``spp`` samples a pixel:
    the set-up steps from the scene's own parameters, and the window's
    checked step from the program's parameters before it."""
    target = drv.target.to(drv.device)

    def step(P, i):
        return tracer.train_step(rs, P, target, inputs.step_key(drv.seed, i), spp,
                                 drv.depth, drv.lr, drv.device, dtype)

    P = rscene.params(rs, drv.device, dtype)
    side = {"p0": _leaves(P), "losses": []}
    for i in range(drv.n_setup):
        P, loss, g = step(P, i)
        side["losses"].append(float(loss))
        if i == 0:
            side["p1"], side["grad_norms"] = _leaves(P), _grad_norms(g)
    side["p3"] = _leaves(P)
    w = drv.checked["window"]
    P = rscene.params(rs, drv.device, dtype)
    P = tracer.with_leaves(P, {k: w["before"][k].to(drv.device, dtype) if k in w["before"]
                               else v for k, v in tracer.leaves_of(P).items()})
    before = _leaves(P)
    P, loss, g = step(P, w["i"])
    side["window"] = {"i": w["i"], "before": before, "after": _leaves(P),
                      "loss": float(loss), "grad_norms": _grad_norms(g)}
    return side


def controls(drv) -> dict:
    """The control (the reference in bfloat16 in the program's place) and
    the fault of half the batch (the reference over half of each step's
    samples, the mean taken over them), each judged against the float32
    reference of the driver's check; a step that returns its state
    unchanged reads 1 on the gaps of the applied gradient and the change
    by their definition."""
    rs = drv.ref_scene()
    out = {name: numbers(reference_side(drv, rs, dtype, spp), drv.ref, drv.lr)
           for name, dtype, spp in (("control", torch.bfloat16, drv.spp),
                                    ("half_batch", torch.float32, drv.spp // 2))}
    out["state_unchanged"] = {"grad_gap": 1.0, "change_gap": 1.0, "window_grad_gap": 1.0}
    return out
