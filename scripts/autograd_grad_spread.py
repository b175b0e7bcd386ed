"""How far the plain-autograd route's gradient (``make_train_step(
manual_vjp=False)``) sits from the manual route's, against the spread of
each route between two runs, at three sizes of one step: 512² at spp 16
and spp 4, and a 32-row band at spp 2, on the demo (K4) and on S1
(``stress_spheres(249)``, K5's hit mode).

    python scripts/autograd_grad_spread.py        (from the repository root, on a card)

Each step starts from ``chip_smoke``'s phase 7 start (radii ×1.05, const
row 0 lowered by 0.1) at learning rate ``chip_smoke.H_LR``, so ``(start −
new) / H_LR`` is the gradient; ``remat`` off.  Per tensor it prints
max|a − b| / max|b| for: the manual route twice (m1-m2), the autograd
route twice (a1-a2), across the routes (a-m), across the routes under
PyTorch's deterministic algorithms (det a-m), and the autograd route
against itself with the hit replay's backward run in float64 (a32-a64:
``fasthit.HitReplay.backward`` patched for the run; it moves every
near-grazing lane's guards, so it is no float64 truth).  The card's name
and power limit are printed last.
"""
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ptx_torch.core import rng  # noqa: E402
from ptx_torch.geom import fasthit  # noqa: E402
from ptx_torch.integrate.camera import Camera  # noqa: E402
from ptx_torch.integrate.trace import compile_scene  # noqa: E402
from ptx_torch.parallel.render import _local_render, make_train_step  # noqa: E402
from ptx_torch.scenes import builders  # noqa: E402

KEYS = ("sphere_center", "sphere_radius", "plane_normal", "plane_d", "ior", "const")


def _bwd64(ctx, ct_t, ct_n):
    evt, entering, hit, o, d, *geo = ctx.saved_tensors
    with torch.enable_grad():
        xs = [x.detach().double().requires_grad_(True) for x in (o, d, *geo)]
        t, n = ctx.replay(dict(zip(fasthit.GEO_KEYS, xs[2:])), xs[0], xs[1], evt, entering,
                          hit)
        grads = torch.autograd.grad((t, n), xs, (ct_t.double(), ct_n.double()),
                                    allow_unused=True)
    return (None,) * 6 + tuple(None if g is None else g.float() for g in grads)


def rel(a, b):
    return {k: float(f"{float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-30):.3g}")
            for k in KEYS if k in b and b[k].numel() and float(b[k].abs().max()) > 0}


def main():
    if not torch.cuda.is_available():
        print("autograd_grad_spread: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    os.makedirs(cs.OUT, exist_ok=True)
    _, smi = cs.phase_device()
    cs.phase_build()
    for name, make in (("demo", builders.make_world),
                       ("S1", lambda: builders.stress_spheres(249))):
        scene = compile_scene(make(), dev)
        for spp, rows in ((16, cs.H), (4, cs.H), (2, 32)):
            cam = Camera.reference_demo(cs.W, rows)
            with torch.no_grad():
                target = _local_render(scene, cam, cs.DEPTH, spp, scene.params,
                                       rng.PRNGKey(1), 0, rows)
            start, key = cs._perturbed(scene.params), rng.fold(rng.PRNGKey(2), 0)

            def grads(manual, det=False):
                step = make_train_step(scene, cam, spp=spp, depth=cs.DEPTH,
                                       learning_rate=cs.H_LR, manual_vjp=manual, remat=False)
                with cs._deterministic() if det else cs._all():
                    new, _ = step(start, target, key)
                torch.cuda.synchronize()
                return cs._h_grads(start, new)

            m1, m2, a1, a2 = grads(True), grads(True), grads(False), grads(False)
            md, ad = grads(True, True), grads(False, True)
            plain = fasthit.HitReplay.backward
            fasthit.HitReplay.backward = staticmethod(_bwd64)
            try:
                a64 = grads(False)
            finally:
                fasthit.HitReplay.backward = plain
            print(f"[{name} {rows}x{cs.W} spp {spp}] m1-m2 {rel(m1, m2)}; a1-a2 {rel(a1, a2)}; "
                  f"a-m {rel(a1, m1)}; det a-m {rel(ad, md)}; a32-a64 {rel(a1, a64)}", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
