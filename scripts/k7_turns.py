"""K7, the fused emission kernel, at a chunk's and a train step's widths,
in any tree of the port (the parent of its redesign or later).

    python <this script> TAG          (from the root of the tree to measure)

Run it from two trees in turns (parent, change, change, parent) in one
call on one card to compare them.  With the demo compiled under
``PTX_EMK=1`` it records K7's inputs on one chunk (band 256, chunk 0,
forward + backward of ``radiance.mean()``) and on one ``make_train_step``
step (512², spp 16, depth 16), the cotangent of K7's output included, then
times on those inputs, each the median of 20 calls between CUDA events:
the forward's wrapper as a render calls it, its bare launch queued behind
a device sleep, the plain ``eval_emissive``; the backward as autograd
calls it, queued; ``index_add_`` of the same values into the same flat
``(H·W + R, 3)`` bins; and the kernels each wrapper launches (the
profiler).  The tree's own ``chip_smoke`` supplies the timers.  Without
CUDA it rehearses the control flow on the CPU at a tiny size.
"""
import json
import os
import sys
import types

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ptx_torch.core import rng  # noqa: E402
from ptx_torch.integrate import render  # noqa: E402
from ptx_torch.integrate.camera import Camera  # noqa: E402
from ptx_torch.ops import emission_kernel as ek  # noqa: E402
from ptx_torch.parallel.render import _local_render, make_train_step  # noqa: E402
from ptx_torch.scenes import builders  # noqa: E402

TAG = sys.argv[1] if len(sys.argv) > 1 else "tree"
BIN = hasattr(ek.EmissionKernel, "launch_bwd")   # the redesign: one bin a lane
DRY = not torch.cuda.is_available()
dev = torch.device("cpu") if DRY else torch.device("cuda", 0)
if DRY:
    cs._time_ms = cs._time_queued_ms = lambda fn, **k: (fn(), 0.0)[1]
    cs._kernels_launched = lambda fn: (fn(), 0)[1]
    torch.cuda.synchronize = lambda: None
else:
    torch.cuda.set_device(0)
os.makedirs(cs.OUT, exist_ok=True)
pe = cs._compile_with_emk(builders.make_world(), dev)
kern = pe.emission_fn
P = pe.params
if DRY:                 # the plain versions stand in for the launches
    kern.launch = lambda *a: ek.lanes_reference(kern, *a)
    if BIN:
        kern.launch_bwd = lambda *a: ek.backward_reference(kern, *a)
if DRY and not BIN:     # before the redesign the CPU path skipped _Emission
    ek.EmissionKernel.__call__ = lambda self, p, pos, mid: ek._Emission.apply(
        self, p["tex_xform"], p["const"], p["factor"], p["images"][self.img_id], pos, mid)
img = P["images"][kern.img_id]
H, W, C = img.shape
R = P["const"].shape[0]
SZ = 16 if DRY else 512
SPP = 2 if DRY else 16
cam = Camera.reference_demo(SZ, SZ)

fwd_calls, bwd_calls = [], []
orig_bwd = ek._Emission.backward


def rec_bwd(ctx, ct):
    """K7's backward, logging its cotangent and what it saved."""
    saved = ctx.saved_tensors
    if not BIN:
        saved = types.SimpleNamespace(saved_tensors=saved, kern=ctx.kern, shapes=ctx.shapes)
    bwd_calls.append((ct.detach(), saved))
    return orig_bwd(ctx, ct)


def leaves():
    return {k: ([x.detach().requires_grad_(True) for x in v] if isinstance(v, list)
                else v.detach().requires_grad_(True)) for k, v in P.items()}


ek._Emission.backward = staticmethod(rec_bwd)
with cs._swapped(pe, "emission_fn", cs._recording_em(kern, fwd_calls)):
    k = rng.fold(rng.PRNGKey(0), 0, SZ // 2)
    o, d = render.sample_rays(cam, k, range(SZ // 2, SZ // 2 + SZ // 4), range(SZ), 1, dev)
    render.trace_rays(pe, leaves(), o, d, k, 16).mean().backward()
    with torch.no_grad():
        target = _local_render(pe, cam, 16, SPP, P, rng.PRNGKey(1), 0, SZ)
    step = make_train_step(pe, cam, spp=SPP, depth=16, learning_rate=3e-4)
    step(P, target, rng.PRNGKey(2))
torch.cuda.synchronize()
ek._Emission.backward = orig_bwd
print(f"[{TAG}] K7 calls {[c[1].shape[0] for c in fwd_calls]}, backward calls "
      f"{[c[0].shape[0] for c in bwd_calls]}", flush=True)


def flat_bins(saved):
    """Each lane's bin of the combined histogram, in [0, H·W + R) or -1."""
    if BIN:
        return saved[0].to(torch.int64)
    _, xi, yi, flags, row, _ = saved.saved_tensors
    sel, inb = (flags & 1).bool(), (flags & 2).bool()
    return torch.where(sel, torch.where(inb, yi.long() * W + xi.long(), -1), H * W + row.long())


res = {}
for name, i in (("chunk", 0), ("train", -1)):    # the chunk's call, the step's
    _, pos, mid, _ = fwd_calls[i]
    ct, saved = bwd_calls[i]
    N = pos.shape[0]
    with torch.no_grad():
        wrap = lambda: kern(P, pos, mid)
        plain = lambda: pe.material_fn.eval_emissive(P, pos, mid)
        bare = lambda: kern.launch(P["tex_xform"], P["const"], P["factor"], img, pos, mid)
        n_fwd = cs._kernels_launched(wrap)
        p1, w1 = cs._time_ms(plain), cs._time_ms(wrap)
        w2, p2 = cs._time_ms(wrap), cs._time_ms(plain)
        q = cs._time_queued_ms(bare)
    bwd = ((lambda: kern.launch_bwd(ct, saved[0], img, P["factor"], (R, 3),
                                    tuple(P["factor"].shape))) if BIN
           else (lambda: ek._Emission.backward(saved, ct)))
    n_bwd = cs._kernels_launched(bwd)
    b = flat_bins(saved)
    chain = b < H * W
    vals = torch.where((b >= 0)[:, None],
                       torch.where(chain[:, None], ct * P["factor"][kern.factor_idx], ct), 0.0)
    flat = b.clamp(min=0)
    add = lambda: torch.zeros((H * W + R, 3), device=dev).index_add_(0, flat, vals)
    a1, b1, b2, a2 = cs._time_ms(add), cs._time_ms(bwd), cs._time_ms(bwd), cs._time_ms(add)
    bq = cs._time_queued_ms(bwd)
    nz = (ct != 0).any(1)
    res[name] = dict(N=N, fwd_kernels=n_fwd, wrapper_ms=min(w1, w2), queued_ms=q,
                     plain_ms=min(p1, p2), bwd_kernels=n_bwd, bwd_ms=min(b1, b2),
                     bwd_queued_ms=bq, index_add_ms=min(a1, a2), nonzero_ct=int(nz.sum()),
                     chain_adding=int((chain & (b >= 0) & nz).sum()))
    print(f"[{TAG} {name}] N={N}: fwd wrapper {w1:.4f} / {w2:.4f} ms ({n_fwd} kernels), "
          f"queued {q:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; bwd {b1:.4f} / {b2:.4f} ms "
          f"({n_bwd} kernels), bwd queued {bq:.4f} ms; index_add_ {a1:.4f} / {a2:.4f} ms; "
          f"lanes with nonzero ct {res[name]['nonzero_ct']}, chain lanes adding "
          f"{res[name]['chain_adding']}", flush=True)
print(json.dumps({"tag": TAG, **res}))
