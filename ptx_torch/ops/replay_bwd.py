"""The row-fed replay backward K6: the decision-frozen replay VJP of one
bounce at any leaf count, for large scenes.

Port of ``ptx/ops/replay_bwd.py`` ``build_replay_bwd`` (:47), a Pallas TPU
kernel, as the hand-written CUDA kernel ``ptx_torch/csrc/replay_bwd_kernel.cu``.
It computes what K2 computes (the per-lane adjoint of ``csrc/replay_lane.cuh``
and the per-leaf sums of the row and material cotangents), without K2's
24-leaf cap: the (L, 34) sums live in shared memory and are reduced in the
kernel, deterministically.

:class:`RowFedReplayBwd` is K6's wrapper, with the contract of the JAX
``bwd_fn`` (``replay_bwd.py:177-222``): ``bwd(params, o, d, thr, dec,
ct_o2, ct_d2, ct_thr2) -> (d_o, d_d, d_thr, d_params)``.  The kernel reads
per leaf the 36 words of :meth:`RowFedReplayBwd.pack36` (the replay row,
kind and parity, the leaf's material scalars); the per-leaf sums map to
the params through autograd of that packing.  For CPU tensors, and only
for those, the wrapper runs the plain version ``bounce_bwd_reference``
(autograd through ``trace._bounce_replay``); the kernel's raw outputs are
held against ``bounce_bwd_lanes_reference``.
"""

from __future__ import annotations

import torch

from ptx_torch.geom import hitreplay
from ptx_torch.geom.fasthit import collect_leaves
from ptx_torch.integrate import trace
from ptx_torch.ops import bounce_kernel as bk

RCOLS = 36                   # 26 replay row | sphere, parity | 8 material scalars
_COLS = bk._COLS             # 34 cotangent columns per leaf (row 26, material 8)
_BLOCKS = 264                # the grid: two blocks per SM of an H100
MAX_SMEM = 232448


class RowFedReplayBwd:
    """K6 for one compiled scene (see the module docstring).
    ``LAUNCHES`` counts calls of the kernel (two launches each: the
    per-block partial sums, then their reduction)."""

    LAUNCHES = 0

    def __init__(self, scene):
        self.scene = scene
        self.leaves = collect_leaves(scene.plan)
        self.rows = hitreplay.LeafRows(self.leaves)
        dev = scene.device
        self.aux = torch.tensor(
            [[float(lf.kind == "sphere"), p, float(lf.mat_id)] for lf, p in self.leaves],
            dtype=torch.float32, device=dev)
        self.leaf_mat = torch.tensor([lf.mat_id for lf, _ in self.leaves], device=dev)

    def pack36(self, params):
        """(L, 36): per leaf its replay row, is-sphere and parity, and its
        material's scalars (``ptx/ops/replay_bwd.py:62-73``).
        Differentiable."""
        return torch.cat([self.rows(params), self.aux[:, :2],
                          bk.bwd_material_rows(self.scene.material_fn, params)[self.leaf_mat]],
                         dim=1)

    def pack(self, params):
        """K2's scene vector (``bounce_kernel.pack_bwd``): what the plain
        lanes version ``bounce_bwd_lanes_reference`` reads."""
        return bk.pack_bwd(self.rows, self.scene.material_fn, params)

    def pack_leaves(self, params):
        """``(pack36, leaves)``: :meth:`pack36` of fresh leaf copies of the
        ``DIFF_KEYS`` tensors, with autograd history from them."""
        with torch.enable_grad():
            leaves = [params[k].detach().requires_grad_(True) for k in trace.DIFF_KEYS]
            return self.pack36(dict(params, **dict(zip(trace.DIFF_KEYS, leaves)))), leaves

    def __call__(self, params, o, d, thr, dec, ct_o2, ct_d2, ct_thr2):
        if o.device.type == "cpu":
            return bk.bounce_bwd_reference(self.scene, params, o, d, thr, dec,
                                           ct_o2, ct_d2, ct_thr2)
        if o.device.type != "cuda":
            raise ValueError(f"replay backward kernel: no kernel for {o.device}")
        packed, leaves = self.pack_leaves(params)
        d_o, d_d, d_thr, acc = self.launch(packed.detach(), o, d, thr, dec,
                                           ct_o2, ct_d2, ct_thr2)
        return d_o, d_d, d_thr, self.params_grad(packed, leaves, acc)

    def params_grad(self, packed, leaves, acc):
        """``d_params`` from the (L, 34) per-leaf sums: autograd of
        ``packed = pack36(leaves)`` (the kind and parity columns get 0)."""
        d_packed = torch.cat([acc[:, :hitreplay.ROW], acc.new_zeros((acc.shape[0], 2)),
                              acc[:, hitreplay.ROW:]], dim=1)
        grads = torch.autograd.grad(packed, leaves, d_packed, allow_unused=True)
        return {k: (torch.zeros_like(x) if g is None else g)
                for k, x, g in zip(trace.DIFF_KEYS, leaves, grads)}

    def launch(self, packed, o, d, thr, dec, ct_o2, ct_d2, ct_thr2):
        """One K6 call on the current stream (its two launches), no
        synchronisation: ``(d_o, d_d, d_thr, acc)``, ``acc`` the (L, 34)
        per-leaf sums.  ``packed`` is :meth:`pack36`'s (L, 36)."""
        from ptx_torch.ops import _build

        B = o.shape[0]
        L = len(self.leaves)
        device = packed.device
        f3 = lambda x: (x, (B, 3), torch.float32)
        expect = {"o": f3(o), "d": f3(d), "thr": f3(thr), "u_sel": f3(dec["u_sel"]),
                  "ct_o2": f3(ct_o2), "ct_d2": f3(ct_d2), "ct_thr2": f3(ct_thr2),
                  "evt": (dec["evt"], (B,), torch.int32),
                  "packed": (packed, (L, RCOLS), torch.float32)}
        for k in ("hit", "entering", "take_transmit", "scatter_alive"):
            expect[k] = (dec[k], (B,), torch.bool)
        bk._check_inputs("replay backward kernel", device, expect)
        if B == 0:
            raise ValueError("replay backward kernel: empty wavefront")
        lib = _build.library()
        if lib.ptx_replay_bwd_smem(L) > MAX_SMEM:
            raise NotImplementedError(f"replay backward kernel: {L} leaves exceed a "
                                      "block's shared memory")
        n_blocks = min(-(-B // 128), _BLOCKS)
        empty = lambda *s: torch.empty(s, dtype=torch.float32, device=device)
        d_o, d_d, d_thr = empty(B, 3), empty(B, 3), empty(B, 3)
        partial, acc = empty(n_blocks, L * _COLS), empty(L, _COLS)
        p = bk._ptr
        err = lib.ptx_replay_bwd(
            p(packed), L, p(o), p(d), p(thr), p(dec["evt"]), p(dec["hit"]),
            p(dec["entering"]), p(dec["take_transmit"]), p(dec["scatter_alive"]),
            p(dec["u_sel"]), p(ct_o2), p(ct_d2), p(ct_thr2), B, p(d_o), p(d_d), p(d_thr),
            p(partial), n_blocks, p(acc), bk._stream(device))
        bk._raise_on(err, lib, "replay backward kernel")
        RowFedReplayBwd.LAUNCHES += 1
        return d_o, d_d, d_thr, acc
