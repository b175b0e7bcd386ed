"""The row-fed replay backward K6: the decision-frozen replay VJP of one
bounce at any leaf count, for large scenes.

Port of ``ptx/ops/replay_bwd.py`` ``build_replay_bwd`` (:47), a Pallas TPU
kernel, as the hand-written CUDA kernel ``ptx_torch/csrc/replay_bwd_kernel.cu``.
It computes what K2 computes (the per-lane adjoint of ``csrc/replay_lane.cuh``
and the cotangent of K2's scene vector ``bounce_kernel.pack_bwd``), without
K2's 24-leaf cap: the (L, 34) per-leaf sums live in shared memory, and K2's
second launch reduces and folds them, deterministically.

:class:`RowFedReplayBwd` is K6's wrapper, with K2's contract
(:class:`~ptx_torch.ops.bounce_kernel.BounceBwdKernel`, whose packing,
plain version, params mapping, fold table and counting it shares):
``bwd(packed, o, d, thr, dec, ct_o2, ct_d2, ct_thr2) -> (d_o, d_d, d_thr,
d_packed)``, with ``packed`` packed once per ``trace_rays`` call.  For CPU
tensors, and only for those, the wrapper runs the plain version
(``bounce_bwd_lanes_reference``, then ``fold_packed``).
"""

from __future__ import annotations

from ptx_torch.ops.bounce_kernel import BounceBwdKernel


class RowFedReplayBwd(BounceBwdKernel):
    """K6 for one compiled scene: :class:`BounceBwdKernel` on K6's entry
    points, at any leaf count whose scene and sums fit a block's opt-in
    shared memory (227 KB), on two blocks per SM of an H100.  ``LAUNCHES``
    counts its calls (two launches each: the per-block partial sums, then
    their reduction), ``PACKS`` and ``PACK_VJPS`` its scene vectors."""

    LAUNCHES = 0
    PACKS = 0
    PACK_VJPS = 0
    entry, smem_entry = "ptx_replay_bwd", "ptx_replay_bwd_smem"
    kernel_name = "replay backward kernel"
    max_smem, max_blocks = 232448, 264
