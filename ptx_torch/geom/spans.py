"""Vectorized ray-interval ("span") algebra (port of ``ptx/geom/spans.py``).

A span list is a fixed-capacity masked SoA batch: every ray carries ``K``
slots ``[t0, t1]`` with boundary normals and materials.  Every CSG
combinator is one event merge (see the JAX module's docstring for the
reference's streaming merges it replaces):

1. each span contributes an open and a close event;
2. events of all operands are sorted by ``(t, tie)``, opens before closes
   at equal ``t``, stably;
3. inclusion depth is a running sum of ±1 deltas; union is
   ``depth_a > 0``, intersection ``depth_a == n``, difference
   ``depth_a > 0 and depth_b == 0``;
4. predicate transitions are the output boundaries; a second stable sort
   compacts them to the front, where they alternate open, close.

In a difference the cut surface takes B's payload with the normal negated
(span.h:100-112).  Degenerate (zero-length) output spans are dropped.

The sort: ``lax.sort`` with two keys compares floats after mapping
``-0.0`` to ``0.0`` and every NaN to one NaN, which sorts last, and keeps
the input order among equal keys.  PyTorch has no multi-key sort, so
:func:`_merge` sorts stably on ``tie``, then stably on ``t`` (with ``-0.0``
mapped to ``0.0`` in the key only, as JAX does), gathering in between: the
order of a lexicographic stable sort.  Mat ids are int64, the port's dtype
for them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ptx_torch.core.constants import EPS, MAX_VALUE

# Sentinel t for masked/invalid slots and events: above every real
# boundary (|t| <= MAX_VALUE = 1e20).  float32(3e20), the JAX constant.
PAD_T = 3e20


class SpanList(NamedTuple):
    """Masked SoA span list, batch shape ``(..., K)``: ``t0``, ``t1``
    (..., K) float32, ``n0``, ``n1`` (..., K, 3) outward unit normals,
    ``m0``, ``m1`` (..., K) int64 material ids, ``valid`` (..., K) bool.
    Valid spans are sorted by ``t0`` and pairwise disjoint."""

    t0: torch.Tensor
    n0: torch.Tensor
    m0: torch.Tensor
    t1: torch.Tensor
    n1: torch.Tensor
    m1: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.t0.shape[-1]


def empty(batch_shape, capacity: int = 1, device=None) -> SpanList:
    """A span list of ``capacity`` invalid slots a ray (``PAD_T`` times,
    zero normals and material ids)."""
    shape = tuple(batch_shape) + (capacity,)
    pad = lambda: torch.full(shape, PAD_T, dtype=torch.float32, device=device)
    zeros = lambda *s, dtype=torch.float32: torch.zeros(shape + s, dtype=dtype, device=device)
    return SpanList(t0=pad(), n0=zeros(3), m0=zeros(dtype=torch.int64), t1=pad(), n1=zeros(3),
                    m1=zeros(dtype=torch.int64), valid=zeros(dtype=torch.bool))


def single(t0, n0, m0, t1, n1, m1, valid) -> SpanList:
    """Wrap per-ray scalars into a K=1 span list (primitive output);
    ``m0``/``m1`` are Python ints."""
    mat = lambda m: torch.full(t0.shape + (1,), m, dtype=torch.int64, device=t0.device)
    return SpanList(
        t0=torch.where(valid, t0, PAD_T)[..., None], n0=n0[..., None, :], m0=mat(m0),
        t1=torch.where(valid, t1, PAD_T)[..., None], n1=n1[..., None, :], m1=mat(m1),
        valid=valid[..., None])


def _sorted_by(key, *xs):
    """``xs`` gathered along the last axis by a stable ascending sort of
    ``key``; a trailing (..., E, 3) operand is gathered row-wise."""
    perm = torch.sort(key, dim=-1, stable=True)[1]
    return [x.gather(-2, perm[..., None].expand(x.shape)) if x.dim() > key.dim()
            else x.gather(-1, perm) for x in xs]


def _merge(lists_a: Sequence[SpanList], lists_b: Sequence[SpanList], mode: str,
           out_capacity: int | None = None) -> SpanList:
    """Generic n-ary event merge (``ptx/geom/spans.py:_merge``).

    ``mode``: ``"union"`` (inside ⇔ depth_a > 0), ``"intersection"``
    (depth_a == len(lists_a)) or ``"difference"`` (depth_a > 0 and
    depth_b == 0)."""
    lists = list(lists_a) + list(lists_b)
    if not lists:
        raise ValueError("merge of zero span lists")
    n_a = len(lists_a)
    ts, opens, da, db, ns, ms = [], [], [], [], [], []
    for i, sl in enumerate(lists):
        is_b = i >= n_a
        v = sl.valid
        # difference: every surviving B boundary is a cut, its normal negated
        nsign = -1.0 if (mode == "difference" and is_b) else 1.0
        for t, n, m, is_open in ((sl.t0, sl.n0, sl.m0, True), (sl.t1, sl.n1, sl.m1, False)):
            ts.append(torch.where(v, t, PAD_T))
            opens.append(torch.full(t.shape, is_open, dtype=torch.bool, device=t.device))
            delta = v.to(torch.int32) * (1 if is_open else -1)
            zero = torch.zeros_like(delta)
            da.append(zero if is_b else delta)
            db.append(delta if is_b else zero)
            ns.append(n * nsign)
            ms.append(m)
    t, is_open = torch.cat(ts, dim=-1), torch.cat(opens, dim=-1)
    delta_a, delta_b = torch.cat(da, dim=-1), torch.cat(db, dim=-1)
    n, mat = torch.cat(ns, dim=-2), torch.cat(ms, dim=-1)

    # opens before closes at equal t (coalesces touching union spans; the
    # zero-length spans it makes elsewhere are dropped below)
    tie = torch.where(is_open, 0, 1).to(torch.int32)
    t, delta_a, delta_b, is_open, n, mat = _sorted_by(tie, t, delta_a, delta_b, is_open,
                                                       n, mat)
    t, delta_a, delta_b, is_open, n, mat = _sorted_by(torch.where(t == 0.0, 0.0, t), t,
                                                       delta_a, delta_b, is_open, n, mat)

    depth_a = torch.cumsum(delta_a, dim=-1)
    depth_b = torch.cumsum(delta_b, dim=-1)
    if mode == "union":
        inside = depth_a > 0
    elif mode == "intersection":
        inside = depth_a == len(lists_a)
    elif mode == "difference":
        inside = (depth_a > 0) & (depth_b == 0)
    else:
        raise ValueError(mode)
    inside_prev = torch.cat([torch.zeros_like(inside[..., :1]), inside[..., :-1]], dim=-1)
    boundary = inside != inside_prev
    # boundary events to the front, stably: open, close, open, close, ...
    t, n, mat, bnd = _sorted_by(torch.where(boundary, 0, 1).to(torch.int32), t, n, mat,
                                boundary)

    k_total = sum(sl.capacity for sl in lists)
    k_out = k_total if out_capacity is None else out_capacity
    even = lambda x: x[..., 0::2][..., :k_out]
    odd = lambda x: x[..., 1::2][..., :k_out]
    t0, t1 = even(t), odd(t)
    n0, n1 = n[..., 0::2, :][..., :k_out, :], n[..., 1::2, :][..., :k_out, :]
    valid = even(bnd) & odd(bnd) & (t1 > t0)   # drop degenerate spans
    return SpanList(t0=torch.where(valid, t0, PAD_T), n0=n0, m0=even(mat),
                    t1=torch.where(valid, t1, PAD_T), n1=n1, m1=odd(mat), valid=valid)


def union(*lists: SpanList) -> SpanList:
    """N-ary interval union (union.cpp:84-134; nested unions are one
    n-ary merge)."""
    return _merge(lists, (), "union")


def intersection(*lists: SpanList) -> SpanList:
    """N-ary interval intersection (intersection.cpp:84-130)."""
    return _merge(lists, (), "intersection")


def difference(a: SpanList, b: SpanList) -> SpanList:
    """Interval difference A − B (difference.cpp:84-135): cut surfaces take
    B's material with negated normal."""
    return _merge((a,), (b,), "difference")


def transform_normals(sl: SpanList, nrm_mat) -> SpanList:
    """Map span normals through a (3, 3) linear map and renormalize
    (span.h:122-127), in float32 (TF32 is off package-wide)."""
    def xf(n):
        out = torch.einsum("ij,...kj->...ki", nrm_mat, n)
        mag = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        return out / torch.where(mag == 0, 1.0, mag)
    return sl._replace(n0=xf(sl.n0), n1=xf(sl.n1))


def first_hit(sl):
    """Resolve the span walk of path-trace.h:66-99 in one pass
    (``ptx/integrate/trace.py:260``).  Per span, in list order, the first
    of: ``t0 >= MAX_VALUE`` (escaped), ``t0 >= EPS`` (entry boundary),
    ``t1 >= MAX_VALUE`` (escaped), ``t1 >= EPS`` (exit boundary, normal
    negated); no span triggering is a miss.  Returns ``t`` (0 unless
    hit), ``normal``, ``mat_id`` (int64, 0 unless hit), ``entering`` and
    ``hit`` (False on a miss and on an escape)."""
    c1 = sl.t0 >= MAX_VALUE
    c2 = sl.t0 >= EPS
    c3 = sl.t1 >= MAX_VALUE
    c4 = sl.t1 >= EPS
    trigger = sl.valid & (c1 | c2 | c3 | c4)
    idx = torch.argmax(trigger.to(torch.uint8), dim=-1, keepdim=True)   # first trigger
    take = lambda a: a.gather(-1, idx)[..., 0]
    take3 = lambda a: a.gather(-2, idx[..., None].expand(idx.shape + (3,)))[..., 0, :]
    s_c1, s_c2, s_c3 = take(c1), take(c2), take(c3)
    escaped = s_c1 | (~s_c2 & s_c3)
    entering = ~s_c1 & s_c2
    hit = trigger.any(dim=-1) & ~escaped
    t = torch.where(entering, take(sl.t0), take(sl.t1))
    return {
        "t": torch.where(hit, t, 0.0),
        "normal": torch.where(entering[..., None], take3(sl.n0), -take3(sl.n1)),
        "mat_id": torch.where(hit, torch.where(entering, take(sl.m0), take(sl.m1)), 0),
        "entering": entering,
        "hit": hit,
    }
