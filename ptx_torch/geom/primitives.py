"""Closed-form primitive → span-list kernels over a ray wavefront (port of
``ptx/geom/primitives.py``).

Each maps rays ``(origin, dir)`` ``(..., 3)`` and one primitive's
parameters to a K=1 :class:`~ptx_torch.geom.spans.SpanList`
(the reference's ``src/sphere.cpp:21-81`` and ``src/plane.cpp:23-89``).
"""

from __future__ import annotations

import torch

from ptx_torch.core.constants import EPS, MAX_VALUE
from ptx_torch.core.linalg import dot, normalize
from ptx_torch.geom.spans import SpanList, single


def sphere_spans(origin, direction, center, radius, mat_id: int) -> SpanList:
    """Ray/sphere quadratic: one span ``[t-, t+]`` with outward normals at
    both boundaries; a miss when the quarter-discriminant ``b² − ac`` is
    ``<= EPS`` (the reference's tolerance, sphere.cpp:38-43)."""
    oc = origin - center
    a = dot(direction, direction)
    b = dot(oc, direction)
    c = dot(oc, oc) - radius * radius
    disc = b * b - a * c
    valid = disc > EPS
    sq = torch.sqrt(torch.where(valid, disc, 1.0))
    safe_a = torch.where(a == 0.0, 1.0, a)
    t0 = (-b - sq) / safe_a
    t1 = (-b + sq) / safe_a
    n0 = normalize(origin + t0[..., None] * direction - center)
    n1 = normalize(origin + t1[..., None] * direction - center)
    return single(t0, n0, mat_id, t1, n1, mat_id, valid & (a != 0.0))


def plane_spans(origin, direction, normal, d, mat_id: int) -> SpanList:
    """Half-space ``normal·x + d <= 0``: a half-infinite span clipped at the
    crossing, ``±MAX_VALUE`` on the open side (plane.cpp:35-62): parallel
    (|dir·n| < EPS²) or |t| >= MAX_VALUE gives the full span when the
    origin is on the boundary, else none; ``dir·n < 0`` ``[t, MAX]``,
    ``> 0`` ``[−MAX, t]``.  Both normals are the unit plane normal."""
    n_unit = normalize(normal)
    divisor = dot(direction, normal)
    numerator = -d - dot(origin, normal)
    flat = torch.abs(divisor) < EPS * EPS
    t = numerator / torch.where(flat, 1.0, divisor)
    degenerate = flat | (torch.abs(t) >= MAX_VALUE)
    on_boundary = torch.abs(numerator) < EPS * EPS
    entering = divisor < 0.0
    full = degenerate & on_boundary
    miss = degenerate & ~on_boundary
    t0 = torch.where(full, -MAX_VALUE, torch.where(entering, t, -MAX_VALUE))
    t1 = torch.where(full, MAX_VALUE, torch.where(entering, MAX_VALUE, t))
    nb = torch.broadcast_to(n_unit, origin.shape)
    return single(t0, nb, mat_id, t1, nb, mat_id, ~miss)
