"""Batched 3-vector and affine-transform math (port of ``ptx/core/linalg.py``).

Vectors are ``(..., 3)`` float32 tensors and affines ``(..., 3, 4)``
tensors: the left ``(3, 3)`` block is the linear part, the last column
the translation.  ``compose(outer, inner)`` applies ``inner`` first.

Dot products are written out as ``(a0·b0 + a1·b1) + a2·b2``, one
rounding per operation in that order: the CUDA bounce kernel evaluates
the same expressions, so its plain twin here rounds exactly as it does.
"""

from __future__ import annotations

import torch

from ptx_torch.core.constants import EPS


# ---------------------------------------------------------------------------
# vec3 ops (broadcast over leading batch dims)
# ---------------------------------------------------------------------------

def vec3(x, y, z, device=None):
    """Stack three scalars or broadcastable arrays into (..., 3) float32."""
    xs = [torch.as_tensor(c, dtype=torch.float32, device=device) for c in (x, y, z)]
    return torch.stack(torch.broadcast_tensors(*xs), dim=-1)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def abs_squared(v):
    return dot(v, v)


def norm(v):
    """|v|, exact 0 at v = 0 (the JAX version guards the sqrt for its
    gradient; the forward value is the same)."""
    mag2 = abs_squared(v)
    safe = torch.sqrt(torch.where(mag2 == 0.0, 1.0, mag2))
    return torch.where(mag2 == 0.0, 0.0, safe)


def normalize(v):
    """Zero vectors pass through unchanged (reference vector3d.h:115-120)."""
    mag2 = abs_squared(v)
    safe = torch.sqrt(torch.where(mag2 == 0.0, 1.0, mag2))
    return v / safe[..., None]


def reflect(d, n):
    """Mirror ``d`` about ``n`` (vector3d.h:186-190)."""
    n = normalize(n)
    return d - (2.0 * dot(d, n))[..., None] * n


def clip01(x):
    """``jnp.clip(x, 0, 1)`` with JAX's gradient: half of it at exactly 0
    or 1, as ``minimum`` / ``maximum`` split ties (``torch.clamp`` passes
    all of it there, and material scalars sit at 0 and 1)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _refract_terms(d, eta, n):
    n_unit = normalize(n)
    i = normalize(d)
    idn = dot(i, n_unit)
    arg = 1.0 - eta * eta * (1.0 - idn * idn)
    base_ok = ((eta > EPS) & (eta < 1.0 / EPS)
               & (abs_squared(n) > 0.0) & (abs_squared(d) > 0.0))
    return n_unit, i, idn, arg, base_ok


def refract_strength(d, relative_ior, n):
    """The reference's transmission weight: the fourth root of
    ``1 - eta^2 (1 - cos^2)`` (vector3d.h:191-202); 0 outside validity."""
    _, _, _, arg, base_ok = _refract_terms(d, relative_ior, n)
    ok = base_ok & (arg > 0.0)
    return torch.where(ok, torch.sqrt(torch.sqrt(torch.where(ok, arg, 1.0))),
                       0.0)


def refract(d, relative_ior, n):
    """Refraction direction (vector3d.h:203-214); the zero vector on total
    internal reflection or invalid input.  ``arg`` is floored at 1e-20 as
    in the JAX version (its gradient guard; the value moves < 1 ulp)."""
    eta = relative_ior
    n_unit, i, idn, arg, base_ok = _refract_terms(d, eta, n)
    ok = base_ok & (arg >= 0.0)
    safe_arg = torch.where(ok, torch.clamp(arg, min=1e-20), 1.0)
    t = eta[..., None] * i - (eta * idn + torch.sqrt(safe_arg))[..., None] * n_unit
    return torch.where(ok[..., None], normalize(t), torch.zeros_like(t))


# ---------------------------------------------------------------------------
# affine (3, 4) transforms
# ---------------------------------------------------------------------------

def identity_affine(device=None):
    return torch.cat([torch.eye(3, device=device), torch.zeros((3, 1), device=device)],
                     dim=-1)


def affine(linear, translation):
    linear = torch.as_tensor(linear, dtype=torch.float32).reshape(3, 3)
    translation = torch.as_tensor(translation, dtype=torch.float32,
                                  device=linear.device).reshape(3, 1)
    return torch.cat([linear, translation], dim=-1)


def translate(t, device):
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    return affine(torch.eye(3, device=device), t)


def scale(s, device):
    s = torch.as_tensor(s, dtype=torch.float32, device=device).expand(3)
    return affine(torch.diag(s), torch.zeros(3, device=device))


def rotate(axis, angle, device):
    """Axis-angle rotation via the versine form (transform.h:207-225);
    ``angle`` is rounded to float32 before its cos/sin, as in JAX."""
    a = normalize(torch.as_tensor(axis, dtype=torch.float32, device=device))
    ang = torch.tensor(angle, dtype=torch.float32, device=device)
    c, s = torch.cos(ang), torch.sin(ang)
    v = 1.0 - c
    x, y, z = a[0], a[1], a[2]
    linear = torch.stack([
        torch.stack([x * x + (1 - x * x) * c, x * y * v - z * s, x * z * v + y * s]),
        torch.stack([x * y * v + z * s, y * y + (1 - y * y) * c, y * z * v - x * s]),
        torch.stack([x * z * v - y * s, y * z * v + x * s, z * z + (1 - z * z) * c]),
    ])
    return affine(linear, torch.zeros(3, device=device))


def rotate_x(angle, device):
    return rotate((1.0, 0.0, 0.0), angle, device)


def rotate_y(angle, device):
    return rotate((0.0, 1.0, 0.0), angle, device)


def rotate_z(angle, device):
    return rotate((0.0, 0.0, 1.0), angle, device)


def apply(A, v):
    """``L @ v + t`` for ``A`` ``(..., 3, 4)`` and ``v`` ``(..., 3)``."""
    return apply_linear(A, v) + A[..., :, 3]


def apply_linear(A, v):
    """Linear part only (directions and normals, transform.h:416-421)."""
    return torch.einsum("...ij,...j->...i", A[..., :, :3], v)


def compose(outer, inner):
    """Affine whose action is ``apply(outer, apply(inner, v))``."""
    lin = outer[..., :, :3] @ inner[..., :, :3]
    t = apply_linear(outer, inner[..., :, 3]) + outer[..., :, 3]
    return torch.cat([lin, t[..., :, None]], dim=-1)


def determinant(A):
    """The determinant of the affine's linear part."""
    return torch.linalg.det(A[..., :, :3])


def inverse(A):
    """Inverse of the affine (transform.h:350-383)."""
    lin_inv = torch.linalg.inv(A[..., :, :3])
    t = -torch.einsum("...ij,...j->...i", lin_inv, A[..., :, 3])
    return torch.cat([lin_inv, t[..., :, None]], dim=-1)


def transform_ray(A, origin, direction):
    """Origin affinely, direction linearly (transform.h:429-432)."""
    return apply(A, origin), apply_linear(A, direction)
