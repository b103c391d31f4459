"""Batched ray-primitive intersection.

Moller-Trumbore and stable-quadratic spheres with spherical uv, dpdu and
dpdv: a frozen copy of the port's plain intersection arithmetic.
Constants are grouped as in the JAX package (`2.0 * pi * x` is one
rounded f32 constant times x), so both round alike.
"""
from __future__ import annotations

import math

import torch

from .linalg import cross, dot

# seam-inclusive barycentric bound (see tpu_raytracing/ops/intersect.py):
# rays crossing a shared edge are double-claimed instead of dropped
BARY_EPS = 1e-5


def ray_triangle(origin, direction, p0, p1, p2, t_min, t_max):
    """Moller-Trumbore. Returns (valid, t, u, v); invalid lanes have t=inf."""
    return ray_triangle_edges(origin, direction, p0, p1 - p0, p2 - p0,
                              t_min, t_max)


def ray_triangle_edges(origin, direction, p0, e1, e2, t_min, t_max):
    """Moller-Trumbore on (p0, e1 = p1 - p0, e2 = p2 - p0), in the op order
    of the TPU kernels and of csrc/traverse_common.cuh::tri_hit."""
    pvec = cross(direction, e2)
    denom = dot(pvec, e1)
    safe_denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    tvec = origin - p0
    u = dot(pvec, tvec) / safe_denom
    qvec = cross(tvec, e1)
    v = dot(qvec, direction) / safe_denom
    t = dot(qvec, e2) / safe_denom
    valid = (
        (denom != 0.0)
        & (u >= -BARY_EPS) & (u <= 1.0 + BARY_EPS)
        & (v >= -BARY_EPS) & (u + v <= 1.0 + BARY_EPS)
        & (t >= t_min) & (t <= t_max)
    )
    return valid, torch.where(valid, t, torch.full_like(t, float("inf"))), u, v


def ray_sphere(origin, direction, center, radius, t_min, t_max):
    """Stable-quadratic sphere intersection. Returns (valid, t)."""
    omc = origin - center
    a = dot(direction, direction)
    b = 2.0 * dot(direction, omc)
    c = dot(omc, omc) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = -0.5 * (b + torch.where(b >= 0.0, sq, -sq))
    safe_a = torch.where(a == 0.0, torch.ones_like(a), a)
    safe_q = torch.where(q == 0.0, torch.ones_like(q), q)
    ta = q / safe_a
    tb = c / safe_q
    t1 = torch.minimum(ta, tb)
    t2 = torch.maximum(ta, tb)
    t1_ok = (t1 >= t_min) & (t1 <= t_max)
    t2_ok = (t2 >= t_min) & (t2 <= t_max)
    t = torch.where(t1_ok, t1, t2)
    valid = (disc >= 0.0) & (a != 0.0) & (t1_ok | t2_ok)
    return valid, torch.where(valid, t, torch.full_like(t, float("inf")))


def sphere_hit_geom(point, center, radius):
    """Spherical uv, normal, dpdu and dpdv at an object-space hit point
    (u = phi / 2pi, v = theta / pi, z up)."""
    local = point - center
    cos_theta = torch.clamp(local[..., 2] / radius, -1.0, 1.0)
    theta = torch.acos(cos_theta)
    sin_theta = torch.sin(theta)
    safe_rst = torch.where(sin_theta == 0.0, torch.ones_like(sin_theta),
                           radius * sin_theta)
    cos_phi = torch.clamp(local[..., 0] / safe_rst, -1.0, 1.0)
    sin_phi = local[..., 1] / safe_rst
    acos_cp = torch.acos(cos_phi)
    phi = torch.where(local[..., 1] > 0.0, acos_cp, 2.0 * math.pi - acos_cp)
    u = phi / (2.0 * math.pi)
    v = theta / math.pi
    dpdu = torch.stack(
        [
            -2.0 * math.pi * local[..., 1],
            2.0 * math.pi * local[..., 0],
            torch.zeros_like(local[..., 0]),
        ],
        dim=-1,
    )
    dpdv = math.pi * torch.stack(
        [
            local[..., 2] * cos_phi,
            local[..., 2] * sin_phi,
            -radius * sin_theta,
        ],
        dim=-1,
    )
    normal = local / torch.as_tensor(radius)[..., None]
    return torch.stack([u, v], dim=-1), normal, dpdu, dpdv
