"""Batched ray-primitive intersection.

Counterpart of tpu_raytracing/ops/intersect.py (the slab test and
Moller-Trumbore; spheres are outside the ported slice).
"""
from __future__ import annotations

import torch

from .linalg import cross, dot

# seam-inclusive barycentric bound (see tpu_raytracing/ops/intersect.py):
# rays crossing a shared edge are double-claimed instead of dropped
BARY_EPS = 1e-5


def ray_aabb(origin, inv_dir, bb_min, bb_max):
    """Slab test. Returns (t0, t1); hit iff t0 <= t1. NaN propagates (a
    zero direction component on a slab plane misses), as jnp.minimum."""
    a = (bb_min - origin) * inv_dir
    b = (bb_max - origin) * inv_dir
    t0 = torch.amax(torch.minimum(a, b), dim=-1)
    t1 = torch.amin(torch.maximum(a, b), dim=-1)
    return t0, t1


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
