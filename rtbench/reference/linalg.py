"""Batched vector helpers for SoA math (last axis = xyz).

The benchmark's reference: a frozen copy of the port's
tpu_raytracing_torch/ops/linalg.py, kept as it is so that a change to the
program cannot move the yardstick.

Counterpart of tpu_raytracing/ops/linalg.py. Every contraction is spelled
as elementwise f32 multiplies and adds in a fixed order, never `@` or
matmul: a float32 matmul may run in TF32 on the card, which keeps about
three decimal digits (the JAX package hit the same trap in bf16 on a TPU).
"""
from __future__ import annotations

import torch


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def norm(a):
    return torch.sqrt(dot(a, a))


def normalize(a, eps: float = 0.0):
    n = norm(a)
    safe = torch.where(n > eps, n, torch.ones_like(n))
    return a / safe[..., None]


def _mat3_apply(m, v, transposed: bool = False):
    def at(i, j):
        return m[..., j, i] if transposed else m[..., i, j]

    return torch.stack(
        [
            at(i, 0) * v[..., 0] + at(i, 1) * v[..., 1] + at(i, 2) * v[..., 2]
            for i in range(3)
        ],
        dim=-1,
    )


def apply_point(m, p):
    """4x4 (row-major, column-vector) applied to points; m (..., 4, 4)."""
    r = _mat3_apply(m, p) + m[..., :3, 3]
    w = (
        m[..., 3, 0] * p[..., 0]
        + m[..., 3, 1] * p[..., 1]
        + m[..., 3, 2] * p[..., 2]
        + m[..., 3, 3]
    )
    return r / w[..., None]


def apply_vector(m, v):
    return _mat3_apply(m, v)


def apply_vector_transposed(m, v):
    """M^T v on the 3x3 block (inverse-transpose normal transform)."""
    return _mat3_apply(m, v, transposed=True)


def make_orthonormal_basis(z):
    """Batched ONB: from unit z produce (x, y)."""
    a = torch.zeros_like(z)
    near_pole = torch.abs(z[..., 2]) < 0.8
    a[..., 2] = near_pole.to(z.dtype)
    a[..., 1] = (~near_pole).to(z.dtype)
    x = normalize(cross(a, z))
    y = cross(z, x)
    return x, y
