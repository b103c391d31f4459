"""Host-side vector math on numpy float32 arrays.

Vectors are plain numpy arrays; this module provides the small operation
vocabulary the scene layer needs (capability parity with the reference's
Vec2/Vec3/Vec4 tuple structs, crates/raytracing/src/geometry/vec{2,3,4}.rs).
Device-side math lives in tpu_raytracing_torch.ops and uses torch on batched SoA
arrays instead of per-vector structs.
"""
from __future__ import annotations

import numpy as np

F = np.float32


def v2(x, y) -> np.ndarray:
    return np.array([x, y], dtype=F)


def v3(x, y, z) -> np.ndarray:
    return np.array([x, y, z], dtype=F)


def v4(x, y, z, w) -> np.ndarray:
    return np.array([x, y, z, w], dtype=F)


def dot(a, b) -> np.floating:
    return F(np.dot(np.asarray(a, F), np.asarray(b, F)))


def cross(a, b) -> np.ndarray:
    return np.cross(np.asarray(a, F), np.asarray(b, F)).astype(F)


def length(a) -> np.floating:
    return F(np.linalg.norm(np.asarray(a, F)))


def normalize(a) -> np.ndarray:
    a = np.asarray(a, F)
    return (a / np.linalg.norm(a)).astype(F)


def reflect(v, n) -> np.ndarray:
    """Reflect v about unit normal n (both pointing away from surface)."""
    v = np.asarray(v, F)
    n = np.asarray(n, F)
    return (2.0 * np.dot(v, n) * n - v).astype(F)


def lerp(a, b, t) -> np.ndarray:
    a = np.asarray(a, F)
    b = np.asarray(b, F)
    return (a + (b - a) * F(t)).astype(F)


def near_zero(a, eps: float = 1e-6) -> bool:
    return bool(np.all(np.abs(np.asarray(a)) < eps))
