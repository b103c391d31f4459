"""4x4 matrices: row-major, column-vector convention (p' = M @ [p, 1]).

Capability parity with crates/raytracing/src/geometry/matrix4x4.rs (invert,
det, matmul, transpose, translation/rotation/scale ctors, apply_point with
perspective divide, apply_vector, inverse-transpose normal transform).
"""
from __future__ import annotations

import numpy as np

F = np.float32


def mat_identity() -> np.ndarray:
    return np.eye(4, dtype=F)


def mat_translation(d) -> np.ndarray:
    m = np.eye(4, dtype=F)
    m[:3, 3] = np.asarray(d, F)
    return m


def mat_scale(s) -> np.ndarray:
    m = np.eye(4, dtype=F)
    m[0, 0], m[1, 1], m[2, 2] = np.asarray(s, F)
    return m


def mat_rotation(theta: float, axis) -> np.ndarray:
    """Rotation by theta radians about unit axis (Rodrigues)."""
    v = np.asarray(axis, F)
    v = v / np.linalg.norm(v)
    c, s = np.cos(theta, dtype=F), np.sin(theta, dtype=F)
    x, y, z = v
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], dtype=F)
    r = np.eye(3, dtype=F) * c + s * K + (1 - c) * np.outer(v, v).astype(F)
    m = np.eye(4, dtype=F)
    m[:3, :3] = r
    return m


def mat_from_basis(x, y, z) -> np.ndarray:
    """Matrix whose columns are the basis vectors (local -> parent frame)."""
    m = np.eye(4, dtype=F)
    m[:3, 0] = np.asarray(x, F)
    m[:3, 1] = np.asarray(y, F)
    m[:3, 2] = np.asarray(z, F)
    return m


def mat_invert(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(np.asarray(m, np.float64)).astype(F)


def apply_point(m: np.ndarray, p) -> np.ndarray:
    ph = m @ np.append(np.asarray(p, F), F(1.0))
    return (ph[:3] / ph[3]).astype(F)


def apply_vector(m: np.ndarray, v) -> np.ndarray:
    return (m[:3, :3] @ np.asarray(v, F)).astype(F)


def apply_vector_transposed(m: np.ndarray, v) -> np.ndarray:
    """M^T v on the 3x3 block; used for inverse-transpose normal transforms."""
    return (m[:3, :3].T @ np.asarray(v, F)).astype(F)
