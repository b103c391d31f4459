"""Rotation quaternions (w, x, y, z) as numpy float32 arrays of shape (4,).

Capability parity with crates/raytracing/src/geometry/quaternion.rs:
from_rotation_matrix uses the Shepperd-style branch on the largest of
trace / diagonal elements for numerical stability.
"""
from __future__ import annotations

import numpy as np

F = np.float32


def quat_identity() -> np.ndarray:
    return np.array([1.0, 0.0, 0.0, 0.0], dtype=F)


def quat_from_axis_angle(axis, angle: float) -> np.ndarray:
    """Unit quaternion rotating by `angle` radians about unit `axis`
    (reference: quaternion_from_axis_angle, quaternion.rs)."""
    axis = np.asarray(axis, F)
    h = 0.5 * float(angle)
    return np.concatenate(
        [np.array([np.cos(h)], F), np.sin(h) * axis]
    ).astype(F)


def quat_norm(q) -> float:
    return float(np.linalg.norm(np.asarray(q, F)))


def quat_dot(a, b) -> float:
    return float(np.dot(np.asarray(a, F), np.asarray(b, F)))


def quat_conjugate(q) -> np.ndarray:
    q = np.asarray(q, F)
    return np.array([q[0], -q[1], -q[2], -q[3]], dtype=F)


def quat_inverse(q) -> np.ndarray:
    """q^-1 = conj(q) / |q|^2  (q * q^-1 = identity)."""
    q = np.asarray(q, F)
    return (quat_conjugate(q) / np.dot(q, q)).astype(F)


def quat_normalize(q) -> np.ndarray:
    q = np.asarray(q, F)
    return (q / np.linalg.norm(q)).astype(F)


def quat_mul(a, b) -> np.ndarray:
    aw, ax, ay, az = np.asarray(a, F)
    bw, bx, by, bz = np.asarray(b, F)
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dtype=F,
    )


def quat_rotate(q, v) -> np.ndarray:
    """Rotate vector v by unit quaternion q."""
    w = F(q[0])
    u = np.asarray(q[1:4], F)
    v = np.asarray(v, F)
    return (
        2.0 * np.dot(u, v) * u
        + (w * w - np.dot(u, u)) * v
        + 2.0 * w * np.cross(u, v)
    ).astype(F)


def quat_to_matrix(q) -> np.ndarray:
    w, x, y, z = quat_normalize(q)
    m = np.eye(4, dtype=F)
    m[:3, :3] = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=F,
    )
    return m


def quat_from_rotation_matrix(m: np.ndarray) -> np.ndarray:
    """Extract a unit quaternion from the 3x3 rotation block of m.

    Branches on the largest of (trace, m00, m11, m22) to avoid catastrophic
    cancellation (Shepperd's method), matching the reference's approach
    (quaternion.rs:157-246).
    """
    m = np.asarray(m, np.float64)
    r = m[:3, :3]
    tr = r[0, 0] + r[1, 1] + r[2, 2]
    if tr > 0.0:
        s = np.sqrt(tr + 1.0) * 2.0
        q = [
            0.25 * s,
            (r[2, 1] - r[1, 2]) / s,
            (r[0, 2] - r[2, 0]) / s,
            (r[1, 0] - r[0, 1]) / s,
        ]
    elif r[0, 0] >= r[1, 1] and r[0, 0] >= r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2.0
        q = [
            (r[2, 1] - r[1, 2]) / s,
            0.25 * s,
            (r[0, 1] + r[1, 0]) / s,
            (r[0, 2] + r[2, 0]) / s,
        ]
    elif r[1, 1] >= r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2.0
        q = [
            (r[0, 2] - r[2, 0]) / s,
            (r[0, 1] + r[1, 0]) / s,
            0.25 * s,
            (r[1, 2] + r[2, 1]) / s,
        ]
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2.0
        q = [
            (r[1, 0] - r[0, 1]) / s,
            (r[0, 2] + r[2, 0]) / s,
            (r[1, 2] + r[2, 1]) / s,
            0.25 * s,
        ]
    return quat_normalize(np.array(q, dtype=F))
