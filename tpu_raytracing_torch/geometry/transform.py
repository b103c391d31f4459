"""Forward+inverse transform pairs (parity: raytracing/src/geometry/transform.rs)."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import matrix as M

F = np.float32


@dataclass
class Transform:
    forward: np.ndarray = field(default_factory=M.mat_identity)
    inverse: np.ndarray = field(default_factory=M.mat_identity)

    @staticmethod
    def identity() -> "Transform":
        return Transform()

    @staticmethod
    def from_matrix(m: np.ndarray) -> "Transform":
        m = np.asarray(m, F)
        return Transform(m, M.mat_invert(m))

    @staticmethod
    def translate(d) -> "Transform":
        return Transform(M.mat_translation(d), M.mat_translation(-np.asarray(d, F)))

    @staticmethod
    def rotate(theta: float, axis) -> "Transform":
        fwd = M.mat_rotation(theta, axis)
        return Transform(fwd, fwd.T.copy())

    @staticmethod
    def scale(s) -> "Transform":
        s = np.asarray(s, F)
        return Transform(M.mat_scale(s), M.mat_scale(1.0 / s))

    def compose(self, other: "Transform") -> "Transform":
        """Apply self first, then other (matches reference compose order)."""
        return Transform(
            (other.forward @ self.forward).astype(F),
            (self.inverse @ other.inverse).astype(F),
        )

    def invert(self) -> "Transform":
        return Transform(self.inverse, self.forward)

    def apply_point(self, p) -> np.ndarray:
        return M.apply_point(self.forward, p)

    def apply_inverse_point(self, p) -> np.ndarray:
        return M.apply_point(self.inverse, p)

    def apply_vector(self, v) -> np.ndarray:
        return M.apply_vector(self.forward, v)

    def apply_inverse_vector(self, v) -> np.ndarray:
        return M.apply_vector(self.inverse, v)

    def apply_normal(self, n) -> np.ndarray:
        """Normals transform by the inverse-transpose."""
        return M.apply_vector_transposed(self.inverse, n)

    @staticmethod
    def look_at(camera_pos, target_pos, up, swap_handedness: bool = False) -> "Transform":
        """Camera-to-world look-at; camera looks down +z in its local frame.

        Matches the reference's handedness convention (transform.rs:96-149):
        camera_x = -normalize(view x up), camera_y = view x camera_x.
        """
        camera_pos = np.asarray(camera_pos, F)
        view = np.asarray(target_pos, F) - camera_pos
        view = view / np.linalg.norm(view)
        up = np.asarray(up, F)
        cx = -np.cross(view, up)
        cx = cx / np.linalg.norm(cx)
        cy = np.cross(view, cx)
        if swap_handedness:
            cx = -cx
        m = np.eye(4, dtype=F)
        m[:3, 0] = cx
        m[:3, 1] = cy
        m[:3, 2] = view
        m[:3, 3] = camera_pos
        return Transform.from_matrix(m)
