"""Axis-aligned bounding boxes (parity: raytracing/src/geometry/aabb.rs)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

F = np.float32


@dataclass
class AABB:
    minimum: np.ndarray
    maximum: np.ndarray

    @staticmethod
    def empty() -> "AABB":
        return AABB(
            np.full(3, np.inf, dtype=F), np.full(3, -np.inf, dtype=F)
        )

    @staticmethod
    def infinite() -> "AABB":
        return AABB(
            np.full(3, -np.inf, dtype=F), np.full(3, np.inf, dtype=F)
        )

    @staticmethod
    def from_points(points: np.ndarray) -> "AABB":
        points = np.asarray(points, F).reshape(-1, 3)
        return AABB(points.min(axis=0), points.max(axis=0))

    def center(self) -> np.ndarray:
        return ((self.minimum + self.maximum) * 0.5).astype(F)

    def radius(self) -> float:
        return float(np.linalg.norm(self.maximum - self.minimum) * 0.5)

    def union(self, other: "AABB") -> "AABB":
        return AABB(
            np.minimum(self.minimum, other.minimum),
            np.maximum(self.maximum, other.maximum),
        )

    def transformed(self, transform) -> "AABB":
        """Transform by mapping all 8 corners (aabb.rs:81-95)."""
        lo, hi = self.minimum, self.maximum
        pts = []
        for ix in (0, 1):
            for iy in (0, 1):
                for iz in (0, 1):
                    p = np.array(
                        [(lo, hi)[ix][0], (lo, hi)[iy][1], (lo, hi)[iz][2]], F
                    )
                    pts.append(transform.apply_point(p))
        return AABB.from_points(np.stack(pts))
