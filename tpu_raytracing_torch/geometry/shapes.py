"""Shapes: triangle meshes and analytic spheres (parity: shapes/mod.rs:6-9)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np

from .mesh import Mesh

F = np.float32


@dataclass
class Sphere:
    center: np.ndarray
    radius: float

    def __post_init__(self):
        self.center = np.asarray(self.center, F).reshape(3)
        self.radius = float(self.radius)

    def area(self) -> float:
        return float(4.0 * np.pi * self.radius * self.radius)


@dataclass
class TriangleMesh:
    mesh: Mesh

    def area(self) -> float:
        return self.mesh.area()


Shape = Union[Sphere, TriangleMesh]
