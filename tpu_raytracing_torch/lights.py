"""Light descriptions (parity: crates/raytracing/src/lights/light.rs)."""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Union

import numpy as np

F = np.float32


@dataclass
class PointLight:
    position: np.ndarray
    intensity: np.ndarray

    def __post_init__(self):
        self.position = np.asarray(self.position, F).reshape(3)
        self.intensity = np.asarray(self.intensity, F).reshape(3)


@dataclass
class DirectionLight:
    # oriented *towards* the direction radiant energy flows
    direction: np.ndarray
    radiance: np.ndarray

    def __post_init__(self):
        self.direction = np.asarray(self.direction, F).reshape(3)
        self.radiance = np.asarray(self.radiance, F).reshape(3)


@dataclass
class DiffuseAreaLight:
    prim_id: int                # BasicPrimitive index
    radiance: np.ndarray
    light_to_world: np.ndarray  # 4x4

    def __post_init__(self):
        self.radiance = np.asarray(self.radiance, F).reshape(3)
        self.light_to_world = np.asarray(self.light_to_world, F).reshape(4, 4)


Light = Union[PointLight, DirectionLight, DiffuseAreaLight]


def is_delta_light(light: Light) -> bool:
    return isinstance(light, (PointLight, DirectionLight))


class TextureMapping(enum.IntEnum):
    SPHERICAL = 0


@dataclass
class EnvironmentLight:
    radiance: int  # TextureId
    mapping: TextureMapping = TextureMapping.SPHERICAL
