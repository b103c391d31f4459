"""Scene description: the port's copy of tpu_raytracing/scene (no file
loaders yet: the glTF and PBRT readers come with the CLI, ROADMAP item 8)."""
from .primitive import AggregatePrimitive, BasicPrimitive, Primitive, TransformPrimitive
from .camera import (
    Camera, CameraType, Orthographic, PinholePerspective, ThinLensPerspective,
)
from .scene import Scene, SceneBuilder

__all__ = [
    "AggregatePrimitive", "BasicPrimitive", "Primitive", "TransformPrimitive",
    "Camera", "CameraType", "Orthographic", "PinholePerspective",
    "ThinLensPerspective", "Scene", "SceneBuilder",
]
