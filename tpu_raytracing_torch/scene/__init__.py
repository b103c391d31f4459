"""Scene description: the port's copy of tpu_raytracing/scene, with the glTF
and PBRT loaders (`scene_from_file`)."""
from .primitive import AggregatePrimitive, BasicPrimitive, Primitive, TransformPrimitive
from .camera import (
    Camera, CameraType, Orthographic, PinholePerspective, ThinLensPerspective,
)
from .scene import Scene, SceneBuilder
from .loaders import scene_from_file, scene_from_gltf_file, scene_from_pbrt_file

__all__ = [
    "AggregatePrimitive", "BasicPrimitive", "Primitive", "TransformPrimitive",
    "Camera", "CameraType", "Orthographic", "PinholePerspective",
    "ThinLensPerspective", "Scene", "SceneBuilder",
    "scene_from_file", "scene_from_gltf_file", "scene_from_pbrt_file",
]
