"""Scene loading dispatch by file extension (parity: cli scene-load logic)."""
from __future__ import annotations

from pathlib import Path

from .scene import Scene


def scene_from_gltf_file(path) -> Scene:
    from .gltf import load_gltf_scene

    return load_gltf_scene(path)


def scene_from_pbrt_file(path) -> Scene:
    from .pbrt import load_pbrt_scene

    return load_pbrt_scene(path)


def scene_from_file(path) -> Scene:
    suffix = Path(path).suffix.lower()
    if suffix in (".glb", ".gltf"):
        return scene_from_gltf_file(path)
    if suffix == ".pbrt":
        return scene_from_pbrt_file(path)
    raise ValueError(f"unsupported scene format: {suffix}")
