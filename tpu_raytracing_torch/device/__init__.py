from .scene_buffers import DeviceScene, SceneMeta, compile_scene, from_jax_leaves

__all__ = ["DeviceScene", "SceneMeta", "compile_scene", "from_jax_leaves"]
