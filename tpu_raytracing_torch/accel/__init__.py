from .bvh import LinearBVH, build_bvh

__all__ = ["LinearBVH", "build_bvh"]
