from .vecmath import (
    v2, v3, v4, cross, dot, normalize, length, reflect, lerp, near_zero,
)
from .matrix import (
    mat_identity, mat_translation, mat_rotation, mat_scale, mat_from_basis,
    mat_invert, apply_point, apply_vector, apply_vector_transposed,
)
from .quaternion import (
    quat_identity, quat_from_rotation_matrix, quat_to_matrix, quat_mul,
    quat_rotate, quat_normalize, quat_from_axis_angle, quat_inverse,
    quat_conjugate, quat_dot, quat_norm,
)
from .transform import Transform
from .aabb import AABB
from .mesh import Mesh, load_ply
from .shapes import Shape, Sphere, TriangleMesh

__all__ = [
    "v2", "v3", "v4", "cross", "dot", "normalize", "length", "reflect",
    "lerp", "near_zero",
    "mat_identity", "mat_translation", "mat_rotation", "mat_scale",
    "mat_from_basis", "mat_invert", "apply_point", "apply_vector",
    "apply_vector_transposed",
    "quat_identity", "quat_from_rotation_matrix", "quat_to_matrix",
    "quat_mul", "quat_rotate", "quat_normalize", "quat_from_axis_angle",
    "quat_inverse", "quat_conjugate", "quat_dot", "quat_norm",
    "Transform", "AABB", "Mesh", "load_ply", "Shape", "Sphere",
    "TriangleMesh",
]
