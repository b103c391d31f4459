"""A quad: four `points` in order and one `normal`, as two triangles
(0, 1, 2) and (2, 3, 0)."""
import numpy as np

TRIS = [[0, 1, 2], [2, 3, 0]]


def port(shape: dict, root):
    from tpu_raytracing_torch.geometry import Mesh, TriangleMesh
    return TriangleMesh(Mesh(
        vertices=np.asarray(shape["points"], np.float32),
        tris=np.array(TRIS, np.uint32),
        normals=np.tile(np.asarray(shape["normal"], np.float32), (4, 1))))


def reference(shape: dict, root) -> dict:
    return dict(vertices=np.asarray(shape["points"], np.float32),
                normals=np.tile(np.asarray(shape["normal"], np.float32),
                                (4, 1)),
                tris=np.array(TRIS, np.int64))
