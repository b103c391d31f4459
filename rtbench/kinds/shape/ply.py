"""A triangle mesh from a binary PLY `file` under the benchmark's
directory (gzipped where it ends in .gz), read as stored (no change of
handedness)."""
import gzip

from reference.ply import read_ply


def port(shape: dict, root):
    from tpu_raytracing_torch.geometry import TriangleMesh, load_ply
    path = root / shape["file"]
    data = path.read_bytes()
    if path.suffix == ".gz":
        data = gzip.decompress(data)
    return TriangleMesh(load_ply(data, swap_handedness=False))


def reference(shape: dict, root) -> dict:
    v, n, tri = read_ply(root / shape["file"])
    return dict(vertices=v, normals=n, tris=tri)
