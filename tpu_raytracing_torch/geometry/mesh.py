"""Triangle meshes + PLY loader.

Capability parity with crates/raytracing/src/geometry/shapes/mesh.rs: a mesh
holds vertices/tris plus optional per-vertex normals and uvs; the PLY loader
supports ascii and binary little/big-endian, fan-triangulates polygon faces
with an optional winding swap, and drops degenerate (zero-area/NaN) triangles.
"""
from __future__ import annotations

import struct
import warnings
from dataclasses import dataclass, field

import numpy as np

F = np.float32

_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


@dataclass
class Mesh:
    vertices: np.ndarray                      # (N, 3) f32
    tris: np.ndarray                          # (T, 3) u32
    normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), F))
    uvs: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), F))

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, F).reshape(-1, 3)
        self.tris = np.asarray(self.tris, np.uint32).reshape(-1, 3)
        self.normals = np.asarray(self.normals, F).reshape(-1, 3)
        self.uvs = np.asarray(self.uvs, F).reshape(-1, 2)

    @property
    def has_normals(self) -> bool:
        return self.normals.shape[0] > 0

    @property
    def has_uvs(self) -> bool:
        return self.uvs.shape[0] > 0

    def tri_areas(self) -> np.ndarray:
        p = self.vertices[self.tris]
        return (
            np.linalg.norm(
                np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=-1
            )
            * 0.5
        ).astype(F)

    def area(self) -> float:
        return float(self.tri_areas().sum())


def _parse_ply_header(data: bytes):
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError("not a PLY file: missing end_header")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body_offset = end + len(b"end_header\n")
    if not header or header[0].strip() != "ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []  # (name, count, [(prop_name, type) or ('list', count_t, item_t, name)])
    for line in header[1:]:
        parts = line.strip().split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[2], parts[1]))
    return fmt, elements, body_offset


def load_ply(path_or_bytes, swap_handedness: bool = False) -> Mesh:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    fmt, elements, offset = _parse_ply_header(data)

    vertices = normals = uvs = None
    faces: list[list[int]] = []

    if fmt == "ascii":
        tokens = data[offset:].split()
        ti = 0

        def next_tok():
            nonlocal ti
            t = tokens[ti]
            ti += 1
            return t

        for name, count, props in elements:
            if name == "vertex":
                cols = [p[0] for p in props]
                rows = np.empty((count, len(cols)), dtype=np.float64)
                for r in range(count):
                    for c in range(len(cols)):
                        rows[r, c] = float(next_tok())
                vertices, normals, uvs = _extract_vertex_arrays(rows, cols)
            elif name == "face":
                for _ in range(count):
                    n = int(next_tok())
                    faces.append([int(next_tok()) for _ in range(n)])
            else:
                for _ in range(count):
                    for p in props:
                        if p[0] == "list":
                            n = int(next_tok())
                            for _ in range(n):
                                next_tok()
                        else:
                            next_tok()
    else:
        endian = "<" if fmt == "binary_little_endian" else ">"
        pos = offset
        for name, count, props in elements:
            if name == "vertex" and all(p[0] != "list" for p in props):
                cols = [p[0] for p in props]
                fmt_str = endian + "".join(_PLY_TYPES[p[1]][0] for p in props)
                size = struct.calcsize(fmt_str)
                raw = np.array(
                    [
                        struct.unpack_from(fmt_str, data, pos + i * size)
                        for i in range(count)
                    ],
                    dtype=np.float64,
                )
                pos += size * count
                vertices, normals, uvs = _extract_vertex_arrays(raw, cols)
            else:
                for _ in range(count):
                    vals = []
                    for p in props:
                        if p[0] == "list":
                            cfmt, csz = _PLY_TYPES[p[1]]
                            (n,) = struct.unpack_from(endian + cfmt, data, pos)
                            pos += csz
                            ifmt, isz = _PLY_TYPES[p[2]]
                            items = struct.unpack_from(
                                endian + str(int(n)) + ifmt, data, pos
                            )
                            pos += isz * int(n)
                            vals.append(list(items))
                        else:
                            tfmt, tsz = _PLY_TYPES[p[1]]
                            (v,) = struct.unpack_from(endian + tfmt, data, pos)
                            pos += tsz
                            vals.append(v)
                    if name == "face":
                        for v in vals:
                            if isinstance(v, list):
                                faces.append([int(x) for x in v])
                                break

    if vertices is None:
        raise ValueError("PLY file has no vertex element")

    tris = []
    for idx in faces:
        if len(idx) < 3:
            continue
        for i in range(1, len(idx) - 1):
            if swap_handedness:
                tri = (idx[0], idx[i + 1], idx[i])
            else:
                tri = (idx[0], idx[i], idx[i + 1])
            a, b, c = (vertices[j] for j in tri)
            area = 0.5 * np.linalg.norm(np.cross(b - a, c - a))
            if area == 0.0 or np.isnan(area):
                warnings.warn(f"degenerate triangle in PLY mesh: {tri}")
            else:
                tris.append(tri)

    return Mesh(
        vertices=vertices,
        tris=np.array(tris, np.uint32).reshape(-1, 3),
        normals=normals if normals is not None else np.zeros((0, 3), F),
        uvs=uvs if uvs is not None else np.zeros((0, 2), F),
    )


def _extract_vertex_arrays(rows: np.ndarray, cols: list[str]):
    def col(name):
        return rows[:, cols.index(name)] if name in cols else None

    vertices = np.stack([col("x"), col("y"), col("z")], axis=-1).astype(F)
    normals = None
    if "nx" in cols:
        normals = np.stack([col("nx"), col("ny"), col("nz")], axis=-1).astype(F)
    uvs = None
    for u_name, v_name in (("u", "v"), ("s", "t")):
        if u_name in cols and v_name in cols:
            uvs = np.stack([col(u_name), col(v_name)], axis=-1).astype(F)
            break
    return vertices, normals, uvs
