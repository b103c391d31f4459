"""The reference's own reader of binary little-endian PLY meshes."""
from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

F = np.float32


def read_ply(path: Path):
    """(vertices (V, 3), normals (V, 3) or None, triangles (T, 3)) of a
    binary little-endian PLY whose faces are triangles: vertex properties
    of float32, the face list of uchar count and uint indices."""
    data = gzip.decompress(path.read_bytes()) if path.suffix == ".gz" \
        else path.read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    if "format binary_little_endian 1.0" not in header:
        raise ValueError(f"{path}: not a binary little-endian PLY")
    counts, props, element = {}, [], None
    for line in header:
        words = line.split()
        if words[:1] == ["element"]:
            element = words[1]
            counts[element] = int(words[2])
        elif words[:1] == ["property"] and element == "vertex":
            if words[1] != "float":
                raise ValueError(f"{path}: vertex property {words}")
            props.append(words[2])
        elif words[:1] == ["property"] and element == "face":
            if words[1:4] != ["list", "uchar", "uint"]:
                raise ValueError(f"{path}: face property {words}")
    nv, nf = counts["vertex"], counts["face"]
    vert = np.frombuffer(data, "<f4", nv * len(props), end).reshape(nv, -1)
    face = np.frombuffer(data, np.dtype([("n", "u1"), ("i", "<u4", 3)]), nf,
                         end + vert.nbytes)
    if not (face["n"] == 3).all():
        raise ValueError(f"{path}: a face is not a triangle")
    col = {name: i for i, name in enumerate(props)}
    vertices = vert[:, [col["x"], col["y"], col["z"]]].astype(F)
    normals = (vert[:, [col["nx"], col["ny"], col["nz"]]].astype(F)
               if "nx" in col else None)
    return vertices, normals, face["i"].astype(np.int64)
