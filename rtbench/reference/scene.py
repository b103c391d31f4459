"""The reference's own scene tables, built from the description in a
configuration file: flat triangle lists in the description's order, the
spheres with their object-to-world transforms, one row a material, the
lights and the camera. Nothing here reads what the program compiled.

A description holds `camera`, `materials`, `shapes` (each with a
material and a position it is translated to) and `lights`, each entry
with a `kind`. Each kind is a file of its own, `kinds/<group>/<kind>.py`
(reference/kinds.py), whose `reference` (`row` for a material) gives the
reference's side: a shape's triangles with vertex normals, or a sphere;
a material's table row (every texture a constant); a light's sampler,
made from the description and this scene's geometry
(`samples(light_sample_count)`, 0 for a light next-event estimation
does not sample, `sample(point, cfg, stream)` -> (LightSample, stream),
and `miss(direction)` where rays that escape see it); the camera.
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .kinds import load_kind

F = np.float32


class LightSample(NamedTuple):
    """One light sample per shading point, as the renderer takes it."""

    radiance: torch.Tensor   # (B, 3)
    origin: torch.Tensor     # (B, 3) the shadow ray's origin
    direction: torch.Tensor  # (B, 3)
    distance: torch.Tensor   # (B,)
    pdf: torch.Tensor        # (B,)


class RefScene:
    """Triangles, spheres, materials, lights and camera on `device`."""

    def __init__(self, desc: dict, width: int, height: int, root: Path,
                 device):
        self.device = torch.device(device)
        p0, p1, p2, n0, n1, n2, mats = [], [], [], [], [], [], []
        spheres = []
        for shape in desc["shapes"]:
            geo = load_kind(root, "shape", shape["kind"]).reference(
                shape, root)
            pos = np.asarray(shape["position"], F)
            if "radius" in geo:
                spheres.append((np.asarray(geo["center"], F),
                                F(geo["radius"]), pos, shape["material"]))
                continue
            v, nrm, tri = geo["vertices"], geo["normals"], geo["tris"]
            if nrm is None:
                raise ValueError("the reference interpolates vertex normals")
            a, b, c = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
            area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
            tri = tri[(area != 0.0) & ~np.isnan(area)]
            v = v + pos
            for lst, k in ((p0, 0), (p1, 1), (p2, 2)):
                lst.append(v[tri[:, k]])
            for lst, k in ((n0, 0), (n1, 1), (n2, 2)):
                lst.append(nrm[tri[:, k]])
            mats.append(np.full(len(tri), shape["material"], np.int32))

        def dev(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)

        if not p0:
            raise ValueError("the reference needs a triangle in the scene")
        self.p0, self.p1, self.p2 = (dev(np.concatenate(x))
                                     for x in (p0, p1, p2))
        self.n0, self.n1, self.n2 = (dev(np.concatenate(x))
                                     for x in (n0, n1, n2))
        self.e1, self.e2 = self.p1 - self.p0, self.p2 - self.p0
        self.tri_mat = dev(np.concatenate(mats), torch.int32)
        self.n_tris = int(self.p0.shape[0])

        self.n_spheres = len(spheres)
        if spheres:
            self.sph_center = dev([s[0] for s in spheres])
            self.sph_radius = dev([s[1] for s in spheres])
            o2w = np.tile(np.eye(4, dtype=F), (len(spheres), 1, 1))
            w2o = o2w.copy()
            o2w[:, :3, 3] = [s[2] for s in spheres]
            w2o[:, :3, 3] = [-s[2] for s in spheres]
            self.sph_o2w, self.sph_w2o = dev(o2w), dev(w2o)
            self.sph_mat = dev([s[3] for s in spheres], torch.int32)

        rows = [load_kind(root, "material", m["kind"]).row(m)
                for m in desc["materials"]]
        self.mats = {
            "kind": dev([r["kind"] for r in rows], torch.int32),
            **{k: dev([r[k] for r in rows])
               for k in ("albedo", "eta", "kappa", "alpha", "thickness",
                         "coat_albedo")},
            "remap": dev([r["remap"] for r in rows], torch.bool),
            "has_rough": dev([r["has_rough"] for r in rows], torch.bool),
        }
        self.kinds = tuple(sorted({r["kind"] for r in rows}))

        self.lights = [load_kind(root, "light", li["kind"]).reference(li, self)
                       for li in desc["lights"]]
        self.miss_lights = [li for li in self.lights if hasattr(li, "miss")]
        cam = desc["camera"]
        self.camera = load_kind(root, "camera", cam["kind"]).reference(
            cam, width, height, self.device)
