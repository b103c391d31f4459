"""The plain reference of the first-hit feature buffers (the AOV-only
render): for each pixel, the camera ray through its centre, its closest
hit by brute force (render.py's `intersect`), and there the shading
normal and the albedo a denoiser takes, in float32.

- normal: the unit shading normal of `hit_details` (render.py), zero on a
  miss;
- albedo: a diffuse material's albedo, a coated-diffuse one's diffuse
  albedo, white for any other material (materials.rs get_albedo), zero
  on a miss.

Departures from the port's `render_aov_chunk`, none of which this
configuration reaches:

- every texture is a constant (scene.py), so the albedo is the material
  row's value and no texture lookup, ray differential or mip level is
  computed; the uv and mip-level buffers are not made;
- a triangle's normal is always its interpolated vertex normals
  (scene.py requires them), where the port falls back to the geometric
  normal on a mesh that has none;
- intersection is brute force over every triangle, the first index
  winning an equal t, where the port walks its tree: on a tie the two
  may name different triangles, which share the hit point and, on one
  mesh, its interpolated normal up to rounding;
- a thin-lens or orthographic camera is not modelled: the configuration's
  camera is a pinhole.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .kinds import MAT_COATED_DIFFUSE, MAT_DIFFUSE
from .linalg import apply_point, apply_vector, normalize
from .render import hit_details, intersect
from .scene import RefScene


class FirstHit(NamedTuple):
    origin: torch.Tensor     # (B, 3) the camera ray
    direction: torch.Tensor  # (B, 3)
    t: torch.Tensor          # (B,) inf on a miss
    prim: torch.Tensor       # (B,) -1 on a miss (render.py's `intersect`)
    normal: torch.Tensor     # (B, 3)
    albedo: torch.Tensor     # (B, 3)


def center_rays(sc: RefScene, px, py):
    """The unjittered camera rays through the centres of pixels (px, py):
    (origin, direction), as `PinholeCamera.rays` makes them at offset
    0.5."""
    cam = sc.camera
    x = px.to(torch.float32) + 0.5
    y = py.to(torch.float32) + 0.5
    p_cam = apply_point(cam.r2c, torch.stack([x, y, torch.zeros_like(x)],
                                             dim=-1))
    return (apply_point(cam.c2w, torch.zeros_like(p_cam)),
            normalize(apply_vector(cam.c2w, normalize(p_cam))))


def first_hit(sc: RefScene, px, py, on_query=None) -> FirstHit:
    """The feature buffers of pixels (px, py). `on_query(origin,
    direction, t_min, t_max, active, (t, prim))`, where given, sees the
    one scene query."""
    o, d = center_rays(sc, px, py)
    n = o.shape[0]
    lo = torch.full((n,), sc.camera.near, device=o.device)
    hi = torch.full((n,), sc.camera.far, device=o.device)
    active = torch.ones(n, dtype=torch.bool, device=o.device)
    t, prim = intersect(sc, o, d, lo, hi, active)
    if on_query is not None:
        on_query(o, d, lo, hi, active, (t, prim))
    hit = hit_details(sc, o, d, t, prim)
    kind = sc.mats["kind"][hit.material]
    has_albedo = ((kind == MAT_DIFFUSE) | (kind == MAT_COATED_DIFFUSE))[:, None]
    albedo = torch.where(has_albedo, sc.mats["albedo"][hit.material], 1.0)
    albedo = torch.where((prim >= 0)[:, None], albedo, 0.0)
    return FirstHit(o, d, t, prim, hit.normal, albedo)
