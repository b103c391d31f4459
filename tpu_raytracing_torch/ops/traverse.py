"""Batched scene intersection: closest-hit, any-hit and hit shading data.

Counterpart of tpu_raytracing/ops/traverse.py for the triangle path: one
pass over the main accel (no spheres, instances, bounce sort or presorted
lanes). The triangle query goes through ops/traverse_kernels.py, which
picks the walk as the JAX kernel switch does and runs its CUDA kernel on
the card and its plain version on the CPU.

Winning primitive encoding: prim >= 0 -> triangle index (BVH order);
prim < 0 -> miss.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device.scene_buffers import DeviceScene
from .intersect import ray_triangle
from .linalg import cross, normalize
from .traverse_kernels import intersect_tris

INF = float("inf")


class Hit(NamedTuple):
    """SoA hit records."""

    hit: torch.Tensor       # (B,) bool
    t: torch.Tensor         # (B,) f32
    prim: torch.Tensor      # (B,) i32 encoded winner
    uv: torch.Tensor        # (B, 2)
    point: torch.Tensor     # (B, 3) world
    normal: torch.Tensor    # (B, 3) world, unit
    dpdu: torch.Tensor      # (B, 3)
    dpdv: torch.Tensor      # (B, 3)
    material: torch.Tensor  # (B,) i32
    light: torch.Tensor     # (B,) i32 (-1 = not an emitter)


def intersect_scene(ds: DeviceScene, origin, direction, t_min, t_max,
                    early_exit: bool = False, active=None):
    """Closest-hit (or any-hit) query. Returns (t, encoded prim or -1)."""
    B = origin.shape[0]
    t_max = t_max.to(torch.float32).expand(B).contiguous()
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=origin.device)
    if ds.meta.n_tris == 0:
        return (torch.full((B,), INF, device=origin.device),
                torch.full((B,), -1, dtype=torch.int32, device=origin.device))
    t_best, best = intersect_tris(
        ds, origin, direction, t_min.expand(B).contiguous(), t_max, active,
        early_exit,
    )
    t = torch.where(best >= 0, t_best, torch.full_like(t_best, INF))
    return t, best


def occluded(ds: DeviceScene, origin, direction, t_min, t_max, active=None):
    """Any-hit query for shadow rays."""
    _, prim = intersect_scene(ds, origin, direction, t_min, t_max,
                              early_exit=True, active=active)
    return prim >= 0


def hit_details(ds: DeviceScene, origin, direction, t, prim) -> Hit:
    """Expand an encoded (t, prim) result into full shading geometry."""
    n_tris = ds.meta.n_tris
    hit = prim >= 0
    point = origin + t[:, None] * direction

    tid = torch.clamp(torch.where(hit, prim, torch.zeros_like(prim)),
                      0, max(n_tris - 1, 0))
    sh = ds.tri_shade[tid.long()]
    p0, p1, p2 = sh[:, 0:3], sh[:, 3:6], sh[:, 6:9]
    sh_ints = sh[:, 24:28].contiguous().view(torch.int32)
    _, _, u, v = ray_triangle(
        origin, direction, p0, p1, p2,
        torch.full_like(t, -INF), torch.full_like(t, INF),
    )
    w = 1.0 - u - v
    geo_n = normalize(cross(p2 - p0, p1 - p0))
    sn = (
        w[:, None] * sh[:, 9:12]
        + u[:, None] * sh[:, 12:15]
        + v[:, None] * sh[:, 15:18]
    )
    normal = torch.where((sh_ints[:, 2] != 0)[:, None], normalize(sn), geo_n)
    has_uv = (sh_ints[:, 3] != 0)[:, None]
    default_uv = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]],
                              device=origin.device)
    uv0 = torch.where(has_uv, sh[:, 18:20], default_uv[0])
    uv1 = torch.where(has_uv, sh[:, 20:22], default_uv[1])
    uv2 = torch.where(has_uv, sh[:, 22:24], default_uv[2])
    uv = w[:, None] * uv0 + u[:, None] * uv1 + v[:, None] * uv2
    # pbrt 4ed eq. 6.7
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    dp02 = p0 - p2
    dp12 = p1 - p2
    det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
    degenerate = torch.abs(det) < 1e-9
    inv_det = torch.where(
        degenerate, torch.zeros_like(det),
        1.0 / torch.where(degenerate, torch.ones_like(det), det))
    dpdu = inv_det[:, None] * (duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12)
    dpdv = inv_det[:, None] * (duv02[:, 0:1] * dp12 - duv12[:, 0:1] * dp02)

    h1 = hit[:, None]
    return Hit(
        hit=hit,
        t=torch.where(hit, t, torch.full_like(t, INF)),
        prim=prim,
        uv=torch.where(h1, uv, torch.zeros_like(uv)),
        point=torch.where(h1, point, torch.zeros_like(point)),
        normal=torch.where(h1, normal, torch.zeros_like(normal)),
        dpdu=torch.where(h1, dpdu, torch.zeros_like(dpdu)),
        dpdv=torch.where(h1, dpdv, torch.zeros_like(dpdv)),
        material=torch.where(hit, sh_ints[:, 0], torch.zeros_like(prim)),
        light=torch.where(hit, sh_ints[:, 1], torch.full_like(prim, -1)),
    )
