"""Batched light sampling and environment lighting.

Counterpart of tpu_raytracing/ops/light_sampling.py: point, direction and
area lights, and the environment lookup of rays that miss. Shadow rays run
from the light toward the shading point, and occlusion is tested on t in
[1e-3, distance - 1e-3].

The area-light pdf keeps the JAX package's grouping, pdf_area * d^2 /
cos(theta) with the emitter's world-space area (PARITY.md 2.2 records how
it differs from the reference renderer).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device.scene_buffers import (
    DeviceScene, LIGHT_AREA, LIGHT_DIRECTION, LIGHT_POINT,
)
from .linalg import cross, dot, norm, normalize
from .rng import SampleStream, SamplerConfig, sample_uniform, sample_uniform2
from .textures import EvalCtx, eval_texture


class LightSample(NamedTuple):
    radiance: torch.Tensor   # (B, 3)
    origin: torch.Tensor     # (B, 3) shadow-ray origin (on the light)
    direction: torch.Tensor  # (B, 3) shadow-ray direction (light -> point)
    distance: torch.Tensor   # (B,)
    pdf: torch.Tensor        # (B,)


def sample_light(ds: DeviceScene, light_index: int, point,
                 cfg: SamplerConfig, stream: SampleStream):
    """One sample of light `light_index` (static) per shading point."""
    kind = ds.meta.light_kinds[light_index]
    li = light_index
    B = point.shape[0]
    ones = torch.ones(B, dtype=point.dtype, device=point.device)

    if kind == LIGHT_POINT:
        pos = ds.light_va[li]
        d_vec = point - pos
        d = norm(d_vec)
        safe_d = torch.where(d == 0.0, 1.0, d)
        return LightSample(
            radiance=ds.light_vb[li] / (safe_d * safe_d)[:, None],
            origin=pos.expand(point.shape),
            direction=d_vec / safe_d[:, None],
            distance=d,
            pdf=ones,
        ), stream

    if kind == LIGHT_DIRECTION:
        direction = ds.light_va[li]
        diameter = ds.bounds_radius * 2.0
        return LightSample(
            radiance=ds.light_vb[li].expand(point.shape),
            origin=point - direction * diameter,
            direction=normalize(direction).expand(point.shape),
            distance=diameter.expand(B),
            pdf=ones,
        ), stream

    assert kind == LIGHT_AREA
    n_tris = ds.light_emit_count[li]
    u_tri, stream = sample_uniform(cfg, stream)
    tri_rel = torch.minimum(
        (u_tri * n_tris.to(torch.float32)).to(torch.int32), n_tris - 1)
    idx = ds.light_emit_first[li] + tri_rel
    u, stream = sample_uniform2(cfg, stream)
    # low-distortion square -> triangle mapping
    u0, u1 = u[:, 0], u[:, 1]
    lt = u0 < u1
    b0 = torch.where(lt, u0 / 2.0, u0 - u1 / 2.0)
    b1 = torch.where(lt, u1 - u0 / 2.0, u1 / 2.0)
    b2 = 1.0 - b0 - b1

    sh = ds.em_shade[idx.long()]
    p0, p1, p2 = sh[:, 0:3], sh[:, 3:6], sh[:, 6:9]
    p_world = b0[:, None] * p0 + b1[:, None] * p1 + b2[:, None] * p2
    dir_world = point - p_world
    d = norm(dir_world)
    safe_d = torch.where(d == 0.0, 1.0, d)
    dir_unit = dir_world / safe_d[:, None]

    n_interp = (b0[:, None] * sh[:, 9:12] + b1[:, None] * sh[:, 12:15]
                + b2[:, None] * sh[:, 15:18])
    n_geo = normalize(cross(p2 - p0, p1 - p0))
    has_n = sh[:, 19].contiguous().view(torch.int32) != 0
    n = torch.where(has_n[:, None], normalize(n_interp), n_geo)

    cos = dot(dir_unit, n)
    radiance = torch.where((cos < 0.0)[:, None], 0.0,
                           ds.light_vb[li].expand(point.shape))
    area = sh[:, 18]
    safe_cos = torch.clamp(torch.abs(cos), min=1e-9)
    pdf = ((1.0 / n_tris.to(torch.float32))
           * (1.0 / torch.clamp(area, min=1e-20)) * (d * d) / safe_cos)
    return LightSample(radiance=radiance, origin=p_world, direction=dir_unit,
                       distance=d, pdf=pdf), stream


def light_emitted_radiance(ds: DeviceScene, light_idx):
    """Radiance seen when a path directly hits an emitter."""
    li = torch.clamp(light_idx, min=0).long()
    is_area = ds.light_kind[li] == LIGHT_AREA
    return torch.where(((light_idx >= 0) & is_area)[:, None], ds.light_vb[li],
                       0.0)


def environment_radiance(ds: DeviceScene, direction):
    """Spherical lat-long environment lookup of directions (B, 3)."""
    d = normalize(direction)
    t = torch.acos(torch.clamp(d[..., 2], -1.0, 1.0)) / math.pi
    s = (torch.atan2(d[..., 0], d[..., 1]) + math.pi) / (2.0 * math.pi)
    ctx = EvalCtx.without_antialiasing(torch.stack([s, t], dim=-1))
    tid = torch.full(direction.shape[:-1], ds.meta.env_tex,
                     dtype=torch.int32, device=direction.device)
    return eval_texture(ds, tid, ctx, has_derivs=False,
                        kinds=ds.meta.env_kinds)[..., :3]
