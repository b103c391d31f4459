"""Batched light sampling.

Counterpart of tpu_raytracing/ops/light_sampling.py for point and
direction lights. Shadow rays run from the light toward the shading point,
and occlusion is tested on t in [1e-3, distance - 1e-3].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device.scene_buffers import (
    DeviceScene, LIGHT_AREA, LIGHT_DIRECTION, LIGHT_POINT,
)
from .linalg import norm, normalize
from .rng import SampleStream, SamplerConfig


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

    raise NotImplementedError(
        "area lights are outside the ported slice (ROADMAP.md: Next: area "
        "and environment lights)")


def light_emitted_radiance(ds: DeviceScene, light_idx):
    """Radiance seen when a path directly hits an emitter."""
    li = torch.clamp(light_idx, min=0).long()
    is_area = ds.light_kind[li] == LIGHT_AREA
    return torch.where(((light_idx >= 0) & is_area)[:, None], ds.light_vb[li],
                       0.0)
