"""Batched camera ray generation + ray differentials.

Counterpart of tpu_raytracing/ops/camera_rays.py: orthographic, pinhole
and thin-lens rays through raster_to_camera + camera_to_world, per-pixel
jitter, concentric-disk lens sampling, and differentials scaled by
max(0.125, sqrt(1/spp)).
"""
from __future__ import annotations

import torch

from ..device.scene_buffers import (
    CAM_ORTHOGRAPHIC, CAM_PINHOLE, CAM_THIN_LENS, DeviceScene,
)
from .linalg import apply_point, apply_vector, normalize
from .rng import (
    SampleStream, SamplerConfig, sample_uniform2, sample_unit_disk_concentric,
)


def _camera_ray(ds: DeviceScene, x, y, lens):
    """One ray per lane from raster coords (x, y); lens: (B, 2) or None."""
    kind = ds.meta.cam_kind
    r2c = ds.cam_raster_to_camera
    c2w = ds.cam_camera_to_world
    raster = torch.stack([x, y, torch.zeros_like(x)], dim=-1)

    if kind == CAM_ORTHOGRAPHIC:
        o_cam = apply_point(r2c, raster)
        d_cam = torch.zeros_like(o_cam)
        d_cam[..., 2] = 1.0
        return apply_point(c2w, o_cam), normalize(apply_vector(c2w, d_cam))

    p_cam = apply_point(r2c, raster)
    if kind == CAM_PINHOLE or lens is None:
        o_cam = torch.zeros_like(p_cam)
        d_cam = normalize(p_cam)
    else:
        if kind != CAM_THIN_LENS:
            raise ValueError(f"unknown camera kind {kind}")
        ap = ds.meta.aperture_radius
        t = ds.meta.focal_distance / p_cam[..., 2]
        focus = p_cam * t[..., None]
        o_cam = torch.stack(
            [lens[..., 0] * ap, lens[..., 1] * ap, torch.zeros_like(x)], dim=-1
        )
        d_cam = normalize(focus - o_cam)
    return apply_point(c2w, o_cam), normalize(apply_vector(c2w, d_cam))


def generate_rays(
    ds: DeviceScene,
    px, py,                    # (B,) integer pixel coords
    cfg: SamplerConfig,
    stream: SampleStream,
    spp: int,
    jitter: bool,
):
    """Returns (origin (B,3), direction (B,3), differentials (B,4,3), stream).

    Differential rows: x_origin, y_origin, x_direction, y_direction.
    """
    fx = px.to(torch.float32)
    fy = py.to(torch.float32)
    if jitter:
        u, stream = sample_uniform2(cfg, stream)
        x = fx + u[:, 0]
        y = fy + u[:, 1]
    else:
        x = fx + 0.5
        y = fy + 0.5

    lens = None
    if ds.meta.cam_kind == CAM_THIN_LENS:
        ul, stream = sample_uniform2(cfg, stream)
        lens = sample_unit_disk_concentric(ul)

    o, d = _camera_ray(ds, x, y, lens)
    ox, dx = _camera_ray(ds, x + 1.0, y, lens)
    oy, dy = _camera_ray(ds, x, y + 1.0, lens)

    scale = max(0.125, (1.0 / spp) ** 0.5)
    scaled_x = normalize(d + (dx - d) * scale)
    scaled_y = normalize(d + (dy - d) * scale)
    diff = torch.stack([ox - o, oy - o, scaled_x - d, scaled_y - d], dim=1)
    return o, d, diff, stream
