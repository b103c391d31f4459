"""Texture evaluation over the flattened texture tables.

Counterpart of tpu_raytracing/ops/textures.py for the slice: the eval
context (uv and its screen-space derivatives) and constant textures.
Image, checker, scale and mix textures are outside the slice; scene compile
already refuses them, and evaluating one raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device.scene_buffers import DeviceScene, TEX_CONSTANT
from .linalg import dot


class EvalCtx(NamedTuple):
    """uv + screen-space uv derivatives."""

    uv: torch.Tensor     # (B, 2)
    dudx: torch.Tensor   # (B,)
    dudy: torch.Tensor
    dvdx: torch.Tensor
    dvdy: torch.Tensor

    @staticmethod
    def without_antialiasing(uv) -> "EvalCtx":
        z = torch.zeros(uv.shape[:-1], dtype=uv.dtype, device=uv.device)
        return EvalCtx(uv=uv, dudx=z, dudy=z, dvdx=z, dvdy=z)


def eval_ctx_from_differentials(hit, ray_o, ray_d, diff) -> EvalCtx:
    """Chain-rule + least-squares duv/dxy from world-space ray
    differentials. diff: (B, 4, 3) rows x_o, y_o, x_d, y_d."""
    n, p = hit.normal, hit.point
    rx_o = ray_o + diff[:, 0]
    ry_o = ray_o + diff[:, 1]
    rx_d = ray_d + diff[:, 2]
    ry_d = ray_d + diff[:, 3]

    d = -dot(n, p)
    tx = -(dot(n, rx_o) + d) / dot(n, rx_d)
    ty = -(dot(n, ry_o) + d) / dot(n, ry_d)
    dpdx = rx_o + tx[:, None] * rx_d - p
    dpdy = ry_o + ty[:, None] * ry_d - p

    dpdu, dpdv = hit.dpdu, hit.dpdv
    ata00 = dot(dpdu, dpdu)
    ata11 = dot(dpdv, dpdv)
    ata01 = dot(dpdu, dpdv)
    inv_det = 1.0 / (ata00 * ata11 - ata01 * ata01)
    atb0x = dot(dpdu, dpdx)
    atb1x = dot(dpdv, dpdx)
    atb0y = dot(dpdu, dpdy)
    atb1y = dot(dpdv, dpdy)

    def clamp(v):
        v = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
        return torch.clamp(v, -1.0e8, 1.0e8)

    return EvalCtx(
        uv=hit.uv,
        dudx=clamp(inv_det * (ata11 * atb0x - ata01 * atb1x)),
        dvdx=clamp(inv_det * (ata00 * atb1x - ata01 * atb0x)),
        dudy=clamp(inv_det * (ata11 * atb0y - ata01 * atb1y)),
        dvdy=clamp(inv_det * (ata00 * atb1y - ata01 * atb0y)),
    )


def eval_texture_from_row(ds: DeviceScene, row, ctx: EvalCtx,
                          has_derivs=True, kinds=None):
    """Evaluate pre-gathered (B, 16) tex_pack rows -> (B, 4).

    kinds: the texture kinds reachable at this call site (None = every
    kind in the scene); only constants are ported."""
    if kinds is None:
        kinds = ds.meta.tex_kinds_present
    if set(kinds) - {TEX_CONSTANT}:
        raise NotImplementedError(
            "only constant textures are ported (ROADMAP.md: Next: image, "
            "checker, scale and mix textures)")
    return row[:, 0:4]


def eval_texture(ds: DeviceScene, tid, ctx: EvalCtx, has_derivs=True,
                 kinds=None):
    """Evaluate texture ids (B,) at ctx -> (B, 4)."""
    row = ds.tex_pack[torch.clamp(tid, min=0).long()]
    return eval_texture_from_row(ds, row, ctx, has_derivs, kinds)
