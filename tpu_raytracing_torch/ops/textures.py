"""Texture evaluation over the flattened texture tables.

Counterpart of tpu_raytracing/ops/textures.py, on its CPU path (the
four-gather bilinear tap; the TPU-only quad atlas is not ported). Scale and
mix textures reference leaf textures, so evaluation is two fixed passes
instead of recursion. Image sampling gathers from the flat mip atlas: wrap,
point and bilinear taps, and trilinear as the lerp of two bilinear taps at
the mip level the uv footprint picks. Checker textures use the erf-based
analytic antialiasing.

Every kind is computed on every lane its call site's kind set reaches and
selected by the row's kind, as in JAX; kinds outside the set are skipped.
Table reads clamp their indices into the table, as XLA's gathers do, so
lanes whose rows are masked out read some row and never fault.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device.scene_buffers import (
    DeviceScene, TEX_CHECKER, TEX_IMAGE, TEX_MIX, TEX_SCALE,
)
from ..materials import FilterMode, WrapMode
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


def _rows(table, idx):
    """table[idx] with idx clamped into the table (XLA gather semantics)."""
    return table[torch.clamp(idx, 0, table.shape[0] - 1).long()]


def _clip(x, lo, hi):
    """jnp.clip: per-lane bounds, hi wins where lo > hi."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _int_cols(row):
    """The eight int columns of (B, 16) tex_pack rows."""
    return row[:, 8:16].contiguous().view(torch.int32)


def _apply_wrap(wrap_kind, x):
    frac = x - torch.floor(x)
    # floored modulo (jnp.mod), so negative cells mirror like positive ones
    odd = torch.remainder(torch.floor(x).to(torch.int32), 2) == 1
    mirrored = torch.where(odd, 1.0 - frac, frac)
    clamped = torch.clamp(x, 0.0, 1.0)
    out = torch.where(wrap_kind == int(WrapMode.MIRROR), mirrored, frac)
    return torch.where(wrap_kind == int(WrapMode.CLAMP), clamped, out)


def _level_info(ds: DeviceScene, level):
    """(offset, w, h) of mip levels (B,)."""
    lv = _rows(ds.lvl_pack, level)
    return lv[:, 0], lv[:, 1], lv[:, 2]


def _fetch_texel(ds: DeviceScene, offset, w, x, y):
    return _rows(ds.img_texels, offset + y * w + x)


def _bilerp(ds: DeviceScene, level, u, v):
    offset, w_i, h_i = _level_info(ds, level)
    w = w_i.to(torch.float32)
    h = h_i.to(torch.float32)
    x = u * w - 0.5
    y = v * h - 0.5
    zero = torch.zeros_like(x)
    x0 = _clip(torch.floor(x), zero, w - 1.0).to(torch.int32)
    y0 = _clip(torch.floor(y), zero, h - 1.0).to(torch.int32)
    x1 = _clip(torch.ceil(x), zero, w - 1.0).to(torch.int32)
    y1 = _clip(torch.ceil(y), zero, h - 1.0).to(torch.int32)
    xf = torch.clamp(x - torch.floor(x), 0.0, 1.0)[:, None]
    yf = torch.clamp(y - torch.floor(y), 0.0, 1.0)[:, None]
    p00 = _fetch_texel(ds, offset, w_i, x0, y0)
    p01 = _fetch_texel(ds, offset, w_i, x1, y0)
    p10 = _fetch_texel(ds, offset, w_i, x0, y1)
    p11 = _fetch_texel(ds, offset, w_i, x1, y1)
    u0 = p00 * (1.0 - xf) + p01 * xf
    u1 = p10 * (1.0 - xf) + p11 * xf
    return u0 * (1.0 - yf) + u1 * yf


def _point_sample(ds: DeviceScene, level, u, v):
    offset, w_i, h_i = _level_info(ds, level)
    w = w_i.to(torch.float32)
    h = h_i.to(torch.float32)
    zero = torch.zeros_like(u)
    # torch.round rounds half to even, as jnp.round does
    x = _clip(torch.round(u * w - 0.5), zero, w - 1.0).to(torch.int32)
    y = _clip(torch.round(v * h - 0.5), zero, h - 1.0).to(torch.int32)
    return _fetch_texel(ds, offset, w_i, x, y)


def _mip_level_value(ds: DeviceScene, mip0, ctx: EvalCtx):
    """Raw (unclamped) mip level from the uv footprint; (level, valid)."""
    _, w0_i, _ = _level_info(ds, mip0)
    w0 = w0_i.to(torch.float32)
    dx = torch.sqrt(ctx.dudx * ctx.dudx + ctx.dvdx * ctx.dvdx)
    dy = torch.sqrt(ctx.dudy * ctx.dudy + ctx.dvdy * ctx.dvdy)
    larger = torch.maximum(dx, dy)
    valid = larger > 0.0
    half_pixel = 1.0 / (2.0 * w0)
    level = torch.log2(torch.where(valid, larger, 1.0) / half_pixel)
    return level, valid


def _sample_image(ds: DeviceScene, ints, ctx: EvalCtx, has_derivs=True):
    mip0 = torch.clamp(ints[:, 0], min=0)  # first mip level
    filt = ints[:, 4]
    wrap = ints[:, 5]
    n_levels = ints[:, 6]
    u = _apply_wrap(wrap, ctx.uv[:, 0])
    v = _apply_wrap(wrap, ctx.uv[:, 1])

    # without derivatives every footprint is invalid and trilinear lanes
    # take the bilinear tap: the mip taps are skipped (the same values)
    if ds.meta.any_trilinear and has_derivs:
        # non-trilinear or invalid-footprint lanes route both taps to the
        # base level, where tap `a` is the bilinear value
        level, valid = _mip_level_value(ds, mip0, ctx)
        max_level = (n_levels - 1).to(torch.float32)
        cl = _clip(level, torch.zeros_like(level), max_level)
        lower = torch.floor(cl).to(torch.int32)
        upper = torch.ceil(cl).to(torch.int32)
        t = (level - torch.floor(level))[:, None]
        tri_lane = (filt == int(FilterMode.TRILINEAR)) & valid
        a = _bilerp(ds, torch.where(tri_lane, mip0 + lower, mip0), u, v)
        b = _bilerp(ds, torch.where(tri_lane, mip0 + upper, mip0), u, v)
        out = torch.where(tri_lane[:, None], (1.0 - t) * a + t * b, a)
    else:
        out = _bilerp(ds, mip0, u, v)
    if ds.meta.any_nearest:
        nearest = _point_sample(ds, mip0, u, v)
        out = torch.where((filt == int(FilterMode.NEAREST))[:, None],
                          nearest, out)
    return out


_SQRT2 = float(torch.sqrt(torch.tensor(2.0, dtype=torch.float32)))


def _checker(row, ctx: EvalCtx, has_derivs=True):
    c1 = row[:, 0:4]
    c2 = row[:, 4:8]
    u = ctx.uv[:, 0] - torch.floor(ctx.uv[:, 0])
    v = ctx.uv[:, 1] - torch.floor(ctx.uv[:, 1])
    plain = torch.where(((u > 0.5) != (v > 0.5))[:, None], c1, c2)
    # zero derivatives point-sample every lane: skip the erf antialiasing
    if not has_derivs:
        return plain
    point_sampled = ((ctx.dudx == 0.0) & (ctx.dvdx == 0.0)) | (
        (ctx.dudy == 0.0) & (ctx.dvdy == 0.0))
    rate_x = torch.sqrt(ctx.dudx * ctx.dudx + ctx.dvdx * ctx.dvdx)
    rate_y = torch.sqrt(ctx.dudy * ctx.dudy + ctx.dvdy * ctx.dvdy)
    sigma = 0.1 * torch.maximum(rate_x, rate_y)
    sigma = torch.where(sigma == 0.0, 1.0, sigma)

    def fold(x):
        return torch.where(x < 0.25, x,
                           torch.where(x < 0.75, -(x - 0.5), x - 1.0))

    scale = _SQRT2 * sigma
    x_factor = 0.5 * (1.0 + torch.special.erf(fold(u) / scale))
    y_factor = 0.5 * (1.0 + torch.special.erf(fold(v) / scale))
    x_factor = torch.where(v > 0.5, x_factor, 1.0 - x_factor)
    y_factor = torch.where(u > 0.5, y_factor, 1.0 - y_factor)
    factor = (x_factor * y_factor)[:, None]
    aa = factor * c1 + (1.0 - factor) * c2
    return torch.where(point_sampled[:, None], plain, aa)


def _leaf_from_row(ds: DeviceScene, row, ctx: EvalCtx, has_derivs, kinds):
    out = row[:, 0:4]  # constants (and the default)
    if TEX_IMAGE not in kinds and TEX_CHECKER not in kinds:
        return out
    ints = _int_cols(row)
    kind = ints[:, 3]
    if TEX_IMAGE in kinds:
        out = torch.where((kind == TEX_IMAGE)[:, None],
                          _sample_image(ds, ints, ctx, has_derivs), out)
    if TEX_CHECKER in kinds:
        out = torch.where((kind == TEX_CHECKER)[:, None],
                          _checker(row, ctx, has_derivs), out)
    return out


def _eval_leaf(ds: DeviceScene, tid, ctx: EvalCtx, has_derivs, kinds):
    return _leaf_from_row(ds, _rows(ds.tex_pack, tid), ctx, has_derivs,
                          kinds)


def eval_texture_from_row(ds: DeviceScene, row, ctx: EvalCtx,
                          has_derivs=True, kinds=None):
    """Evaluate pre-gathered (B, 16) tex_pack rows -> (B, 4).

    has_derivs False promises that every ctx derivative is zero, which
    skips the mip taps and the checker's antialiasing (they give the same
    values then). kinds: the texture kinds reachable at this call site
    (scene compile's slot and env sets; None = every kind in the scene)."""
    if kinds is None:
        kinds = ds.meta.tex_kinds_present
    out = _leaf_from_row(ds, row, ctx, has_derivs, kinds)
    if TEX_SCALE in kinds or TEX_MIX in kinds:
        ints = _int_cols(row)
        kind = ints[:, 3]
        # an image row's ref0 is a mip level: the children ids clamp into
        # the table, and the selects below mask those lanes out
        a = _eval_leaf(ds, ints[:, 0], ctx, has_derivs, kinds)
        b = _eval_leaf(ds, ints[:, 1], ctx, has_derivs, kinds)
        if TEX_SCALE in kinds:
            out = torch.where((kind == TEX_SCALE)[:, None], a * b, out)
        if TEX_MIX in kinds:
            c = _eval_leaf(ds, ints[:, 2], ctx, has_derivs, kinds)
            out = torch.where((kind == TEX_MIX)[:, None],
                              (1.0 - c) * a + c * b, out)
    return out


def eval_texture(ds: DeviceScene, tid, ctx: EvalCtx, has_derivs=True,
                 kinds=None):
    """Evaluate texture ids (B,) at ctx -> (B, 4); ids below 0 read row 0."""
    row = _rows(ds.tex_pack, tid)
    return eval_texture_from_row(ds, row, ctx, has_derivs, kinds)


def texture_mip_level(ds: DeviceScene, tid, ctx: EvalCtx):
    """Mip level of trilinear image textures; (level, valid) per lane, zero
    and invalid unless the texture is a trilinear image."""
    B = tid.shape[0]
    if TEX_IMAGE not in ds.meta.tex_kinds_present or not ds.meta.any_trilinear:
        return (torch.zeros(B, dtype=torch.float32, device=tid.device),
                torch.zeros(B, dtype=torch.bool, device=tid.device))
    ints = _int_cols(_rows(ds.tex_pack, tid))
    mip0 = torch.clamp(ints[:, 0], min=0)
    level, valid = _mip_level_value(ds, mip0, ctx)
    valid = (valid & (ints[:, 3] == TEX_IMAGE)
             & (ints[:, 4] == int(FilterMode.TRILINEAR)))
    return torch.where(valid, level, 0.0), valid
