"""Top-level BSDF dispatch over per-lane material kinds.

Counterpart of tpu_raytracing/ops/bsdf_dispatch.py on its predicated path
(what JAX runs on the CPU): each kind present in the scene is evaluated and
per-lane kinds select the result. The layered walk of CoatedDiffuse costs
about 100 times any other kind, so it runs only on the coated lanes the
caller consumes, gathered by boolean index; per-lane math is unchanged, so
those lanes get the values the predicated path gives them.

Every bsdf_sample consumes exactly 3 sampler dimensions whatever the lane's
material, so streams stay aligned across the batch; the layered BSDF
derives a hashed sub-stream for its random walk.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..device.scene_buffers import MAT_COATED_DIFFUSE, MAT_DIFFUSE
from . import bsdf as B
from .layered import layered_eval, layered_sample
from .rng import SampleStream, SamplerConfig, hash_u32, sample_uniform, sample_uniform2


def _check_kinds(kinds: Tuple[int, ...]):
    unported = set(kinds) - {MAT_DIFFUSE, MAT_COATED_DIFFUSE}
    if unported:
        raise NotImplementedError(
            f"material kinds {sorted(unported)} are outside the ported slice "
            "(ROADMAP.md: Next: conductor and dielectric BSDFs)")


def _coated_lanes(params: B.BsdfParams, active):
    wanted = params.kind == MAT_COATED_DIFFUSE
    if active is not None:
        wanted = wanted & active
    return torch.nonzero(wanted)[:, 0]


def _take(params: B.BsdfParams, lanes) -> B.BsdfParams:
    return B.BsdfParams(*(x[lanes] for x in params))


def bsdf_eval(params: B.BsdfParams, wo, wi, kinds: Tuple[int, ...],
              active=None):
    """f(wo, wi) per lane; delta BSDFs evaluate to zero.

    active (optional bool mask): the lanes whose result is consumed; the
    layered walk skips coated lanes outside it, which return zero."""
    _check_kinds(kinds)
    k = params.kind
    f = torch.zeros_like(wo)
    if MAT_DIFFUSE in kinds:
        f = torch.where((k == MAT_DIFFUSE)[..., None],
                        B.diffuse_eval(params.albedo, wo, wi), f)
    if MAT_COATED_DIFFUSE in kinds:
        lanes = _coated_lanes(params, active)
        if lanes.numel():
            f[lanes] = layered_eval(_take(params, lanes), wo[lanes], wi[lanes])
    return f


def bsdf_sample(
    params: B.BsdfParams,
    wo,
    allowed,
    cfg: SamplerConfig,
    stream: SampleStream,
    kinds: Tuple[int, ...],
    active=None,
):
    """Sample every lane's BSDF; returns (BsdfSample, stream + 3 dims).

    active (optional bool mask): the lanes whose sample is consumed; the
    layered walk skips coated lanes outside it, which return a null
    sample."""
    _check_kinds(kinds)
    k = params.kind
    u2, stream = sample_uniform2(cfg, stream)
    _, stream = sample_uniform(cfg, stream)  # u1: no ported kind reads it

    B_ = wo.shape[0]
    out = B.BsdfSample(
        wi=torch.zeros_like(wo),
        f=torch.zeros_like(wo),
        pdf=torch.zeros(B_, dtype=wo.dtype, device=wo.device),
        component=torch.zeros(B_, dtype=torch.int32, device=wo.device),
        valid=torch.zeros(B_, dtype=torch.bool, device=wo.device),
    )
    if MAT_DIFFUSE in kinds:
        ok = torch.as_tensor((allowed & B.NONSPECULAR_REFLECTION) != 0,
                             device=wo.device)
        s = B.diffuse_sample(params.albedo, wo, u2)
        m = k == MAT_DIFFUSE
        m3 = m[..., None]
        out = B.BsdfSample(
            wi=torch.where(m3, s.wi, out.wi),
            f=torch.where(m3, s.f, out.f),
            pdf=torch.where(m, s.pdf, out.pdf),
            component=torch.where(m, s.component, out.component),
            valid=torch.where(m, s.valid & ok, out.valid),
        )
    if MAT_COATED_DIFFUSE in kinds:
        lanes = _coated_lanes(params, active)
        if lanes.numel():
            draw_base = hash_u32(
                stream.px[lanes], stream.py[lanes], stream.sample[lanes],
                stream.dim[lanes], 0xC0A7ED,
            )
            s = layered_sample(_take(params, lanes), wo[lanes], draw_base)
            for dst, src in zip(out, s):
                dst[lanes] = src
    return out, stream

