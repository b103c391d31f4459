"""Top-level BSDF dispatch over per-lane material kinds.

Counterpart of tpu_raytracing/ops/bsdf_dispatch.py.

- On CUDA tensors `bsdf_sample` and `bsdf_eval` launch
  csrc/bsdf_kinds.cu for every kind but the coat's: one thread a lane
  computes only its lane's kind, bit for bit with the plain twins; there
  is no fallback.
- On CPU tensors they run the plain twins, `bsdf_sample_plain` and
  `bsdf_eval_plain`: the JAX package's predicated path (what JAX runs on
  the CPU), where each kind that can occur in the scene is computed over
  every lane and per-lane kinds select the result.

Either way the layered walk of CoatedDiffuse, which costs about 100 times
any other kind, runs after on the coated lanes the caller consumes only,
gathered by boolean index (ops/layered.py: its own kernel on the card);
per-lane math is unchanged, so those lanes get the values the predicated
path gives them.

Every bsdf_sample consumes exactly 3 sampler dimensions whatever the lane's
material, so streams stay aligned across the batch; the layered BSDF
derives a hashed sub-stream for its random walk.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..device.scene_buffers import (
    MAT_COATED_DIFFUSE, MAT_DIFFUSE, MAT_ROUGH_CONDUCTOR, MAT_ROUGH_DIELECTRIC,
    MAT_SMOOTH_CONDUCTOR, MAT_SMOOTH_DIELECTRIC,
)
from .. import native_cuda, tracing
from . import bsdf as B
from .layered import layered_eval, layered_sample
from .rng import SampleStream, SamplerConfig, hash_u32, sample_uniform, sample_uniform2


def _rough_kinds(kinds: Tuple[int, ...]):
    """The kinds that can occur per lane given the scene's kinds: a rough
    kind degrades to its smooth one below the minimum roughness."""
    out = set(kinds)
    if MAT_ROUGH_CONDUCTOR in out:
        out.add(MAT_SMOOTH_CONDUCTOR)
    if MAT_ROUGH_DIELECTRIC in out:
        out.add(MAT_SMOOTH_DIELECTRIC)
    return out


def _coated_lanes(params: B.BsdfParams, active):
    wanted = params.kind == MAT_COATED_DIFFUSE
    if active is not None:
        wanted = wanted & active
    tracing.sync("dispatch.coated_lanes")
    return torch.nonzero(wanted)[:, 0]


def _take(params: B.BsdfParams, lanes) -> B.BsdfParams:
    return B.BsdfParams(*(x[lanes] for x in params))


def _kinds_mask(kinds) -> int:
    """The kernel's `kinds`: bit k set where kind k can occur."""
    return sum(1 << int(k) for k in kinds)


def bsdf_eval(params: B.BsdfParams, wo, wi, kinds: Tuple[int, ...],
              active=None):
    """f(wo, wi) per lane; delta BSDFs evaluate to zero.

    active (optional bool mask): the lanes whose result is consumed; the
    layered walk skips coated lanes outside it, which return zero. CUDA
    tensors launch the kernel for the other kinds (adding the lanes to the
    traced counter `shade.kernel_lanes`); CPU tensors run
    `bsdf_eval_plain`."""
    if not native_cuda.on_card("bsdf_eval", wo):
        return bsdf_eval_plain(params, wo, wi, kinds, active)
    kinds = _rough_kinds(kinds)
    return _coat_eval(params, wo, wi, kinds, active,
                      _eval_kernel(params, wo, wi, kinds))


def bsdf_eval_plain(params: B.BsdfParams, wo, wi, kinds: Tuple[int, ...],
                    active=None):
    """`bsdf_eval` as the predicated twin: every kind in `kinds` over
    every lane, selected per lane."""
    kinds = _rough_kinds(kinds)
    k = params.kind
    f = torch.zeros_like(wo)
    if MAT_DIFFUSE in kinds:
        f = torch.where((k == MAT_DIFFUSE)[..., None],
                        B.diffuse_eval(params.albedo, wo, wi), f)
    if MAT_ROUGH_CONDUCTOR in kinds:
        f = torch.where(
            (k == MAT_ROUGH_CONDUCTOR)[..., None],
            B.ts_refl_eval(wo, wi, params.eta, params.kappa, params.alpha_x,
                           params.alpha_y),
            f)
    if MAT_ROUGH_DIELECTRIC in kinds:
        f = torch.where(
            (k == MAT_ROUGH_DIELECTRIC)[..., None],
            B.ts_eval(wo, wi, params.eta[..., 0], params.alpha_x,
                      params.alpha_y),
            f)
    return _coat_eval(params, wo, wi, kinds, active, f)


def _coat_eval(params: B.BsdfParams, wo, wi, kinds, active, f):
    """f with the coated lanes the caller consumes written by the layered
    walk."""
    if MAT_COATED_DIFFUSE in kinds:
        lanes = _coated_lanes(params, active)
        if lanes.numel():
            with tracing.span("rt.coat.eval"):
                f[lanes] = layered_eval(_take(params, lanes), wo[lanes],
                                        wi[lanes])
    return f


def bsdf_pdf(params: B.BsdfParams, wo, wi, allowed, kinds: Tuple[int, ...]):
    """pdf of sampling wi per lane. The layered BSDF has none (nor has the
    reference); the integrator has no BSDF-against-light MIS that would ask
    for it."""
    kinds = _rough_kinds(kinds)
    k = params.kind
    pdf = torch.zeros(wo.shape[:-1], dtype=wo.dtype, device=wo.device)
    if MAT_DIFFUSE in kinds:
        pdf = torch.where(k == MAT_DIFFUSE, B.diffuse_pdf(wo, wi, allowed),
                          pdf)
    if MAT_ROUGH_CONDUCTOR in kinds:
        ok = B.has_flag(allowed, B.NONSPECULAR_REFLECTION, wo)
        p = B.ts_refl_pdf(wo, wi, params.alpha_x, params.alpha_y)
        pdf = torch.where((k == MAT_ROUGH_CONDUCTOR) & ok, p, pdf)
    if MAT_ROUGH_DIELECTRIC in kinds:
        p = B.ts_pdf(wo, wi, params.eta[..., 0], params.alpha_x,
                     params.alpha_y, allowed)
        pdf = torch.where(k == MAT_ROUGH_DIELECTRIC, p, pdf)
    return pdf


def _merge(out: B.BsdfSample, mask, s: B.BsdfSample) -> B.BsdfSample:
    m = mask[..., None]
    return B.BsdfSample(
        wi=torch.where(m, s.wi, out.wi),
        f=torch.where(m, s.f, out.f),
        pdf=torch.where(mask, s.pdf, out.pdf),
        component=torch.where(mask, s.component, out.component),
        valid=torch.where(mask, s.valid, out.valid),
    )


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
    sample. CUDA tensors launch the kernel for the other kinds (adding the
    lanes to `shade.kernel_lanes`), which samples every component and so
    takes only the int ALL_COMPONENTS as `allowed`; CPU tensors run
    `bsdf_sample_plain`."""
    if not native_cuda.on_card("bsdf_sample", wo):
        return bsdf_sample_plain(params, wo, allowed, cfg, stream, kinds,
                                 active)
    kinds = _rough_kinds(kinds)
    u2, stream = sample_uniform2(cfg, stream)
    u1, stream = sample_uniform(cfg, stream)
    out = _sample_kernel(params, wo, u2, u1, allowed, kinds)
    return _coat_sample(params, wo, stream, kinds, active, out), stream


def bsdf_sample_plain(
    params: B.BsdfParams,
    wo,
    allowed,
    cfg: SamplerConfig,
    stream: SampleStream,
    kinds: Tuple[int, ...],
    active=None,
):
    """`bsdf_sample` as the predicated twin: every kind in `kinds` over
    every lane, merged per lane."""
    kinds = _rough_kinds(kinds)
    k = params.kind
    u2, stream = sample_uniform2(cfg, stream)
    u1, stream = sample_uniform(cfg, stream)

    B_ = wo.shape[0]
    out = B.BsdfSample(
        wi=torch.zeros_like(wo),
        f=torch.zeros_like(wo),
        pdf=torch.zeros(B_, dtype=wo.dtype, device=wo.device),
        component=torch.zeros(B_, dtype=torch.int32, device=wo.device),
        valid=torch.zeros(B_, dtype=torch.bool, device=wo.device),
    )
    if MAT_DIFFUSE in kinds:
        ok = B.has_flag(allowed, B.NONSPECULAR_REFLECTION, wo)
        s = B.diffuse_sample(params.albedo, wo, u2)
        out = _merge(out, k == MAT_DIFFUSE, s._replace(valid=s.valid & ok))
    if MAT_SMOOTH_DIELECTRIC in kinds:
        s = B.smooth_dielectric_sample(params.eta[..., 0], wo, u1, allowed)
        out = _merge(out, k == MAT_SMOOTH_DIELECTRIC, s)
    if MAT_SMOOTH_CONDUCTOR in kinds:
        ok = B.has_flag(allowed, B.SPECULAR_REFLECTION, wo)
        s = B.smooth_conductor_sample(params.eta, params.kappa, wo)
        out = _merge(out, k == MAT_SMOOTH_CONDUCTOR,
                     s._replace(valid=s.valid & ok))
    if MAT_ROUGH_CONDUCTOR in kinds:
        ok = B.has_flag(allowed, B.REFLECTION, wo)
        s = B.ts_refl_sample(wo, params.eta, params.kappa, params.alpha_x,
                             params.alpha_y, u2)
        out = _merge(out, k == MAT_ROUGH_CONDUCTOR,
                     s._replace(valid=s.valid & ok))
    if MAT_ROUGH_DIELECTRIC in kinds:
        s = B.ts_sample(wo, params.eta[..., 0], params.alpha_x,
                        params.alpha_y, allowed, u2, u1)
        out = _merge(out, k == MAT_ROUGH_DIELECTRIC, s)
    return _coat_sample(params, wo, stream, kinds, active, out), stream


def _coat_sample(params: B.BsdfParams, wo, stream: SampleStream, kinds,
                 active, out: B.BsdfSample) -> B.BsdfSample:
    """out with the coated lanes the caller consumes written by the layered
    walk, whose draws hash the stream after the dispatch's three."""
    if MAT_COATED_DIFFUSE in kinds:
        lanes = _coated_lanes(params, active)
        if lanes.numel():
            with tracing.span("rt.coat.sample"):
                draw_base = hash_u32(
                    stream.px[lanes], stream.py[lanes], stream.sample[lanes],
                    stream.dim[lanes], 0xC0A7ED,
                )
                s = layered_sample(_take(params, lanes), wo[lanes],
                                   draw_base)
                for dst, src in zip(out, s):
                    dst[lanes] = src
    return out


# ------------------------------------------------------- the card's kernel

def _card_args(name: str, params: B.BsdfParams, wo, extra) -> list:
    """The fields of `params` the kernel reads, wo and `extra` ((field,
    tensor, dtype, shape after n) entries), each checked and contiguous."""
    n, f32 = wo.shape[0], torch.float32
    fields = [("kind", params.kind, torch.int32, ()),
              ("albedo", params.albedo, f32, (3,)),
              ("eta", params.eta, f32, (3,)),
              ("kappa", params.kappa, f32, (3,)),
              ("alpha_x", params.alpha_x, f32, ()),
              ("alpha_y", params.alpha_y, f32, ()),
              ("wo", wo, f32, (3,)), *extra]
    return [native_cuda.check_tensor(f"{name}: {field}", x, (n, *width),
                                     dtype, wo.device)
            for field, x, dtype, width in fields]


def _eval_kernel(params: B.BsdfParams, wo, wi, kinds) -> torch.Tensor:
    """f of every lane of a kind other than the coat's, zero on the coated
    lanes; `kinds` as `_rough_kinds` gives them."""
    args = _card_args("bsdf_eval", params, wo,
                      [("wi", wi, torch.float32, (3,))])
    f = torch.empty_like(args[-1])
    n = wo.shape[0]
    if n:
        native_cuda.launch("tpu_rt_bsdf_eval", wo.device,
                           *(x.data_ptr() for x in (*args, f)),
                           _kinds_mask(kinds), n)
        tracing.count("shade.kernel_lanes", n)
    return f


def _sample_kernel(params: B.BsdfParams, wo, u2, u1, allowed,
                   kinds) -> B.BsdfSample:
    """The sample of every lane of a kind other than the coat's from the
    draws u2 (n, 2) and u1 (n,), the null sample on the coated lanes;
    `allowed` must be the int ALL_COMPONENTS, the integrator's."""
    if not isinstance(allowed, int) or allowed != B.ALL_COMPONENTS:
        raise ValueError(f"bsdf_sample: the kernel samples every component "
                         f"and takes `allowed` = {B.ALL_COMPONENTS} only, "
                         f"got {allowed!r}")
    args = _card_args("bsdf_sample", params, wo,
                      [("u2", u2, torch.float32, (2,)),
                       ("u1", u1, torch.float32, ())])
    n, dev = wo.shape[0], wo.device
    out = B.BsdfSample(
        wi=torch.empty((n, 3), dtype=torch.float32, device=dev),
        f=torch.empty((n, 3), dtype=torch.float32, device=dev),
        pdf=torch.empty(n, dtype=torch.float32, device=dev),
        component=torch.empty(n, dtype=torch.int32, device=dev),
        valid=torch.empty(n, dtype=torch.bool, device=dev),
    )
    if n:
        native_cuda.launch("tpu_rt_bsdf_sample", dev,
                           *(x.data_ptr() for x in (*args, *out)),
                           _kinds_mask(kinds), n)
        tracing.count("shade.kernel_lanes", n)
    return out
