"""Batched BSDF evaluation/sampling in the local shading frame.

Counterpart of tpu_raytracing/ops/bsdf.py: parameter fetch, the diffuse
BSDF, smooth and rough dielectrics (whose pieces the coated-diffuse top
interface also uses, ops/layered.py), and smooth and rough conductors with
the complex Fresnel term. The conductors keep the JAX package's two guards
against hits from inside (PARITY.md 2.2): a smooth conductor's sample is
invalid where cos(wo) <= 0, and a rough one evaluates to zero where wo and
wi lie in opposite hemispheres.

Conventions: wo/wi in local shading coordinates, +z = shading normal;
pdfs of delta BSDFs are "1 against the implied delta".
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device.scene_buffers import (
    DeviceScene, MAT_COATED_DIFFUSE, MAT_DIFFUSE, MAT_ROUGH_CONDUCTOR,
    MAT_ROUGH_DIELECTRIC, MAT_SMOOTH_CONDUCTOR, MAT_SMOOTH_DIELECTRIC,
)
from .. import tracing
from .complexmath import fresnel_complex
from .linalg import cross, dot, normalize
from .rng import sample_cosine_hemisphere, sample_unit_disk
from .textures import EvalCtx, eval_texture_from_row

MINIMUM_ROUGHNESS = 1.0e-3

# component flags (bitmask per lane)
NONSPECULAR_REFLECTION = 1
SPECULAR_REFLECTION = 2
NONSPECULAR_TRANSMISSION = 4
SPECULAR_TRANSMISSION = 8
REFLECTION = NONSPECULAR_REFLECTION | SPECULAR_REFLECTION
TRANSMISSION = NONSPECULAR_TRANSMISSION | SPECULAR_TRANSMISSION
SPECULAR = SPECULAR_REFLECTION | SPECULAR_TRANSMISSION
NONSPECULAR = NONSPECULAR_REFLECTION | NONSPECULAR_TRANSMISSION
ALL_COMPONENTS = REFLECTION | TRANSMISSION

_PI = math.pi


def has_flag(allowed, flag, ref):
    """(allowed & flag) != 0 as a bool tensor; allowed: int or tensor."""
    on = (allowed & flag) != 0
    if not isinstance(on, torch.Tensor):
        tracing.sync("*.has_flag")  # a host bool copied to the device
    return torch.as_tensor(on, device=ref.device)


class BsdfParams(NamedTuple):
    """Per-lane material parameters after texture evaluation; kind is the
    effective kind (rough kinds degrade to smooth below MINIMUM_ROUGHNESS)."""

    kind: torch.Tensor       # (B,) i32
    albedo: torch.Tensor     # (B, 3) diffuse / layered-bottom albedo
    eta: torch.Tensor        # (B, 3) ior (dielectric uses [..., 0])
    kappa: torch.Tensor      # (B, 3)
    alpha_x: torch.Tensor    # (B,)
    alpha_y: torch.Tensor    # (B,)
    top_kind: torch.Tensor   # (B,) layered top (smooth/rough dielectric)
    thickness: torch.Tensor  # (B,)
    coat_albedo: torch.Tensor  # (B, 3)


class BsdfSample(NamedTuple):
    wi: torch.Tensor         # (B, 3)
    f: torch.Tensor          # (B, 3)
    pdf: torch.Tensor        # (B,)
    component: torch.Tensor  # (B,) i32 flags (single bit)
    valid: torch.Tensor      # (B,) bool


def get_bsdf_params(ds: DeviceScene, mat_id, ctx: EvalCtx,
                    has_derivs=True) -> BsdfParams:
    """Gather + evaluate material textures -> per-lane BSDF parameters."""
    m = torch.clamp(mat_id, min=0).long()
    mp = ds.mat_pack[m]
    kind = mp[:, 0]
    tex = mp[:, 1:6]
    remap = mp[:, 6] != 0
    rows = ds.mat_tex_rows[m]

    def slot(j):
        return rows[:, 16 * j:16 * (j + 1)]

    sk = ds.meta.slot_kinds or (ds.meta.tex_kinds_present,) * 5
    t0 = eval_texture_from_row(ds, slot(0), ctx, has_derivs, sk[0])
    t1 = eval_texture_from_row(ds, slot(1), ctx, has_derivs, sk[1])
    t2 = eval_texture_from_row(ds, slot(2), ctx, has_derivs, sk[2])
    has_rough_tex = tex[:, 2] >= 0

    is_layered = kind == MAT_COATED_DIFFUSE
    albedo = t0[:, :3]
    eta = torch.where(is_layered[:, None], t1[:, :3], t0[:, :3])
    kappa = t1[:, :3]

    alpha = t2[:, :2]
    alpha = torch.where(remap[:, None],
                        torch.sqrt(torch.clamp(alpha, min=0.0)), alpha)
    alpha = torch.where(has_rough_tex[:, None], alpha, torch.zeros_like(alpha))
    alpha_x, alpha_y = alpha[:, 0], alpha[:, 1]
    too_smooth = torch.maximum(alpha_x, alpha_y) < MINIMUM_ROUGHNESS

    effective = kind
    effective = torch.where((kind == MAT_ROUGH_CONDUCTOR) & too_smooth,
                       MAT_SMOOTH_CONDUCTOR, effective)
    effective = torch.where((kind == MAT_ROUGH_DIELECTRIC) & too_smooth,
                       MAT_SMOOTH_DIELECTRIC, effective)
    top_kind = torch.where(
        too_smooth, MAT_SMOOTH_DIELECTRIC, MAT_ROUGH_DIELECTRIC
    ).to(torch.int32)

    if MAT_COATED_DIFFUSE in ds.meta.mat_kinds_present:
        thickness = eval_texture_from_row(
            ds, slot(3), ctx, has_derivs, sk[3])[:, 0]
        coat_albedo = eval_texture_from_row(
            ds, slot(4), ctx, has_derivs, sk[4])[:, :3]
    else:
        thickness = torch.zeros_like(alpha_x)
        coat_albedo = torch.zeros_like(albedo)

    return BsdfParams(
        kind=effective.to(torch.int32),
        albedo=albedo,
        eta=eta,
        kappa=kappa,
        alpha_x=torch.clamp(alpha_x, min=MINIMUM_ROUGHNESS),
        alpha_y=torch.clamp(alpha_y, min=MINIMUM_ROUGHNESS),
        top_kind=top_kind,
        thickness=thickness,
        coat_albedo=coat_albedo,
    )


def is_delta_bsdf(params: BsdfParams):
    return (params.kind == MAT_SMOOTH_DIELECTRIC) | (
        params.kind == MAT_SMOOTH_CONDUCTOR
    )


def bsdf_components(params: BsdfParams):
    """Component flags supported per lane."""
    k = params.kind
    out = torch.zeros_like(k)
    out = torch.where(k == MAT_DIFFUSE, NONSPECULAR_REFLECTION, out)
    out = torch.where(k == MAT_SMOOTH_DIELECTRIC,
                 SPECULAR_REFLECTION | SPECULAR_TRANSMISSION, out)
    out = torch.where(k == MAT_SMOOTH_CONDUCTOR, SPECULAR_REFLECTION, out)
    out = torch.where(k == MAT_ROUGH_CONDUCTOR, NONSPECULAR_REFLECTION, out)
    out = torch.where(k == MAT_ROUGH_DIELECTRIC,
                 NONSPECULAR_REFLECTION | NONSPECULAR_TRANSMISSION, out)
    out = torch.where(k == MAT_COATED_DIFFUSE, NONSPECULAR, out)
    return out


# ------------------------------------------------------------ scalar pieces

def reflect_z(wo, n):
    return 2.0 * dot(wo, n)[..., None] * n - wo


def fresnel_dielectric(cos_theta_i, eta):
    """Backside flips eta; total internal reflection -> 1."""
    flip = cos_theta_i < 0.0
    eta = torch.where(flip, 1.0 / eta, eta)
    cos_theta_i = torch.abs(cos_theta_i)
    sin2_i = 1.0 - cos_theta_i * cos_theta_i
    sin2_t = sin2_i / (eta * eta)
    tir = sin2_t >= 1.0
    cos_theta_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_parl = (eta * cos_theta_i - cos_theta_t) / (eta * cos_theta_i + cos_theta_t)
    r_perp = (cos_theta_i - eta * cos_theta_t) / (cos_theta_i + eta * cos_theta_t)
    r = (r_parl * r_parl + r_perp * r_perp) * 0.5
    return torch.where(tir, 1.0, r)


def fresnel_complex_rgb(cos_theta, eta3, kappa3):
    return torch.stack(
        [fresnel_complex(cos_theta, eta3[..., i], kappa3[..., i])
         for i in range(3)],
        dim=-1,
    )


def refract(eta, wo, normal):
    """Returns (wi, tir_mask)."""
    cos_i = dot(wo, normal)
    flip = cos_i < 0.0
    eta = torch.where(flip, 1.0 / eta, eta)
    cos_i = torch.abs(cos_i)
    normal = torch.where(flip[..., None], -normal, normal)
    sin2_i = 1.0 - cos_i * cos_i
    sin2_t = sin2_i / (eta * eta)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wi = -wo / eta[..., None] + (cos_i / eta - cos_t)[..., None] * normal
    return wi, tir


# ------------------------------------------------------------ microfacet

def tr_distribution(wm, ax, ay):
    """Anisotropic Trowbridge-Reitz D (PBRT 4ed 9.16, compact form)."""
    q = (wm[..., 0] / ax) ** 2 + (wm[..., 1] / ay) ** 2 + wm[..., 2] ** 2
    safe_q = torch.where(q == 0.0, 1.0, q)
    d = 1.0 / (_PI * ax * ay * safe_q * safe_q)
    return torch.where(q == 0.0, 0.0, d)


def tr_lambda(w, ax, ay):
    """Smith Lambda."""
    z2 = w[..., 2] ** 2
    a2 = (ax * w[..., 0]) ** 2 + (ay * w[..., 1]) ** 2
    safe_z2 = torch.where(z2 == 0.0, 1.0, z2)
    lam = (torch.sqrt(1.0 + a2 / safe_z2) - 1.0) * 0.5
    return torch.where(z2 == 0.0, 1e8, lam)


def tr_g1(w, ax, ay):
    return 1.0 / (1.0 + tr_lambda(w, ax, ay))


def tr_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay))


def tr_visible_distribution(w, wm, ax, ay):
    cos_theta = torch.abs(w[..., 2])
    safe = torch.where(cos_theta == 0.0, 1.0, cos_theta)
    return (
        (tr_g1(w, ax, ay) / safe)
        * tr_distribution(wm, ax, ay)
        * torch.abs(dot(w, wm))
    )


def tr_sample_wm(w, ax, ay, u):
    """Visible-normal (VNDF) sampling (PBRT 4ed 9.6.4)."""
    wh = normalize(
        torch.stack([ax * w[..., 0], ay * w[..., 1], w[..., 2]], dim=-1)
    )
    wh = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    p = sample_unit_disk(u)
    z_axis = torch.zeros_like(w)
    z_axis[..., 2] = 1.0
    x_axis = torch.zeros_like(w)
    x_axis[..., 0] = 1.0
    t1 = torch.where((wh[..., 2] < 0.9999)[..., None], cross(z_axis, wh),
                     x_axis)
    t2 = cross(wh, t1)
    h = torch.sqrt(torch.clamp(1.0 - p[..., 0] ** 2, min=0.0))
    offset = 0.5 * h * (1.0 - wh[..., 2])
    scale = 0.5 * (1.0 + wh[..., 2])
    py = offset + scale * p[..., 1]
    px = p[..., 0]
    pz = torch.sqrt(torch.clamp(1.0 - px * px - py * py, min=0.0))
    nh = px[..., None] * t1 + py[..., None] * t2 + pz[..., None] * wh
    wm = torch.stack(
        [ax * nh[..., 0], ay * nh[..., 1],
         torch.clamp(nh[..., 2], min=1.0e-6)],
        dim=-1,
    )
    return normalize(wm)


# ---------------------------------------------------------------- diffuse

def diffuse_eval(albedo, wo, wi):
    same_side = wo[..., 2] * wi[..., 2] >= 0.0
    return torch.where(same_side[..., None], albedo / _PI,
                       torch.zeros_like(albedo))


def diffuse_pdf(wo, wi, allowed):
    same_side = wo[..., 2] * wi[..., 2] > 0.0
    ok = has_flag(allowed, NONSPECULAR_REFLECTION, wo) & same_side
    return torch.where(ok, 1.0 / (2.0 * _PI), torch.zeros_like(wo[..., 2]))


def diffuse_sample(albedo, wo, u2) -> BsdfSample:
    wi = sample_cosine_hemisphere(u2)
    pdf = wi[..., 2] / _PI
    return BsdfSample(
        wi=wi,
        f=albedo / _PI,
        pdf=pdf,
        component=torch.full(wo.shape[:-1], NONSPECULAR_REFLECTION,
                             dtype=torch.int32, device=wo.device),
        valid=pdf > 0.0,
    )


# ------------------------------------------------------------ smooth kinds

def smooth_dielectric_sample(eta, wo, u1, allowed) -> BsdfSample:
    R = fresnel_dielectric(wo[..., 2], eta)
    T = 1.0 - R
    zero = torch.zeros_like(R)
    p_reflect = torch.where(has_flag(allowed, SPECULAR_REFLECTION, R), R, zero)
    p_transmit = torch.where(has_flag(allowed, SPECULAR_TRANSMISSION, R), T,
                             zero)
    p_total = p_reflect + p_transmit
    safe_total = torch.where(p_total == 0.0, 1.0, p_total)
    choose_reflect = u1 * safe_total < p_reflect

    wi_r = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
    cos_r = torch.abs(wi_r[..., 2])
    safe_cos_r = torch.where(cos_r == 0.0, 1.0, cos_r)
    f_r = R / safe_cos_r
    pdf_r = R / safe_total

    normal = torch.zeros_like(wo)
    normal[..., 2] = 1.0
    wi_t, tir = refract(eta, wo, normal)
    eta_corr = torch.where(wo[..., 2] < 0.0, 1.0 / eta, eta)
    cos_t = torch.abs(wi_t[..., 2])
    safe_cos_t = torch.where(cos_t == 0.0, 1.0, cos_t)
    f_t = (T / safe_cos_t) / (eta_corr * eta_corr)
    pdf_t = T / safe_total

    wi = torch.where(choose_reflect[..., None], wi_r, wi_t)
    f = torch.where(choose_reflect, f_r, f_t)
    pdf = torch.where(choose_reflect, pdf_r, pdf_t)
    component = torch.where(choose_reflect, SPECULAR_REFLECTION,
                            SPECULAR_TRANSMISSION).to(torch.int32)
    valid = (p_total > 0.0) & (pdf > 0.0) & ~(~choose_reflect & tir)
    return BsdfSample(
        wi=wi, f=f[..., None].expand(*f.shape, 3).contiguous(), pdf=pdf,
        component=component, valid=valid,
    )


def smooth_conductor_sample(eta3, kappa3, wo) -> BsdfSample:
    wi = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
    cos = wo[..., 2]
    safe_cos = torch.where(cos == 0.0, torch.ones_like(cos), cos)
    f = fresnel_complex_rgb(cos, eta3, kappa3) / safe_cos[..., None]
    # cos <= 0: a hit from inside the conductor, where F / wo.z would be a
    # huge negative weight; the path ends instead (PARITY.md 2.2)
    return BsdfSample(
        wi=wi, f=f, pdf=torch.ones_like(cos),
        component=torch.full(cos.shape, SPECULAR_REFLECTION,
                             dtype=torch.int32, device=wo.device),
        valid=cos > 0.0,
    )


# --------------------------------------------------- rough conductor (BRDF)

def _ts_refl_halfvector(wo, wi):
    h = wo + wi
    degenerate = torch.all(h == 0.0, dim=-1)
    return degenerate, normalize(
        torch.where(degenerate[..., None], torch.ones_like(h), h))


def ts_refl_pdf(wo, wi, ax, ay):
    degenerate, wm = _ts_refl_halfvector(wo, wi)
    wm = torch.where((wm[..., 2] < 0.0)[..., None], -wm, wm)
    safe_dot = torch.clamp(torch.abs(dot(wo, wm)), min=1e-20)
    pdf = tr_visible_distribution(wo, wm, ax, ay) / (4.0 * safe_dot)
    return torch.where(degenerate, 0.0, pdf)


def ts_refl_eval(wo, wi, eta3, kappa3, ax, ay):
    degenerate, wm = _ts_refl_halfvector(wo, wi)
    fres = fresnel_complex_rgb(torch.abs(dot(wm, wi)), eta3, kappa3)
    denom = 4.0 * wo[..., 2] * wi[..., 2]
    safe_denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    f = ((tr_distribution(wm, ax, ay) * tr_g(wo, wi, ax, ay)
          / safe_denom)[..., None] * fres)
    # opposite hemispheres (a hit from inside) would give a negative
    # reflectance; zero for a reflection-only conductor (PARITY.md 2.2)
    bad = degenerate | (denom <= 0.0)
    return torch.where(bad[..., None], 0.0, f)


def ts_refl_sample(wo, eta3, kappa3, ax, ay, u2) -> BsdfSample:
    wm = tr_sample_wm(wo, ax, ay, u2)
    wi = reflect_z(wo, wm)
    below = wo[..., 2] * wi[..., 2] < 0.0
    pdf = ts_refl_pdf(wo, wi, ax, ay)
    f = ts_refl_eval(wo, wi, eta3, kappa3, ax, ay)
    return BsdfSample(
        wi=wi, f=f, pdf=pdf,
        component=torch.full(pdf.shape, NONSPECULAR_REFLECTION,
                             dtype=torch.int32, device=wo.device),
        valid=~below & (pdf > 0.0),
    )


# -------------------------------------------------- rough dielectric (BSDF)

def _ts_halfvector(wo, wi, eta):
    reflect_case = wo[..., 2] * wi[..., 2] > 0.0
    eta_wm = torch.where(
        reflect_case, torch.ones_like(eta),
        torch.where(wo[..., 2] > 0.0, eta, 1.0 / eta),
    )
    h = wi * eta_wm[..., None] + wo
    degenerate = torch.all(h == 0.0, dim=-1)
    wm = normalize(torch.where(degenerate[..., None], torch.ones_like(h), h))
    wm = torch.where((wm[..., 2] < 0.0)[..., None], -wm, wm)
    grazing = (wi[..., 2] == 0.0) | (wo[..., 2] == 0.0) | degenerate
    backfacing = (dot(wm, wi) * wi[..., 2] < 0.0) | (
        dot(wm, wo) * wo[..., 2] < 0.0
    )
    return reflect_case, eta_wm, wm, grazing | backfacing


def _ts_terms(wo, wi, eta, ax, ay):
    """The terms ts_eval and ts_pdf share for one (wo, wi) pair."""
    reflect_case, eta_wm, wm, invalid = _ts_halfvector(wo, wi, eta)
    F = fresnel_dielectric(dot(wo, wm), eta)
    d = tr_distribution(wm, ax, ay)
    lam_o = tr_lambda(wo, ax, ay)
    return reflect_case, eta_wm, wm, invalid, F, d, lam_o


def _ts_pdf_from(terms, wo, wi, ax, ay, allowed):
    reflect_case, eta_wm, wm, invalid, R, d, lam_o = terms
    T = 1.0 - R
    zero = torch.zeros_like(R)
    p_reflect = torch.where(has_flag(allowed, NONSPECULAR_REFLECTION, R), R,
                            zero)
    p_transmit = torch.where(has_flag(allowed, NONSPECULAR_TRANSMISSION, R), T,
                             zero)
    p_total = p_reflect + p_transmit
    safe_total = torch.where(p_total == 0.0, 1.0, p_total)
    # tr_visible_distribution(wo, wm, ax, ay) with its Lambda(wo) shared
    cos_o = torch.abs(wo[..., 2])
    safe_o = torch.where(cos_o == 0.0, 1.0, cos_o)
    vd = ((1.0 / (1.0 + lam_o)) / safe_o) * d * torch.abs(dot(wo, wm))
    safe_dot = torch.clamp(torch.abs(dot(wo, wm)), min=1e-20)
    pdf_r = (p_reflect / safe_total) * vd / (4.0 * safe_dot)
    denom = (dot(wi, wm) + dot(wo, wm) / eta_wm) ** 2
    safe_denom = torch.where(denom == 0.0, 1.0, denom)
    dwm_dwi = torch.abs(dot(wi, wm)) / safe_denom
    pdf_t = (p_transmit / safe_total) * vd * dwm_dwi
    pdf = torch.where(reflect_case, pdf_r, pdf_t)
    return torch.where(invalid | (p_total == 0.0) | (denom == 0.0), 0.0, pdf)


def _ts_eval_from(terms, wo, wi, ax, ay):
    reflect_case, eta_wm, wm, invalid, F, d, lam_o = terms
    g = 1.0 / (1.0 + lam_o + tr_lambda(wi, ax, ay))  # tr_g(wo, wi)
    denom_r = torch.abs(4.0 * wo[..., 2] * wi[..., 2])
    safe_r = torch.where(denom_r == 0.0, 1.0, denom_r)
    brdf = d * F * g / safe_r
    denom_t = (
        wi[..., 2] * wo[..., 2] * (dot(wi, wm) + dot(wo, wm) / eta_wm) ** 2
    )
    safe_t = torch.where(denom_t == 0.0, 1.0, denom_t)
    btdf = (
        d * (1.0 - F) * g
        * torch.abs(dot(wi, wm) * dot(wo, wm) / safe_t)
        / (eta_wm * eta_wm)
    )
    f = torch.where(reflect_case, brdf, btdf)
    f = torch.where(invalid | (denom_r == 0.0) & reflect_case, 0.0, f)
    return f[..., None].expand(*f.shape, 3).contiguous()


def ts_pdf(wo, wi, eta, ax, ay, allowed):
    return _ts_pdf_from(_ts_terms(wo, wi, eta, ax, ay), wo, wi, ax, ay,
                        allowed)


def ts_eval(wo, wi, eta, ax, ay):
    return _ts_eval_from(_ts_terms(wo, wi, eta, ax, ay), wo, wi, ax, ay)


def ts_eval_pdf(wo, wi, eta, ax, ay, allowed):
    """(ts_eval, ts_pdf) of one (wo, wi) pair: the same operations as the
    two calls, with their common terms computed once."""
    terms = _ts_terms(wo, wi, eta, ax, ay)
    return (_ts_eval_from(terms, wo, wi, ax, ay),
            _ts_pdf_from(terms, wo, wi, ax, ay, allowed))


def ts_sample(wo, eta, ax, ay, allowed, u2, u1) -> BsdfSample:
    wm = tr_sample_wm(wo, ax, ay, u2)
    R = fresnel_dielectric(dot(wo, wm), eta)
    T = 1.0 - R
    zero = torch.zeros_like(R)
    p_reflect = torch.where(has_flag(allowed, REFLECTION, R), R, zero)
    p_transmit = torch.where(has_flag(allowed, TRANSMISSION, R), T, zero)
    p_total = p_reflect + p_transmit
    safe_total = torch.where(p_total == 0.0, 1.0, p_total)
    choose_reflect = u1 * safe_total < p_reflect

    wi_r = reflect_z(wo, wm)
    null_r = wo[..., 2] * wi_r[..., 2] < 0.0
    wi_t, tir = refract(eta, wo, wm)
    null_t = (wo[..., 2] * wi_t[..., 2] > 0.0) | (wi_t[..., 2] == 0.0) | tir

    wi = torch.where(choose_reflect[..., None], wi_r, wi_t)
    null = torch.where(choose_reflect, null_r, null_t) | (p_total == 0.0)
    f, pdf = ts_eval_pdf(wo, wi, eta, ax, ay, allowed)
    component = torch.where(
        choose_reflect, NONSPECULAR_REFLECTION, NONSPECULAR_TRANSMISSION
    ).to(torch.int32)
    return BsdfSample(
        wi=wi, f=f, pdf=pdf, component=component, valid=~null & (pdf > 0.0),
    )
