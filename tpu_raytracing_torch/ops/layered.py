"""Stochastic layered BSDF (CoatedDiffuse): a dielectric coat over a
diffuse base with an optional homogeneous medium between (HG phase, g = 0).

Counterpart of tpu_raytracing/ops/layered.py, with the same per-lane math
and the same hashed sub-streams: evaluation hashes the (wo, wi) bit
patterns, sampling hashes the caller's per-lane seed.

- `layered_eval` and `layered_sample` launch csrc/layered_walk.cu on CUDA
  tensors, one thread a lane with the whole walk in registers, bit for bit
  with the plain twins; there is no fallback.
- On CPU tensors they run the plain twins, `layered_eval_plain` and
  `layered_sample_plain`: the JAX package's fori_loops over samples and
  walk depth as Python loops over masked tensors.
"""
from __future__ import annotations

import math

import torch

from .. import native_cuda, tracing
from ..device.scene_buffers import MAT_SMOOTH_DIELECTRIC
from . import bsdf as B
from .linalg import dot, make_orthonormal_basis
from .rng import (
    f32_bits, hash_u32, power_heuristic, sample_exponential, uniform_from_bits,
)

N_SAMPLES = 8
MAX_DEPTH = 8
G_HG = 0.0  # the reference hardcodes g = 0


# ------------------------------------------------------- phase function (HG)

def hg_p(wo, wi, g):
    return hg_p_cos(dot(wo, wi), g)


def hg_p_cos(cos_theta, g):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (0.25 / math.pi) * (1.0 - g * g) / (denom * torch.sqrt(denom))


def hg_sample(wo, g, u):
    if abs(g) < 1.0e-3:
        cos_theta = 1.0 - 2.0 * u[..., 0]
    else:
        term = (1.0 - g * g) / (1.0 + g - 2.0 * g * u[..., 0])
        cos_theta = -1.0 / (2.0 * g) * (1.0 + g * g - term * term)
    phi = 2.0 * math.pi * u[..., 1]
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    x, y = make_orthonormal_basis(wo)
    wi = ((torch.cos(phi) * sin_theta)[..., None] * x
          + (torch.sin(phi) * sin_theta)[..., None] * y
          + cos_theta[..., None] * wo)
    p = hg_p_cos(cos_theta, g)
    return wi, p, p  # (wi, p, pdf): exact importance sampling


def _tr_layer(dz, w):
    """Beer-Lambert transmittance through a slab of optical depth |dz/w.z|."""
    wz = torch.where(w[..., 2] == 0.0, 1.0, w[..., 2])
    return torch.exp(-torch.abs(dz / wz))


# ---------------------------------------------------- interface dispatchers

def _top_sample(params: B.BsdfParams, w, allowed, u2, u1) -> B.BsdfSample:
    """Dielectric coat sample; per-lane smooth/rough select (a branch no
    lane takes is skipped, which leaves every lane's value unchanged)."""
    eta = params.eta[..., 0]
    smooth = params.top_kind == MAT_SMOOTH_DIELECTRIC
    tracing.sync("coat.top_sample_kinds", 2)
    any_smooth, all_smooth = bool(smooth.any()), bool(smooth.all())
    if any_smooth:
        # the smooth path reads NONSPECULAR flags as their specular twins
        allowed_s = ((B.SPECULAR_REFLECTION if allowed & B.REFLECTION else 0)
                     | (B.SPECULAR_TRANSMISSION if allowed & B.TRANSMISSION
                        else 0))
        s_smooth = B.smooth_dielectric_sample(eta, w, u1, allowed_s)
        if all_smooth:
            return s_smooth
    s_rough = B.ts_sample(w, eta, params.alpha_x, params.alpha_y, allowed,
                          u2, u1)
    if not any_smooth:
        return s_rough
    sel = smooth[..., None]
    return B.BsdfSample(
        wi=torch.where(sel, s_smooth.wi, s_rough.wi),
        f=torch.where(sel, s_smooth.f, s_rough.f),
        pdf=torch.where(smooth, s_smooth.pdf, s_rough.pdf),
        component=torch.where(smooth, s_smooth.component, s_rough.component),
        valid=torch.where(smooth, s_smooth.valid, s_rough.valid),
    )


def _top_eval_pdf(params: B.BsdfParams, wo, wi, allowed):
    """(f, pdf) of the coat for (wo, wi); zero on smooth (delta) lanes."""
    smooth = params.top_kind == MAT_SMOOTH_DIELECTRIC
    tracing.sync("coat.top_eval_pdf_kinds")
    if bool(smooth.all()):
        return torch.zeros_like(wo), torch.zeros_like(wo[..., 0])
    f, pdf = B.ts_eval_pdf(wo, wi, params.eta[..., 0], params.alpha_x,
                           params.alpha_y, allowed)
    return (torch.where(smooth[..., None], 0.0, f),
            torch.where(smooth, 0.0, pdf))


def _top_eval(params: B.BsdfParams, wo, wi):
    smooth = params.top_kind == MAT_SMOOTH_DIELECTRIC
    tracing.sync("coat.top_eval_kinds")
    if bool(smooth.all()):
        return torch.zeros_like(wo)
    f = B.ts_eval(wo, wi, params.eta[..., 0], params.alpha_x, params.alpha_y)
    return torch.where(smooth[..., None], 0.0, f)


def _top_is_delta(params: B.BsdfParams):
    return params.top_kind == MAT_SMOOTH_DIELECTRIC


def _any_nonzero(x):
    return torch.any(x != 0.0, dim=-1)


# --------------------------------------------------------------- evaluation

def _eval_base_stream(wo, wi):
    """Per-lane one-off stream seed from the (wo, wi) bit patterns."""
    return hash_u32(*(f32_bits(wo[..., i]) for i in range(3)),
                    *(f32_bits(wi[..., i]) for i in range(3)))


def layered_eval_plain(params: B.BsdfParams, wo, wi):
    """Stochastic estimate of the layered BSDF value."""
    flip = (wo[..., 2] < 0.0)[..., None]
    wo = torch.where(flip, -wo, wo)
    wi = torch.where(flip, -wi, wi)
    # the diffuse bottom is opaque: after the two-sided flip only wi.z > 0
    # (exit through the top, exit_z = thickness) is reachable
    reachable = wi[..., 2] > 0.0

    thickness = params.thickness
    albedo = params.coat_albedo
    g = G_HG
    has_medium = _any_nonzero(albedo)
    exit_delta = _top_is_delta(params)

    f = N_SAMPLES * _top_eval(params, wo, wi)
    base = _eval_base_stream(wo, wi)

    def u1(s, d):
        return uniform_from_bits(hash_u32(base, s, d))

    def u2(s, d):
        return torch.stack([u1(s, d), u1(s, d + 1)], dim=-1)

    for s in range(N_SAMPLES):
        enter = _top_sample(params, wo, B.TRANSMISSION, u2(s, 0), u1(s, 2))
        exit_s = _top_sample(params, wi, B.TRANSMISSION, u2(s, 3), u1(s, 5))
        ok = enter.valid & exit_s.valid
        safe_exit_pdf = torch.where(exit_s.pdf <= 0.0, 1.0, exit_s.pdf)
        beta = (exit_s.f * torch.abs(exit_s.wi[..., 2:3])
                / safe_exit_pdf[..., None])
        w = enter.wi
        z = thickness
        beta = torch.where(ok[..., None], beta, 0.0)
        alive = ok

        for depth in range(MAX_DEPTH):
            tracing.sync("coat.eval_alive")
            if not bool(alive.any()):
                break  # nothing below changes a dead lane
            d0 = 8 + depth * 8

            # russian roulette (after depth 3)
            beta_max = torch.amax(beta, dim=-1)
            rr_on = (depth > 3) & (beta_max < 0.25) & alive
            q = torch.clamp(beta_max, min=0.0)
            kill = rr_on & (u1(s, d0) < q)
            alive = alive & ~kill
            beta = torch.where((rr_on & ~kill)[..., None],
                               beta / (1.0 - q)[..., None], beta)

            # medium transit
            wz = torch.where(w[..., 2] == 0.0, 1.0, torch.abs(w[..., 2]))
            dz = sample_exponential(
                torch.clamp(u1(s, d0 + 1), max=0.9999995), 1.0 / wz)
            zp = torch.where(w[..., 2] > 0.0, z + dz, z - dz)
            scatter = has_medium & (zp > 0.0) & (zp < thickness) & alive

            # scattering event between interfaces (NEE toward exit + phase)
            wt = torch.where(
                exit_delta, 1.0,
                power_heuristic(1.0, exit_s.pdf, 1.0,
                                hg_p(-w, -exit_s.wi, g)),
            )
            contrib1 = (
                beta * albedo
                * hg_p(-w, -exit_s.wi, g)[..., None]
                * wt[..., None]
                * _tr_layer(zp - thickness, exit_s.wi)[..., None]
                * exit_s.f
                / safe_exit_pdf[..., None]
            )
            f = f + torch.where(scatter[..., None], contrib1, 0.0)

            ph_wi, ph_p, ph_pdf = hg_sample(-w, g, u2(s, d0 + 2))
            safe_ph_pdf = torch.where(ph_pdf == 0.0, 1.0, ph_pdf)
            beta_sc = beta * albedo * (ph_p / safe_ph_pdf)[..., None]
            facing_exit = (zp < thickness) & (ph_wi[..., 2] > 0.0)
            exit_f, exit_pdf = _top_eval_pdf(params, -ph_wi, wi,
                                             B.TRANSMISSION)
            wt2 = power_heuristic(1.0, ph_pdf, 1.0, exit_pdf)
            contrib2 = (
                beta_sc
                * _tr_layer(zp - thickness, ph_wi)[..., None]
                * exit_f
                * wt2[..., None]
            )
            add2 = (scatter & ~exit_delta & facing_exit
                    & _any_nonzero(exit_f))
            f = f + torch.where(add2[..., None], contrib2, 0.0)

            # no-scatter transit: advance to an interface
            z_nomedium = torch.where(z == thickness, 0.0, thickness)
            beta_nomedium = beta * _tr_layer(thickness, w)[..., None]
            z_medium = torch.minimum(torch.clamp(zp, min=0.0), thickness)

            new_z_transit = torch.where(has_medium, z_medium, z_nomedium)
            new_beta_transit = torch.where(has_medium[..., None], beta,
                                           beta_nomedium)

            at_interface = alive & ~scatter
            at_top = at_interface & (new_z_transit == thickness)
            at_bottom = at_interface & ~at_top

            # top interface: reflect back down
            top_s = _top_sample(params, -w, B.REFLECTION, u2(s, d0 + 4),
                                u1(s, d0 + 6))
            safe_top_pdf = torch.where(top_s.pdf <= 0.0, 1.0, top_s.pdf)
            beta_top = (new_beta_transit * top_s.f
                        * torch.abs(top_s.wi[..., 2:3])
                        / safe_top_pdf[..., None])
            top_dead = at_top & ~top_s.valid

            # bottom (diffuse): NEE toward the exit, then cosine-sample up
            bot_f1 = B.diffuse_eval(params.albedo, -w, -exit_s.wi)
            bot_pdf1 = B.diffuse_pdf(-w, -exit_s.wi, B.NONSPECULAR_REFLECTION)
            wt3 = power_heuristic(1.0, exit_s.pdf, 1.0, bot_pdf1)
            contrib3 = (
                new_beta_transit
                * bot_f1
                * torch.abs(exit_s.wi[..., 2:3])
                * wt3[..., None]
                * _tr_layer(thickness, exit_s.wi)[..., None]
                * exit_s.f
                / safe_exit_pdf[..., None]
            )
            f = f + torch.where(at_bottom[..., None], contrib3, 0.0)

            bot_s = B.diffuse_sample(params.albedo, -w, u2(s, d0 + 4))
            safe_bot_pdf = torch.where(bot_s.pdf <= 0.0, 1.0, bot_s.pdf)
            beta_bot = (new_beta_transit * bot_s.f
                        * torch.abs(bot_s.wi[..., 2:3])
                        / safe_bot_pdf[..., None])
            bot_dead = at_bottom & ~bot_s.valid

            # second NEE term after the bottom bounce
            exit_f2, exit_pdf2 = _top_eval_pdf(params, -bot_s.wi, wi,
                                               B.ALL_COMPONENTS)
            wt4 = power_heuristic(1.0, bot_s.pdf, 1.0, exit_pdf2)
            contrib4 = (
                beta_bot
                * _tr_layer(thickness, bot_s.wi)[..., None]
                * exit_f2
                * wt4[..., None]
            )
            add4 = (at_bottom & ~bot_dead & ~exit_delta
                    & _any_nonzero(exit_f2))
            f = f + torch.where(add4[..., None], contrib4, 0.0)

            new_w = torch.where(
                scatter[..., None], ph_wi,
                torch.where(at_top[..., None], top_s.wi, bot_s.wi))
            new_beta = torch.where(
                scatter[..., None], beta_sc,
                torch.where(at_top[..., None], beta_top, beta_bot))
            new_z = torch.where(scatter, zp, new_z_transit)
            alive = alive & ~(top_dead | bot_dead)
            w = torch.where(alive[..., None], new_w, w)
            beta = torch.where(alive[..., None], new_beta, beta)
            z = torch.where(alive, new_z, z)

    f = f / N_SAMPLES
    return torch.where(reachable[..., None], f, 0.0)


# ----------------------------------------------------------------- sampling

def layered_sample_plain(params: B.BsdfParams, wo,
                         draw_base) -> B.BsdfSample:
    """Sample the layered BSDF with a random walk.

    draw_base: per-lane uint32 seed (int64), derived by the caller from
    the pixel sample stream."""
    flip = wo[..., 2] < 0.0
    flip3 = flip[..., None]
    wo_f = torch.where(flip3, -wo, wo)
    thickness = params.thickness
    albedo = params.coat_albedo
    g = G_HG
    has_medium = _any_nonzero(albedo)

    def u1(d):
        return uniform_from_bits(hash_u32(draw_base, d))

    def u2(d):
        return torch.stack([u1(d), u1(d + 1)], dim=-1)

    enter = _top_sample(params, wo_f, B.ALL_COMPONENTS, u2(0), u1(2))
    enter_reflect = (enter.component & B.REFLECTION) != 0

    # walk state
    w = enter.wi
    f = enter.f * torch.abs(enter.wi[..., 2:3])
    pdf = enter.pdf
    z = thickness.expand(pdf.shape)
    specular_path = (enter.component & B.SPECULAR) != 0
    walking = enter.valid & ~enter_reflect

    done = torch.zeros_like(walking)  # escaped with a transmission event
    out_wi = torch.zeros_like(wo)
    out_f = torch.zeros_like(f)
    out_pdf = torch.zeros_like(pdf)
    out_comp = torch.zeros(pdf.shape, dtype=torch.int32, device=wo.device)

    for depth in range(MAX_DEPTH):
        tracing.sync("coat.sample_walking")
        if not bool(walking.any()):
            break  # nothing below changes a lane that stopped walking
        d0 = 8 + depth * 8

        # russian roulette
        fmax = torch.amax(f, dim=-1)
        safe_pdf = torch.where(pdf == 0.0, 1.0, pdf)
        rr_beta = fmax / safe_pdf
        rr_on = (depth > 3) & (rr_beta < 0.25) & walking
        q = torch.clamp(1.0 - rr_beta, min=0.0)
        kill = rr_on & (u1(d0) < q)
        walking = walking & ~kill & (w[..., 2] != 0.0)
        pdf = torch.where(rr_on & ~kill, pdf * (1.0 - q), pdf)

        # medium event?
        wz = torch.where(w[..., 2] == 0.0, 1.0, torch.abs(w[..., 2]))
        dz = sample_exponential(torch.clamp(u1(d0 + 1), max=0.9999995),
                                1.0 / wz)
        zp = torch.where(w[..., 2] > 0.0, z + dz, z - dz)
        scatter = has_medium & (zp > 0.0) & (zp < thickness) & walking

        ph_wi, ph_p, ph_pdf = hg_sample(-w, g, u2(d0 + 2))
        f_sc = f * albedo * ph_p[..., None]
        pdf_sc = pdf * ph_pdf

        z_transit = torch.where(
            has_medium,
            torch.minimum(torch.clamp(zp, min=0.0), thickness),
            torch.where(z == thickness, 0.0, thickness),
        )
        f_transit = torch.where(has_medium[..., None], f,
                                f * _tr_layer(thickness, w)[..., None])

        at_interface = walking & ~scatter
        at_bottom = at_interface & (z_transit == 0.0)
        bot3 = at_bottom[..., None]

        # interface sample (top dielectric or bottom diffuse)
        top_s = _top_sample(params, -w, B.ALL_COMPONENTS, u2(d0 + 4),
                            u1(d0 + 6))
        bot_s = B.diffuse_sample(params.albedo, -w, u2(d0 + 4))
        i_wi = torch.where(bot3, bot_s.wi, top_s.wi)
        i_f = torch.where(bot3, bot_s.f, top_s.f)
        i_pdf = torch.where(at_bottom, bot_s.pdf, top_s.pdf)
        i_comp = torch.where(at_bottom, bot_s.component, top_s.component)
        i_valid = torch.where(at_bottom, bot_s.valid, top_s.valid)

        f_if = f_transit * i_f
        pdf_if = pdf * i_pdf
        spec_if = specular_path & ((i_comp & B.SPECULAR) != 0)
        transmitted = at_interface & i_valid & ((i_comp & B.TRANSMISSION) != 0)

        # record escapes
        same_dir = wo_f[..., 2] * i_wi[..., 2] > 0.0
        comp_escape = torch.where(
            same_dir,
            torch.where(spec_if, B.SPECULAR_REFLECTION,
                        B.NONSPECULAR_REFLECTION),
            torch.where(spec_if, B.SPECULAR_TRANSMISSION,
                        B.NONSPECULAR_TRANSMISSION),
        ).to(torch.int32)
        escape = transmitted & ~done
        esc3 = escape[..., None]
        out_wi = torch.where(esc3, torch.where(flip3, -i_wi, i_wi), out_wi)
        out_f = torch.where(esc3, f_if, out_f)
        out_pdf = torch.where(escape, pdf_if, out_pdf)
        out_comp = torch.where(escape, comp_escape, out_comp)
        done = done | escape

        # update walk state
        interface_dead = at_interface & ~i_valid
        walking = walking & ~escape & ~interface_dead
        sc3 = scatter[..., None]
        new_w = torch.where(sc3, ph_wi, i_wi)
        new_f = torch.where(sc3, f_sc, f_if * torch.abs(i_wi[..., 2:3]))
        new_pdf = torch.where(scatter, pdf_sc, pdf_if)
        new_spec = torch.where(scatter, False, spec_if)
        new_z = torch.where(scatter, zp, z_transit)
        walk3 = walking[..., None]
        w = torch.where(walk3, new_w, w)
        f = torch.where(walk3, new_f, f)
        pdf = torch.where(walking, new_pdf, pdf)
        specular_path = torch.where(walking, new_spec, specular_path)
        z = torch.where(walking, new_z, z)

    # coat reflection takes priority; else the walk's escape; else null
    sel = enter_reflect[..., None]
    return B.BsdfSample(
        wi=torch.where(sel, torch.where(flip3, -enter.wi, enter.wi), out_wi),
        f=torch.where(sel, enter.f, out_f),
        pdf=torch.where(enter_reflect, enter.pdf, out_pdf),
        component=torch.where(enter_reflect, enter.component, out_comp),
        valid=torch.where(enter_reflect, enter.valid, done),
    )


# ------------------------------------------------------- the card's kernel

def _card_args(name: str, params: B.BsdfParams, wo, extra) -> list:
    """The coat's fields the kernel reads, wo and `extra` (a (field,
    tensor, dtype, shape after n) entry), each checked and contiguous."""
    n, f32 = wo.shape[0], torch.float32
    fields = [("albedo", params.albedo, f32, (3,)),
              ("eta", params.eta, f32, (3,)),
              ("alpha_x", params.alpha_x, f32, ()),
              ("alpha_y", params.alpha_y, f32, ()),
              ("top_kind", params.top_kind, torch.int32, ()),
              ("thickness", params.thickness, f32, ()),
              ("coat_albedo", params.coat_albedo, f32, (3,)),
              ("wo", wo, f32, (3,)), extra]
    return [native_cuda.check_tensor(f"{name}: {field}", x, (n, *width),
                                     dtype, wo.device)
            for field, x, dtype, width in fields]


def _launch(entry: str, args: list, outs, steps) -> None:
    n = args[0].shape[0]
    if steps is not None:
        steps = native_cuda.check_tensor("steps", steps, (n,), torch.int32,
                                         args[0].device)
    native_cuda.launch(entry, args[0].device,
                       *(x.data_ptr() for x in (*args, *outs)),
                       None if steps is None else steps.data_ptr(), n)
    tracing.count("coat.kernel_lanes", n)


def layered_eval(params: B.BsdfParams, wo, wi):
    """Stochastic estimate of the layered BSDF value, (n, 3).

    CUDA tensors launch the kernel (adding n to the traced counter
    `coat.kernel_lanes`); CPU tensors run `layered_eval_plain`."""
    if not native_cuda.on_card("layered_eval", wo):
        return layered_eval_plain(params, wo, wi)
    return _eval_kernel(params, wo, wi)


def layered_sample(params: B.BsdfParams, wo, draw_base) -> B.BsdfSample:
    """Sample the layered BSDF with a random walk.

    draw_base: per-lane uint32 seed (int64), derived by the caller from
    the pixel sample stream. CUDA tensors launch the kernel (adding n to
    `coat.kernel_lanes`); CPU tensors run `layered_sample_plain`."""
    if not native_cuda.on_card("layered_sample", wo):
        return layered_sample_plain(params, wo, draw_base)
    return _sample_kernel(params, wo, draw_base)


def _eval_kernel(params: B.BsdfParams, wo, wi, steps=None):
    """`layered_eval` on CUDA tensors. `steps` (None, or an (n,) int32
    tensor) receives the depth steps each lane's walks began: chip_smoke.py
    bounds the kernel by them, and the card tests read them."""
    args = _card_args("layered_eval", params, wo,
                      ("wi", wi, torch.float32, (3,)))
    f = torch.empty_like(args[-1])
    if wo.shape[0]:
        _launch("tpu_rt_layered_eval", args, (f,), steps)
    return f


def _sample_kernel(params: B.BsdfParams, wo, draw_base,
                   steps=None) -> B.BsdfSample:
    """`layered_sample` on CUDA tensors; `steps` as in `_eval_kernel`."""
    args = _card_args("layered_sample", params, wo,
                      ("draw_base", draw_base, torch.int64, ()))
    n, dev = wo.shape[0], wo.device
    out = B.BsdfSample(
        wi=torch.empty((n, 3), dtype=torch.float32, device=dev),
        f=torch.empty((n, 3), dtype=torch.float32, device=dev),
        pdf=torch.empty(n, dtype=torch.float32, device=dev),
        component=torch.empty(n, dtype=torch.int32, device=dev),
        valid=torch.empty(n, dtype=torch.bool, device=dev),
    )
    if n:
        _launch("tpu_rt_layered_sample", args, out, steps)
    return out
