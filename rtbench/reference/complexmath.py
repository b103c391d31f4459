"""Batched complex arithmetic as (re, im) tensor pairs.

The benchmark's reference: a frozen copy of the port's
tpu_raytracing_torch/ops/complexmath.py, kept as it is so that a change to the
program cannot move the yardstick.

Counterpart of tpu_raytracing/ops/complexmath.py, for the conductor Fresnel
term; principal-branch square root.
"""
from __future__ import annotations

import torch


def c_mul(a, b):
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def c_div(a, b):
    ar, ai = a
    br, bi = b
    d = br * br + bi * bi
    d = torch.where(d == 0.0, torch.ones_like(d), d)
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def c_add(a, b):
    return a[0] + b[0], a[1] + b[1]


def c_sub(a, b):
    return a[0] - b[0], a[1] - b[1]


def c_scale(a, s):
    return a[0] * s, a[1] * s


def c_abs2(a):
    return a[0] * a[0] + a[1] * a[1]


def _hypot(x, y):
    """sqrt(x^2 + y^2) in the f32 operations of jnp.hypot: the larger leg
    times sqrt(1 + (smaller / larger)^2). c_sqrt's `mag - re` cancels when
    im is small, so the last bit of the magnitude matters there."""
    x, y = torch.abs(x), torch.abs(y)
    inf = torch.isinf(x) | torch.isinf(y)
    x, y = torch.maximum(x, y), torch.minimum(x, y)
    zero = x == 0
    h = x * torch.sqrt(1 + torch.square(
        y / torch.where(zero, torch.ones_like(x), x)))
    h = torch.where(zero, x, h)
    return torch.where(inf, torch.full_like(h, float("inf")), h)


def c_sqrt(a):
    """Principal-branch complex sqrt."""
    re, im = a
    mag = _hypot(re, im)
    sr = torch.sqrt(torch.clamp((mag + re) * 0.5, min=0.0))
    si_mag = torch.sqrt(torch.clamp((mag - re) * 0.5, min=0.0))
    si = torch.where(im < 0.0, -si_mag, si_mag)
    return sr, si


def fresnel_complex(cos_theta_i, eta_re, eta_im):
    """Conductor Fresnel reflectance (materials.rs:1045-1065 semantics)."""
    eta = (eta_re, eta_im)
    sin2_i = 1.0 - cos_theta_i * cos_theta_i
    eta2 = c_mul(eta, eta)
    sin2_t = c_div((sin2_i, torch.zeros_like(sin2_i)), eta2)
    cos2_t = c_sub((torch.ones_like(sin2_i), torch.zeros_like(sin2_i)), sin2_t)
    cos_t = c_sqrt(cos2_t)
    eta_cos_i = c_scale(eta, cos_theta_i)
    cos_i = (cos_theta_i, torch.zeros_like(cos_theta_i))
    r_parl = c_div(c_sub(eta_cos_i, cos_t), c_add(eta_cos_i, cos_t))
    eta_cos_t = c_mul(eta, cos_t)
    r_perp = c_div(c_sub(cos_i, eta_cos_t), c_add(cos_i, eta_cos_t))
    return (c_abs2(r_parl) + c_abs2(r_perp)) * 0.5
