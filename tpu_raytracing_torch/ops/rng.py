"""Counter-based deterministic RNG + sampling distributions.

Counterpart of tpu_raytracing/ops/rng.py, and the renderer's RNG contract:
every draw is a pure hash of (seed, pixel, sample index, dimension), so a
draw is bit-identical to the JAX package's whatever the batching.

uint32 words are carried in int64 tensors holding values in [0, 2**32):
PyTorch on the CPU has no shift or add for uint32. Every multiply and add
is masked back to 32 bits; where an int64 product wraps, its low 32 bits
are still exact, so the masked result equals the uint32 arithmetic.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from ..sampling import Independent, Sampler, Stratified

M32 = 0xFFFFFFFF
_INV_2_24 = 1.0 / (1 << 24)


def _recip(n: int) -> float:
    """The f32 reciprocal of n: XLA rewrites the JAX package's (jitted)
    x / n into x * (1 / n), and the draws follow it bit for bit."""
    return float(np.float32(1.0) / np.float32(n))


def _fmix32(h):
    """murmur3 finalizer: full avalanche on 32 bits."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    h = h ^ (h >> 16)
    return h


def hash_u32(*words):
    """Mix uint32 words (Python ints or int64 tensors) into one."""
    h = 0x811C9DC5
    for w in words:
        h = ((h ^ w) * 0x01000193) & M32
        h = h ^ (h >> 15)
    return _fmix32(h)


def uniform_from_bits(bits):
    """uint32 (in int64) -> f32 in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * _INV_2_24


def f32_bits(x):
    """The uint32 bit pattern of an f32 tensor, as int64."""
    return x.contiguous().view(torch.int32).to(torch.int64) & M32


class SamplerConfig(NamedTuple):
    """Static sampler configuration."""

    kind: str  # "independent" | "stratified"
    jitter: bool = True
    x_strata: int = 4
    y_strata: int = 4
    seed: int = 42

    @staticmethod
    def from_settings(sampler: Sampler, seed) -> "SamplerConfig":
        s = 42 if seed is None else int(seed) & M32
        if isinstance(sampler, Stratified):
            return SamplerConfig(
                "stratified", sampler.jitter, sampler.x_strata,
                sampler.y_strata, s,
            )
        if not isinstance(sampler, Independent):
            raise TypeError(f"unknown sampler: {sampler}")
        return SamplerConfig("independent", seed=s)


class SampleStream(NamedTuple):
    """Per-ray stream: pixel coords, sample index, dimension (int64)."""

    px: torch.Tensor
    py: torch.Tensor
    sample: torch.Tensor
    dim: torch.Tensor


def make_stream(px, py, sample_index) -> SampleStream:
    px = px.to(torch.int64) & M32
    tracing.sync("rng.stream_sample")  # a host int copied to the device
    sample = torch.as_tensor(sample_index, dtype=torch.int64, device=px.device)
    return SampleStream(
        px=px,
        py=py.to(torch.int64) & M32,
        sample=(sample & M32).expand(px.shape).contiguous(),
        dim=torch.zeros_like(px),
    )


def kensler_permute(index, length: int, seed):
    """Stateless permutation of [0, length) (Kensler, Pixar CMJ paper).

    Cycle-walks a keyed bijection on the next power of two until every
    lane lands inside [0, length)."""
    length = int(length)
    if length <= 1:
        return torch.zeros_like(index)
    mask = (1 << (length - 1).bit_length()) - 1

    def round_fn(i):
        i = i ^ seed
        i = (i * 0xE170893D) & M32
        i = i ^ (seed >> 16)
        i = i ^ ((i & mask) >> 4)
        i = i ^ (seed >> 8)
        i = (i * 0x0929EB3F) & M32
        i = i ^ (seed >> 23)
        i = i ^ ((i & mask) >> 1)
        i = (i * (1 | (seed >> 27))) & M32
        i = (i * 0x6935FA69) & M32
        i = i ^ ((i & mask) >> 11)
        i = (i * 0x74DCB303) & M32
        i = i ^ ((i & mask) >> 2)
        i = (i * 0x9E501CC3) & M32
        i = i ^ ((i & mask) >> 2)
        i = (i * 0xC860A3DF) & M32
        i = i & mask
        i = i ^ (i >> 5)
        return i

    out = round_fn(index)
    while True:
        outside = out >= length
        tracing.sync("rng.permute_outside")
        if not bool(outside.any()):
            break
        out = torch.where(outside, round_fn(out), out)
    return ((out + seed) & M32) % length


def _draw_bits(cfg: SamplerConfig, stream: SampleStream, dim):
    return hash_u32(cfg.seed, stream.px, stream.py, stream.sample, dim,
                    0x5F3759DF)


def _strata(cfg: SamplerConfig, stream: SampleStream):
    pseed = hash_u32(stream.dim, cfg.seed, 0xA5A5A5A5)
    return kensler_permute(stream.sample, cfg.x_strata * cfg.y_strata, pseed)


def sample_uniform(cfg: SamplerConfig, stream: SampleStream):
    """One f32 in [0, 1) per lane; returns (value, new stream)."""
    u = uniform_from_bits(_draw_bits(cfg, stream, stream.dim))
    if cfg.kind == "stratified":
        total = cfg.x_strata * cfg.y_strata
        delta = u if cfg.jitter else torch.full_like(u, 0.5)
        u = (_strata(cfg, stream).to(torch.float32) + delta) * _recip(total)
    return u, stream._replace(dim=(stream.dim + 1) & M32)


def sample_uniform2(cfg: SamplerConfig, stream: SampleStream):
    """A 2D sample per lane; returns ((B, 2) values, new stream)."""
    dim = stream.dim
    u0 = uniform_from_bits(_draw_bits(cfg, stream, dim))
    u1 = uniform_from_bits(_draw_bits(cfg, stream, (dim + 1) & M32))
    if cfg.kind == "stratified":
        strata = _strata(cfg, stream)
        y, x = strata // cfg.x_strata, strata % cfg.x_strata
        if cfg.jitter:
            dx, dy = u0, u1
        else:
            dx = dy = torch.full_like(u0, 0.5)
        u0 = (x.to(torch.float32) + dx) * _recip(cfg.x_strata)
        u1 = (y.to(torch.float32) + dy) * _recip(cfg.y_strata)
    return torch.stack([u0, u1], dim=-1), stream._replace(dim=(dim + 2) & M32)


def sample_u32(cfg: SamplerConfig, stream: SampleStream, n: int):
    """An integer in [0, n) per lane (float path, as the JAX package)."""
    u, stream = sample_uniform(cfg, stream)
    idx = torch.clamp((u * n).to(torch.int32), max=n - 1)
    return idx, stream


# ------------------------------------------------------------ distributions

def sample_unit_disk(u):
    r = torch.sqrt(u[..., 0])
    theta = (2.0 * math.pi) * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def sample_unit_disk_concentric(u):
    uo = 2.0 * u - 1.0
    ux, uy = uo[..., 0], uo[..., 1]
    x_dominant = torch.abs(ux) > torch.abs(uy)
    safe_ux = torch.where(ux == 0.0, torch.ones_like(ux), ux)
    safe_uy = torch.where(uy == 0.0, torch.ones_like(uy), uy)
    theta = torch.where(
        x_dominant,
        (math.pi / 4.0) * (uy / safe_ux),
        (math.pi / 2.0) - (math.pi / 4.0) * (ux / safe_uy),
    )
    r = torch.where(x_dominant, ux, uy)
    zero = (ux == 0.0) & (uy == 0.0)
    d = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    return torch.where(zero[..., None], torch.zeros_like(d), d)


def sample_cosine_hemisphere(u):
    d = sample_unit_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.stack([d[..., 0], d[..., 1], z], dim=-1)


def sample_exponential(u, a):
    return -torch.log1p(-u) / a


def power_heuristic(n_a, p_a, n_b, p_b):
    w_a = (n_a * p_a) ** 2
    w_b = (n_b * p_b) ** 2
    return w_a / (w_a + w_b)
