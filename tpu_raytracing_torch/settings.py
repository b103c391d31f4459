"""Renderer vocabulary: AOV flags, settings, outputs.

Parity: crates/raytracing/src/renderer/mod.rs:13-117.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .sampling import Independent, Sampler


class AovFlags(enum.IntFlag):
    NONE = 0
    BEAUTY = 1 << 0
    NORMALS = 1 << 1
    ALBEDO = 1 << 2
    UV_COORDS = 1 << 3
    MIP_LEVEL = 1 << 4

    DEBUG = NORMALS | ALBEDO | UV_COORDS | MIP_LEVEL
    FIRST_HIT_AOVS = NORMALS | ALBEDO | UV_COORDS | MIP_LEVEL


@dataclass
class RaytracerSettings:
    max_ray_depth: int = 8
    accumulate_bounces: bool = True

    light_sample_count: int = 4
    samples_per_pixel: int = 32
    seed: Optional[int] = None
    sampler: Sampler = field(default_factory=Independent)

    outputs: AovFlags = AovFlags.BEAUTY

    antialias_primary_rays: bool = True
    antialias_secondary_rays: bool = True


@dataclass
class RenderOutput:
    width: int
    height: int
    beauty: Optional[np.ndarray] = None     # (H, W, 3) f32
    normals: Optional[np.ndarray] = None    # (H, W, 3) f32
    albedo: Optional[np.ndarray] = None     # (H, W, 3) f32
    uv: Optional[np.ndarray] = None         # (H, W, 2) f32
    mip_level: Optional[np.ndarray] = None  # (H, W) f32
    rays_traced: int = 0                    # beauty-pass ray count (perf)
    aov_rays_traced: int = 0                # camera rays of the AOV pass


@dataclass
class SinglePixelOutput:
    sample_index: int
    hit: bool
    uv: np.ndarray
    normal: np.ndarray
    radiance: np.ndarray
