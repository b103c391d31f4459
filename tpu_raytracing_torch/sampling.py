"""Sampler configuration (parity: crates/raytracing/src/sampling/mod.rs).

Implementations are device-side, counter-based streams in ops/rng.py keyed by
(pixel, sample, dimension) so renders are bit-deterministic regardless of how
pixels/samples are sharded across chips.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union


@dataclass
class Independent:
    pass


@dataclass
class Stratified:
    jitter: bool = True
    x_strata: int = 4
    y_strata: int = 4


Sampler = Union[Independent, Stratified]
