"""PBRT-style 3-kind primitive DAG (parity: scene/primitive.rs:44-145).

- BasicPrimitive: shape + material + optional area light
- TransformPrimitive: transform applied to a referenced primitive
- AggregatePrimitive: "build an acceleration structure here"; nesting defines
  a multi-level structure. The device compiler (tpu_raytracing_torch.device) folds
  transform chains and aggregates into flat world-space SoA instance buffers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

from ..geometry import Shape, Transform


@dataclass
class BasicPrimitive:
    shape: Shape
    material: Optional[int]      # MaterialIndex
    area_light: Optional[int] = None  # index into scene.lights


@dataclass
class TransformPrimitive:
    primitive: int               # PrimitiveIndex
    transform: Transform


@dataclass
class AggregatePrimitive:
    children: List[int]          # PrimitiveIndex list


Primitive = Union[BasicPrimitive, TransformPrimitive, AggregatePrimitive]
