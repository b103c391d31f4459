"""Scene container + SceneBuilder (parity: scene/scene.rs:14-27, 525-675).

The Scene is a pure host-side description (no rendering). descendants()
mirrors the reference's DescendantsIter: iterate an aggregate's children
while flattening TransformPrimitive chains into a single composed transform
(scene.rs:201-224).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..geometry import Shape, Transform
from ..lights import DiffuseAreaLight, EnvironmentLight, Light
from ..materials import ConstantTexture, Image, Material, Texture
from .camera import Camera
from .primitive import (
    AggregatePrimitive, BasicPrimitive, Primitive, TransformPrimitive,
)

F = np.float32


@dataclass
class Scene:
    camera: Camera
    primitives: List[Primitive]
    root_primitive: int  # index of root AggregatePrimitive
    environment_light: Optional[EnvironmentLight]
    lights: List[Light]
    materials: List[Material]
    textures: List[Texture]
    images: List[Image]

    def root_index(self) -> int:
        return self.root_primitive

    def get_primitive(self, idx: int) -> Primitive:
        return self.primitives[idx]

    def get_aggregate(self, idx: int) -> AggregatePrimitive:
        prim = self.primitives[idx]
        assert isinstance(prim, AggregatePrimitive)
        return prim

    def get_basic(self, idx: int) -> BasicPrimitive:
        prim = self.primitives[idx]
        assert isinstance(prim, BasicPrimitive)
        return prim

    def get_descendant(self, aggregate_idx: int, child: int) -> Tuple[int, Transform]:
        """Resolve an aggregate child, flattening transform chains."""
        current = self.get_aggregate(aggregate_idx).children[child]
        transform = Transform.identity()
        while isinstance(self.primitives[current], TransformPrimitive):
            tp: TransformPrimitive = self.primitives[current]
            current = tp.primitive
            transform = transform.compose(tp.transform)
        return current, transform

    def descendants(self, aggregate_idx: int) -> Iterator[Tuple[int, Transform]]:
        for i in range(len(self.get_aggregate(aggregate_idx).children)):
            yield self.get_descendant(aggregate_idx, i)


@dataclass
class SceneBuilder:
    camera: Optional[Camera] = None
    primitives: List[Primitive] = field(default_factory=list)
    primitive_idxs: List[int] = field(default_factory=list)
    environment_light: Optional[EnvironmentLight] = None
    lights: List[Light] = field(default_factory=list)
    materials: List[Material] = field(default_factory=list)
    textures: List[Texture] = field(default_factory=list)
    images: List[Image] = field(default_factory=list)

    def add_camera(self, camera: Camera) -> None:
        self.camera = camera

    def add_environment_light(self, env: EnvironmentLight) -> None:
        self.environment_light = env

    def add_texture(self, tex: Texture) -> int:
        self.textures.append(tex)
        return len(self.textures) - 1

    def add_constant_texture(self, value) -> int:
        return self.add_texture(ConstantTexture(value=np.asarray(value, F)))

    def add_material(self, material: Material) -> int:
        self.materials.append(material)
        return len(self.materials) - 1

    def add_image(self, image: Image) -> int:
        self.images.append(image)
        return len(self.images) - 1

    def add_light(self, light: Light) -> int:
        self.lights.append(light)
        return len(self.lights) - 1

    def add_point_light(self, position, intensity) -> int:
        from ..lights import PointLight

        return self.add_light(PointLight(position, intensity))

    def add_primitive(self, primitive: Primitive) -> int:
        self.primitives.append(primitive)
        return len(self.primitives) - 1

    def add_root_child(self, primitive_idx: int) -> None:
        self.primitive_idxs.append(primitive_idx)

    def add_shape_at_position(self, shape: Shape, material_id: int, position) -> int:
        return self.add_shape_with_transform(
            shape, material_id, Transform.translate(position), None
        )

    def add_shape_with_transform(
        self,
        shape: Shape,
        material_id: int,
        transform: Transform,
        area_light_radiance=None,
    ) -> int:
        basic_idx = len(self.primitives)
        area_light_idx = None
        if area_light_radiance is not None:
            area_light_idx = self.add_light(
                DiffuseAreaLight(
                    prim_id=basic_idx,
                    radiance=np.asarray(area_light_radiance, F),
                    light_to_world=transform.forward,
                )
            )
        self.primitives.append(
            BasicPrimitive(
                shape=shape, material=material_id, area_light=area_light_idx
            )
        )
        transform_idx = len(self.primitives)
        self.primitives.append(
            TransformPrimitive(primitive=basic_idx, transform=transform)
        )
        self.primitive_idxs.append(transform_idx)
        return basic_idx

    def build(self) -> Scene:
        if self.camera is None:
            raise ValueError("scene description incomplete: no camera")
        root_idx = len(self.primitives)
        self.primitives.append(
            AggregatePrimitive(children=list(self.primitive_idxs))
        )
        return Scene(
            camera=self.camera,
            primitives=self.primitives,
            root_primitive=root_idx,
            environment_light=self.environment_light,
            lights=self.lights,
            materials=self.materials,
            textures=self.textures,
            images=self.images,
        )
