"""Cameras: orthographic / pinhole / thin-lens perspective.

Parity: crates/raytracing/src/scene/camera.rs. Stores world_to_raster,
camera_to_world and raster_to_camera transform pairs; the perspective
transform flips X and Y so that raster Y=0 is the top row, and cameras look
down +z in their local frame.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Union

import numpy as np

from ..geometry import Transform, quat_from_rotation_matrix, quat_identity

F = np.float32

DEFAULT_NEAR_CLIP = 0.01
DEFAULT_FAR_CLIP = 1000.0


@dataclass
class Orthographic:
    screen_space_width: float
    screen_space_height: float


@dataclass
class PinholePerspective:
    yfov: float  # radians


@dataclass
class ThinLensPerspective:
    yfov: float            # radians
    aperture_radius: float  # lens radius, world units
    focal_distance: float   # distance to focal plane, camera space


CameraType = Union[Orthographic, PinholePerspective, ThinLensPerspective]


def _screen_to_raster(width, height, top_left, bottom_right) -> Transform:
    screen_to_zero = Transform.translate(-np.asarray(top_left, F))
    scaling = np.asarray(bottom_right, F) - np.asarray(top_left, F)
    screen_to_ndc = screen_to_zero.compose(
        Transform.scale([1.0 / scaling[0], 1.0 / scaling[1], 1.0])
    )
    return screen_to_ndc.compose(
        Transform.scale([float(width), float(height), 1.0])
    )


def create_perspective_transform(
    far_clip: float, near_clip: float, yfov: float, width: int, height: int
) -> Transform:
    """Camera-space -> raster-space through screen space (camera.rs:63-107)."""
    persp = np.array(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [
                0,
                0,
                far_clip / (far_clip - near_clip),
                -(far_clip * near_clip) / (far_clip - near_clip),
            ],
            [0, 0, 1, 0],
        ],
        dtype=F,
    )
    persp_t = Transform.from_matrix(persp)
    wide = width >= height
    fov = yfov * (width / height) if wide else yfov
    invt = 1.0 / np.tan(fov / 2.0)
    # flip both X and Y to match raster convention (Y=0 at top)
    fov_scale = Transform.scale([-invt, -invt, 1.0])
    if wide:
        top_left = [-1.0, -(height / width), 0.0]
        bottom_right = [1.0, height / width, 0.0]
    else:
        top_left = [-(width / height), -1.0, 0.0]
        bottom_right = [width / height, 1.0, 0.0]
    s2r = _screen_to_raster(width, height, top_left, bottom_right)
    return persp_t.compose(fov_scale).compose(s2r)


def create_orthographic_transform(
    far_clip: float,
    near_clip: float,
    width: int,
    height: int,
    screen_space_width: float,
    screen_space_height: float,
) -> Transform:
    translate = Transform.translate([0.0, 0.0, -near_clip])
    scale = Transform.scale([1.0, 1.0, 1.0 / (far_clip - near_clip)])
    top_left = [-screen_space_width / 2.0, -screen_space_height / 2.0, 0.0]
    bottom_right = [screen_space_width / 2.0, screen_space_height / 2.0, 0.0]
    s2r = _screen_to_raster(width, height, top_left, bottom_right)
    return translate.compose(scale).compose(s2r)


@dataclass
class Camera:
    camera_position: np.ndarray
    camera_rotation: np.ndarray  # quaternion (w, x, y, z)

    camera_type: CameraType
    raster_width: int
    raster_height: int
    near_clip: float
    far_clip: float

    world_to_raster: Transform
    camera_to_world: Transform
    raster_to_camera: Transform

    # raster-transform build recipe, kept so with_resolution can rebuild
    # the exact ctor convention. The GLTF importer passes NEGATED clips
    # (cameras look down -z there, gltf.py:330-342) and a flipped ortho
    # ssh, and composes world_to_raster from a world_to_camera WITHOUT
    # the flip_y baked into camera_to_world — rebuilding from the
    # positive near/far fields (the pre-round-4 shape) produced all-miss
    # renders for resized GLTF cameras. None = lookat-ctor convention.
    r2c_clips: tuple | None = None       # (far_arg, near_arg)
    r2c_ssh_sign: float = 1.0            # ortho screen_space_height sign
    world_to_camera: Transform | None = None

    def with_resolution(self, width: int, height: int) -> "Camera":
        """Same view, new raster size — rebuilds the raster transforms.

        Used by the viewer's preview scaling and by tests that shrink
        imported scenes (the reference fixes GLTF output height at 600,
        scene.rs:247; this is the knob it lacks).
        """
        ct = self.camera_type
        far_arg, near_arg = self.r2c_clips or (self.far_clip, self.near_clip)
        if isinstance(ct, Orthographic):
            camera_to_raster = create_orthographic_transform(
                far_arg, near_arg, width, height,
                ct.screen_space_width,
                ct.screen_space_height * self.r2c_ssh_sign,
            )
        else:  # pinhole / thin-lens share the perspective raster mapping
            camera_to_raster = create_perspective_transform(
                far_arg, near_arg, ct.yfov, width, height
            )
        w2c = self.world_to_camera or self.camera_to_world.invert()
        return Camera(
            camera_position=self.camera_position,
            camera_rotation=self.camera_rotation,
            camera_type=ct,
            raster_width=width,
            raster_height=height,
            near_clip=self.near_clip,
            far_clip=self.far_clip,
            world_to_raster=w2c.compose(camera_to_raster),
            camera_to_world=self.camera_to_world,
            raster_to_camera=camera_to_raster.invert(),
            r2c_clips=self.r2c_clips,
            r2c_ssh_sign=self.r2c_ssh_sign,
            world_to_camera=self.world_to_camera,
        )

    @staticmethod
    def lookat_camera_perspective(
        camera_position, target, up, swap_handedness: bool,
        yfov: float, raster_width: int, raster_height: int,
    ) -> "Camera":
        near_clip, far_clip = DEFAULT_NEAR_CLIP, DEFAULT_FAR_CLIP
        camera_to_raster = create_perspective_transform(
            far_clip, near_clip, yfov, raster_width, raster_height
        )
        camera_to_world = Transform.look_at(
            camera_position, target, up, swap_handedness
        )
        return Camera(
            camera_position=np.asarray(camera_position, F),
            camera_rotation=quat_from_rotation_matrix(camera_to_world.forward),
            camera_type=PinholePerspective(yfov=yfov),
            raster_width=raster_width,
            raster_height=raster_height,
            near_clip=near_clip,
            far_clip=far_clip,
            world_to_raster=camera_to_world.invert().compose(camera_to_raster),
            camera_to_world=camera_to_world,
            raster_to_camera=camera_to_raster.invert(),
        )

    @staticmethod
    def lookat_camera_orthographic(
        camera_position, target, up, swap_handedness: bool,
        raster_width: int, raster_height: int, raster_to_screen_ratio: float,
    ) -> "Camera":
        near_clip, far_clip = DEFAULT_NEAR_CLIP, DEFAULT_FAR_CLIP
        ssw = raster_width * raster_to_screen_ratio
        ssh = raster_height * raster_to_screen_ratio
        camera_to_raster = create_orthographic_transform(
            far_clip, near_clip, raster_width, raster_height, ssw, ssh
        )
        camera_to_world = Transform.look_at(
            camera_position, target, up, swap_handedness
        )
        return Camera(
            camera_position=np.asarray(camera_position, F),
            camera_rotation=quat_from_rotation_matrix(camera_to_world.forward),
            camera_type=Orthographic(ssw, ssh),
            raster_width=raster_width,
            raster_height=raster_height,
            near_clip=near_clip,
            far_clip=far_clip,
            world_to_raster=camera_to_world.invert().compose(camera_to_raster),
            camera_to_world=camera_to_world,
            raster_to_camera=camera_to_raster.invert(),
        )

    @staticmethod
    def lookat_camera_thin_lens_perspective(
        camera_position, target, up, swap_handedness: bool,
        yfov: float, raster_width: int, raster_height: int,
        aperture_radius: float, focal_distance: float,
    ) -> "Camera":
        cam = Camera.lookat_camera_perspective(
            camera_position, target, up, swap_handedness,
            yfov, raster_width, raster_height,
        )
        cam.camera_type = ThinLensPerspective(
            yfov=yfov,
            aperture_radius=aperture_radius,
            focal_distance=focal_distance,
        )
        return cam

    @staticmethod
    def from_camera_to_world(
        camera_to_world: Transform,
        camera_type: CameraType,
        raster_width: int,
        raster_height: int,
        camera_to_raster: Transform,
        near_clip: float = DEFAULT_NEAR_CLIP,
        far_clip: float = DEFAULT_FAR_CLIP,
        camera_position=None,
    ) -> "Camera":
        """Generic ctor used by the GLTF/PBRT importers."""
        pos = (
            np.asarray(camera_position, F)
            if camera_position is not None
            else camera_to_world.apply_point([0.0, 0.0, 0.0])
        )
        try:
            rot = quat_from_rotation_matrix(camera_to_world.forward)
        except Exception:
            rot = quat_identity()
        return Camera(
            camera_position=pos,
            camera_rotation=rot,
            camera_type=camera_type,
            raster_width=raster_width,
            raster_height=raster_height,
            near_clip=near_clip,
            far_clip=far_clip,
            world_to_raster=camera_to_world.invert().compose(camera_to_raster),
            camera_to_world=camera_to_world,
            raster_to_camera=camera_to_raster.invert(),
        )
