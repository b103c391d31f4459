"""Builtin test scenes (parity: raytracing/src/scene/test_scenes/mod.rs:618-692).

The 11 smoke-test scenes the rttest visual-regression harness renders. The
`bunny.ply` asset is the public-domain Stanford bunny scan (stored gzipped).
The reference embeds a `lake_pier_1k.exr` environment map that is not present
in the mounted reference checkout (.MISSING_LARGE_BLOBS); environment_light
uses a deterministic procedural sky image instead — snapshots are blessed
against this renderer's own output, so the substitution is self-consistent.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List

import numpy as np

from ..geometry import Mesh, Sphere, TriangleMesh, load_ply, v3, v4
from ..lights import DirectionLight, EnvironmentLight, TextureMapping
from ..materials import (
    CheckerTexture, CoatedDiffuse, Diffuse, FilterMode, Image, ImageTexture,
    RoughConductor, RoughDielectric, SmoothConductor, SmoothDielectric,
    TextureSampler, WrapMode,
)
from ..sampling import Stratified
from ..settings import AovFlags, RaytracerSettings
from .camera import Camera
from .scene import Scene, SceneBuilder

F = np.float32
_ASSETS = Path(__file__).parent / "assets"


def make_mesh(verts, tris, normals) -> Mesh:
    return Mesh(
        vertices=np.asarray(verts, F),
        tris=np.asarray(tris, np.uint32),
        normals=np.asarray(normals, F),
    )


def make_plane(a, b, c, d, normal) -> Mesh:
    a, b, c, d = (np.asarray(p, F) for p in (a, b, c, d))
    normal = np.asarray(normal, F)
    x = np.cross(b - a, c - a)
    x = x / np.linalg.norm(x)
    assert np.allclose(x, normal, atol=1e-5), "points not in plane"
    return make_mesh(
        [a, b, c, d],
        [[0, 1, 2], [2, 3, 0]],
        [normal] * 4,
    )


def make_cube(side_length: float) -> Mesh:
    """Axis-aligned cube, 4 verts per face for flat shading, CCW outward."""
    h = side_length / 2.0
    vertices, normals, tris = [], [], []

    def face(vs, n):
        base = len(vertices)
        vertices.extend(vs)
        normals.extend([n] * 4)
        tris.append([base, base + 1, base + 2])
        tris.append([base, base + 2, base + 3])

    face([( h, -h, -h), ( h,  h, -h), ( h,  h,  h), ( h, -h,  h)], (1, 0, 0))
    face([(-h,  h, -h), (-h, -h, -h), (-h, -h,  h), (-h,  h,  h)], (-1, 0, 0))
    face([( h,  h, -h), (-h,  h, -h), (-h,  h,  h), ( h,  h,  h)], (0, 1, 0))
    face([(-h, -h, -h), ( h, -h, -h), ( h, -h,  h), (-h, -h,  h)], (0, -1, 0))
    face([(-h, -h,  h), ( h, -h,  h), ( h,  h,  h), (-h,  h,  h)], (0, 0, 1))
    face([( h, -h, -h), (-h, -h, -h), (-h,  h, -h), ( h,  h, -h)], (0, 0, -1))
    return make_mesh(vertices, tris, normals)


def load_bunny() -> Mesh:
    with gzip.open(_ASSETS / "bunny.ply.gz", "rb") as f:
        return load_ply(f.read(), swap_handedness=False)


def _procedural_sky_image(width: int = 256, height: int = 128) -> Image:
    """Deterministic lat-long sky: blue-ish gradient + warm horizon + ground."""
    v = (np.arange(height, dtype=F) + 0.5) / height  # 0 = +z pole
    u = (np.arange(width, dtype=F) + 0.5) / width
    theta = v * np.pi
    phi = u * 2.0 * np.pi
    ct = np.cos(theta)[:, None] * np.ones((1, width), F)  # z component
    sky_t = np.clip(ct, 0.0, 1.0)
    horizon = np.exp(-np.abs(ct) * 8.0)
    sun = np.exp(
        -(
            (np.cos(phi)[None, :] * np.sin(theta)[:, None] - 0.8) ** 2
            + (ct - 0.4) ** 2
        )
        * 40.0
    )
    r = 0.25 + 0.15 * sky_t + 0.55 * horizon + 4.0 * sun
    g = 0.35 + 0.25 * sky_t + 0.35 * horizon + 3.5 * sun
    b = 0.55 + 0.45 * sky_t + 0.15 * horizon + 2.5 * sun
    ground = ct < 0.0
    r = np.where(ground, 0.12, r)
    g = np.where(ground, 0.10, g)
    b = np.where(ground, 0.08, b)
    return Image(np.stack([r, g, b], axis=-1).astype(F))


def sphere_scene() -> Scene:
    sb = SceneBuilder()
    white = sb.add_constant_texture(v4(1, 1, 1, 1))
    mat = sb.add_material(Diffuse(albedo=white))
    sb.add_shape_at_position(Sphere(v3(0, 0, 0), 1.0), mat, v3(0, 0, -3))
    sb.add_camera(
        Camera.lookat_camera_perspective(
            v3(0, 0, 0), v3(0, 0, -3), v3(0, 1, 0), False,
            np.deg2rad(45.0), 400, 400,
        )
    )
    return sb.build()


def cube_scene() -> Scene:
    sb = SceneBuilder()
    white = sb.add_constant_texture(v4(1, 1, 1, 1))
    mat = sb.add_material(Diffuse(albedo=white))
    sb.add_shape_at_position(TriangleMesh(make_cube(1.0)), mat, v3(0, 0, -3))
    sb.add_camera(
        Camera.lookat_camera_perspective(
            v3(1, 0.75, -1), v3(0, 0, -3), v3(0, 1, 0), False,
            np.deg2rad(45.0), 400, 400,
        )
    )
    return sb.build()


def cube_orthographic_scene() -> Scene:
    sb = SceneBuilder()
    white = sb.add_constant_texture(v4(1, 1, 1, 1))
    mat = sb.add_material(Diffuse(albedo=white))
    sb.add_shape_at_position(TriangleMesh(make_cube(1.0)), mat, v3(0, 0, -3))
    sb.add_camera(
        Camera.lookat_camera_orthographic(
            v3(1, 0.75, -1), v3(0, 0, -3), v3(0, 1, 0), False,
            400, 400, 2.5 / 400.0,
        )
    )
    return sb.build()


def checkered_plane_scene() -> Scene:
    sb = SceneBuilder()
    plane = make_plane(
        v3(-100, -100, 0.1), v3(100, -100, 0.1),
        v3(100, 100, 0.1), v3(-100, 100, 0.1),
        v3(0, 0, 1),
    )
    plane.uvs = np.array(
        [[-500, -500], [500, -500], [500, 500], [-500, 500]], F
    )
    checker = sb.add_texture(
        CheckerTexture(color1=v4(0, 0, 0, 1), color2=v4(1, 1, 1, 1))
    )
    mat = sb.add_material(Diffuse(albedo=checker))
    sb.add_shape_at_position(TriangleMesh(plane), mat, v3(0, 0, 0))
    sb.add_light(
        DirectionLight(direction=v3(0, 0, -1), radiance=v3(1000, 1000, 1000))
    )
    y_angle = np.deg2rad(10.0)
    sb.add_camera(
        Camera.lookat_camera_perspective(
            v3(0, 0, 0.22),
            v3(0, np.cos(y_angle), 0.22 - np.sin(y_angle)),
            v3(0, 0, 1),
            False,
            np.deg2rad(40.0), 480, 270,
        )
    )
    return sb.build()


def cornell_box() -> SceneBuilder:
    """Cornell-box template (z-up): width=2, height=1.5, depth=2."""
    sb = SceneBuilder()
    w, h, d = 2.0, 1.5, 2.0
    left, right = w / 2, -w / 2
    bottom, top = 0.0, h
    back, front = -d / 2, d / 2
    up, down = v3(0, 0, 1), v3(0, 0, -1)
    leftn, rightn, backn = v3(-1, 0, 0), v3(1, 0, 0), v3(0, 1, 0)

    floor = make_plane(
        v3(right, front, bottom), v3(right, back, bottom),
        v3(left, back, bottom), v3(left, front, bottom), up,
    )
    ceiling = make_plane(
        v3(left, front, top), v3(left, back, top),
        v3(right, back, top), v3(right, front, top), down,
    )
    left_wall = make_plane(
        v3(left, front, bottom), v3(left, back, bottom),
        v3(left, back, top), v3(left, front, top), leftn,
    )
    right_wall = make_plane(
        v3(right, front, top), v3(right, back, top),
        v3(right, back, bottom), v3(right, front, bottom), rightn,
    )
    back_wall = make_plane(
        v3(right, back, top), v3(left, back, top),
        v3(left, back, bottom), v3(right, back, bottom), backn,
    )

    white = sb.add_constant_texture(v4(0.6, 0.6, 0.6, 1))
    red = sb.add_constant_texture(v4(0.6, 0.2, 0.2, 1))
    blue = sb.add_constant_texture(v4(0.2, 0.2, 0.6, 1))
    white_d = sb.add_material(Diffuse(albedo=white))
    red_d = sb.add_material(Diffuse(albedo=red))
    blue_d = sb.add_material(Diffuse(albedo=blue))

    zero = v3(0, 0, 0)
    sb.add_shape_at_position(TriangleMesh(floor), white_d, zero)
    sb.add_shape_at_position(TriangleMesh(ceiling), white_d, zero)
    sb.add_shape_at_position(TriangleMesh(left_wall), red_d, zero)
    sb.add_shape_at_position(TriangleMesh(right_wall), blue_d, zero)
    sb.add_shape_at_position(TriangleMesh(back_wall), white_d, zero)

    sb.add_camera(
        Camera.lookat_camera_perspective(
            v3(0, front + 3.4, 0.4), v3(0, 0, h / 2), v3(0, 0, 1), False,
            np.deg2rad(37.8), 500, 500,
        )
    )
    sb.add_point_light(v3(0, 0, top - 0.1), v3(1000, 1000, 1000))
    return sb


def dielectric_scene() -> Scene:
    sb = cornell_box()
    ior = sb.add_constant_texture(v4(1.5, 0, 0, 0))
    mat = sb.add_material(SmoothDielectric(eta=ior))
    sb.add_shape_at_position(Sphere(v3(0, 0, 0), 0.5), mat, v3(0, 0, 0.75))
    return sb.build()


def metal_scene() -> Scene:
    sb = cornell_box()
    eta = sb.add_constant_texture(v4(0.13, 0.43, 1.38, 0))
    kappa = sb.add_constant_texture(v4(4.10, 2.46, 1.91, 0))
    mat = sb.add_material(SmoothConductor(eta=eta, kappa=kappa))
    sb.add_shape_at_position(Sphere(v3(0, 0, 0), 0.5), mat, v3(0, 0, 0.75))
    return sb.build()


def rough_metal_scene() -> Scene:
    sb = cornell_box()
    eta = sb.add_constant_texture(v4(0.13, 0.43, 1.38, 0))
    kappa = sb.add_constant_texture(v4(4.10, 2.46, 1.91, 0))
    rough = sb.add_constant_texture(v4(0.5, 0.5, 0, 0))
    mat = sb.add_material(
        RoughConductor(eta=eta, kappa=kappa, remap_roughness=True, roughness=rough)
    )
    sb.add_shape_at_position(Sphere(v3(0, 0, 0), 0.5), mat, v3(0, 0, 0.75))
    return sb.build()


def rough_dielectric_scene() -> Scene:
    sb = cornell_box()
    ior = sb.add_constant_texture(v4(1.5, 0, 0, 0))
    rough = sb.add_constant_texture(v4(0.5, 0.5, 0, 0))
    mat = sb.add_material(
        RoughDielectric(eta=ior, remap_roughness=True, roughness=rough)
    )
    sb.add_shape_at_position(Sphere(v3(0, 0, 0), 0.5), mat, v3(0, 0, 0.75))
    return sb.build()


def out_of_focus_sphere_scene() -> Scene:
    sb = SceneBuilder()
    white = sb.add_constant_texture(v4(1, 1, 1, 1))
    mat = sb.add_material(Diffuse(albedo=white))
    sb.add_shape_at_position(Sphere(v3(0, 0, 0), 1.0), mat, v3(0, 0, -5))
    sb.add_light(DirectionLight(direction=v3(0, 0, -1), radiance=v3(1, 1, 1)))
    sb.add_camera(
        Camera.lookat_camera_thin_lens_perspective(
            v3(0, 0, 0), v3(0, 0, -5), v3(0, 1, 0), False,
            np.deg2rad(45.0), 400, 400, 0.1, 3.0,
        )
    )
    return sb.build()


def coated_diffuse_bunny_scene() -> Scene:
    sb = cornell_box()
    bunny = load_bunny()
    diffuse_albedo = sb.add_constant_texture(v4(0.8, 0.2, 0.2, 1))
    eta = sb.add_constant_texture(v4(1.5, 0, 0, 0))
    roughness = sb.add_constant_texture(v4(0.1, 0.1, 0, 0))
    thickness = sb.add_constant_texture(v4(0.5, 0, 0, 0))
    coat_albedo = sb.add_constant_texture(v4(1, 1, 1, 1))
    mat = sb.add_material(
        CoatedDiffuse(
            diffuse_albedo=diffuse_albedo,
            dielectric_eta=eta,
            dielectric_remap_roughness=True,
            dielectric_roughness=roughness,
            thickness=thickness,
            coat_albedo=coat_albedo,
        )
    )
    sb.add_shape_at_position(TriangleMesh(bunny), mat, v3(0, 0, 0.25))
    return sb.build()


def environment_lighting_scene() -> Scene:
    sb = SceneBuilder()
    env_img = sb.add_image(_procedural_sky_image())
    env_tex = sb.add_texture(
        ImageTexture(
            image=env_img,
            sampler=TextureSampler(
                filter=FilterMode.NEAREST, wrap=WrapMode.REPEAT
            ),
        )
    )
    sb.add_environment_light(
        EnvironmentLight(radiance=env_tex, mapping=TextureMapping.SPHERICAL)
    )
    white = sb.add_constant_texture(v4(1, 1, 1, 1))
    mat = sb.add_material(Diffuse(albedo=white))
    sb.add_shape_at_position(TriangleMesh(make_cube(1.0)), mat, v3(0, 15, 0))
    sb.add_camera(
        Camera.lookat_camera_perspective(
            v3(0, 0, 0), v3(0, 1, 0), v3(0, 0, 1), False,
            np.deg2rad(37.8), 500, 500,
        )
    )
    return sb.build()


def _debug_normals_settings() -> RaytracerSettings:
    return RaytracerSettings(outputs=AovFlags.NORMALS)


@dataclass
class TestScene:
    name: str
    scene_func: Callable[[], Scene]
    settings_func: Callable[[], RaytracerSettings]


def all_test_scenes() -> List[TestScene]:
    return [
        TestScene("sphere", sphere_scene, _debug_normals_settings),
        TestScene("cube", cube_scene, _debug_normals_settings),
        TestScene(
            "cube_orthographic", cube_orthographic_scene, _debug_normals_settings
        ),
        TestScene(
            "checkered_plane",
            checkered_plane_scene,
            # deliberately only 1 spp to exhibit aliasing
            lambda: RaytracerSettings(samples_per_pixel=1),
        ),
        TestScene("dielectric", dielectric_scene, RaytracerSettings),
        TestScene("metal", metal_scene, RaytracerSettings),
        TestScene("rough_metal", rough_metal_scene, RaytracerSettings),
        TestScene("rough_dielectric", rough_dielectric_scene, RaytracerSettings),
        TestScene(
            "out_of_focus_sphere",
            out_of_focus_sphere_scene,
            lambda: RaytracerSettings(
                sampler=Stratified(jitter=True, x_strata=6, y_strata=6),
                samples_per_pixel=36,
            ),
        ),
        TestScene(
            "environment_light", environment_lighting_scene, RaytracerSettings
        ),
        TestScene(
            "coated_diffuse_bunny", coated_diffuse_bunny_scene, RaytracerSettings
        ),
    ]


def get_test_scene(name: str) -> TestScene:
    for ts in all_test_scenes():
        if ts.name == name:
            return ts
    raise KeyError(f"unknown builtin scene: {name}")
