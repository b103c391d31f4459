"""The port's tracing (tpu_raytracing_torch/tracing.py) on the CPU: off,
it is a shared no-op that counts nothing; on, the image is unchanged to
the bit, its spans nest by layer under torch.profiler, and its counters
count what the bounce loop did. Scenes are cut to 8x8 pixels to keep the
coat's walk quick."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_raytracing_torch import tracing
from tpu_raytracing_torch.device.scene_buffers import compile_scene
from tpu_raytracing_torch.geometry import Sphere, v3, v4
from tpu_raytracing_torch.integrator import render as render_mod
from tpu_raytracing_torch.integrator.accumulate import render_accumulated
from tpu_raytracing_torch.materials import (
    CoatedDiffuse, SmoothConductor, SmoothDielectric,
)
from tpu_raytracing_torch.scene.camera import Camera
from tpu_raytracing_torch.scene.scene import SceneBuilder
from tpu_raytracing_torch.scene.test_scenes import cornell_box
from tpu_raytracing_torch.settings import AovFlags, RaytracerSettings

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and no counters."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _settings(spp=2, depth=2):
    return RaytracerSettings(samples_per_pixel=spp, max_ray_depth=depth,
                             outputs=AovFlags.BEAUTY)


def _coated_box():
    """The Cornell box with the bunny's coated-diffuse material on a
    sphere, at 8x8 pixels."""
    sb = cornell_box()
    mat = sb.add_material(CoatedDiffuse(
        diffuse_albedo=sb.add_constant_texture(v4(0.8, 0.2, 0.2, 1)),
        dielectric_eta=sb.add_constant_texture(v4(1.5, 0, 0, 0)),
        dielectric_remap_roughness=True,
        dielectric_roughness=sb.add_constant_texture(v4(0.1, 0.1, 0, 0)),
        thickness=sb.add_constant_texture(v4(0.5, 0, 0, 0)),
        coat_albedo=sb.add_constant_texture(v4(1, 1, 1, 1))))
    sb.add_shape_at_position(Sphere(v3(0, 0, 0), 0.5), mat, v3(0, 0, 0.75))
    scene = sb.build()
    scene.camera = scene.camera.with_resolution(8, 8)
    return compile_scene(scene, "cpu")


def _delta_spheres():
    """A mirror and a glass sphere under a point light: every BSDF is a
    delta, so no lane takes a shadow ray."""
    sb = SceneBuilder()
    metal = sb.add_material(SmoothConductor(
        eta=sb.add_constant_texture(v4(0.13, 0.43, 1.38, 0)),
        kappa=sb.add_constant_texture(v4(4.10, 2.46, 1.91, 0))))
    glass = sb.add_material(SmoothDielectric(
        eta=sb.add_constant_texture(v4(1.5, 0, 0, 0))))
    sb.add_shape_at_position(Sphere(v3(0, 0, 0), 1.0), metal, v3(-1, 0, -5))
    sb.add_shape_at_position(Sphere(v3(0, 0, 0), 1.0), glass, v3(1, 0, -5))
    sb.add_point_light(v3(0, 3, -3), v3(100, 100, 100))
    sb.add_camera(Camera.lookat_camera_perspective(
        v3(0, 0, 0), v3(0, 0, -5), v3(0, 1, 0), False, np.deg2rad(45.0),
        8, 8))
    return compile_scene(sb.build(), "cpu")


@pytest.fixture(scope="module")
def coated_box():
    return _coated_box()


@pytest.fixture(scope="module")
def profiled(coated_box):
    """The rt. events of a traced render of the coated box under the
    CPU profiler."""
    tracing.reset()
    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            render_accumulated(coated_box, _settings(), spp_chunk=1,
                               on_chunk=lambda image, spp: None,
                               device="cpu")
    finally:
        tracing.disable()
        tracing.reset()
    return [e for e in prof.events() if e.name.startswith("rt.")]


def test_off_is_a_shared_noop_that_counts_nothing(coated_box):
    assert not tracing.enabled()
    first, second = tracing.span("rt.pass"), tracing.span("rt.bounce",
                                                          {"depth": 1})
    assert first is second
    with first:
        pass
    out = render_accumulated(coated_box, _settings(spp=1), spp_chunk=1,
                             device="cpu")
    assert out.rays_traced > 0
    assert tracing.snapshot() == {}


def test_image_is_bit_for_bit_with_tracing_on(coated_box):
    off = render_accumulated(coated_box, _settings(), spp_chunk=1,
                             device="cpu")
    tracing.enable()
    on = render_accumulated(coated_box, _settings(), spp_chunk=1,
                            device="cpu")
    tracing.disable()
    counts = tracing.snapshot()
    assert counts["sync.coat.eval_alive"] > 0
    np.testing.assert_array_equal(on.beauty, off.beauty)
    assert on.rays_traced == off.rays_traced


def _ancestors(event):
    names = set()
    while event.cpu_parent is not None:
        event = event.cpu_parent
        names.add(event.name)
    return names


@pytest.mark.parametrize("child, ancestor", [
    ("rt.sample", "rt.pass"),
    ("rt.accumulate", "rt.pass"),
    ("rt.callback", "rt.pass"),
    ("rt.bounce", "rt.sample"),
    ("rt.traverse.closest", "rt.bounce"),
    ("rt.traverse.shadow", "rt.bounce"),
    ("rt.nee", "rt.bounce"),
    ("rt.shade.eval", "rt.bounce"),
    ("rt.shade.sample", "rt.bounce"),
    ("rt.coat.eval", "rt.shade.eval"),
    ("rt.coat.sample", "rt.shade.sample"),
])
def test_spans_nest_by_layer(profiled, child, ancestor):
    found = [e for e in profiled if e.name == child]
    assert found, f"no {child} span"
    for e in found:
        assert ancestor in _ancestors(e), (child, _ancestors(e))


def test_pass_spans_are_top_level_one_a_pass(profiled):
    passes = [e for e in profiled if e.name == "rt.pass"]
    assert len(passes) == 2
    assert all(not _ancestors(e) for e in passes)


@pytest.mark.parametrize("depth", [1, 3])
def test_alive_any_counts_each_loop_test(coated_box, monkeypatch, depth):
    tests = []
    any_alive = render_mod._any_alive

    def counted(alive):
        tests.append(1)
        return any_alive(alive)

    monkeypatch.setattr(render_mod, "_any_alive", counted)
    tracing.enable()
    render_accumulated(coated_box, _settings(depth=depth), spp_chunk=1,
                       device="cpu")
    tracing.disable()
    counts = tracing.snapshot()
    assert len(tests) > 2
    assert counts["sync.render.alive_any"] == len(tests)
    # a bounce a loop test: the primary one, then one for each test passed
    assert counts["lanes.run"] == 64 * len(tests)


def test_alive_lanes_are_the_rays_without_shadow_rays():
    ds = _delta_spheres()
    tracing.enable()
    out = render_accumulated(ds, _settings(spp=2, depth=4), spp_chunk=1,
                             device="cpu")
    tracing.disable()
    counts = tracing.snapshot()
    assert out.rays_traced > 64
    assert counts["lanes.alive"] == out.rays_traced
    assert counts["lanes.alive"] < counts["lanes.run"]


def test_shared_site_counts_under_the_open_span():
    tracing.enable()
    tracing.sync("*.read")
    with tracing.span("rt.coat.eval"):
        tracing.sync("*.read", 2)
        with tracing.span("rt.shade.sample"):
            tracing.sync("*.read")
    tracing.count("lanes.alive", torch.tensor(3))
    tracing.count("lanes.alive", 4)
    assert tracing.snapshot() == {"sync.untraced.read": 1,
                                  "sync.coat.read": 2, "sync.shade.read": 1,
                                  "lanes.alive": 7}
