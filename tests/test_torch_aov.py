"""First-hit AOVs (normals, albedo, uv, mip level): the port's render
against the JAX package's.

Both packages trace the same unjittered camera rays, bit for bit, and shade
the first hit with short f32 chains. Normals and uv agree within atol 1e-5
on at least 99.9% of pixels: a sphere's uv goes through acos, whose slope
amplifies a last-bit difference near the poles (tests/test_torch_spheres.py).
The hit masks (a pixel is hit where its normal is not zero) are equal except
on at most 0.1% of pixels, where a ray grazing a silhouette may fall either
side of it. Albedo is a constant texture read, so it is equal wherever both
hit. The scenes are the three builtin normals-only scenes at 64x64, with
albedo and uv asked for as well.
"""
import numpy as np
import pytest
import torch

from tpu_raytracing.integrator.render import render as jax_render
from tpu_raytracing.scene.test_scenes import get_test_scene as jax_test_scene
from tpu_raytracing.settings import AovFlags as JAovFlags
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.integrator.render import render
from tpu_raytracing_torch.scene.test_scenes import get_test_scene
from tpu_raytracing_torch.settings import AovFlags

torch.set_num_threads(1)

SIZE = 64
AOVS = AovFlags.NORMALS | AovFlags.ALBEDO | AovFlags.UV_COORDS
MIN_CLOSE = 0.999
MAX_MASK_DIFF = 0.001


def _small(get_scene, name):
    ts = get_scene(name)
    scene, settings = ts.scene_func(), ts.settings_func()
    scene.camera = scene.camera.with_resolution(SIZE, SIZE)
    return scene, settings


@pytest.mark.parametrize("name", ["sphere", "cube", "cube_orthographic"])
def test_aovs_match_jax(name):
    scene, s = _small(get_test_scene, name)
    jscene, js = _small(jax_test_scene, name)
    assert s.outputs == AovFlags.NORMALS  # the builtin settings
    s.outputs = AOVS
    js.outputs = JAovFlags(int(AOVS))
    got = render(scene, s, "cpu")
    want = jax_render(jscene, js)
    assert got.beauty is None and got.rays_traced == 0
    for f in ("normals", "albedo", "uv"):
        assert getattr(got, f).shape == getattr(want, f).shape, f
        assert np.isfinite(getattr(got, f)).all(), f
    hit_got = np.any(got.normals != 0, axis=-1)
    hit_want = np.any(want.normals != 0, axis=-1)
    assert 0.05 < hit_want.mean() < 0.95
    assert (hit_got != hit_want).mean() <= MAX_MASK_DIFF
    both = hit_got & hit_want
    for f in ("normals", "uv"):
        close = np.all(np.isclose(getattr(got, f), getattr(want, f), rtol=0,
                                  atol=1e-5), axis=-1)
        assert close.mean() >= MIN_CLOSE, (f, close.mean())
    np.testing.assert_array_equal(got.albedo[both], want.albedo[both])
    np.testing.assert_array_equal(got.albedo[~hit_got], 0.0)
    np.testing.assert_allclose(np.linalg.norm(got.normals[hit_got], axis=-1),
                               1.0, rtol=1e-5)


def test_aovs_leave_beauty_unchanged():
    """AOVs before the beauty pass in the same call give the beauty of a
    beauty-only render, bit for bit (a lit Cornell box with a mirror
    sphere at 8x8)."""
    scene = get_test_scene("metal").scene_func()
    scene.camera = scene.camera.with_resolution(8, 8)
    ds = compile_scene(scene, "cpu")
    s = get_test_scene("metal").settings_func()
    s.samples_per_pixel = 2
    s.outputs = AovFlags.BEAUTY
    plain = render(ds, s, "cpu")
    s.outputs = AovFlags.BEAUTY | AOVS
    both = render(ds, s, "cpu")
    assert plain.normals is None and both.normals.shape == (8, 8, 3)
    assert both.uv.shape == (8, 8, 2) and both.albedo.shape == (8, 8, 3)
    assert plain.beauty.mean() > 0
    np.testing.assert_array_equal(both.beauty, plain.beauty)
    assert both.rays_traced == plain.rays_traced > 0
    # the mirror sphere has no albedo texture: white where it is hit
    assert np.any(np.all(both.albedo == 1.0, axis=-1))


def test_mip_level_raises():
    """The mip-level AOV no longer raises. On a scene with no trilinear
    image texture (the cube, whose albedo is a constant) it is all zero,
    as JAX's is; tests/test_torch_render_textures.py holds it on a
    trilinear image."""
    scene, s = _small(get_test_scene, "cube")
    jscene, js = _small(jax_test_scene, "cube")
    s.outputs = AovFlags.NORMALS | AovFlags.MIP_LEVEL
    js.outputs = JAovFlags(int(s.outputs))
    got = render(scene, s, "cpu")
    want = jax_render(jscene, js)
    assert got.mip_level.shape == want.mip_level.shape == (SIZE, SIZE)
    np.testing.assert_array_equal(got.mip_level, 0.0)
    np.testing.assert_array_equal(want.mip_level, 0.0)
    assert got.albedo is None and np.any(got.normals != 0)
