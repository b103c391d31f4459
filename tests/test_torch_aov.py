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
albedo and uv asked for as well; and the coated-diffuse bunny, the
benchmark's `bunny-aov` frame in small (normals and albedo, no beauty, 32
px), for the mesh's interpolated normals and the coated material's albedo.
"""
import numpy as np
import pytest
import torch

from tpu_raytracing.integrator.render import render as jax_render
from tpu_raytracing.scene.test_scenes import get_test_scene as jax_test_scene
from tpu_raytracing.settings import AovFlags as JAovFlags
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.integrator import render as render_mod
from tpu_raytracing_torch.integrator.render import (
    StaticSettings, render, render_aov_chunk,
)
from tpu_raytracing_torch.ops.rng import SamplerConfig
from tpu_raytracing_torch.scene.test_scenes import get_test_scene
from tpu_raytracing_torch.settings import AovFlags

torch.set_num_threads(1)

SIZE = 64
AOVS = AovFlags.NORMALS | AovFlags.ALBEDO | AovFlags.UV_COORDS
MIN_CLOSE = 0.999
MAX_MASK_DIFF = 0.001


def _small(get_scene, name, size=SIZE):
    ts = get_scene(name)
    scene, settings = ts.scene_func(), ts.settings_func()
    scene.camera = scene.camera.with_resolution(size, size)
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
    _assert_aovs_match(got, want, ("normals", "uv"))


def _assert_aovs_match(got, want, close_fields):
    """The hit masks, `close_fields` within atol 1e-5, albedo bit for bit
    wherever both hit and zero wherever the port misses (module doc)."""
    for f in close_fields + ("albedo",):
        assert getattr(got, f).shape == getattr(want, f).shape, f
        assert np.isfinite(getattr(got, f)).all(), f
    hit_got = np.any(got.normals != 0, axis=-1)
    hit_want = np.any(want.normals != 0, axis=-1)
    assert 0.05 < hit_want.mean() < 0.95
    assert (hit_got != hit_want).mean() <= MAX_MASK_DIFF
    both = hit_got & hit_want
    for f in close_fields:
        close = np.all(np.isclose(getattr(got, f), getattr(want, f), rtol=0,
                                  atol=1e-5), axis=-1)
        assert close.mean() >= MIN_CLOSE, (f, close.mean())
    np.testing.assert_array_equal(got.albedo[both], want.albedo[both])
    np.testing.assert_array_equal(got.albedo[~hit_got], 0.0)
    np.testing.assert_allclose(np.linalg.norm(got.normals[hit_got], axis=-1),
                               1.0, rtol=1e-5)
    return both


def test_coated_bunny_aovs_match_jax():
    """The benchmark's `bunny-aov` frame in small: the coated-diffuse bunny
    (28,586 triangles with vertex normals) at 32x32, normals and albedo and
    no beauty, as `cli.py full --aov n,a --no-beauty` asks. Holds the
    mesh's interpolated normals and the coated material's albedo branch
    against the JAX package's render."""
    scene, s = _small(get_test_scene, "coated_diffuse_bunny", 32)
    jscene, js = _small(jax_test_scene, "coated_diffuse_bunny", 32)
    s.outputs = AovFlags.NORMALS | AovFlags.ALBEDO
    js.outputs = JAovFlags(int(s.outputs))
    got = render(scene, s, "cpu")
    want = jax_render(jscene, js)
    assert got.beauty is None and got.uv is None and got.rays_traced == 0
    assert got.aov_rays_traced == 32 * 32
    both = _assert_aovs_match(got, want, ("normals",))
    # the bunny's coated-diffuse albedo, (0.8, 0.2, 0.2), is among the hits
    coated = np.all(got.albedo == np.float32([0.8, 0.2, 0.2]), axis=-1)
    assert (coated & both).sum() >= 16


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


def test_inactive_lanes_are_walked_dead(monkeypatch):
    """`render_aov_chunk` hands its `active` mask to the walk: the lanes
    left active give the AOVs of an unmasked call bit for bit, and every
    other lane is walked dead (prim -1) with every AOV zero. The metal
    scene (triangles and a sphere) at 8x8, every other lane masked."""
    scene = get_test_scene("metal").scene_func()
    scene.camera = scene.camera.with_resolution(8, 8)
    ds = compile_scene(scene, "cpu")
    s = get_test_scene("metal").settings_func()
    cfg = SamplerConfig.from_settings(s.sampler, s.seed)
    st = StaticSettings.from_settings(s)
    px = torch.arange(64) % 8
    py = torch.arange(64) // 8
    active = torch.arange(64) % 2 == 0
    real = render_mod.intersect_scene
    walked = []

    def recorded(*args, **kw):
        t, prim = real(*args, **kw)
        walked.append((kw.get("active"), prim))
        return t, prim
    monkeypatch.setattr(render_mod, "intersect_scene", recorded)
    whole = render_aov_chunk(ds, cfg, st, px, py)
    masked = render_aov_chunk(ds, cfg, st, px, py, active=active)
    assert walked[0][0] is None and walked[1][0] is active
    assert (walked[0][1][active] >= 0).any()
    assert (walked[1][1][~active] == -1).all()
    for w, m in zip(whole, masked):
        assert torch.equal(m[active].view(torch.int32),
                           w[active].view(torch.int32))
        assert (m[~active] == 0).all()
    assert (whole[0][~active] != 0).any()
