"""The textured and area-lit scenes end to end: render_beauty_chunk against
the JAX package's, as tests/test_torch_render_materials.py does for the
sphere scenes, and the mip-level AOV against JAX's render.

Blocks are 256 Morton-order pixels (16x16 squares) at the scene's builtin
settings, spp cut to 2 where the builtin is higher:

- checkered_plane (480x270, 1 spp, a direction light), two blocks: one in
  the near half of the plane at (224, 240), where a checker cell covers
  many pixels, and one farther off at (224, 144);
- environment_light (500x500, 2 spp, depth 8), at (272, 240) across the
  cube's right silhouette against the sky: the sky lights the cube and is
  seen past it;
- the emissive Cornell box (chip_smoke.py's, at 64x64, 2 spp, 4 light
  samples): at (16, 16), the ceiling around the quad's left edge.

Tolerance. As in the sphere scenes: the mean within 1% per channel,
rays_traced within 0.5%, and a least share of pixels within rtol 1e-3
(atol 1e-4), 2-5 points under the share measured on the CPU against JAX:

    checkered_plane near 94.5%, far 94.1%; environment_light 100% (rays
    equal); emissive box 100% (rays 15,822 against 15,847).

The checkered plane's uv run from -500 to 500, so an interpolated uv is
only good to about 3e-5 (one step of f32 at 500), and XLA's contracted
multiply-adds round it another way; at 1 spp the antialiased checker's
erf edge, about 4e-4 of uv wide, turns that into up to 7% of a pixel at a
cell edge.

The checkered plane's rays are not compared directly. XLA's f32 erf
saturates at 1 - 2^-22 where torch.special.erf, like libm, reaches 1, so
JAX's antialiased checker is never quite black: on a black cell JAX's
albedo is 2.4e-7, and JAX continues each such path one bounce (into the
sky), where the port ends it. So the test asserts that the port's count
plus its black primary lanes (albedo exactly 0) is JAX's count, and that
JAX's pixels there are within the atol (its near-black NEE adds 7.6e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_raytracing.settings as JSet
from tpu_raytracing.device import compile_scene as jax_compile_scene
from tpu_raytracing.integrator.render import StaticSettings as JStatic
from tpu_raytracing.integrator.render import _pixel_grid as jax_pixel_grid
from tpu_raytracing.integrator.render import render as jax_render
from tpu_raytracing.integrator.render import render_beauty_chunk as jax_chunk
from tpu_raytracing.ops.rng import SamplerConfig as JSamplerConfig
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.integrator.render import (
    StaticSettings, render, render_beauty_chunk,
)
from tpu_raytracing_torch.ops import bsdf as B
from tpu_raytracing_torch.ops.camera_rays import generate_rays
from tpu_raytracing_torch.ops.rng import SamplerConfig, make_stream
from tpu_raytracing_torch.ops.textures import eval_ctx_from_differentials
from tpu_raytracing_torch.ops.traverse import hit_details, intersect_scene
from tpu_raytracing_torch.scene.test_scenes import get_test_scene
from tpu_raytracing_torch.settings import AovFlags, RaytracerSettings

from test_torch_scene import _built, _builtin

torch.set_num_threads(1)

N_PIX = 256
# block -> (scene, the block's first pixel, least share within rtol 1e-3)
BLOCKS = {
    "checkered_plane_near": ("checkered_plane", (224, 240), 0.92),
    "checkered_plane_far": ("checkered_plane", (224, 144), 0.92),
    "environment_light": ("environment_light", (272, 240), 0.98),
    "emissive_quad": ("emissive_quad", (16, 16), 0.98),
}


def _scenes(name):
    if name == "emissive_quad":
        port, jax_ = _built(name)
        return port, jax_, RaytracerSettings()
    port, jax_ = _builtin(name)
    return port, jax_, get_test_scene(name).settings_func()


def _black_primary_lanes(tds, cfg, st, px, py, sample: int = 0) -> int:
    """Primary lanes of `sample` whose albedo the port evaluates to exactly
    0."""
    stream = make_stream(px, py, sample)
    o, d, diff, _ = generate_rays(tds, px, py, cfg, stream,
                                  st.samples_per_pixel, jitter=True)
    n = px.shape[0]
    t, prim = intersect_scene(tds, o, d, torch.full((n,), tds.meta.near_clip),
                              torch.full((n,), tds.meta.far_clip))
    hit = hit_details(tds, o, d, t, prim)
    ctx = eval_ctx_from_differentials(hit, o, d, diff)
    params = B.get_bsdf_params(tds, hit.material, ctx, has_derivs=True)
    return int((hit.hit & torch.all(params.albedo == 0.0, dim=-1)).sum())


@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_matches_jax(block):
    name, (x0, y0), min_close = BLOCKS[block]
    port_scene, jax_scene, s = _scenes(name)
    s.samples_per_pixel = min(s.samples_per_pixel, 2)
    jds = jax_compile_scene(jax_scene)
    tds = compile_scene(port_scene, "cpu")
    px, py, _ = jax_pixel_grid(jds.meta.width, jds.meta.height)
    start = int(np.nonzero((px == x0) & (py == y0))[0][0])
    sel = slice(start, start + N_PIX)
    assert px[sel].max() - x0 == 15 and py[sel].max() - y0 == 15
    cfg = SamplerConfig.from_settings(s.sampler, s.seed)
    st = StaticSettings.from_settings(s)
    r, n = jax_chunk(jds, JSamplerConfig(*cfg), JStatic(*st),
                     jnp.asarray(px[sel]), jnp.asarray(py[sel]),
                     jnp.ones(N_PIX, bool))
    tpx = torch.from_numpy(px[sel].astype(np.int64))
    tpy = torch.from_numpy(py[sel].astype(np.int64))
    g, m = render_beauty_chunk(tds, cfg, st, tpx, tpy,
                               torch.ones(N_PIX, dtype=torch.bool))
    want, got = np.asarray(r), g.numpy()
    n_want, n_got = int(n), int(m)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert want.mean() > 0
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=0.01)
    close = np.all(np.abs(got - want) <= 1e-3 * np.abs(want) + 1e-4, axis=-1)
    assert close.mean() >= min_close, close.mean()
    if name == "checkered_plane":
        black = _black_primary_lanes(tds, cfg, st, tpx, tpy)
        assert black > 0 and n_got + black == n_want, (n_got, black, n_want)
    else:
        assert abs(n_got - n_want) <= 0.005 * n_want, (n_got, n_want)


def test_mip_level_aov_matches_jax():
    """The textured cubes at 64x64: albedo and mip level against JAX's
    render. The mip level is set on the trilinear image's cube only. Both
    come from the uv derivatives, a least-squares solve whose cancellation
    turns contracted multiply-adds into relative differences of about 1e-5
    (measured worst: mip level 2.8e-5), so rtol 1e-4."""
    port_scene, jax_scene = _built("textured_cube")
    fl = AovFlags.NORMALS | AovFlags.ALBEDO | AovFlags.MIP_LEVEL
    got = render(port_scene, RaytracerSettings(outputs=fl), "cpu")
    want = jax_render(jax_scene, JSet.RaytracerSettings(
        outputs=JSet.AovFlags(int(fl))))
    hit = np.any(got.normals != 0, axis=-1)
    np.testing.assert_array_equal(hit, np.any(want.normals != 0, axis=-1))
    assert 0.2 < hit.mean() < 0.9
    assert got.mip_level.shape == (64, 64)
    np.testing.assert_array_equal(got.mip_level != 0, want.mip_level != 0)
    np.testing.assert_allclose(got.mip_level, want.mip_level, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got.albedo, want.albedo, rtol=1e-4, atol=1e-6)
    on_mip = got.mip_level != 0
    assert 0.05 < on_mip.mean() < hit.mean()
    assert got.mip_level[on_mip].max() > 1.0  # coarser than the base level
