"""The five beauty scenes with a sphere: render_beauty_chunk against the JAX
package's, as tests/test_torch_render.py does for the bunny.

Each block is 256 Morton-order pixels (a 16x16 square) on the sphere, at
the scene's builtin settings (depth 8, 4 light samples) but 2 spp, except
out_of_focus_sphere at its builtin 36 spp (6x6 stratified). Cornell blocks
start at pixel (192, 288), where the mirror sphere reflects the red wall and
the floor and the glass sphere refracts them; out_of_focus_sphere's starts
at (160, 224) on its blurred sphere.

Tolerance. Both renderers draw the same random numbers and trace the same
camera rays bit for bit; they differ in the last bits of acos, sin, cos and
sqrt and in XLA's contracted multiply-adds. Mirror and glass bounces carry
such a bit from bounce to bounce, and a few paths flip a comparison near a
silhouette or an edge and take another branch. The gates: rays_traced
within 0.5% (measured: equal), the mean within 1% per channel (measured
within 2e-4), and at least MIN_CLOSE of the pixels within rtol 1e-3, set
2-3 points under the share measured on the CPU against JAX:

    dielectric 100%, metal 99.2%, rough_metal 99.6%, rough_dielectric 99.6%,
    out_of_focus_sphere 100%.

out_of_focus_sphere is diffuse only: every pixel agrees within rtol 1e-5
(measured worst 3.1e-7), as the bunny's walls do.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracing.device import compile_scene as jax_compile_scene
from tpu_raytracing.integrator.render import StaticSettings as JStatic
from tpu_raytracing.integrator.render import _pixel_grid as jax_pixel_grid
from tpu_raytracing.integrator.render import render_beauty_chunk as jax_chunk
from tpu_raytracing.ops.rng import SamplerConfig as JSamplerConfig
from tpu_raytracing.scene.test_scenes import get_test_scene as jax_test_scene
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.integrator.render import (
    StaticSettings, render_beauty_chunk,
)
from tpu_raytracing_torch.ops.rng import SamplerConfig
from tpu_raytracing_torch.scene.test_scenes import get_test_scene

torch.set_num_threads(1)

N_PIX = 256
# scene -> (the block's first pixel, least share within rtol 1e-3)
BLOCKS = {
    "dielectric": ((192, 288), 0.98),
    "metal": ((192, 288), 0.97),
    "rough_metal": ((192, 288), 0.97),
    "rough_dielectric": ((192, 288), 0.97),
    "out_of_focus_sphere": ((160, 224), 0.98),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_sphere_block_matches_jax(name):
    (x0, y0), min_close = BLOCKS[name]
    s = get_test_scene(name).settings_func()
    if name != "out_of_focus_sphere":
        s.samples_per_pixel = 2
    jds = jax_compile_scene(jax_test_scene(name).scene_func())
    tds = compile_scene(get_test_scene(name).scene_func(), "cpu")
    assert tds.meta.n_spheres == 1
    px, py, _ = jax_pixel_grid(jds.meta.width, jds.meta.height)
    start = int(np.nonzero((px == x0) & (py == y0))[0][0])
    sel = slice(start, start + N_PIX)
    assert px[sel].max() - x0 == 15 and py[sel].max() - y0 == 15
    cfg = SamplerConfig.from_settings(s.sampler, s.seed)
    st = StaticSettings.from_settings(s)
    r, n = jax_chunk(jds, JSamplerConfig(*cfg), JStatic(*st),
                     jnp.asarray(px[sel]), jnp.asarray(py[sel]),
                     jnp.ones(N_PIX, bool))
    g, m = render_beauty_chunk(
        tds, cfg, st, torch.from_numpy(px[sel].astype(np.int64)),
        torch.from_numpy(py[sel].astype(np.int64)),
        torch.ones(N_PIX, dtype=torch.bool))
    want, got = np.asarray(r), g.numpy()
    n_want, n_got = int(n), int(m)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert want.mean() > 0
    assert abs(n_got - n_want) <= 0.005 * n_want, (n_got, n_want)
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=0.01)
    close = np.all(np.abs(got - want) <= 1e-3 * np.abs(want) + 1e-6, axis=-1)
    assert close.mean() >= min_close, close.mean()
    if name == "out_of_focus_sphere":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
