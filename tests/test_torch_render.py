"""The ported slice end to end: render_beauty_chunk against the JAX package.

Tolerance. Both renderers draw the same random numbers (bit-identical
streams) and trace the same rays to within f32 rounding, so rays_traced
matches and a pixel whose paths never evaluate the coated BSDF agrees to
about 1e-6. The coated BSDF's evaluation, however, is a stochastic estimate
whose random stream is hashed from the bit patterns of (wo, wi)
(ops/layered.py::_eval_base_stream); XLA contracts multiply-adds into FMAs
and PyTorch does not, so a last-bit difference in a direction draws a
different, equally valid estimate. Pixels that see the coat therefore
agree only in distribution. The gates:

- rays_traced within 0.5% (measured: equal);
- the chunk's mean radiance within 1% per channel (measured < 0.01%);
- on 1,024 pixels that mostly see the bunny, at least 40% of pixels within
  rtol 1e-3 (measured 47%);
- on 1,024 pixels beside it, at least 97% within rtol 1e-3 (measured 98.9%).
"""
import os
import subprocess
import sys

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
    StaticSettings, _pixel_grid, render, render_beauty_chunk,
)
from tpu_raytracing_torch.ops.rng import SamplerConfig
from tpu_raytracing_torch.ops.traverse_bvh8t import intersect_tris_bvh8t
from tpu_raytracing_torch.ops.traverse_kernels import reset_launch_counts
from tpu_raytracing_torch.scene.test_scenes import get_test_scene
from tpu_raytracing_torch.settings import AovFlags, RaytracerSettings

torch.set_num_threads(1)

SETTINGS = RaytracerSettings(samples_per_pixel=2, light_sample_count=1,
                             max_ray_depth=8)
BUNNY_BLOCK = 148480   # Morton offset of 1,024 pixels, 58% on the bunny
SIDE_BLOCK = 125000    # 1,024 pixels of walls and floor
N_PIX = 1024


@pytest.fixture(scope="module")
def scene():
    return get_test_scene("coated_diffuse_bunny").scene_func()


@pytest.fixture(scope="module")
def scenes(scene):
    return (jax_compile_scene(jax_test_scene("coated_diffuse_bunny")
                              .scene_func()),
            compile_scene(scene, "cpu"))


def _both(scenes, start):
    jds, tds = scenes
    px, py, _ = jax_pixel_grid(jds.meta.width, jds.meta.height)
    sel = slice(start, start + N_PIX)
    cfg = SamplerConfig.from_settings(SETTINGS.sampler, SETTINGS.seed)
    r, n = jax_chunk(jds, JSamplerConfig(*cfg), JStatic(
        *StaticSettings.from_settings(SETTINGS)), jnp.asarray(px[sel]),
        jnp.asarray(py[sel]), jnp.ones(N_PIX, bool))
    g, m = render_beauty_chunk(
        tds, cfg, StaticSettings.from_settings(SETTINGS),
        torch.from_numpy(px[sel].astype(np.int64)),
        torch.from_numpy(py[sel].astype(np.int64)),
        torch.ones(N_PIX, dtype=torch.bool))
    return np.asarray(r), int(n), g.numpy(), int(m)


def _check(want, n_want, got, n_got, min_close):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert abs(n_got - n_want) <= 0.005 * n_want, (n_got, n_want)
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=0.01)
    close = np.all(np.abs(got - want) <= 1e-3 * np.abs(want) + 1e-6, axis=-1)
    assert close.mean() >= min_close, close.mean()


def test_slice_bunny_pixels(scenes):
    _check(*_both(scenes, BUNNY_BLOCK), min_close=0.40)


def test_slice_side_pixels(scenes):
    _check(*_both(scenes, SIDE_BLOCK), min_close=0.97)


def _small_bunny(width, height):
    scene = get_test_scene("coated_diffuse_bunny").scene_func()
    scene.camera = scene.camera.with_resolution(width, height)
    return scene


def test_chunk_invariance():
    """Bit-identical images across chunk sizes (one with a padded tail)."""
    ds = compile_scene(_small_bunny(16, 12), "cpu")
    s = RaytracerSettings(samples_per_pixel=1, light_sample_count=1,
                          max_ray_depth=3)
    a = render(ds, s, "cpu", chunk_pixels=192)
    b = render(ds, s, "cpu", chunk_pixels=50)
    assert a.beauty.shape == (12, 16, 3) and a.beauty.mean() > 0
    np.testing.assert_array_equal(a.beauty, b.beauty)
    assert a.rays_traced == b.rays_traced > 0


def test_render_cpu_never_launches():
    reset_launch_counts()
    out = render(_small_bunny(4, 4), SETTINGS, "cpu")
    assert np.isfinite(out.beauty).all()
    assert intersect_tris_bvh8t.launches == {"closest_hit": 0, "any_hit": 0}


def test_render_rejects_outside_slice(scene):
    """An area light on a sphere (the JAX package asserts against it)
    raises; so does a cuda render without a card."""
    import tpu_raytracing_torch.geometry as TG
    import tpu_raytracing_torch.materials as TM
    import tpu_raytracing_torch.scene.test_scenes as TS
    from test_torch_scene import _outside_scene

    s = RaytracerSettings(outputs=AovFlags.BEAUTY | AovFlags.MIP_LEVEL)
    with pytest.raises(NotImplementedError, match="area light on a sphere"):
        render(_outside_scene("sphere_emitter", TS, TM, TG), s, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            render(scene, SETTINGS, "cuda")


def test_sample_light_matches_jax():
    """Point and direction lights, per lane (rtol 1e-6: a few f32 ops)."""
    import tpu_raytracing.ops.light_sampling as JL
    import tpu_raytracing.ops.rng as JR
    import tpu_raytracing.lights as JLights
    import tpu_raytracing_torch.lights as TLights
    from tpu_raytracing_torch.ops import light_sampling as TL
    from tpu_raytracing_torch.ops import rng as TR

    def lit_cube(get_scene, lights):
        scene = get_scene("cube").scene_func()
        scene.lights.append(lights.PointLight(
            np.array([0.5, 2.0, -2.0], np.float32),
            np.array([10.0, 8.0, 6.0], np.float32)))
        scene.lights.append(lights.DirectionLight(
            np.array([0.3, -1.0, -0.2], np.float32),
            np.array([2.0, 2.0, 1.5], np.float32)))
        return scene

    jds = jax_compile_scene(lit_cube(jax_test_scene, JLights))
    tds = compile_scene(lit_cube(get_test_scene, TLights), "cpu")
    g = np.random.default_rng(9)
    pts = (g.normal(0, 1, (N_PIX, 3)) + [0, 0, -3]).astype(np.float32)
    cfg = TR.SamplerConfig("independent", seed=42)
    zeros = np.zeros(N_PIX, np.uint32)
    js = JR.make_stream(jnp.asarray(zeros), jnp.asarray(zeros), 0)
    ts = TR.make_stream(*[torch.from_numpy(zeros.astype(np.int64))] * 2, 0)
    for li in range(2):
        want, _ = JL.sample_light(jds, li, jnp.asarray(pts),
                                  JR.SamplerConfig(*cfg), js)
        got, _ = TL.sample_light(tds, li, torch.from_numpy(pts), cfg, ts)
        for f in want._fields:
            np.testing.assert_allclose(
                getattr(got, f).numpy(), np.broadcast_to(
                    np.asarray(getattr(want, f)), getattr(got, f).shape),
                rtol=1e-6, atol=1e-7, err_msg=f"light {li} {f}")
    ids = np.array([-1, 0, 1, 1, -1], np.int32)
    np.testing.assert_array_equal(
        TL.light_emitted_radiance(tds, torch.from_numpy(ids)).numpy(),
        np.asarray(JL.light_emitted_radiance(jds, jnp.asarray(ids))))


def test_pixel_grid_matches_jax():
    for a, b in zip(_pixel_grid(500, 500), jax_pixel_grid(500, 500)):
        np.testing.assert_array_equal(a, b)


def test_port_never_imports_jax():
    """With jax and the JAX package made unimportable, the port imports,
    compiles the bunny and the metal scene (a mirror sphere) and renders
    both on the CPU."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tpu_raytracing'] = None\n"
        "import numpy as np\n"
        "import tpu_raytracing_torch.integrator.render as R\n"
        "import tpu_raytracing_torch.native_cuda\n"
        "from tpu_raytracing_torch.device import compile_scene\n"
        "from tpu_raytracing_torch.scene.test_scenes import get_test_scene\n"
        "from tpu_raytracing_torch.settings import RaytracerSettings\n"
        "sc = get_test_scene('coated_diffuse_bunny').scene_func()\n"
        "ds = compile_scene(sc, 'cpu')\n"
        "assert ds.meta.n_tris == 28586\n"
        "sc.camera = sc.camera.with_resolution(4, 4)\n"
        "s = RaytracerSettings(samples_per_pixel=1, max_ray_depth=2)\n"
        "out = R.render(sc, s, 'cpu')\n"
        "assert np.isfinite(out.beauty).all()\n"
        "sc = get_test_scene('metal').scene_func()\n"
        "assert compile_scene(sc, 'cpu').meta.n_spheres == 1\n"
        "sc.camera = sc.camera.with_resolution(4, 4)\n"
        "out = R.render(sc, s, 'cpu')\n"
        "assert np.isfinite(out.beauty).all() and out.beauty.mean() > 0\n"
        "assert not any(m.split('.')[0] in ('jax', 'tpu_raytracing') for m, "
        "v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
