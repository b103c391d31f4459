"""RNG draws, Morton pixel order and camera rays against the JAX package.

Draws and the pixel order are integer work and must be bit-identical;
camera rays are f32 arithmetic (XLA may contract multiply-adds into FMAs
where PyTorch does not), so they agree within rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_raytracing.ops.rng as JR
from tpu_raytracing.device import compile_scene as jax_compile_scene
from tpu_raytracing.integrator.render import _pixel_grid as jax_pixel_grid
from tpu_raytracing.ops.camera_rays import generate_rays as jax_generate_rays
from tpu_raytracing.scene.camera import Camera as JCamera
from tpu_raytracing.scene.test_scenes import get_test_scene as jax_test_scene
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.integrator.render import _pixel_grid
from tpu_raytracing_torch.ops import rng as R
from tpu_raytracing_torch.ops.camera_rays import generate_rays
from tpu_raytracing_torch.scene.camera import Camera
from tpu_raytracing_torch.scene.test_scenes import get_test_scene

torch.set_num_threads(1)

LANES = 4096
DIMS = 8
CONFIGS = {
    "independent": R.SamplerConfig("independent", seed=42),
    "stratified": R.SamplerConfig("stratified", True, 4, 4, 7),
    "stratified_nojitter": R.SamplerConfig("stratified", False, 6, 6, 123),
}


def _lanes(seed=0):
    g = np.random.default_rng(seed)
    px = g.integers(0, 1 << 12, LANES).astype(np.uint32)
    py = g.integers(0, 1 << 12, LANES).astype(np.uint32)
    sample = g.integers(0, 16, LANES).astype(np.uint32)
    return px, py, sample


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def test_hash_bit_identical():
    g = np.random.default_rng(1)
    words = [g.integers(0, 1 << 32, LANES, dtype=np.uint64).astype(np.uint32)
             for _ in range(6)]
    want = np.asarray(JR.hash_u32(*[jnp.asarray(w) for w in words]))
    got = R.hash_u32(*[_t(w) for w in words]).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_kensler_permute_bit_identical():
    g = np.random.default_rng(2)
    seed = g.integers(0, 1 << 32, LANES, dtype=np.uint64).astype(np.uint32)
    for length in (5, 16, 36):
        # the cycle walk assumes index < length (a sample index below the
        # stratum count); outside it a fixed point can stall the walk
        idx = g.integers(0, length, LANES).astype(np.uint32)
        want = np.asarray(JR.kensler_permute(jnp.asarray(idx), length,
                                             jnp.asarray(seed)))
        got = R.kensler_permute(_t(idx), length, _t(seed)).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_draws_bit_identical(kind):
    cfg = CONFIGS[kind]
    jcfg = JR.SamplerConfig(*cfg)
    px, py, sample = _lanes()
    js = JR.make_stream(jnp.asarray(px), jnp.asarray(py), jnp.asarray(sample))
    ts = R.make_stream(_t(px), _t(py), _t(sample))
    for d in range(DIMS):
        if d % 2:
            ju, js = JR.sample_uniform2(jcfg, js)
            tu, ts = R.sample_uniform2(cfg, ts)
        else:
            ju, js = JR.sample_uniform(jcfg, js)
            tu, ts = R.sample_uniform(cfg, ts)
        ju = np.asarray(ju)
        assert tu.dtype == torch.float32
        np.testing.assert_array_equal(tu.numpy().view(np.uint32),
                                      ju.view(np.uint32), err_msg=f"dim {d}")
    np.testing.assert_array_equal(ts.dim.numpy(), np.asarray(js.dim))


def test_distributions_match():
    """f32 maps of uniform draws. atol 1e-5: the hemisphere's
    z = sqrt(1 - x^2 - y^2) cancels near the horizon, where XLA's fused
    arithmetic and PyTorch's differ by a few ULPs of the operands."""
    g = np.random.default_rng(3)
    u = g.random((LANES, 2), dtype=np.float32)
    for jf, tf in [(JR.sample_unit_disk, R.sample_unit_disk),
                   (JR.sample_unit_disk_concentric,
                    R.sample_unit_disk_concentric),
                   (JR.sample_cosine_hemisphere, R.sample_cosine_hemisphere)]:
        np.testing.assert_allclose(tf(torch.from_numpy(u)).numpy(),
                                   np.asarray(jf(jnp.asarray(u))),
                                   rtol=1e-6, atol=1e-5)
    a = g.random(LANES, dtype=np.float32) + 0.5
    np.testing.assert_allclose(
        R.sample_exponential(torch.from_numpy(u[:, 0]),
                             torch.from_numpy(a)).numpy(),
        np.asarray(JR.sample_exponential(jnp.asarray(u[:, 0]),
                                         jnp.asarray(a))), rtol=1e-6)


@pytest.mark.parametrize("wh", [(500, 500), (37, 53)])
def test_pixel_grid_identical(wh):
    want = jax_pixel_grid(*wh)
    got = _pixel_grid(*wh)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _thin_lens_cube(get_test_scene, Camera):
    scene = get_test_scene("cube").scene_func()
    scene.camera = Camera.lookat_camera_thin_lens_perspective(
        np.array([1.0, 0.75, -1.0]), np.array([0.0, 0.0, -3.0]),
        np.array([0.0, 1.0, 0.0]), False, np.deg2rad(45.0), 200, 200,
        0.1, 3.0)
    return scene


@pytest.mark.parametrize("name", ["coated_diffuse_bunny", "cube",
                                  "cube_orthographic", "cube_thin_lens"])
def test_camera_rays(name):
    if name == "cube_thin_lens":
        jscene = _thin_lens_cube(jax_test_scene, JCamera)
        scene = _thin_lens_cube(get_test_scene, Camera)
    else:
        jscene = jax_test_scene(name).scene_func()
        scene = get_test_scene(name).scene_func()
    jds = jax_compile_scene(jscene)
    tds = compile_scene(scene, "cpu")
    px, py, _ = jax_pixel_grid(jds.meta.width, jds.meta.height)
    sel = slice(1000, 1000 + LANES)
    cfg = R.SamplerConfig("independent", seed=42)
    js = JR.make_stream(jnp.asarray(px[sel]), jnp.asarray(py[sel]), 3)
    jo, jd, jdiff, _ = jax_generate_rays(
        jds, jnp.asarray(px[sel]), jnp.asarray(py[sel]),
        JR.SamplerConfig(*cfg), js, 8, jitter=True)
    ts = R.make_stream(_t(px[sel]), _t(py[sel]), 3)
    to, td, tdiff, ts = generate_rays(tds, _t(px[sel]), _t(py[sel]), cfg, ts,
                                      8, jitter=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tdiff.numpy(), np.asarray(jdiff), rtol=1e-6,
                               atol=1e-6)
