"""Analytic spheres: the port against the JAX package.

The same seeded rays go through both packages. Per lane, `ray_sphere` and
`sphere_hit_geom` agree within rtol 1e-6 (short f32 chains; acos and sin
may differ in their last bit). `intersect_scene` on the `metal` tables, a
Cornell box with a sphere, runs the sphere pass and then the triangle walk
with the sphere hit as its t_max: winners are exact, spheres encoded as
n_tris + sphere index, and t agrees within rtol 1e-5. `hit_details` on
sphere hits agrees within rtol 1e-5, atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_raytracing.ops.intersect as JI
import tpu_raytracing.ops.traverse as JT
from tpu_raytracing.device import compile_scene as jax_compile_scene
from tpu_raytracing.scene.test_scenes import get_test_scene as jax_test_scene
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.ops import intersect as TI
from tpu_raytracing_torch.ops.traverse import hit_details, intersect_scene
from tpu_raytracing_torch.scene.test_scenes import get_test_scene

torch.set_num_threads(1)

N = 4096
SPHERE_CENTER = np.array([0.0, 0.0, 0.75], np.float32)  # metal_scene
SPHERE_RADIUS = 0.5


@pytest.fixture(scope="module")
def scenes():
    return (jax_compile_scene(jax_test_scene("metal").scene_func()),
            compile_scene(get_test_scene("metal").scene_func(), "cpu"))


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _rays(n, seed):
    """Half random rays inside the box, half aimed at the sphere from
    random points around it, grazing ones included."""
    g = np.random.default_rng(seed)
    m = n // 2
    o_rand = (g.uniform(-0.9, 0.9, (m, 3)) + [0, 0, 0.75]).astype(np.float32)
    d_rand = _unit(g.normal(size=(m, 3)))
    o_aim = (SPHERE_CENTER + _unit(g.normal(size=(n - m, 3)))
             * g.uniform(0.6, 1.2, (n - m, 1))).astype(np.float32)
    target = SPHERE_CENTER + _unit(g.normal(size=(n - m, 3))) * (
        SPHERE_RADIUS * g.uniform(0.0, 1.02, (n - m, 1)))
    d_aim = _unit(target - o_aim)
    return (np.concatenate([o_rand, o_aim]).astype(np.float32),
            np.concatenate([d_rand, d_aim]).astype(np.float32))


def _query(n, seed, early_exit):
    o, d = _rays(n, seed)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.full(n, 1.2 if early_exit else np.inf, np.float32)
    act = np.arange(n) % 7 != 3  # some inactive lanes
    return o, d, tmin, tmax, act


def test_ray_sphere_per_lane():
    g = np.random.default_rng(1)
    o = g.normal(0, 2, (N, 3)).astype(np.float32)
    c = g.normal(0, 0.3, (N, 3)).astype(np.float32)
    r = g.uniform(0.2, 1.5, N).astype(np.float32)
    # toward a point near the sphere, not unit length (a != 1); some rays
    # start inside
    aim = c + g.normal(size=(N, 3)) * r[:, None] * 0.7 - o
    d = (aim * g.uniform(0.3, 3.0, (N, 1))).astype(np.float32)
    tmin = np.full(N, 1e-4, np.float32)
    tmax = np.where(g.random(N) < 0.3, 2.0, np.inf).astype(np.float32)
    v_want, t_want = JI.ray_sphere(*map(jnp.asarray, (o, d, c, r, tmin, tmax)))
    v_got, t_got = TI.ray_sphere(*map(torch.from_numpy, (o, d, c, r, tmin,
                                                         tmax)))
    np.testing.assert_array_equal(v_got.numpy(), np.asarray(v_want))
    assert 0.2 < v_got.numpy().mean() < 0.9
    np.testing.assert_allclose(t_got.numpy(), np.asarray(t_want), rtol=1e-6)


def test_sphere_hit_geom_per_lane():
    g = np.random.default_rng(2)
    c = g.normal(0, 0.3, (N, 3)).astype(np.float32)
    r = g.uniform(0.2, 1.5, N).astype(np.float32)
    p = (c + _unit(g.normal(size=(N, 3))) * r[:, None]).astype(np.float32)
    want = JI.sphere_hit_geom(*map(jnp.asarray, (p, c, r)))
    got = TI.sphere_hit_geom(*map(torch.from_numpy, (p, c, r)))
    for name, a, b in zip(("normal", "dpdu", "dpdv"), got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    # u = acos(cos_phi) / 2pi and v = acos(cos_theta) / pi. XLA's acos and
    # sin differ from PyTorch's in the last bit or two (measured on 1-13% of
    # f32 inputs), and acos's slope 1 / sqrt(1 - x^2) amplifies a last-bit
    # difference of its input near x = +-1: allow rtol 1e-6 plus 8 input
    # ULPs through that slope (measured worst: 1.6e-6 in u at
    # cos_phi = 0.99993, where the allowance is 6.6e-6)
    local = (p - c).astype(np.float64)
    cos_t = np.clip(local[:, 2] / r, -1, 1)
    cos_p = np.clip(local[:, 0] / (r * np.sqrt(1 - cos_t ** 2)), -1, 1)
    slope = np.stack([1 / (2 * np.pi) / np.sqrt(1 - cos_p ** 2 + 1e-12),
                      1 / np.pi / np.sqrt(1 - cos_t ** 2 + 1e-12)], axis=1)
    a, b = got[0].numpy(), np.asarray(want[0])
    assert np.all(np.abs(a - b) <= 1e-6 * np.abs(b) + 1e-7
                  + 8 * np.finfo(np.float32).eps * slope)
    assert np.isclose(a, b, rtol=1e-6, atol=1e-7).all(axis=1).mean() > 0.99


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
def test_intersect_scene_vs_jax(scenes, early_exit):
    jds, tds = scenes
    o, d, tmin, tmax, act = _query(N, 11 + early_exit, early_exit)
    t_ref, p_ref = JT.intersect_scene(
        jds, *map(jnp.asarray, (o, d, tmin, tmax)), early_exit=early_exit,
        active=jnp.asarray(act))
    t_got, p_got = intersect_scene(
        tds, *map(torch.from_numpy, (o, d, tmin, tmax)), early_exit=early_exit,
        active=torch.from_numpy(act))
    t_ref, p_ref, t_got, p_got = map(np.asarray, (t_ref, p_ref, t_got, p_got))
    n_tris = tds.meta.n_tris
    assert n_tris == 10 and tds.meta.n_spheres == 1
    if early_exit:
        np.testing.assert_array_equal(p_got >= 0, p_ref >= 0)
        # a lane the sphere occludes keeps the sphere and skips the walk
        np.testing.assert_array_equal(p_got >= n_tris, p_ref >= n_tris)
    else:
        np.testing.assert_array_equal(p_got, p_ref)
        hit = p_ref >= 0
        np.testing.assert_allclose(t_got[hit], t_ref[hit], rtol=1e-5)
    assert np.all(p_got[~act] == -1)
    assert np.all(np.isinf(t_got[p_got < 0]))
    sph = p_got == n_tris
    assert 0.2 < sph.mean() < 0.8 and (p_got[act] < n_tris).any()


def test_hit_details_on_spheres(scenes):
    jds, tds = scenes
    o, d, tmin, tmax, _ = _query(N, 13, False)
    t_ref, p_ref = JT.intersect_scene(jds, *map(jnp.asarray, (o, d, tmin,
                                                              tmax)))
    sph = np.asarray(p_ref) == tds.meta.n_tris
    assert sph.sum() > N // 4
    want = JT.hit_details(jds, jnp.asarray(o), jnp.asarray(d), t_ref, p_ref)
    got = hit_details(tds, torch.from_numpy(o), torch.from_numpy(d),
                      torch.from_numpy(np.array(t_ref)),
                      torch.from_numpy(np.array(p_ref)))
    for name in ("hit", "prim", "material", "light"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    for name in ("t", "point", "normal", "uv", "dpdu", "dpdv"):
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        np.testing.assert_allclose(a[sph], b[sph], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    # the reprojected point lies on or just outside the surface
    rel = getattr(got, "point").numpy()[sph] - SPHERE_CENTER
    assert np.all(np.linalg.norm(rel, axis=1) >= SPHERE_RADIUS * (1 - 1e-6))
