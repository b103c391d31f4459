"""Traversal and hit shading: the port against the JAX package.

On the CPU the port's triangle query is the plain walk
(`intersect_tris_plain`, a PyTorch port of the XLA stack walk). It is held
against JAX's own CPU path (`intersect_scene`, the XLA walk) and against
the bvh8t Pallas kernel in interpret mode, whose tables the CUDA walk
reads. Winners must match exactly except for equal-t ties between
different leaves; t agrees within rtol 1e-5 (XLA contracts multiply-adds).
The CUDA kernel itself is tested against the plain walk on the card, in
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_raytracing.device.scene_buffers as JSB
import tpu_raytracing.ops.traverse as JT
from tpu_raytracing.device import compile_scene as jax_compile_scene
from tpu_raytracing.ops.traverse_pallas import intersect_tris_pallas
from tpu_raytracing.scene.test_scenes import get_test_scene as jax_test_scene
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.device import scene_buffers as SB
from tpu_raytracing_torch.native_cuda import launch_counts, reset_launch_counts
from tpu_raytracing_torch.ops.traverse import (
    hit_details, intersect_scene, occluded,
)
from tpu_raytracing_torch.ops.traverse_bvh8t import (
    intersect_tris_bvh8t, intersect_tris_plain,
)
from tpu_raytracing_torch.scene.test_scenes import get_test_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    return (jax_compile_scene(jax_test_scene("coated_diffuse_bunny")
                              .scene_func()),
            compile_scene(get_test_scene("coated_diffuse_bunny").scene_func(),
                          "cpu"))


def _rays(ds, n, seed):
    """tests/test_pallas_traverse.py::_rays."""
    rng = np.random.default_rng(seed)
    c = np.asarray(ds.bounds_center)
    r = float(ds.bounds_radius)
    o = (c[None, :] + rng.normal(0, 0.15, (n, 3)) * r).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _query(n, seed, jds, early_exit):
    o, d = _rays(jds, n, seed)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 10.0 if early_exit else np.inf, np.float32)
    act = np.arange(n) % 7 != 3  # some inactive lanes
    return o, d, tmin, tmax, act


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _assert_winners(p_want, p_got, t_want, t_got, tie_limit):
    diff = p_want != p_got
    # equal-t ties between leaves are the only allowed disagreement
    ties = diff & (p_want >= 0) & (p_got >= 0) & np.isclose(
        t_want, t_got, rtol=1e-6, atol=0)
    assert not (diff & ~ties).any(), np.nonzero(diff & ~ties)
    assert ties.sum() <= tie_limit
    hit = (p_want >= 0) & (p_got >= 0)
    np.testing.assert_allclose(t_got[hit], t_want[hit], rtol=1e-5)


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
def test_plain_walk_vs_jax_walk(scenes, early_exit):
    jds, tds = scenes
    n = 4096
    o, d, tmin, tmax, act = _query(n, 11, jds, early_exit)
    t_ref, p_ref = JT.intersect_scene(
        jds, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax), early_exit=early_exit, active=jnp.asarray(act))
    t_ref, p_ref = np.asarray(t_ref), np.asarray(p_ref)
    to, td, ttmin, ttmax, tact = _t(o, d, tmin, tmax, act)
    tp, bp = intersect_tris_plain(tds, to, td, ttmin, ttmax, tact, early_exit)
    t_s, p_s = intersect_scene(tds, to, td, ttmin, ttmax,
                               early_exit=early_exit, active=tact)
    tp, bp, t_s, p_s = (x.numpy() for x in (tp, bp, t_s, p_s))
    np.testing.assert_array_equal(p_s, bp)
    assert np.all(bp[~act] == -1) and np.all(tp[~act] == tmax[~act])
    if early_exit:
        np.testing.assert_array_equal(bp >= 0, p_ref >= 0)
        assert np.all(np.isinf(t_s[bp < 0]))
    else:
        _assert_winners(p_ref, bp, t_ref, tp, tie_limit=0)
        np.testing.assert_array_equal(np.isinf(t_s), bp < 0)


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
def test_plain_walk_vs_pallas_bvh8t(scenes, early_exit):
    """The bvh8t Pallas kernel (interpret mode) walks the tables the CUDA
    kernel walks; the plain walk must agree with it."""
    jds, tds = scenes
    n = 1024
    o, d, tmin, tmax, act = _query(n, 12, jds, early_exit)
    t_k, p_k = intersect_tris_pallas(
        jds, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax), jnp.asarray(act), early_exit=early_exit)
    t_k, p_k = np.asarray(t_k), np.asarray(p_k)
    tp, bp = intersect_tris_plain(tds, *_t(o, d, tmin, tmax, act), early_exit)
    tp, bp = tp.numpy(), bp.numpy()
    assert np.all(p_k[~act] == -1) and np.all(bp[~act] == -1)
    if early_exit:
        np.testing.assert_array_equal(bp >= 0, p_k >= 0)
    else:
        _assert_winners(p_k, bp, t_k, tp, tie_limit=1)


def test_hit_details_vs_jax(scenes):
    """Geometry within rtol 1e-5. The barycentric-derived fields (uv and
    the interpolated normal) get atol 5e-5: Moller-Trumbore's u and v
    cancel by |o - p0| / |edge|, some 10^2 to 10^3 on the bunny's small
    triangles, so one ULP of XLA's contracted multiply-adds becomes ~2e-5
    there (measured max 1.6e-5)."""
    jds, tds = scenes
    n = 4096
    o, d, tmin, tmax, act = _query(n, 13, jds, False)
    t_ref, p_ref = JT.intersect_scene(jds, jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(tmin), jnp.asarray(tmax))
    want = JT.hit_details(jds, jnp.asarray(o), jnp.asarray(d), t_ref, p_ref)
    got = hit_details(tds, *_t(o, d), torch.from_numpy(np.array(t_ref)),
                      torch.from_numpy(np.array(p_ref)))
    for name in ("hit", "prim", "material", "light"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    for name in ("t", "point", "dpdu", "dpdv"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for name in ("uv", "normal"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=5e-5, err_msg=name)


def test_occluded_is_any_hit(scenes):
    jds, tds = scenes
    n = 2048
    o, d, tmin, tmax, act = _query(n, 14, jds, True)
    occ = occluded(tds, *_t(o, d, tmin, tmax), active=torch.from_numpy(act))
    _, p = intersect_scene(tds, *_t(o, d, tmin, tmax), early_exit=True,
                           active=torch.from_numpy(act))
    np.testing.assert_array_equal(occ.numpy(), p.numpy() >= 0)
    assert not occ.numpy()[~act].any()


def test_cpu_tensors_take_the_plain_walk(scenes):
    _, tds = scenes
    reset_launch_counts()
    o, d, tmin, tmax, act = _query(256, 15, scenes[0], False)
    args = _t(o, d, tmin, tmax, act)
    got = intersect_tris_bvh8t(tds, *args)
    want = intersect_tris_plain(tds, *args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not launch_counts()


def test_other_devices_raise(scenes):
    _, tds = scenes
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="device"):
        intersect_tris_bvh8t(tds, x, x, x[:, 0], x[:, 0],
                             torch.ones(4, dtype=torch.bool, device="meta"))


@pytest.mark.parametrize("width", [8, 16, 32])
def test_bvh8t_layout_widths_match_jax(monkeypatch, width):
    """The W-templated tables the kernel reads, built by the port and by
    the JAX layout function at every width the kernel supports."""
    monkeypatch.setenv("TPU_RT_T8_W", str(width))
    from tpu_raytracing.accel import build_bvh

    g = np.random.default_rng(width)
    c = g.random((600, 3)).astype(np.float32) * 4
    p0, p1, p2 = (c + g.normal(0, 0.05, (600, 3)).astype(np.float32)
                  for _ in range(3))
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    bvh = build_bvh(lo, hi)
    o = bvh.prim_order
    tri_pack = np.concatenate([p0[o], p1[o], p2[o]], axis=1)
    want = JSB._bvh8t_layout(bvh, tri_pack)
    got = SB._bvh8t_layout(bvh, tri_pack, w=width, lg=16)
    for a, b in zip(got[:3], want[:3]):
        assert a.tobytes() == b.tobytes()
    assert got[3] == want[3]


def _soup_scene(pkg: str):
    """tests/test_pallas_traverse.py::test_bvh8t_chunked_big_scene's
    scene (3,000 seeded triangles) from package `pkg`'s modules."""
    import importlib

    G = importlib.import_module(pkg + ".geometry")
    M = importlib.import_module(pkg + ".materials")
    S = importlib.import_module(pkg + ".scene")
    C = importlib.import_module(pkg + ".scene.camera")
    rng = np.random.default_rng(7)
    n = 3000
    base = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    verts = np.concatenate(
        [base, base + rng.normal(0, 0.05, (n, 3)).astype(np.float32),
         base + rng.normal(0, 0.05, (n, 3)).astype(np.float32)], axis=1
    ).reshape(n * 3, 3).astype(np.float32)
    mesh = G.Mesh(vertices=verts,
                  tris=np.arange(n * 3, dtype=np.uint32).reshape(n, 3))
    sb = S.SceneBuilder()
    sb.add_camera(C.Camera.lookat_camera_perspective(
        G.v3(0, 0, 5), G.v3(0, 0, 0), G.v3(0, 1, 0), False,
        np.deg2rad(45.0), 64, 64))
    mat = sb.add_material(M.Diffuse(albedo=sb.add_constant_texture(
        G.v4(0.5, 0.5, 0.5, 1))))
    sb.add_shape_at_position(G.TriangleMesh(mesh), mat, G.v3(0, 0, 0))
    return sb.build()


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
def test_unchunked_walk_vs_jax_chunked_walk(monkeypatch, early_exit):
    """A scene that JAX splits into bvh8t chunks (a 64 KiB budget, as
    test_bvh8t_chunked_big_scene sets it) is walked by the port as one
    table set, from its own compile and from JAX's leaves: the winners of
    JAX's chunked Pallas walk (interpret mode), t within rtol 1e-5;
    any-hit bits equal."""
    import dataclasses

    from tpu_raytracing_torch.device import from_jax_leaves

    monkeypatch.setenv("TPU_RT_PALLAS_KERNEL", "bvh8t")
    monkeypatch.setenv("TPU_RT_T8_CHUNK_BYTES", str(64 * 1024))
    monkeypatch.setattr(JT, "_use_pallas", lambda _ds: True)
    jds = jax_compile_scene(_soup_scene("tpu_raytracing"))
    assert len(jds.meta.t8_chunk_meta) > 1
    tds = compile_scene(_soup_scene("tpu_raytracing_torch"), "cpu")
    fj = from_jax_leaves(_jax_leaves(jds), dataclasses.asdict(jds.meta),
                         "cpu")
    rng = np.random.default_rng(3)
    n = 1024
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 1.0 if early_exit else np.inf, np.float32)
    tj, pj = JT.intersect_scene(jds, *(jnp.asarray(x)
                                       for x in (o, d, tmin, tmax)),
                                early_exit=early_exit)
    tj, pj = np.asarray(tj), np.asarray(pj)
    assert (pj >= 0).sum() > 50
    for ds in (tds, fj):
        tt, pt = intersect_scene(ds, *_t(o, d, tmin, tmax),
                                 early_exit=early_exit)
        if early_exit:
            np.testing.assert_array_equal(pt.numpy() >= 0, pj >= 0)
        else:
            _assert_winners(pj, pt.numpy(), tj, tt.numpy(), tie_limit=1)


def _jax_leaves(jds) -> dict:
    return {k: np.asarray(getattr(jds, k)) for k in SB.LEAF_NAMES}
