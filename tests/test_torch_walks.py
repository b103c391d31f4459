"""The walks behind the kernel switch: each plain version against the JAX
package's Pallas kernel it stands for, and the switch itself.

The Pallas kernels run in interpret mode on the CPU, selected with the
JAX package's own switch (TPU_RT_PALLAS_KERNEL, TPU_RT_BRUTE_GROUPS), as
tests/test_pallas_traverse.py selects them. Their CUDA counterparts
(csrc/*.cu) are held against the same plain versions on the card, in
tests/test_torch_cuda.py. Winners must match exactly except for equal-t
ties between leaves; t agrees within rtol 1e-5 (XLA contracts multiply-
adds); any-hit bits must be equal. The walks whose kernels repeat their
plain versions bit for bit (quad, quadrow, pair, walk) are held on the rays
where a kernel is most likely to slip too: at their hits' t and along axes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracing.device import compile_scene as jax_compile_scene
from tpu_raytracing.ops.traverse_pallas import intersect_tris_pallas
from tpu_raytracing.scene.test_scenes import get_test_scene as jax_test_scene
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.integrator.render import (
    StaticSettings, _pixel_grid, render_beauty_chunk,
)
from tpu_raytracing_torch.native_cuda import launch_counts, reset_launch_counts
from tpu_raytracing_torch.ops import traverse_bvh8t as T8
from tpu_raytracing_torch.ops import traverse_kernels as TK
from tpu_raytracing_torch.ops.rng import SamplerConfig
from tpu_raytracing_torch.scene.test_scenes import get_test_scene
from tpu_raytracing_torch.settings import RaytracerSettings

from torch_fixtures import at_t_limits, axis_rays

torch.set_num_threads(1)

# walk -> (scene, the JAX switch that selects its Pallas kernel)
CASES = {
    "brute": ("cube", {"TPU_RT_PALLAS_KERNEL": "bvh8t",
                       "TPU_RT_BRUTE_GROUPS": "4096"}),
    "quad": ("coated_diffuse_bunny", {"TPU_RT_PALLAS_KERNEL": "quad"}),
    "quadrow": ("coated_diffuse_bunny", {"TPU_RT_PALLAS_KERNEL": "quadrow"}),
    "pair": ("coated_diffuse_bunny", {"TPU_RT_PALLAS_KERNEL": "pair"}),
    "walk": ("coated_diffuse_bunny", {"TPU_RT_PALLAS_KERNEL": "walk"}),
}
PLAINS = {
    "brute": TK.intersect_tris_brute_plain,
    "quad": TK.intersect_tris_quad_plain,
    "quadrow": lambda *a: TK.intersect_tris_quad_plain(*a, rowrec=True),
    "pair": TK.intersect_tris_pair_plain,
    "walk": TK.intersect_tris_skiplink_plain,
}
SWITCH = ("TPU_RT_PALLAS_KERNEL", "TPU_RT_BRUTE_GROUPS")


@pytest.fixture(scope="module")
def scenes():
    return {name: (jax_compile_scene(jax_test_scene(name).scene_func()),
                   compile_scene(get_test_scene(name).scene_func(), "cpu"))
            for name in ("coated_diffuse_bunny", "cube")}


def _set_switch(monkeypatch, env):
    for k in SWITCH:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _query(ds, n, seed, early_exit):
    """tests/test_pallas_traverse.py::_rays, t ranges and inactive lanes."""
    rng = np.random.default_rng(seed)
    c = ds.bounds_center.numpy()
    r = float(ds.bounds_radius)
    o = (c[None, :] + rng.normal(0, 0.15, (n, 3)) * r).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 10.0 if early_exit else np.inf, np.float32)
    act = np.arange(n) % 7 != 3
    return o, d, tmin, tmax, act


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
@pytest.mark.parametrize("walk", list(CASES))
def test_plain_vs_pallas_kernel(scenes, monkeypatch, walk, early_exit):
    name, env = CASES[walk]
    jds, tds = scenes[name]
    _set_switch(monkeypatch, env)
    n = 1024
    o, d, tmin, tmax, act = _query(tds, n, 31, early_exit)
    t_k, p_k = intersect_tris_pallas(
        jds, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax), jnp.asarray(act), early_exit=early_exit)
    t_k, p_k = np.asarray(t_k), np.asarray(p_k)
    tp, bp = PLAINS[walk](tds, *[torch.from_numpy(x)
                                 for x in (o, d, tmin, tmax, act)], early_exit)
    tp, bp = tp.numpy(), bp.numpy()
    assert np.all(p_k[~act] == -1) and np.all(bp[~act] == -1)
    assert np.all(tp[~act] == tmax[~act])
    assert (bp >= 0).sum() > n // 4  # the rays hit the scene
    if early_exit and walk != "brute":  # the brute kernel has no early exit
        np.testing.assert_array_equal(bp >= 0, p_k >= 0)
        return
    diff = p_k != bp
    ties = diff & (p_k >= 0) & (bp >= 0) & np.isclose(t_k, tp, rtol=1e-6,
                                                      atol=0)
    assert not (diff & ~ties).any(), np.nonzero(diff & ~ties)
    assert ties.sum() <= 1
    hit = (p_k >= 0) & (bp >= 0)
    np.testing.assert_allclose(tp[hit], t_k[hit], rtol=1e-5)


def _hard_rays(jds, tds, walk, kind):
    """The ray sets where a walk is most likely to slip, as numpy (o, d,
    t_min, t_max, active). "at_t_limits": _query's rays with t_min or t_max
    at their closest hit's t (torch_fixtures.py::at_t_limits: a third t_min
    = t, a third t_max = t, a third t_max one float below), on the lanes where
    the Pallas kernel and the plain version find the same triangle at the
    same t bits (XLA contracts multiply-adds, so on the others the two t
    differ in the last bits and a limit at one is not at the other).
    "axis": torch_fixtures.py::axis_rays, zero direction components from a
    node box's plane (the NaN slab)."""
    if kind == "axis":
        return axis_rays(tds, 1024, 42)
    base = _query(tds, 1024, 41, False)
    t_k, p_k = intersect_tris_pallas(jds, *[jnp.asarray(x) for x in base])
    t_k, p_k = np.asarray(t_k), np.asarray(p_k)
    tp, bp = PLAINS[walk](tds, *[torch.from_numpy(x) for x in base])
    tp, bp = tp.numpy(), bp.numpy()
    same = (bp >= 0) & (p_k == bp) & (t_k.view(np.int32) == tp.view(np.int32))
    assert same.sum() > 512
    held = at_t_limits([torch.from_numpy(x) for x in base],
                       torch.from_numpy(tp),
                       torch.from_numpy(np.where(same, bp, -1)))
    return tuple(x.numpy() for x in held)


@pytest.mark.parametrize("kind", ["at_t_limits", "axis"])
@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
@pytest.mark.parametrize("walk", ["quad", "quadrow", "pair", "walk"])
def test_plain_vs_pallas_kernel_hard_rays(scenes, monkeypatch, walk,
                                          early_exit, kind):
    """The plain versions that the K4, K5 and K6 kernels repeat bit for bit,
    against the Pallas kernel on rays at their hits' t (the <= rule of the
    leaf update and t >= t_min) and on axis rays (NaN slabs). Any-hit bits
    equal; closest-hit winners equal but for equal-t ties, t within rtol
    1e-5. At the t limits no tie is allowed: one lane at most, as in
    test_plain_vs_pallas_kernel. An axis ray from a snapped plane often runs
    through a shared vertex or edge, so equal-t ties there are common, and
    XLA's last-bit drift in t decides them: a tie is a different winner at
    t within the rtol, and at most 2% of the hits may be one."""
    name, env = CASES[walk]
    jds, tds = scenes[name]
    _set_switch(monkeypatch, env)
    o, d, tmin, tmax, act = _hard_rays(jds, tds, walk, kind)
    t_k, p_k = intersect_tris_pallas(
        jds, *[jnp.asarray(x) for x in (o, d, tmin, tmax, act)],
        early_exit=early_exit)
    t_k, p_k = np.asarray(t_k), np.asarray(p_k)
    tp, bp = PLAINS[walk](tds, *[torch.from_numpy(x)
                                 for x in (o, d, tmin, tmax, act)], early_exit)
    tp, bp = tp.numpy(), bp.numpy()
    assert np.all(p_k[~act] == -1) and np.all(bp[~act] == -1)
    assert (bp >= 0).sum() > 1024 // 4
    np.testing.assert_array_equal(bp >= 0, p_k >= 0)
    if early_exit:
        return
    hit = bp >= 0
    np.testing.assert_allclose(tp[hit], t_k[hit], rtol=1e-5)
    ties = (p_k != bp) & hit
    assert ties.sum() <= (1 if kind == "at_t_limits" else 0.02 * hit.sum())


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
@pytest.mark.parametrize("scene,kind", [
    ("coated_diffuse_bunny", "random"), ("coated_diffuse_bunny", "axis"),
    ("checkered_plane", "random"), ("sphere", "random"),
], ids=["bunny", "bunny_axis", "single_leaf", "no_triangles"])
def test_pair_plain_vs_stack_walk(scene, kind, early_exit):
    """K5's plain version, which walks in the kernel's child order, against
    the XLA stack walk over the same child-pair rows (near-first by entry
    distance, leaves parked): on the bunny, on a single-leaf tree
    (checkered_plane's two triangles, root_meta & 7) and on a scene with no
    triangles (sphere, root_meta -1). Hit bits equal in both modes;
    closest-hit winners equal but for equal-t ties (a different winner at
    t within rtol 1e-5: at most one on random rays, 2% of the hits on axis
    rays), t within rtol 1e-5."""
    tds = compile_scene(get_test_scene(scene).scene_func(), "cpu")
    if kind == "axis":
        rays = axis_rays(tds, 1024, 43)
    else:
        rays = _query(tds, 1024, 33, early_exit)
    args = [torch.from_numpy(x) for x in rays]
    tp, bp = TK.intersect_tris_pair_plain(tds, *args, early_exit)
    ts, bs = T8.intersect_tris_plain(tds, *args, early_exit)
    tp, bp, ts, bs = (x.numpy() for x in (tp, bp, ts, bs))
    act = rays[4]
    assert np.all(bp[~act] == -1) and np.all(tp[~act] == rays[3][~act])
    np.testing.assert_array_equal(bp >= 0, bs >= 0)
    hits = int((bp >= 0).sum())
    if scene == "sphere":
        assert hits == 0 and np.array_equal(tp, rays[3])
        return
    assert hits > 64  # the rays hit the scene
    if early_exit:
        return
    hit = bp >= 0
    np.testing.assert_allclose(tp[hit], ts[hit], rtol=1e-5)
    ties = (bp != bs) & hit
    assert ties.sum() <= (0.02 * hits if kind == "axis" else 1)


def _slab_nan_bounds_nothing(origin, inv_dir, bb_min, bb_max):
    """ops/intersect.py::ray_aabb, except that an axis where the direction
    is zero bounds nothing when the origin lies in the slab (and everything
    when it does not), in place of the 0 * inf = NaN that culls the box."""
    a = (bb_min - origin) * inv_dir
    b = (bb_max - origin) * inv_dir
    zero = torch.isinf(inv_dir).expand_as(a)
    inside = (bb_min <= origin) & (origin <= bb_max)
    inf = torch.full_like(a, float("inf"))
    a = torch.where(zero, torch.where(inside, -inf, inf), a)
    b = torch.where(zero, torch.where(inside, inf, -inf), b)
    return (torch.amax(torch.minimum(a, b), dim=-1),
            torch.amin(torch.maximum(a, b), dim=-1))


def test_f3_nan_slab_culls_grazing_hits(scenes, monkeypatch):
    """Fault F3 (ROADMAP section 3), cause (a): a ray that lies in the plane
    of a box face, across which its direction is zero, meets 0 * inf = NaN
    in the slab test, and the walk culls the box. On the cube every axis
    ray (torch_fixtures.py::axis_rays) lies in the plane of a face of the root
    box and grazes the triangles of the faces across that plane at an edge:
    the brute force, which culls nothing, finds those hits (the port's and
    the JAX package's alike), and the plain stack walk, which keeps the NaN
    rule as the JAX package has it, loses every one, as JAX's bvh8t kernel
    does; the same walk with a slab test where such an axis bounds nothing
    finds them all, at the brute force's t."""
    jds, tds = scenes["cube"]
    rays = axis_rays(tds, 4096, 7)
    args = [torch.from_numpy(x) for x in rays]
    tb, bb = TK.intersect_tris_brute_plain(tds, *args)
    assert (bb >= 0).sum() > 1024
    for env in ({"TPU_RT_BRUTE_GROUPS": "4096"}, {}):
        _set_switch(monkeypatch, env)
        _, p_k = intersect_tris_pallas(jds, *[jnp.asarray(x) for x in rays])
        np.testing.assert_array_equal(np.asarray(p_k) >= 0,
                                      bb.numpy() >= 0 if env else False)
    _, b_nan = T8.intersect_tris_plain(tds, *args)
    assert torch.all(b_nan == -1)
    monkeypatch.setattr(T8, "ray_aabb", _slab_nan_bounds_nothing)
    t_all, b_all = T8.intersect_tris_plain(tds, *args)
    assert torch.equal(b_all >= 0, bb >= 0)
    hit = bb >= 0
    np.testing.assert_allclose(t_all[hit], tb[hit], rtol=1e-5)


@pytest.mark.parametrize("walk", ["stack", "pair", "walk"])
def test_f3_box_entry_culls_a_hit_at_t_max(scenes, monkeypatch, walk):
    """Fault F3, cause (b): a leaf box's entry t, from the slab test, can
    round above the t that Moller-Trumbore gives a triangle in it, so with
    t_max at a hit's own t the box test (t0 <= t_best) culls the box and
    the walk loses the hit. On random bunny rays with t_max at each closest
    hit's t, the walks over the BVH2's boxes (the stack walk, the pair and
    skip-link walks) each lose some hits; the brute force finds each at
    that t, bit for bit, and a slab test without the NaN rule loses them
    too."""
    _, tds = scenes["coated_diffuse_bunny"]
    plain = {"stack": T8.intersect_tris_plain,
             "pair": TK.intersect_tris_pair_plain,
             "walk": TK.intersect_tris_skiplink_plain}[walk]
    args = [torch.from_numpy(x) for x in _query(tds, 1024, 31, False)]
    t, b = plain(tds, *args)
    held = [*args[:3], torch.where(b >= 0, t, args[3]), args[4]]
    lost = torch.nonzero((b >= 0) & (plain(tds, *held)[1] < 0))[:, 0]
    assert 0 < lost.numel() < 0.2 * (b >= 0).sum()
    sub = [x[lost] for x in held]
    tb, bb = TK.intersect_tris_brute_plain(tds, *sub)
    assert torch.equal(bb, b[lost])
    assert torch.equal(tb.view(torch.int32), t[lost].view(torch.int32))
    monkeypatch.setattr(T8, "ray_aabb", _slab_nan_bounds_nothing)
    monkeypatch.setattr(TK, "ray_aabb", _slab_nan_bounds_nothing)
    assert torch.all(plain(tds, *sub)[1] == -1)


# three of the bench frame's camera rays (coated_diffuse_bunny, 500x500,
# 8 spp) on which a replay of the frame's batches on the card found the
# bvh8t walk and the brute force apart: the pinhole at (0, 4.4, 0.4), t in
# [0.01, 1000]
F3_CAMERA_DIRS = (
    (0.24134749174118042, -0.9233184456825256, 0.2987213432788849),
    (-0.1646970510482788, -0.9384512901306152, 0.30361825227737427),
    (-0.2712153196334839, -0.9221281409263611, 0.2759021520614624))


def test_f3_barycentric_margin_outside_the_boxes(scenes, monkeypatch):
    """Fault F3, cause (c), on the renderer's own rays: Moller-Trumbore
    accepts u + v up to 1 + 1e-5, so it hits a point just past a
    triangle's edge, and so past the boxes that bound the triangle. A
    camera ray that runs through the seam where the room's ceiling meets
    its walls (u + v just above 1, the hit point past y = 1) has such a hit
    and no other: the brute force, which culls no box, finds it at t near
    3.6, and every walk over a tree loses it and misses, the JAX package's
    bvh8t kernel as the port's plain versions."""
    jds, tds = scenes["coated_diffuse_bunny"]
    n = len(F3_CAMERA_DIRS)
    o = np.tile(np.float32([0.0, 4.4, 0.4]), (n, 1))
    d = np.float32(F3_CAMERA_DIRS)
    rays = (o, d, np.full(n, 0.01, np.float32), np.full(n, 1000.0, np.float32),
            np.ones(n, bool))
    args = [torch.from_numpy(x) for x in rays]
    tb, bb = TK.intersect_tris_brute_plain(tds, *args)
    assert torch.all(bb >= 0) and torch.all((tb > 3.6) & (tb < 3.7))
    for plain in (T8.intersect_tris_plain, *PLAINS.values()):
        if plain is not TK.intersect_tris_brute_plain:
            t, b = plain(tds, *args)
            assert torch.all(b == -1) and torch.all(t == 1000.0)
    _set_switch(monkeypatch, {})
    _, p_b = intersect_tris_pallas(jds, *[jnp.asarray(x) for x in rays])
    assert np.all(np.asarray(p_b) == -1)
    # the brute force's rows: u + v past 1 by less than the margin
    groups = (tds.t8_tris.reshape(-1, int(tds.meta.t8_leaf), 128)
              [:, :, :TK.G8_PER_BLOCK * 10]
              .reshape(-1, TK.G8_PER_BLOCK, 10).double().numpy())
    rows = groups.reshape(-1, 10)
    ids = rows[:, 9].astype(np.float32).view(np.int32)
    for k in range(n):
        p0, e1, e2 = np.split(rows[np.nonzero(ids == int(bb[k]))[0][0], :9], 3)
        pv = np.cross(d[k], e2)
        den = pv @ e1
        tv = o[k] - p0
        u, v = pv @ tv / den, np.cross(tv, e1) @ d[k] / den
        assert 0.0 < u + v - 1.0 < 1e-5, (u, v)


@pytest.mark.parametrize("env,walk", [
    ({}, "bvh8t"),
    ({"TPU_RT_PALLAS_KERNEL": "bvh8t"}, "bvh8t"),
    ({"TPU_RT_BRUTE_GROUPS": "2556"}, "brute"),
    ({"TPU_RT_BRUTE_GROUPS": "2555"}, "bvh8t"),
    ({"TPU_RT_PALLAS_KERNEL": "quad"}, "quad"),
    ({"TPU_RT_PALLAS_KERNEL": "quadrow"}, "quadrow"),
    ({"TPU_RT_PALLAS_KERNEL": "pair"}, "pair"),
    ({"TPU_RT_PALLAS_KERNEL": "walk"}, "walk"),
    ({"TPU_RT_PALLAS_KERNEL": "skiplink"}, "walk"),
], ids=["default", "bvh8t", "brute", "brute_too_few", "quad", "quadrow",
        "pair", "walk", "any_other"])
def test_switch_runs_that_plain_version(scenes, monkeypatch, env, walk):
    """intersect_tris on CPU tensors runs the selected walk's plain
    version (spied on), as the JAX rule selects it at call time (the
    bunny has 2,556 groups), and launches no kernel."""
    _, tds = scenes["coated_diffuse_bunny"]
    _set_switch(monkeypatch, env)
    assert TK.select_walk(tds) == walk
    owner, attr = {
        "bvh8t": (T8, "intersect_tris_plain"),
        "brute": (TK, "intersect_tris_brute_plain"),
        "quad": (TK, "intersect_tris_quad_plain"),
        "quadrow": (TK, "intersect_tris_quad_plain"),
        "pair": (TK, "intersect_tris_pair_plain"),
        "walk": (TK, "intersect_tris_skiplink_plain"),
    }[walk]
    calls = []
    real = getattr(owner, attr)

    def spy(*a, **k):
        calls.append(k.get("rowrec", a[7] if len(a) > 7 else False))
        return real(*a, **k)

    monkeypatch.setattr(owner, attr, spy)
    reset_launch_counts()
    o, d, tmin, tmax, act = _query(tds, 64, 32, False)
    t, b = TK.intersect_tris(tds, *[torch.from_numpy(x)
                                    for x in (o, d, tmin, tmax, act)])
    assert len(calls) == 1
    assert calls[0] == (walk == "quadrow")
    assert b.shape == (64,) and t.dtype == torch.float32
    assert not launch_counts()


@pytest.fixture(scope="module")
def chunk_bvh8t(scenes):
    """256 bunny pixels (1 spp, depth 3) through the default walk."""
    with pytest.MonkeyPatch.context() as mp:
        _set_switch(mp, {})
        return _chunk(scenes["coated_diffuse_bunny"][1])


def _chunk(tds):
    s = RaytracerSettings(samples_per_pixel=1, light_sample_count=1,
                          max_ray_depth=3)
    px, py, _ = _pixel_grid(tds.meta.width, tds.meta.height)
    sel = slice(148480, 148480 + 256)  # mostly on the bunny
    r, n = render_beauty_chunk(
        tds, SamplerConfig.from_settings(s.sampler, s.seed),
        StaticSettings.from_settings(s),
        torch.from_numpy(px[sel].astype(np.int64)),
        torch.from_numpy(py[sel].astype(np.int64)),
        torch.ones(256, dtype=torch.bool))
    return r.numpy(), int(n)


@pytest.mark.parametrize("walk", list(CASES))
def test_slice_under_each_walk(scenes, monkeypatch, chunk_bvh8t, walk):
    """The slice through each walk equals the bvh8t slice: every walk
    finds the same winners with bit-equal t, so rays_traced is equal and
    pixels differ only where a path meets an equal-t tie between leaves
    (none in this block: the images are equal)."""
    _, tds = scenes["coated_diffuse_bunny"]
    env = dict(CASES[walk][1])
    if walk == "brute":
        env["TPU_RT_BRUTE_GROUPS"] = str(TK.t8_groups(tds))
    _set_switch(monkeypatch, env)
    assert TK.select_walk(tds) == walk
    want, n_want = chunk_bvh8t
    got, n_got = _chunk(tds)
    assert n_got == n_want > 0
    assert np.isfinite(got).all() and got.mean() > 0
    np.testing.assert_array_equal(got, want)
