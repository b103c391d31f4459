"""The CUDA walks, the coat kernel, the shading kernel, the hit_details
kernel and the probes on the card, against their plain PyTorch versions.

Marked `cuda`: the kernels have no CPU mode, so these tests skip without a
card. This file imports no jax and nothing of the JAX package (the machine
with the card has no jax), so it runs there on its own:

    python3 -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from tpu_raytracing_torch.accel import build_bvh
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.device import scene_buffers as SB
from tpu_raytracing_torch.integrator.accumulate import render_accumulated
from tpu_raytracing_torch.integrator import render as R
from tpu_raytracing_torch.integrator.render import render
from tpu_raytracing_torch.native_cuda import launch_counts, reset_launch_counts
from tpu_raytracing_torch.ops import bsdf as TB
from tpu_raytracing_torch.ops import bsdf_dispatch as D
from tpu_raytracing_torch.ops import layered as L
from tpu_raytracing_torch.ops import traverse as TT
from tpu_raytracing_torch.ops import traverse_kernels as TK
from tpu_raytracing_torch.ops.traverse_bvh8t import (
    intersect_tris_bvh8t, intersect_tris_plain,
)
from tpu_raytracing_torch.ops.rng import SamplerConfig
from tpu_raytracing_torch.ops.walk_common import launch_key
from tpu_raytracing_torch.probes import bf16_vpu as P4
from tpu_raytracing_torch.probes import iter_cost as P3
from tpu_raytracing_torch.probes import slab_cost as P2
from tpu_raytracing_torch.probes import walk_cost as P1
from tpu_raytracing_torch.scene import scene_from_file
from tpu_raytracing_torch.scene.test_scenes import get_test_scene
from tpu_raytracing_torch.settings import RaytracerSettings

from torch_fixtures import (
    COAT_SETTINGS, EXACT, PERSISTENT, at_t_limits, axis_limits, axis_rays,
    bsdf_lanes, bunnies_glb, coat_calls, compare_trees, edge_rays,
    emissive_box, hit_calls, path_rays, repeated_triangles, shade_calls,
    textured_cubes,
)

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

# kernel wrapper and its plain version, per walk of the kernel switch
WALKS = {
    "brute": (TK.intersect_tris_brute, TK.intersect_tris_brute_plain),
    "quad": (TK.intersect_tris_quad, TK.intersect_tris_quad_plain),
    "quadrow": (TK.intersect_tris_quadrow,
                lambda *a: TK.intersect_tris_quad_plain(*a, rowrec=True)),
    "pair": (TK.intersect_tris_pair, TK.intersect_tris_pair_plain),
    "walk": (TK.intersect_tris_skiplink, TK.intersect_tris_skiplink_plain),
}
# the coat's and the shading kernel's entries, as native_cuda counts them
COAT = {"eval": ("tpu_rt_layered_eval", ""),
        "sample": ("tpu_rt_layered_sample", "")}
SHADE = {"eval": ("tpu_rt_bsdf_eval", ""),
         "sample": ("tpu_rt_bsdf_sample", "")}


def _n(key) -> int:
    """The launches native_cuda counted under (entry, tag) since its last
    reset."""
    return launch_counts().get(key, 0)


def _walk_n(walk: str, early_exit: bool) -> int:
    return _n(launch_key(walk, early_exit))


@pytest.fixture(scope="module")
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the walks are CUDA kernels")
    scene = get_test_scene("coated_diffuse_bunny").scene_func()
    return compile_scene(scene, "cuda")


@pytest.fixture(scope="module")
def path_batches(cuda_scene):
    """The bunny frame's camera rays and their shadow rays (500x500, the
    bench frame's settings), by mode."""
    s = RaytracerSettings(samples_per_pixel=8, light_sample_count=1,
                          max_ray_depth=8)
    return path_rays(cuda_scene, s)


def _batch(ds, path_batches, rays: str, n: int, seed: int,
           early_exit: bool):
    """`rays` "random": _rays(n, seed); "path": path_batches' batch of the
    mode."""
    if rays == "path":
        mode = "any_hit" if early_exit else "closest_hit"
        return list(path_batches[mode][:5])
    return _rays(ds, n, seed, early_exit)


def _rays(ds, n, seed, early_exit):
    """tests/test_pallas_traverse.py::_rays, plus t ranges and a mask."""
    rng = np.random.default_rng(seed)
    c = ds.bounds_center.cpu().numpy()
    r = float(ds.bounds_radius)
    o = (c[None, :] + rng.normal(0, 0.15, (n, 3)) * r).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 10.0 if early_exit else np.inf, np.float32)
    act = np.arange(n) % 7 != 3
    return [torch.from_numpy(x).to(ds.device) for x in (o, d, tmin, tmax, act)]


def _assert_agree(tk, bk, tp, bp, act, early_exit, exact=False):
    """Winners equal except equal-t ties between leaves (under 1e-4 of the
    rays; none where `exact`), t within rtol 1e-5 (bit-equal where
    `exact`), any-hit bits equal; inactive lanes (t_max, -1)."""
    tk, bk, tp, bp = (x.cpu().numpy() for x in (tk, bk, tp, bp))
    assert np.all(bk[~act] == -1)
    if early_exit and not exact:
        np.testing.assert_array_equal(bk >= 0, bp >= 0)
        return
    if exact:
        np.testing.assert_array_equal(bk, bp)
        np.testing.assert_array_equal(tk.view(np.int32), tp.view(np.int32))
        return
    diff = bk != bp
    ties = diff & (bk >= 0) & (bp >= 0) & (tk == tp)
    assert not (diff & ~ties).any()
    assert ties.sum() <= 1e-4 * bk.shape[0]
    np.testing.assert_allclose(tk[bk >= 0], tp[bk >= 0], rtol=1e-5)


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
@pytest.mark.parametrize("rays", ["random", "path"])
def test_kernel_vs_plain(cuda_scene, path_batches, rays, early_exit):
    """K1/K2 on 65,536 random rays, and on the bunny frame's 250,000 camera
    rays and their shadow rays."""
    ds = cuda_scene
    args = _batch(ds, path_batches, rays, 65536, 16, early_exit)
    reset_launch_counts()
    tk, bk = intersect_tris_bvh8t(ds, *args, early_exit)
    assert _walk_n("bvh8t", early_exit) == 1
    tp, bp = intersect_tris_plain(ds, *args, early_exit)
    torch.cuda.synchronize()
    _assert_agree(tk, bk, tp, bp, args[4].cpu().numpy(), early_exit)


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
@pytest.mark.parametrize("walk", list(WALKS))
@pytest.mark.parametrize("rays", ["random", "path"])
def test_walk_kernel_vs_plain(cuda_scene, path_batches, rays, walk,
                              early_exit):
    """K3-K6 on 16,384 random rays, and on the bunny frame's 250,000 camera
    rays and their shadow rays, bit for bit."""
    ds = cuda_scene
    kernel, plain = WALKS[walk]
    args = _batch(ds, path_batches, rays, 16384, 18, early_exit)
    reset_launch_counts()
    tk, bk = kernel(ds, *args, early_exit)
    assert _walk_n(walk, early_exit) == 1
    tp, bp = plain(ds, *args, early_exit)
    torch.cuda.synchronize()
    _assert_agree(tk, bk, tp, bp, args[4].cpu().numpy(), early_exit,
                  exact=walk in EXACT)


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
def test_kernel_repeats_bit_for_bit(cuda_scene, early_exit):
    """Three launches on the same rays: each agrees with the plain walk and
    all three are bit-equal, whichever warp the persistent grid hands each
    ray to."""
    ds = cuda_scene
    args = _rays(ds, 65536, 22, early_exit)
    tp, bp = intersect_tris_plain(ds, *args, early_exit)
    runs = [intersect_tris_bvh8t(ds, *args, early_exit) for _ in range(3)]
    torch.cuda.synchronize()
    act = args[4].cpu().numpy()
    for tk, bk in runs:
        _assert_agree(tk, bk, tp, bp, act, early_exit)
    for tk, bk in runs[1:]:
        assert torch.equal(bk, runs[0][1])
        assert torch.equal(tk.view(torch.int32), runs[0][0].view(torch.int32))


@pytest.mark.parametrize("walk", ["bvh8t", *WALKS])
def test_counts(cuda_scene, walk):
    """The per-ray counters: work on live rays, none on inactive ones, and
    the same (t, best) as a launch without them. Padding rows are not
    counted, so the brute kernel counts one test per real triangle."""
    ds = cuda_scene
    kernel = intersect_tris_bvh8t if walk == "bvh8t" else WALKS[walk][0]
    args = _rays(ds, 4096, 19, False)
    counts = torch.zeros((4096, 3), dtype=torch.int32, device=ds.device)
    t1, b1 = kernel(ds, *args, False, counts=counts)
    t0, b0 = kernel(ds, *args, False)
    torch.cuda.synchronize()
    assert torch.equal(t0, t1) and torch.equal(b0, b1)
    c = counts.cpu().numpy()
    act = args[4].cpu().numpy()
    assert np.all(c[~act] == 0)
    assert np.all(c[act, 0] > 0) and np.all(c[act, 2] >= 0)
    if walk == "brute":
        assert np.all(c[act, 2] == ds.meta.n_tris)


@pytest.fixture(scope="module")
def brute_scenes(cuda_scene):
    """The bunny (28,586 triangle rows, 224 ring tiles), metal (10 rows,
    one triangle block, one tile) and a mesh of repeated triangles (240
    rows, equal-t ties inside and across groups) on the card."""
    return {"bunny": cuda_scene,
            "metal": compile_scene(get_test_scene("metal").scene_func(),
                                   "cuda"),
            "repeated": compile_scene(repeated_triangles(), "cuda")}


def _exact_vs_plain(ds, walk, args, early_exit):
    """One launch of a K3, K4, K5 or K6 kernel against its plain version, bit
    for bit; returns the plain (t, best)."""
    kernel, plain = WALKS[walk]
    reset_launch_counts()
    tk, bk = kernel(ds, *args, early_exit)
    assert _walk_n(walk, early_exit) == 1
    tp, bp = plain(ds, *args, early_exit)
    torch.cuda.synchronize()
    _assert_agree(tk, bk, tp, bp, args[4].cpu().numpy(), early_exit,
                  exact=True)
    return tp, bp


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
@pytest.mark.parametrize("n", [1, 127, 513, 16385])
@pytest.mark.parametrize("scene", ["bunny", "metal"])
def test_brute_bit_for_bit(brute_scenes, scene, n, early_exit):
    """The redesigned K3 at ray counts that fill no whole block or slot,
    every 7th lane inactive and every other lane with its own t_max."""
    ds = brute_scenes[scene]
    args = _rays(ds, n, 40 + n, early_exit)
    g = np.random.default_rng(n)
    own = torch.from_numpy(g.uniform(0.05, 2.0, n).astype(np.float32)
                           * float(ds.bounds_radius)).to(ds.device)
    args[3] = torch.where(torch.arange(n, device=ds.device) % 2 == 1, own,
                          args[3])
    _, bp = _exact_vs_plain(ds, "brute", args, early_exit)
    if n > 1000:
        assert (bp >= 0).sum() > n // 4


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
@pytest.mark.parametrize("scene", ["bunny", "metal", "repeated"])
def test_brute_edge_rays(brute_scenes, scene, early_exit):
    """K3 on rays at its prefilter's edges (vertices, edges, just inside
    and outside them, nearly parallel; torch_fixtures.py::edge_rays), then on
    the same rays with t_min or t_max at each hit's t; on the repeated
    triangles every hit is an equal-t tie."""
    ds = brute_scenes[scene]
    args = [torch.from_numpy(x).to(ds.device)
            for x in edge_rays(ds, 16384, 50)]
    tp, bp = _exact_vs_plain(ds, "brute", args, early_exit)
    assert (bp >= 0).sum() > 4096
    _exact_vs_plain(ds, "brute", at_t_limits(args, tp, bp), early_exit)


def test_brute_repeats_bit_for_bit(cuda_scene):
    """Three launches of K3 on the same rays, bit-equal to each other and
    to the plain version."""
    ds = cuda_scene
    args = _rays(ds, 65536, 23, False)
    tp, bp = TK.intersect_tris_brute_plain(ds, *args)
    runs = [TK.intersect_tris_brute(ds, *args) for _ in range(3)]
    torch.cuda.synchronize()
    for tk, bk in runs:
        assert torch.equal(bk, bp)
        assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
@pytest.mark.parametrize("n", [1, 127, 513, 16385])
@pytest.mark.parametrize("walk", PERSISTENT)
def test_persistent_walk_bit_for_bit(cuda_scene, walk, n, early_exit):
    """K4, K5 and K6 at ray counts that fill no whole warp, block or fetch
    chunk, every 7th lane inactive and every other lane with its own
    t_max."""
    ds = cuda_scene
    args = _rays(ds, n, 60 + n, early_exit)
    g = np.random.default_rng(n)
    own = torch.from_numpy(g.uniform(0.05, 2.0, n).astype(np.float32)
                           * float(ds.bounds_radius)).to(ds.device)
    args[3] = torch.where(torch.arange(n, device=ds.device) % 2 == 1, own,
                          args[3])
    _, bp = _exact_vs_plain(ds, walk, args, early_exit)
    if n > 1000:
        assert (bp >= 0).sum() > n // 4


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
@pytest.mark.parametrize("walk", PERSISTENT)
def test_persistent_walk_hard_rays(cuda_scene, walk, early_exit):
    """K4, K5 and K6 bit for bit on axis rays (zero direction components from
    node box planes: NaN slabs; torch_fixtures.py::axis_rays), then on the
    same rays with t_min or t_max at each hit's t."""
    ds = cuda_scene
    args = [torch.from_numpy(x).to(ds.device)
            for x in axis_rays(ds, 16384, 61)]
    tp, bp = _exact_vs_plain(ds, walk, args, early_exit)
    assert (bp >= 0).sum() > 4096
    _exact_vs_plain(ds, walk, at_t_limits(args, tp, bp), early_exit)


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
@pytest.mark.parametrize("walk", PERSISTENT)
def test_persistent_walk_repeats_bit_for_bit(cuda_scene, walk, early_exit):
    """Three launches on the same rays give the same bits and counters,
    whichever warp the fetch counter hands each ray to."""
    ds = cuda_scene
    kernel, _ = WALKS[walk]
    args = _rays(ds, 65536, 24, early_exit)
    runs = []
    for _ in range(3):
        counts = torch.zeros((65536, 3), dtype=torch.int32, device=ds.device)
        runs.append((*kernel(ds, *args, early_exit, counts=counts), counts))
    torch.cuda.synchronize()
    t0, b0, c0 = runs[0]
    for t1, b1, c1 in runs[1:]:
        assert torch.equal(b0, b1) and torch.equal(c0, c1)
        assert torch.equal(t0.view(torch.int32), t1.view(torch.int32))


@pytest.mark.parametrize("walk", PERSISTENT)
def test_misaligned_table_raises(cuda_scene, walk):
    """The K4, K5 and K6 kernels read 16-byte records: a table that starts
    off a 16-byte boundary raises, with no fallback."""
    ds = cuda_scene
    name = {"quad": "bvh4_recs_pk", "quadrow": "bvh4_rows",
            "pair": "bvh2_rows_pk", "walk": "bvh_nodes_pk"}[walk]
    table = getattr(ds, name)
    buf = torch.zeros(table.numel() + 1, dtype=table.dtype, device=ds.device)
    shifted = buf[1:].view(table.shape)
    shifted.copy_(table)
    bad = dataclasses.replace(ds, **{name: shifted})
    with pytest.raises(ValueError, match="16-byte"):
        WALKS[walk][0](bad, *_rays(ds, 128, 25, False))


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
def test_bvh8t_axis_rays(cuda_scene, early_exit):
    """K1/K2 on axis rays (NaN slabs; torch_fixtures.py::axis_rays), then on
    the same rays with t_min or t_max at the hits' t where the kernel and the
    plain walk agree bit for bit, against the plain walk (another tree) by
    the traversal contract: hit bits equal, winners equal but for ties (a
    different winner at t within rtol 1e-5, at most 2% of the live rays),
    t within rtol 1e-5; or fault F3, a hit in a box that one tree's box test
    culls and the brute-force plain version finds
    (torch_fixtures.py::compare_trees)."""
    ds = cuda_scene
    mode = "any_hit" if early_exit else "closest_hit"
    args = [torch.from_numpy(x).to(ds.device)
            for x in axis_rays(ds, 16384, 62)]
    lim = at_t_limits(args, *axis_limits(ds, "bvh8t", intersect_tris_bvh8t,
                                         intersect_tris_plain, args))
    for rays in (args, lim):
        tp, bp = intersect_tris_plain(ds, *rays, early_exit)
        tk, bk = intersect_tris_bvh8t(ds, *rays, early_exit)
        torch.cuda.synchronize()
        ok, report = compare_trees(ds, mode, rays, tk, bk, tp, bp)
        assert ok, report
        assert (bp >= 0).sum() > 4096


def test_stack_caps_raise(cuda_scene):
    ds = cuda_scene
    args = _rays(ds, 128, 20, False)
    deep4 = dataclasses.replace(
        ds, meta=dataclasses.replace(ds.meta, bvh4_stack=65))
    deep2 = dataclasses.replace(
        ds, meta=dataclasses.replace(ds.meta, bvh2_depth=65))
    with pytest.raises(ValueError, match="exceeds"):
        TK.intersect_tris_quad(deep4, *args)
    with pytest.raises(ValueError, match="exceeds"):
        TK.intersect_tris_pair(deep2, *args)


@pytest.mark.parametrize("width", [8, 32])
def test_kernel_other_widths(cuda_scene, width):
    """The W=8 and W=32 instantiations on tables of those widths and their
    card layout."""
    ds = cuda_scene
    p = ds.tri_pack.cpu().numpy()[:ds.meta.n_tris]
    lo = np.minimum(np.minimum(p[:, 0:3], p[:, 3:6]), p[:, 6:9])
    hi = np.maximum(np.maximum(p[:, 0:3], p[:, 3:6]), p[:, 6:9])
    bvh = build_bvh(lo, hi)
    pk = p[bvh.prim_order]
    nodes, meta, tris, stack = SB._bvh8t_layout(bvh, pk, w=width, lg=16)
    dev = ds.device
    ds_w = dataclasses.replace(
        ds, t8_nodes=torch.from_numpy(nodes).to(dev),
        t8_meta=torch.from_numpy(meta).to(dev),
        t8_tris=torch.from_numpy(tris).to(dev),
        t8_card=SB.bvh8t_card(nodes, meta, tris, width, 16, dev),
        meta=dataclasses.replace(ds.meta, t8_width=width, t8_stack=stack))
    args = _rays(ds, 16384, 17, False)
    tk, bk = intersect_tris_bvh8t(ds_w, *args)
    tp, bp = intersect_tris_plain(ds, *args)
    tk, bk, tp, bp = (x.cpu().numpy() for x in (tk, bk, tp, bp))
    # the rebuilt BVH numbers triangles in its own order: compare hits and t
    hit = bk >= 0
    np.testing.assert_array_equal(hit, bp >= 0)
    np.testing.assert_allclose(tk[hit], tp[hit], rtol=1e-5)


@pytest.fixture
def cpu_threads():
    """Every CPU core for a test's cpu side, one thread again after it."""
    torch.set_num_threads(os.cpu_count() or 1)
    yield
    torch.set_num_threads(1)


def _block(scene, s, dev, start: int, n: int):
    """(radiance (n, 3), rays_traced) of the n Morton-order pixels from
    `start` of `scene` at settings s on `dev`."""
    from tpu_raytracing_torch.integrator.render import (
        StaticSettings, _pixel_grid, render_beauty_chunk,
    )

    cfg = SamplerConfig.from_settings(s.sampler, s.seed)
    px, py, _ = _pixel_grid(scene.camera.raster_width,
                            scene.camera.raster_height)
    sel = slice(start, start + n)
    r, rays = render_beauty_chunk(
        compile_scene(scene, dev), cfg, StaticSettings.from_settings(s),
        torch.from_numpy(px[sel].astype(np.int64)).to(dev),
        torch.from_numpy(py[sel].astype(np.int64)).to(dev),
        torch.ones(n, dtype=torch.bool, device=dev))
    return r.cpu().numpy(), int(rays)


def _share_close(g, c) -> float:
    """The share of pixels whose every channel is within rtol 1e-3 (+1e-6)
    of the cpu one."""
    return float(np.all(np.abs(g - c) <= 1e-3 * np.abs(c) + 1e-6,
                        axis=-1).mean())


# the bench frame's 4,096-pixel Morton blocks (500x500, 2 spp, depth 8, one
# light sample): offset and the least share of pixels within rtol 1e-3. Both
# devices draw the same random numbers and trace the same camera rays bit
# for bit; they differ in the last bits of sin, cos, exp and log1p, and the
# card computes x / scalar as x * (1 / scalar). The coated BSDF's
# evaluation hashes the bits of (wo, wi) into its random stream
# (ops/layered.py), so once a bounce direction differs in a last bit, every
# later coat evaluation draws another, equally valid estimate: on the bunny
# the pixels agree in distribution only (measured on the H100: 99.29% of
# wall pixels and 93.77% of the bunny block within rtol 1e-3)
BUNNY_BLOCKS = {"walls_and_floor": (125000, 0.98), "bunny": (147456, 0.90)}


@pytest.mark.parametrize("block", ["frame", *BUNNY_BLOCKS])
def test_render_on_card_matches_cpu(cuda_scene, cpu_threads, block):
    """A 64x64 bunny frame on cuda (through the kernel) and on cpu, and two
    4,096-pixel blocks of the 500x500 frame, one of walls and floor and one
    65% on the bunny: mean within 1%, rays_traced within 0.5%, and on the
    blocks BUNNY_BLOCKS' share of pixels within rtol 1e-3."""
    scene = get_test_scene("coated_diffuse_bunny").scene_func()
    s = RaytracerSettings(samples_per_pixel=2, light_sample_count=1,
                          max_ray_depth=8)
    reset_launch_counts()
    if block == "frame":
        scene.camera = scene.camera.with_resolution(64, 64)
        g, c = render(scene, s), render(scene, s, "cpu")
        (g, ng), (c, nc) = ((x.beauty, x.rays_traced) for x in (g, c))
    else:
        start, least = BUNNY_BLOCKS[block]
        (g, ng), (c, nc) = (_block(scene, s, dev, start, 4096)
                            for dev in ("cuda", "cpu"))
        assert _share_close(g, c) >= least, _share_close(g, c)
    assert min(_walk_n("bvh8t", ee) for ee in (False, True)) > 0
    assert np.isfinite(g).all() and g.mean() > 0
    assert abs(ng - nc) <= 0.005 * nc
    np.testing.assert_allclose(g.mean(), c.mean(), rtol=0.01)


@pytest.fixture(scope="module")
def metal_scenes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the walk is a CUDA kernel")
    scene = get_test_scene("metal").scene_func()
    return compile_scene(scene, "cuda"), compile_scene(scene, "cpu")


def _sphere_rays(n, seed, early_exit):
    """Half random rays inside the Cornell box, half aimed at its sphere
    (center (0, 0, 0.75), radius 0.5) from around it, grazing ones
    included; t ranges and a mask of active lanes."""
    g = np.random.default_rng(seed)
    c = np.array([0.0, 0.0, 0.75])

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    m = n // 2
    o_rand = g.uniform(-0.9, 0.9, (m, 3)) + c
    d_rand = unit(g.normal(size=(m, 3)))
    o_aim = c + unit(g.normal(size=(n - m, 3))) * g.uniform(0.6, 1.2,
                                                             (n - m, 1))
    target = c + unit(g.normal(size=(n - m, 3))) * 0.5 * g.uniform(
        0.0, 1.02, (n - m, 1))
    o = np.concatenate([o_rand, o_aim]).astype(np.float32)
    d = np.concatenate([d_rand, unit(target - o_aim)]).astype(np.float32)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.full(n, 1.2 if early_exit else np.inf, np.float32)
    act = np.arange(n) % 7 != 3
    return o, d, tmin, tmax, act


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
def test_intersect_scene_spheres_cuda_vs_cpu(metal_scenes, early_exit):
    """The sphere pass, then the bvh8t walk with the sphere hit as t_max
    (any-hit lanes the sphere occludes skip the walk): winners exact, spheres
    encoded n_tris + index, t within rtol 1e-5."""
    from tpu_raytracing_torch.ops.traverse import intersect_scene

    gds, cds = metal_scenes
    rays = _sphere_rays(16384, 23, early_exit)
    res = {}
    reset_launch_counts()
    for ds in (gds, cds):
        args = [torch.from_numpy(x).to(ds.device) for x in rays]
        t, p = intersect_scene(ds, *args[:4], early_exit=early_exit,
                               active=args[4])
        res[ds.device.type] = (t.cpu().numpy(), p.cpu().numpy())
    assert _walk_n("bvh8t", early_exit) == 1
    (tg, pg), (tc, pc) = res["cuda"], res["cpu"]
    n_tris = gds.meta.n_tris
    if early_exit:
        np.testing.assert_array_equal(pg >= 0, pc >= 0)
        np.testing.assert_array_equal(pg >= n_tris, pc >= n_tris)
    else:
        np.testing.assert_array_equal(pg, pc)
        hit = pc >= 0
        np.testing.assert_allclose(tg[hit], tc[hit], rtol=1e-5)
    assert np.all(pg[~rays[4]] == -1)
    assert 0.2 < (pg == n_tris).mean() < 0.8 and (pg[rays[4]] < n_tris).any()


# blocks of builtin scenes at their builtin settings but the spp: scene ->
# (the block's first pixel, pixels, spp, the least share within rtol 1e-3).
# The sphere scenes' blocks lie on the sphere, where mirror and glass
# bounces carry a last-bit difference from bounce to bounce (measured on
# the H100: 100% on every 1,024-pixel block); the checkered plane's in the
# near half, where a cell covers many pixels; environment_light's across
# the cube's silhouette against the sky (no light, so no shadow ray); the
# emissive box's (RaytracerSettings' defaults) on the ceiling at the quad's
# edge.
SCENE_BLOCKS = {
    "dielectric_256": ("dielectric", (192, 288), 256, 2, 0.90),
    "out_of_focus_sphere": ("out_of_focus_sphere", (160, 224), 1024, 2,
                            0.99),
    "dielectric": ("dielectric", (192, 288), 1024, 2, 0.98),
    "metal": ("metal", (192, 288), 1024, 2, 0.98),
    "rough_metal": ("rough_metal", (192, 288), 1024, 2, 0.98),
    "rough_dielectric": ("rough_dielectric", (192, 288), 1024, 2, 0.98),
    "checkered_plane": ("checkered_plane", (224, 224), 1024, 1, 0.98),
    "environment_light": ("environment_light", (256, 224), 1024, 2, 0.98),
    "emissive_box": ("emissive_box", (192, 96), 1024, 2, 0.98),
}


@pytest.mark.parametrize("case", list(SCENE_BLOCKS))
def test_dielectric_block_cuda_vs_cpu(cpu_threads, case):
    """A block of a builtin scene (SCENE_BLOCKS; first the 256-pixel block
    on the glass sphere of tests/test_torch_render_materials.py), on cuda
    through the kernels and on cpu: rays_traced within 0.5%, the mean
    within 1% per channel, and the case's share of pixels within rtol 1e-3.
    The walk launches where the scene has triangles, its any-hit mode
    where it has a light too."""
    from tpu_raytracing_torch.integrator.render import _pixel_grid

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the walk is a CUDA kernel")
    name, (x0, y0), n, spp, least = SCENE_BLOCKS[case]
    if name == "emissive_box":
        scene, s = emissive_box(), RaytracerSettings()
    else:
        ts = get_test_scene(name)
        scene, s = ts.scene_func(), ts.settings_func()
    s = dataclasses.replace(s, samples_per_pixel=spp)
    px, py, _ = _pixel_grid(scene.camera.raster_width,
                            scene.camera.raster_height)
    start = int(np.nonzero((px == x0) & (py == y0))[0][0])
    reset_launch_counts()
    (g, ng), (c, nc) = (_block(scene, s, dev, start, n)
                        for dev in ("cuda", "cpu"))
    walked = name != "out_of_focus_sphere"  # a lone sphere: no triangle
    assert (_walk_n("bvh8t", False) > 0) == walked
    assert (_walk_n("bvh8t", True) > 0) == (
        walked and name != "environment_light")
    assert np.isfinite(g).all() and c.mean() > 0
    assert abs(ng - nc) <= 0.005 * nc
    np.testing.assert_allclose(g.mean(axis=0), c.mean(axis=0), rtol=0.01)
    assert _share_close(g, c) >= least, _share_close(g, c)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the walk is a CUDA kernel")


def test_textures_cuda_vs_cpu():
    """Every texture kind (image under each filter and wrap mode, checker,
    constant, scale, mix) on seeded uv and derivatives, on cuda against cpu
    on the same tables: within rtol 1e-5 (erf and log2 may differ in the
    last bits), and bit-equal without derivatives on at least 99% of the
    lanes (a last bit of a wrapped coordinate may move a NEAREST tap)."""
    import tpu_raytracing_torch.materials as TM
    from tpu_raytracing_torch.ops import textures as TT

    _needs_card()
    scene = textured_cubes(16)
    for f in TM.FilterMode:
        for w in TM.WrapMode:
            scene.textures.append(TM.ImageTexture(
                image=0, sampler=TM.TextureSampler(filter=f, wrap=w)))
    ds = {dev: compile_scene(scene, dev) for dev in ("cuda", "cpu")}
    assert ds["cpu"].meta.any_nearest and ds["cpu"].meta.any_trilinear
    n = 65536
    g = np.random.default_rng(41)
    tid = g.integers(-1, len(scene.textures), n).astype(np.int32)
    uv = g.uniform(-3, 3, (n, 2))
    uv[: n // 4] = g.uniform(-500, 500, (n // 4, 2))
    der = g.choice([-1, 1], (4, n)) * 10.0 ** g.uniform(-4, -0.5, (4, n))
    der[:, : n // 3] = 0.0
    inp = [uv.astype(np.float32), *der.astype(np.float32)]
    for has_derivs in (False, True):
        out = {}
        for dev, d in ds.items():
            ctx = TT.EvalCtx(*(torch.from_numpy(a).to(dev) for a in inp))
            if not has_derivs:
                ctx = TT.EvalCtx.without_antialiasing(ctx.uv)
            out[dev] = TT.eval_texture(d, torch.from_numpy(tid).to(dev), ctx,
                                       has_derivs).cpu().numpy()
        got, want = out["cuda"], out["cpu"]
        assert np.isfinite(got).all()
        close = np.all(np.isclose(got, want, rtol=1e-5, atol=1e-6), axis=-1)
        assert close.mean() >= 0.99, (has_derivs, close.mean())
        if not has_derivs:
            assert np.all(got == want, axis=-1).mean() >= 0.99


def test_area_light_shadow_rays_kernel_vs_plain():
    """Area-light shadow rays of the emissive Cornell box (origins on the
    quad, per-lane t_max = d - 1e-3) through the any-hit kernel against
    the plain walk: hit bits equal. Half the shading points are the camera
    rays' first hits, which the empty box leaves unoccluded; the other
    half lie above the ceiling, which occludes them."""
    from tpu_raytracing_torch.device.scene_buffers import LIGHT_AREA
    from tpu_raytracing_torch.integrator.render import _pixel_grid
    from tpu_raytracing_torch.ops.camera_rays import generate_rays
    from tpu_raytracing_torch.ops.light_sampling import sample_light
    from tpu_raytracing_torch.ops.rng import SamplerConfig, make_stream
    from tpu_raytracing_torch.ops.traverse import intersect_scene

    _needs_card()
    scene = emissive_box()
    scene.camera = scene.camera.with_resolution(128, 128)
    ds = compile_scene(scene, "cuda")
    cfg = SamplerConfig("independent")
    px, py, _ = _pixel_grid(128, 128)
    px = torch.from_numpy(px.astype(np.int64)).cuda()
    py = torch.from_numpy(py.astype(np.int64)).cuda()
    stream = make_stream(px, py, 0)
    o, d, _, stream = generate_rays(ds, px, py, cfg, stream, 1, True)
    n = o.shape[0]
    full = lambda v: torch.full((n,), v, device="cuda")  # noqa: E731
    t, prim = intersect_scene(ds, o, d, full(ds.meta.near_clip),
                              full(ds.meta.far_clip))
    g = np.random.default_rng(43)
    above = np.stack([g.uniform(-0.9, 0.9, n), g.uniform(-0.9, 0.9, n),
                      g.uniform(1.6, 2.5, n)], axis=1).astype(np.float32)
    outside = torch.arange(n, device="cuda") >= n // 2
    points = torch.where(outside[:, None], torch.from_numpy(above).cuda(),
                         o + t[:, None] * d)
    li = ds.meta.light_kinds.index(LIGHT_AREA)
    ls, _ = sample_light(ds, li, points, cfg, stream)
    args = (ls.origin.contiguous(), ls.direction.contiguous(), full(1e-3),
            (ls.distance - 1e-3).contiguous(), outside | (prim >= 0))
    reset_launch_counts()
    tk, bk = intersect_tris_bvh8t(ds, *args, early_exit=True)
    assert _walk_n("bvh8t", True) == 1
    tp, bp = intersect_tris_plain(ds, *args, early_exit=True)
    hit_k, hit_p = (bk >= 0).cpu().numpy(), (bp >= 0).cpu().numpy()
    np.testing.assert_array_equal(hit_k, hit_p)
    act, out = args[4].cpu().numpy(), outside.cpu().numpy()
    assert np.all(hit_k[~act] == 0)
    assert hit_p[out].mean() > 0.99  # the ceiling blocks them
    assert hit_p[act & ~out].mean() < 0.01  # the box is empty
    assert float(args[3][args[4]].std()) > 0  # t_max differs per lane


def test_environment_light_never_launches_any_hit():
    """environment_light at 64x64 and 2 spp on cuda: its cube takes the
    closest-hit walk, and with no light no shadow ray is walked; the frame
    agrees with cpu in mean (1%) and rays_traced (0.5%)."""
    _needs_card()
    ts = get_test_scene("environment_light")
    scene = ts.scene_func()
    scene.camera = scene.camera.with_resolution(64, 64)
    s = dataclasses.replace(ts.settings_func(), samples_per_pixel=2)
    reset_launch_counts()
    g = render(scene, s)
    assert _walk_n("bvh8t", False) > 0
    assert _walk_n("bvh8t", True) == 0
    c = render(scene, s, "cpu")
    assert np.isfinite(g.beauty).all() and g.beauty.mean() > 0
    assert abs(g.rays_traced - c.rays_traced) <= 0.005 * c.rays_traced
    np.testing.assert_allclose(g.beauty.mean(), c.beauty.mean(), rtol=0.01)


@pytest.fixture(scope="module")
def bunnies(tmp_path_factory):
    """torch_fixtures.py's glTF scenes: four bunnies over one BLAS, and the
    same scene with every bunny baked world-space, at 96x96."""
    from tpu_raytracing_torch.scene import scene_from_file

    _needs_card()
    d = tmp_path_factory.mktemp("bunnies")
    out = {}
    for instanced in (True, False):
        path = d / f"{instanced}.glb"
        bunnies_glb(path, instanced)
        scene = scene_from_file(path)
        scene.camera = scene.camera.with_resolution(96, 96)
        out[instanced] = scene
    return out


def _blas_rays(blas, n, seed, early_exit):
    """Object-space rays around the BLAS's root box, with t ranges and a
    mask: _rays' distribution over the box instead of the scene."""
    boxes = blas.t8_card.children[:, :6].cpu().numpy()
    lo, hi = boxes[:, :3].min(axis=0), boxes[:, 3:6].max(axis=0)
    rng = np.random.default_rng(seed)
    c, r = (lo + hi) / 2, float(np.linalg.norm(hi - lo)) / 2
    o = (c[None, :] + rng.normal(0, 0.5, (n, 3)) * r).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, r if early_exit else np.inf, np.float32)
    act = np.arange(n) % 7 != 3
    return [torch.from_numpy(x).cuda() for x in (o, d, tmin, tmax, act)]


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
@pytest.mark.parametrize("walk", ["bvh8t", *WALKS])
def test_kernels_on_a_blas_vs_plain(bunnies, walk, early_exit):
    """Every walk's kernel over the shared BLAS's tables (accel_of), on
    object-space rays, against its plain version on the same view; one
    launch counted."""
    ds = compile_scene(bunnies[True], "cuda")
    assert len(ds.meta.instances) == 4 and ds.meta.n_tris == 2
    blas = TK.accel_of(ds, 0)
    assert blas.meta.n_tris == 28576
    kernel, plain = WALKS.get(walk, (intersect_tris_bvh8t,
                                     intersect_tris_plain))
    args = _blas_rays(blas, 16384, 19, early_exit)
    reset_launch_counts()
    tk, bk = kernel(blas, *args, early_exit)
    assert _walk_n(walk, early_exit) == 1
    tp, bp = plain(blas, *args, early_exit)
    torch.cuda.synchronize()
    assert (bp >= 0).sum() > 1000
    _assert_agree(tk, bk, tp, bp, args[4].cpu().numpy(), early_exit,
                  exact=walk in EXACT)


def test_instanced_frame_matches_baked(bunnies):
    """The four bunnies over one BLAS against the same scene baked
    world-space, on cuda (2 spp, depth 4): MSE < 1e-6; each bounce walks
    the main tables and each instance once (1 + 4 closest-hit launches,
    and as many any-hit launches for the shadow rays)."""
    s = RaytracerSettings(samples_per_pixel=2, light_sample_count=1,
                          max_ray_depth=4)
    imgs = {}
    for instanced, scene in bunnies.items():
        reset_launch_counts()
        imgs[instanced] = render(scene, s).beauty
        n = {"closest_hit": _walk_n("bvh8t", False),
             "any_hit": _walk_n("bvh8t", True)}
        per = 5 if instanced else 1
        assert n["closest_hit"] % per == 0 and n["closest_hit"] > 0
        assert n["any_hit"] == n["closest_hit"], n
    assert imgs[True].mean() > 0 and np.isfinite(imgs[True]).all()
    mse = float(np.mean((imgs[True] - imgs[False]) ** 2))
    assert mse < 1e-6, mse


# the probes: the plain versions run op by op, so they are compared at a
# small count, one of fori's compiled trip counts (the probes' mains time
# the kernels at the scripts' counts)
PROBE_ITERS = 256


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probes and the coat's walk "
                    "are CUDA kernels")


@pytest.mark.parametrize("small_ids", [False, True], ids=["script", "small_ids"])
@pytest.mark.parametrize("config", P3.CONFIGS, ids=P3.label)
def test_iter_cost_kernel_vs_plain(card, config, small_ids):
    """P3 bit for bit, and the same number of iterations run."""
    ins = P3.script_inputs("cuda", small_ids)
    ck, cp = (torch.zeros(1, dtype=torch.int32, device="cuda")
              for _ in range(2))
    reset_launch_counts()
    got = P3.iter_cost(*ins, *config, PROBE_ITERS, counts=ck)
    assert _n(("tpu_rt_probe_iter_cost", P3.label(config))) == 1
    want = P3.iter_cost_plain(*ins, *config, PROBE_ITERS, counts=cp)
    torch.cuda.synchronize()
    assert torch.isfinite(want).any() and not torch.isfinite(want).all()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int(ck.item()) == int(cp.item())


@pytest.mark.parametrize("dtype", list(P4.DTYPES))
def test_bf16_vpu_kernel_vs_plain(card, dtype):
    """P4 bit for bit in both types."""
    box, ray = P4.script_inputs("cuda")[dtype]
    reset_launch_counts()
    got = P4.bf16_vpu(box, ray, PROBE_ITERS)
    assert _n(("tpu_rt_probe_bf16_vpu", dtype)) == 1
    want = P4.bf16_vpu_plain(box, ray, PROBE_ITERS)
    torch.cuda.synchronize()
    assert torch.isfinite(want).all()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# counts the kernel's unrolled loop (P4.UNROLL iterations a trip) does
# not divide, so its remainder loop runs, and none at all
@pytest.mark.parametrize("iters", [0, 1, 3, 257])
@pytest.mark.parametrize("dtype", list(P4.DTYPES))
def test_bf16_vpu_remainder_iterations(card, dtype, iters):
    """P4 bit for bit where the iterations do not fill the unrolled loop."""
    assert iters % P4.UNROLL or iters == 0
    box, ray = P4.script_inputs("cuda")[dtype]
    got = P4.bf16_vpu(box, ray, iters)
    want = P4.bf16_vpu_plain(box, ray, iters)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_probes_reject_what_the_kernels_do_not_take(card):
    ins = P3.script_inputs("cuda")
    with pytest.raises(ValueError, match="compiled for"):
        P3.iter_cost(*ins, *P3.CONFIGS[0], 512)
    with pytest.raises(ValueError, match="expected"):
        P3.iter_cost(ins[0][:64], *ins[1:], *P3.CONFIGS[0], 256)
    box, ray = P4.script_inputs("cuda")["float32"]
    with pytest.raises(ValueError, match="expected"):
        P4.bf16_vpu(box[:8], ray[:8], 256)


def _inputs(probe, kind):
    return (probe.script_inputs if kind == "script" else probe.varied_inputs)(
        "cuda")


def _record_equal(run_kernel, run_plain, n: int = PROBE_ITERS):
    """Kernel and plain version bit for bit at n visits: output, stats
    (visits run, the drains' fold) and every visit's drained mask."""
    vk, vp = (torch.full((n,), -7, dtype=torch.int32, device="cuda")
              for _ in range(2))
    got, sk = run_kernel(vk)
    want, sp = run_plain(vp)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(sk, sp) and torch.equal(vk, vp)
    assert 0 < int(sp[0]) <= n
    return want, vp[:int(sp[0])]


@pytest.mark.parametrize("inputs", ["script", "varied"])
@pytest.mark.parametrize("variant", P2.VARIANTS)
def test_slab_cost_kernel_vs_plain(card, variant, inputs):
    """P2 bit for bit, visit by visit."""
    ins = _inputs(P2, inputs)
    reset_launch_counts()
    _, seq = _record_equal(
        lambda v: P2.slab_cost(*ins, variant, PROBE_ITERS, visits=v),
        lambda v: P2.slab_cost_plain(*ins, variant, PROBE_ITERS, visits=v))
    assert _n(("tpu_rt_probe_slab_cost", variant)) == 1
    if inputs == "varied":
        assert len(set(seq.tolist())) > 1


# P2's visits that pass the 1,024-node table's end (q wraps to node 0) and
# so cross every stage of the kernel's ring of node blocks many times
P2_WRAP_ITERS = 2100


@pytest.mark.parametrize("inputs", ["script", "varied"])
@pytest.mark.parametrize("variant", P2.VARIANTS)
def test_slab_cost_wraps_the_table(card, variant, inputs):
    """P2 bit for bit, visit by visit, at a count that wraps the node table
    and refills every ring stage: the blocks stream in the walk's order."""
    ins = _inputs(P2, inputs)
    reset_launch_counts()
    _, seq = _record_equal(
        lambda v: P2.slab_cost(*ins, variant, P2_WRAP_ITERS, visits=v),
        lambda v: P2.slab_cost_plain(*ins, variant, P2_WRAP_ITERS, visits=v),
        P2_WRAP_ITERS)
    assert _n(("tpu_rt_probe_slab_cost", variant)) == 1
    q = sum(1 + (int(m) & 1) for m in seq[:-1])
    assert q >= P2.NODES  # the last visit's node lies past the wrap


@pytest.mark.parametrize("inputs", ["script", "varied"])
@pytest.mark.parametrize("level", P1.LEVELS)
def test_walk_cost_kernel_vs_plain(card, level, inputs):
    """P1 bit for bit, visit by visit; the leaf levels find hits."""
    ins = _inputs(P1, inputs)
    reset_launch_counts()
    want, seq = _record_equal(
        lambda v: P1.walk_cost(*ins, level, PROBE_ITERS, visits=v),
        lambda v: P1.walk_cost_plain(*ins, level, PROBE_ITERS, visits=v))
    assert _n(("tpu_rt_probe_walk_cost", level)) == 1
    assert len(seq) == PROBE_ITERS and len(set(seq.tolist())) > 1
    fin = torch.isfinite(want)
    assert bool(fin.any()) == level.endswith("50")


@pytest.mark.parametrize("inputs", ["script", "varied"])
@pytest.mark.parametrize("level", P1.LEVELS)
def test_walk_cost_without_visits(card, level, inputs):
    """P1 bit for bit in output and stats when no visits buffer is given
    (the kernel then writes none), at a count past the node table's 256
    nodes."""
    ins = _inputs(P1, inputs)
    got, sk = P1.walk_cost(*ins, level, 300)
    want, sp = P1.walk_cost_plain(*ins, level, 300)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(sk, sp) and int(sp[0]) == 300


def test_slab_walk_reject_what_the_kernels_do_not_take(card):
    ins = P2.script_inputs("cuda")
    with pytest.raises(ValueError, match="expected"):
        P2.slab_cost(ins[0][:512], *ins[1:], "cur", 8)
    with pytest.raises(ValueError, match="variant"):
        P2.slab_cost(*ins, "nope", 8)
    with pytest.raises(ValueError, match="visits"):
        P2.slab_cost(*ins, "cur", 8,
                     visits=torch.zeros(4, dtype=torch.int32, device="cuda"))
    shifted = torch.empty(1024 * 128 + 1, device="cuda")[1:].view(1024, 128)
    with pytest.raises(ValueError, match="aligned"):
        P2.slab_cost(shifted, *ins[1:], "floor", 8)
    ins1 = P1.script_inputs("cuda")
    with pytest.raises(ValueError, match="expected"):  # tables of NB = 8
        P1.walk_cost(ins1[0][:128], ins1[1][:128], *ins1[2:], "slab", 8)
    with pytest.raises(ValueError, match="expected"):
        P1.walk_cost(*ins1[:2], ins1[2].float(), *ins1[3:], "slab", 8)
    with pytest.raises(ValueError, match="level"):
        P1.walk_cost(*ins1, "inner99", 8)


# ---------------------------------------------- the coat's layered walk

def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _coat_lanes(n, seed):
    """Seeded per-lane coats (numpy): smooth and rough (also anisotropic)
    tops, eta 1 to 2 and exactly 1, with and without a medium (some white,
    as the bunny's), thin and thick layers, dark bases that Russian
    roulette ends; wo of both signs, wi.z <= 0 on a tenth (unreachable
    after the flip), and grazing and axis directions on others."""
    g = np.random.default_rng(seed)
    ax = np.where(g.random(n) < 0.3, 1e-3, 0.05 + 0.6 * g.random(n))
    ay = np.where((g.random(n) < 0.7) | (ax == 1e-3), ax,
                  0.05 + 0.6 * g.random(n))
    eta = np.where(g.random(n) < 0.05, 1.0, 1.0 + g.random(n))
    medium = np.where((g.random(n) < 0.3)[:, None], 0.0, g.random((n, 3)))
    medium[g.random(n) < 0.2] = 1.0
    albedo = g.random((n, 3)) * np.where(g.random(n) < 0.3, 0.05, 1.0)[
        :, None]
    thickness = np.where(g.random(n) < 0.1, 1e-4, 0.01 + g.random(n))
    wo, wi = _unit(g.normal(size=(n, 3))), _unit(g.normal(size=(n, 3)))
    wi[:, 2] = np.abs(wi[:, 2]) * np.sign(wo[:, 2]) * np.where(
        g.random(n) < 0.1, -1, 1)
    special = np.array([[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0],
                        [0.6, 0.8, 0], [0.6, 0, 0.8], [1, 0, 1e-7],
                        [0, -1, -1e-7]], np.float32)
    for d in (wo, wi):
        pick = g.random(n) < 0.05
        d[pick] = _unit(special[g.integers(0, len(special), pick.sum())])
    params = TB.BsdfParams(
        kind=np.full(n, 5, np.int32), albedo=albedo,
        eta=np.repeat(eta[:, None], 3, 1), kappa=np.zeros((n, 3)),
        alpha_x=ax, alpha_y=ay,
        top_kind=np.where((ax == 1e-3) & (ay == 1e-3), 1, 3).astype(np.int32),
        thickness=thickness, coat_albedo=medium)
    params = TB.BsdfParams(*(
        torch.from_numpy(np.asarray(
            x, np.int32 if x.dtype == np.int32 else np.float32)).cuda()
        for x in params))
    draw_base = torch.from_numpy(
        g.integers(0, 1 << 32, n, dtype=np.int64)).cuda()
    return (params, torch.from_numpy(wo).cuda(), torch.from_numpy(wi).cuda(),
            draw_base)


def _same_bits(got, want) -> bool:
    """Every output bit for bit (floats as int32 views, so NaNs compare)."""
    got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    want = (want,) if isinstance(want, torch.Tensor) else tuple(want)
    torch.cuda.synchronize()
    return all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        if a.dtype == torch.float32 else torch.equal(a, b)
        for a, b in zip(got, want, strict=True))


@pytest.mark.parametrize("seed", [0, 1])
def test_coat_eval_kernel_vs_plain(card, seed):
    params, wo, wi, _ = _coat_lanes(16385, seed)
    steps = torch.zeros(wo.shape[0], dtype=torch.int32, device="cuda")
    got = L._eval_kernel(params, wo, wi, steps=steps)
    assert _same_bits(got, L.layered_eval_plain(params, wo, wi))
    # unreachable lanes walk no step; the others end their walks at every
    # depth, all eight samples' walks at most 64 steps
    assert (steps == 0).any() and int(steps.max()) <= 64
    assert len(torch.unique(steps)) > 32


@pytest.mark.parametrize("seed", [0, 1])
def test_coat_sample_kernel_vs_plain(card, seed):
    params, wo, _, draw_base = _coat_lanes(16385, seed)
    steps = torch.zeros(wo.shape[0], dtype=torch.int32, device="cuda")
    got = L._sample_kernel(params, wo, draw_base, steps=steps)
    want = L.layered_sample_plain(params, wo, draw_base)
    assert _same_bits(got, want)
    # coat reflections (no step), escapes after 2 to 8 steps (the first
    # step down reaches the base, which reflects), and null samples
    assert set(torch.unique(steps).tolist()) >= {0, *range(2, 9)}
    assert want.valid.any() and not want.valid.all()


def test_coat_bunny_calls_bit_for_bit(card):
    """Every coat call of one 1-spp 500x500 bunny pass (its lane counts and
    its inputs as the dispatch gathers them)."""
    scene = get_test_scene("coated_diffuse_bunny").scene_func()
    calls = coat_calls(scene, RaytracerSettings(**COAT_SETTINGS))
    assert {c[0] for c in calls} == {"eval", "sample"}
    for kind, params, wo, third in calls:
        kernel, plain = ((L.layered_eval, L.layered_eval_plain)
                         if kind == "eval" else
                         (L.layered_sample, L.layered_sample_plain))
        assert _same_bits(kernel(params, wo, third),
                          plain(params, wo, third)), (kind, wo.shape[0])


def test_coat_repeats_bit_for_bit(card):
    params, wo, wi, draw_base = _coat_lanes(4097, 2)
    first = (L.layered_eval(params, wo, wi),
             *L.layered_sample(params, wo, draw_base))
    for _ in range(2):
        again = (L.layered_eval(params, wo, wi),
                 *L.layered_sample(params, wo, draw_base))
        assert _same_bits(again, first)


def test_coat_empty_call_launches_nothing(card):
    params, wo, wi, draw_base = _coat_lanes(8, 3)
    none = TB.BsdfParams(*(x[:0] for x in params))
    launched = (_n(COAT["eval"]), _n(COAT["sample"]))
    f = L.layered_eval(none, wo[:0], wi[:0])
    s = L.layered_sample(none, wo[:0], draw_base[:0])
    assert f.shape == (0, 3) and s.wi.shape == (0, 3) and s.valid.shape == (0,)
    assert (_n(COAT["eval"]), _n(COAT["sample"])) == launched
    L.layered_eval(params, wo, wi)
    assert _n(COAT["eval"]) == launched[0] + 1


def test_coat_rejects_what_the_kernel_does_not_take(card):
    params, wo, wi, draw_base = _coat_lanes(64, 4)
    with pytest.raises(ValueError, match="expected"):
        L.layered_eval(params, wo, wi.double())
    with pytest.raises(ValueError, match="expected"):
        L.layered_eval(params, wo, wi[:, :2])
    with pytest.raises(ValueError, match="expected"):
        L.layered_eval(params, wo, wi.cpu())
    with pytest.raises(ValueError, match="expected"):
        L.layered_eval(params._replace(top_kind=params.top_kind.long()), wo,
                       wi)
    with pytest.raises(ValueError, match="expected"):
        L.layered_sample(params, wo, draw_base.int())
    with pytest.raises(ValueError, match="expected"):
        L.layered_sample(params._replace(thickness=params.thickness[:32]),
                         wo, draw_base)


def test_coat_frame_with_plain_twin_bit_for_bit(card, monkeypatch):
    """A small bunny frame through render_accumulated(spp_chunk=1): the
    same image with the kernel and with the plain twins routed in."""
    scene = get_test_scene("coated_diffuse_bunny").scene_func()
    scene.camera = scene.camera.with_resolution(48, 40)
    s = RaytracerSettings(samples_per_pixel=2, light_sample_count=4,
                          max_ray_depth=8)
    launched = _n(COAT["eval"])
    a = render_accumulated(scene, s, spp_chunk=1)
    assert _n(COAT["eval"]) > launched
    monkeypatch.setattr(D, "layered_eval", L.layered_eval_plain)
    monkeypatch.setattr(D, "layered_sample", L.layered_sample_plain)
    b = render_accumulated(scene, s, spp_chunk=1)
    assert a.beauty.mean() > 0 and a.rays_traced == b.rays_traced
    np.testing.assert_array_equal(a.beauty.view(np.int32),
                                  b.beauty.view(np.int32))


# ---------------------------------------- the shading kernel (other kinds)

SHADE_KINDS = (0, 1, 2, 3, 4, 5)
SHADE_CFG = SamplerConfig("independent", seed=3)


def _shade_lanes(n, seed, kinds=SHADE_KINDS, edge=0.05):
    params, wo, wi, stream = bsdf_lanes(n, seed, kinds, edge)
    return (TB.BsdfParams(*(x.cuda() for x in params)), wo.cuda(), wi.cuda(),
            type(stream)(*(x.cuda() for x in stream)))


def _shade_sample_same(params, wo, stream, kinds=SHADE_KINDS,
                       active=None) -> bool:
    """The kernel's sample against the plain twins', at the one `allowed`
    the kernel takes (ALL_COMPONENTS, the integrator's)."""
    got, gs = D.bsdf_sample(params, wo, TB.ALL_COMPONENTS, SHADE_CFG, stream,
                            kinds, active)
    want, ws = D.bsdf_sample_plain(params, wo, TB.ALL_COMPONENTS, SHADE_CFG,
                                   stream, kinds, active)
    return _same_bits((*got, *gs), (*want, *ws))


@pytest.fixture(scope="module")
def rough_pass(card):
    """Every BSDF dispatch call of one 1-spp 500x500 rough_dielectric pass
    (COAT_SETTINGS: the benchmark's lane counts), its inputs as the
    integrator hands them over."""
    scene = get_test_scene("rough_dielectric").scene_func()
    return shade_calls(scene, RaytracerSettings(**COAT_SETTINGS))


def _pass_calls(rough_pass, kind: str) -> list:
    calls = [c[1:] for c in rough_pass if c[0] == kind]
    assert calls
    return calls


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed", "pass"])
def test_shade_sample_kernel_vs_plain(rough_pass, kind):
    """Seeded lanes of one kind or of all, and every sample call of one
    rough_dielectric pass; a launch a call."""
    if kind == "pass":
        calls = _pass_calls(rough_pass, "sample")
    else:
        kinds = SHADE_KINDS if kind == "mixed" else (kind,)
        params, wo, _, stream = _shade_lanes(16385, 7, kinds)
        calls = [(params, wo, TB.ALL_COMPONENTS, SHADE_CFG, stream,
                  SHADE_KINDS, None)]
    launched = _n(SHADE["sample"])
    for args in calls:
        got, gs = D.bsdf_sample(*args)
        want, ws = D.bsdf_sample_plain(*args)
        assert _same_bits((*got, *gs), (*want, *ws)), args[1].shape[0]
    assert _n(SHADE["sample"]) == launched + len(calls)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed", "pass"])
def test_shade_eval_kernel_vs_plain(rough_pass, kind):
    """As the sample test, for the eval calls."""
    if kind == "pass":
        calls = _pass_calls(rough_pass, "eval")
    else:
        kinds = SHADE_KINDS if kind == "mixed" else (kind,)
        params, wo, wi, _ = _shade_lanes(16385, 8, kinds)
        calls = [(params, wo, wi, SHADE_KINDS, None)]
    launched = _n(SHADE["eval"])
    for args in calls:
        got = D.bsdf_eval(*args)
        assert _same_bits(got, D.bsdf_eval_plain(*args)), args[1].shape[0]
        if kind in (1, 2):  # delta BSDFs evaluate to zero
            assert not bool(got.any())
    assert _n(SHADE["eval"]) == launched + len(calls)


def test_shade_edge_directions(card):
    """Every wo and wi on an edge direction: the poles, wo.z = 0 and
    +-1e-7, below the surface (total internal reflection in the
    dielectrics, a hit from inside the conductors), across all kinds, with
    the callers' kinds narrowed too."""
    params, wo, wi, stream = _shade_lanes(4099, 9, edge=1.0)
    assert bool((wo[:, 2] == 0).any()) and bool((wo[:, 2] < 0).any())
    for kinds in (SHADE_KINDS, (0, 3), (4,), (0, 5), ()):
        assert _shade_sample_same(params, wo, stream, kinds), kinds
        assert _same_bits(D.bsdf_eval(params, wo, wi, kinds),
                          D.bsdf_eval_plain(params, wo, wi, kinds)), kinds
    tir = (params.kind == 1) & ~D.bsdf_sample_plain(
        params, wo, TB.TRANSMISSION, SHADE_CFG, stream, SHADE_KINDS)[0].valid
    assert bool(tir.any())


def test_shade_coated_lanes_and_active(card):
    """Coated lanes among the others: the kernel leaves them null, the coat
    kernel writes those the caller consumes (once in each of the two
    paths)."""
    params, wo, wi, stream = _shade_lanes(8193, 10)
    act = torch.from_numpy(np.random.default_rng(10).random(8193) < 0.5).cuda()
    launched = _n(COAT["sample"])
    assert _shade_sample_same(params, wo, stream, active=act)
    assert _n(COAT["sample"]) == launched + 2
    assert _same_bits(D.bsdf_eval(params, wo, wi, SHADE_KINDS, act),
                      D.bsdf_eval_plain(params, wo, wi, SHADE_KINDS, act))


def test_shade_repeats_bit_for_bit(card):
    params, wo, wi, stream = _shade_lanes(4097, 11)

    def run():
        s, st = D.bsdf_sample(params, wo, TB.ALL_COMPONENTS, SHADE_CFG,
                              stream, SHADE_KINDS)
        return (*s, D.bsdf_eval(params, wo, wi, SHADE_KINDS))

    first = run()
    for _ in range(2):
        assert _same_bits(run(), first)


def test_shade_empty_call_launches_nothing(card):
    params, wo, wi, stream = _shade_lanes(8, 12)
    none = TB.BsdfParams(*(x[:0] for x in params))
    s0 = type(stream)(*(x[:0] for x in stream))
    launched = (_n(SHADE["eval"]), _n(SHADE["sample"]))
    f = D.bsdf_eval(none, wo[:0], wi[:0], SHADE_KINDS)
    s, st = D.bsdf_sample(none, wo[:0], TB.ALL_COMPONENTS, SHADE_CFG, s0,
                          SHADE_KINDS)
    assert f.shape == (0, 3) and s.wi.shape == (0, 3) and s.valid.shape == (0,)
    assert (_n(SHADE["eval"]), _n(SHADE["sample"])) == launched


def test_shade_rejects_what_the_kernel_does_not_take(card):
    params, wo, wi, stream = _shade_lanes(64, 13)
    with pytest.raises(ValueError, match="expected"):
        D.bsdf_eval(params, wo, wi.double(), SHADE_KINDS)
    with pytest.raises(ValueError, match="expected"):
        D.bsdf_eval(params, wo, wi[:, :2], SHADE_KINDS)
    with pytest.raises(ValueError, match="expected"):
        D.bsdf_eval(params, wo, wi.cpu(), SHADE_KINDS)
    with pytest.raises(ValueError, match="expected"):
        D.bsdf_eval(params._replace(kind=params.kind.long()), wo, wi,
                    SHADE_KINDS)
    with pytest.raises(ValueError, match="expected"):
        D.bsdf_sample(params._replace(kappa=params.kappa[:32]), wo,
                      TB.ALL_COMPONENTS, SHADE_CFG, stream, SHADE_KINDS)
    for allowed in (torch.tensor(TB.ALL_COMPONENTS), TB.REFLECTION,
                    TB.TRANSMISSION, TB.SPECULAR, 0):
        with pytest.raises(ValueError, match="allowed"):
            D.bsdf_sample(params, wo, allowed, SHADE_CFG, stream, SHADE_KINDS)


@pytest.mark.parametrize("name", ["rough_dielectric", "rough_metal"])
def test_shade_frame_with_plain_twins_bit_for_bit(card, monkeypatch, name):
    """A small frame through render_accumulated(spp_chunk=1): the same
    image with the kernel and with the plain twins routed in."""
    scene = get_test_scene(name).scene_func()
    scene.camera = scene.camera.with_resolution(48, 40)
    s = RaytracerSettings(samples_per_pixel=2, light_sample_count=4,
                          max_ray_depth=8)
    launched = (_n(SHADE["eval"]), _n(SHADE["sample"]))
    a = render_accumulated(scene, s, spp_chunk=1)
    assert _n(SHADE["eval"]) > launched[0]
    assert _n(SHADE["sample"]) > launched[1]
    monkeypatch.setattr(R, "bsdf_eval", D.bsdf_eval_plain)
    monkeypatch.setattr(R, "bsdf_sample", D.bsdf_sample_plain)
    b = render_accumulated(scene, s, spp_chunk=1)
    assert a.beauty.mean() > 0 and a.rays_traced == b.rays_traced
    np.testing.assert_array_equal(a.beauty.view(np.int32),
                                  b.beauty.view(np.int32))


# ------------------------------------------------------- hit_details kernel

HIT = ("tpu_rt_hit_details", "")


def _hit_scene(name, tmp_path_factory):
    """A scene of each hit_details branch: rough_dielectric's triangles
    and sphere at the benchmark's 500x500; the bunny's shading-normal
    triangles, the four-bunny instanced glTF and the textured cubes' uv
    corners smaller."""
    if name == "bunnies":
        path = tmp_path_factory.mktemp("hit") / "bunnies.glb"
        bunnies_glb(path, instanced=True)
        scene = scene_from_file(str(path))
    elif name == "textured":
        return textured_cubes(160)
    else:
        scene = get_test_scene(name).scene_func()
    if name != "rough_dielectric":
        scene.camera = scene.camera.with_resolution(160, 160)
    return scene


@pytest.fixture(scope="module")
def hit_passes(card, tmp_path_factory):
    """name -> (every hit_details call of one 1-spp pass at the benchmark's
    depth and light samples, the kernel launches the pass took)."""
    out = {}
    for name in ("rough_dielectric", "coated_diffuse_bunny", "bunnies",
                 "textured"):
        scene = _hit_scene(name, tmp_path_factory)
        launched = _n(HIT)
        calls = hit_calls(scene, RaytracerSettings(**COAT_SETTINGS))
        out[name] = (calls, _n(HIT) - launched)
    return out


def _hit_same(ds, *lanes) -> list:
    """The fields where the kernel's Hit differs from the plain twin's on
    the card, bit for bit; one launch a call."""
    launched = _n(HIT)
    got = TT.hit_details(ds, *lanes)
    assert _n(HIT) == launched + 1
    want = TT.hit_details_plain(ds, *lanes)
    assert got.prim is lanes[3]
    return [f for f, a, b in zip(TT.Hit._fields, got, want)
            if not _same_bits(a, b)]


@pytest.mark.parametrize("name", ["rough_dielectric", "coated_diffuse_bunny",
                                  "bunnies", "textured"])
def test_hit_kernel_vs_plain(hit_passes, name):
    """Every call of a pass, field by field and bit for bit; the pass's
    bounces all went through the kernel, one launch each."""
    calls, launches = hit_passes[name]
    assert calls and launches == len(calls)
    if name == "rough_dielectric":
        assert len(calls) == COAT_SETTINGS["max_ray_depth"] + 1
    ds = calls[0][0]
    kinds = {"sphere": 0, "instance": 0, "miss": 0}
    for ds, *lanes in calls:
        prim = lanes[3]
        kinds["miss"] += int((prim < 0).sum())
        if ds.meta.n_spheres:
            kinds["sphere"] += int(((prim >= ds.meta.n_tris)
                                    & (prim < ds.meta.inst_vtri_base0)).sum())
        if ds.meta.instances:
            kinds["instance"] += int((prim >= ds.meta.inst_vtri_base0).sum())
        assert _hit_same(ds, *lanes) == [], prim.shape[0]
    assert kinds["miss"] > 0
    assert (kinds["sphere"] > 0) == (name == "rough_dielectric")
    assert (kinds["instance"] > 0) == (name == "bunnies")


@pytest.mark.parametrize("n", [1, 255, 4099])
def test_hit_kernel_padded_tail(hit_passes, n):
    """A bounce's lanes cut to n, then a tail of 37 misses (prim -1, t
    inf), as a padded chunk hands them over."""
    ds, o, d, t, prim = hit_passes["rough_dielectric"][0][1]
    dev = o.device
    tail = 37
    lanes = (torch.cat([o[:n], torch.zeros(tail, 3, device=dev)]),
             torch.cat([d[:n], torch.ones(tail, 3, device=dev)]),
             torch.cat([t[:n], torch.full((tail,), float("inf"),
                                          device=dev)]),
             torch.cat([prim[:n], torch.full((tail,), -1, dtype=torch.int32,
                                             device=dev)]))
    assert _hit_same(ds, *lanes) == []
    got = TT.hit_details(ds, *lanes)
    assert not bool(got.hit[n:].any())
    assert bool((got.light[n:] == -1).all())


def _hit_table_variant(ds, variant: str):
    """ds with every tri_shade row made one way: "no_normals" (has_n 0,
    so the geometric normal), "degenerate_uv" (has_uv 1 and one uv at the
    three corners, so det 0 and zero dpdu, dpdv)."""
    rows = ds.tri_shade.clone()
    ints = rows.view(torch.int32)
    if variant == "no_normals":
        ints[:, 26] = 0
    else:
        ints[:, 27] = 1
        rows[:, 18:24] = torch.tensor([0.25, 0.5] * 3, device=rows.device)
    return dataclasses.replace(ds, tri_shade=rows)


@pytest.mark.parametrize("variant", ["no_normals", "degenerate_uv"])
@pytest.mark.parametrize("name", ["rough_dielectric", "bunnies"])
def test_hit_kernel_table_variants(hit_passes, name, variant):
    """The first two bounces of a pass over the scene's rows without
    shading normals, or with a degenerate uv triangle."""
    for ds, *lanes in hit_passes[name][0][:2]:
        assert _hit_same(_hit_table_variant(ds, variant), *lanes) == []


def test_hit_kernel_empty_call_launches_nothing(hit_passes):
    ds, *lanes = hit_passes["rough_dielectric"][0][0]
    launched = _n(HIT)
    got = TT.hit_details(ds, *(x[:0] for x in lanes))
    assert got.uv.shape == (0, 2) and got.point.shape == (0, 3)
    assert _n(HIT) == launched


@pytest.mark.parametrize("name", ["rough_dielectric", "bunnies"])
def test_hit_frame_with_plain_twin_bit_for_bit(card, tmp_path_factory,
                                               monkeypatch, name):
    """A small frame through render_accumulated(spp_chunk=1): the same
    image with the kernel and with the plain twin routed in."""
    scene = _hit_scene(name, tmp_path_factory)
    scene.camera = scene.camera.with_resolution(48, 40)
    s = RaytracerSettings(samples_per_pixel=2, light_sample_count=4,
                          max_ray_depth=8)
    launched = _n(HIT)
    a = render_accumulated(scene, s, spp_chunk=1)
    assert _n(HIT) > launched
    monkeypatch.setattr(R, "hit_details", TT.hit_details_plain)
    b = render_accumulated(scene, s, spp_chunk=1)
    assert a.beauty.mean() > 0 and a.rays_traced == b.rays_traced
    np.testing.assert_array_equal(a.beauty.view(np.int32),
                                  b.beauty.view(np.int32))
