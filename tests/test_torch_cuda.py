"""The CUDA walks and probes on the card, against their plain PyTorch
versions.

Marked `cuda`: the kernels have no CPU mode, so these tests skip without a
card. This file imports no jax and nothing of the JAX package (the machine
with the card has no jax), so it runs there on its own:

    python3 -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from tpu_raytracing_torch.accel import build_bvh
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.device import scene_buffers as SB
from tpu_raytracing_torch.integrator.render import render
from tpu_raytracing_torch.ops import traverse_kernels as TK
from tpu_raytracing_torch.ops.traverse_bvh8t import (
    intersect_tris_bvh8t, intersect_tris_plain,
)
from tpu_raytracing_torch.ops.traverse_kernels import reset_launch_counts
from tpu_raytracing_torch.probes import bf16_vpu as P4
from tpu_raytracing_torch.probes import iter_cost as P3
from tpu_raytracing_torch.probes import reset_launch_counts as reset_probes
from tpu_raytracing_torch.probes import slab_cost as P2
from tpu_raytracing_torch.probes import walk_cost as P1
from tpu_raytracing_torch.scene.test_scenes import get_test_scene
from tpu_raytracing_torch.settings import RaytracerSettings

from chip_smoke import bunnies_glb, emissive_box, textured_cubes

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

# kernel wrapper and its plain version, per walk of the kernel switch
WALKS = {
    "brute": (TK.intersect_tris_brute, TK.intersect_tris_brute_plain),
    "quad": (TK.intersect_tris_quad, TK.intersect_tris_quad_plain),
    "quadrow": (TK.intersect_tris_quadrow,
                lambda *a: TK.intersect_tris_quad_plain(*a, rowrec=True)),
    "pair": (TK.intersect_tris_pair, intersect_tris_plain),
    "walk": (TK.intersect_tris_skiplink, TK.intersect_tris_skiplink_plain),
}


@pytest.fixture(scope="module")
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the walks are CUDA kernels")
    scene = get_test_scene("coated_diffuse_bunny").scene_func()
    return compile_scene(scene, "cuda")


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
def test_kernel_vs_plain(cuda_scene, early_exit):
    ds = cuda_scene
    n = 65536
    args = _rays(ds, n, 16, early_exit)
    reset_launch_counts()
    tk, bk = intersect_tris_bvh8t(ds, *args, early_exit)
    mode = "any_hit" if early_exit else "closest_hit"
    assert intersect_tris_bvh8t.launches[mode] == 1
    tp, bp = intersect_tris_plain(ds, *args, early_exit)
    torch.cuda.synchronize()
    _assert_agree(tk, bk, tp, bp, args[4].cpu().numpy(), early_exit)


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
@pytest.mark.parametrize("walk", list(WALKS))
def test_walk_kernel_vs_plain(cuda_scene, walk, early_exit):
    """K3-K6 on 16,384 random rays; the brute kernel bit for bit."""
    ds = cuda_scene
    kernel, plain = WALKS[walk]
    args = _rays(ds, 16384, 18, early_exit)
    reset_launch_counts()
    tk, bk = kernel(ds, *args, early_exit)
    mode = "any_hit" if early_exit else "closest_hit"
    assert kernel.launches[mode] == 1
    tp, bp = plain(ds, *args, early_exit)
    torch.cuda.synchronize()
    _assert_agree(tk, bk, tp, bp, args[4].cpu().numpy(), early_exit,
                  exact=walk in ("brute", "quad", "quadrow"))


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


def test_render_on_card_matches_cpu(cuda_scene):
    """A 64x64 bunny frame on cuda (through the kernel) and on cpu: frame
    mean within 1% and rays_traced within 0.5% (chip_smoke.py phase 5
    states why pixels agree only in distribution)."""
    scene = get_test_scene("coated_diffuse_bunny").scene_func()
    scene.camera = scene.camera.with_resolution(64, 64)
    s = RaytracerSettings(samples_per_pixel=2, light_sample_count=1,
                          max_ray_depth=8)
    reset_launch_counts()
    g = render(scene, s)
    assert min(intersect_tris_bvh8t.launches.values()) > 0
    c = render(scene, s, "cpu")
    assert np.isfinite(g.beauty).all() and g.beauty.mean() > 0
    assert abs(g.rays_traced - c.rays_traced) <= 0.005 * c.rays_traced
    np.testing.assert_allclose(g.beauty.mean(), c.beauty.mean(), rtol=0.01)


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
    mode = "any_hit" if early_exit else "closest_hit"
    assert intersect_tris_bvh8t.launches[mode] == 1
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


def test_dielectric_block_cuda_vs_cpu():
    """A 256-pixel block on the glass sphere at 2 spp (the block of
    tests/test_torch_render_materials.py), on cuda through the kernels and
    on cpu: rays_traced within 0.5%, the mean within 1%, and at least 90% of
    pixels within rtol 1e-3 (chip_smoke.py phase 7 states the share it
    measures on its 1,024-pixel blocks)."""
    from tpu_raytracing_torch.integrator.render import (
        StaticSettings, _pixel_grid, render_beauty_chunk,
    )
    from tpu_raytracing_torch.ops.rng import SamplerConfig

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the walk is a CUDA kernel")
    ts = get_test_scene("dielectric")
    scene = ts.scene_func()
    s = dataclasses.replace(ts.settings_func(), samples_per_pixel=2)
    cfg = SamplerConfig.from_settings(s.sampler, s.seed)
    st = StaticSettings.from_settings(s)
    px, py, _ = _pixel_grid(500, 500)
    start = int(np.nonzero((px == 192) & (py == 288))[0][0])
    sel = slice(start, start + 256)
    res = {}
    reset_launch_counts()
    for dev in ("cuda", "cpu"):
        r, n = render_beauty_chunk(
            compile_scene(scene, dev), cfg, st,
            torch.from_numpy(px[sel].astype(np.int64)).to(dev),
            torch.from_numpy(py[sel].astype(np.int64)).to(dev),
            torch.ones(256, dtype=torch.bool, device=dev))
        res[dev] = (r.cpu().numpy(), int(n))
    assert min(intersect_tris_bvh8t.launches.values()) > 0
    (g, ng), (c, nc) = res["cuda"], res["cpu"]
    assert np.isfinite(g).all() and c.mean() > 0
    assert abs(ng - nc) <= 0.005 * nc
    np.testing.assert_allclose(g.mean(axis=0), c.mean(axis=0), rtol=0.01)
    close = np.all(np.abs(g - c) <= 1e-3 * np.abs(c) + 1e-6, axis=-1)
    assert close.mean() >= 0.90, close.mean()


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
    assert intersect_tris_bvh8t.launches["any_hit"] == 1
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
    assert intersect_tris_bvh8t.launches["closest_hit"] > 0
    assert intersect_tris_bvh8t.launches["any_hit"] == 0
    c = render(scene, s, "cpu")
    assert np.isfinite(g.beauty).all() and g.beauty.mean() > 0
    assert abs(g.rays_traced - c.rays_traced) <= 0.005 * c.rays_traced
    np.testing.assert_allclose(g.beauty.mean(), c.beauty.mean(), rtol=0.01)


@pytest.fixture(scope="module")
def bunnies(tmp_path_factory):
    """chip_smoke.py's glTF scenes: four bunnies over one BLAS, and the
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
    mode = "any_hit" if early_exit else "closest_hit"
    assert kernel.launches[mode] == 1
    tp, bp = plain(blas, *args, early_exit)
    torch.cuda.synchronize()
    assert (bp >= 0).sum() > 1000
    _assert_agree(tk, bk, tp, bp, args[4].cpu().numpy(), early_exit,
                  exact=walk in ("brute", "quad", "quadrow"))


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
        n = dict(intersect_tris_bvh8t.launches)
        per = 5 if instanced else 1
        assert n["closest_hit"] % per == 0 and n["closest_hit"] > 0
        assert n["any_hit"] == n["closest_hit"], n
    assert imgs[True].mean() > 0 and np.isfinite(imgs[True]).all()
    mse = float(np.mean((imgs[True] - imgs[False]) ** 2))
    assert mse < 1e-6, mse


# the probes: the plain versions run op by op, so they are compared at a
# small count, one of fori's compiled trip counts (chip_smoke.py compares
# them at the scripts' counts)
PROBE_ITERS = 256


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probes are CUDA kernels")


@pytest.mark.parametrize("small_ids", [False, True], ids=["script", "small_ids"])
@pytest.mark.parametrize("config", P3.CONFIGS, ids=P3.label)
def test_iter_cost_kernel_vs_plain(card, config, small_ids):
    """P3 bit for bit, and the same number of iterations run."""
    ins = P3.script_inputs("cuda", small_ids)
    ck, cp = (torch.zeros(1, dtype=torch.int32, device="cuda")
              for _ in range(2))
    reset_probes()
    got = P3.iter_cost(*ins, *config, PROBE_ITERS, counts=ck)
    assert P3.iter_cost.launches[P3.label(config)] == 1
    want = P3.iter_cost_plain(*ins, *config, PROBE_ITERS, counts=cp)
    torch.cuda.synchronize()
    assert torch.isfinite(want).any() and not torch.isfinite(want).all()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int(ck.item()) == int(cp.item())


@pytest.mark.parametrize("dtype", list(P4.DTYPES))
def test_bf16_vpu_kernel_vs_plain(card, dtype):
    """P4 bit for bit in both types."""
    box, ray = P4.script_inputs("cuda")[dtype]
    reset_probes()
    got = P4.bf16_vpu(box, ray, PROBE_ITERS)
    assert P4.bf16_vpu.launches[dtype] == 1
    want = P4.bf16_vpu_plain(box, ray, PROBE_ITERS)
    torch.cuda.synchronize()
    assert torch.isfinite(want).all()
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


def _record_equal(run_kernel, run_plain):
    """Kernel and plain version bit for bit: output, stats (visits run, the
    drains' fold) and every visit's drained mask."""
    vk, vp = (torch.full((PROBE_ITERS,), -7, dtype=torch.int32, device="cuda")
              for _ in range(2))
    got, sk = run_kernel(vk)
    want, sp = run_plain(vp)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(sk, sp) and torch.equal(vk, vp)
    assert 0 < int(sp[0]) <= PROBE_ITERS
    return want, vp[:int(sp[0])]


@pytest.mark.parametrize("inputs", ["script", "varied"])
@pytest.mark.parametrize("variant", P2.VARIANTS)
def test_slab_cost_kernel_vs_plain(card, variant, inputs):
    """P2 bit for bit, visit by visit."""
    ins = _inputs(P2, inputs)
    reset_probes()
    _, seq = _record_equal(
        lambda v: P2.slab_cost(*ins, variant, PROBE_ITERS, visits=v),
        lambda v: P2.slab_cost_plain(*ins, variant, PROBE_ITERS, visits=v))
    assert P2.slab_cost.launches[variant] == 1
    if inputs == "varied":
        assert len(set(seq.tolist())) > 1


@pytest.mark.parametrize("inputs", ["script", "varied"])
@pytest.mark.parametrize("level", P1.LEVELS)
def test_walk_cost_kernel_vs_plain(card, level, inputs):
    """P1 bit for bit, visit by visit; the leaf levels find hits."""
    ins = _inputs(P1, inputs)
    reset_probes()
    want, seq = _record_equal(
        lambda v: P1.walk_cost(*ins, level, PROBE_ITERS, visits=v),
        lambda v: P1.walk_cost_plain(*ins, level, PROBE_ITERS, visits=v))
    assert P1.walk_cost.launches[level] == 1
    assert len(seq) == PROBE_ITERS and len(set(seq.tolist())) > 1
    fin = torch.isfinite(want)
    assert bool(fin.any()) == level.endswith("50")


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
