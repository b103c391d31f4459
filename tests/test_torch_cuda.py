"""The CUDA bvh8t walk on the card, against its plain PyTorch version.

Marked `cuda`: the kernel has no CPU mode, so these tests skip without a
card. This file imports no jax (the machine with the card has none), so
it runs there on its own:

    python3 -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from tpu_raytracing.accel import build_bvh
from tpu_raytracing.scene.test_scenes import get_test_scene
from tpu_raytracing.settings import RaytracerSettings
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.device import scene_buffers as SB
from tpu_raytracing_torch.integrator.render import render
from tpu_raytracing_torch.ops.traverse_bvh8t import (
    intersect_tris_bvh8t, intersect_tris_plain, reset_launch_counts,
)

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bvh8t walk is a CUDA kernel")
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
    tk, bk, tp, bp = (x.cpu().numpy() for x in (tk, bk, tp, bp))
    act = args[4].cpu().numpy()
    assert np.all(bk[~act] == -1)
    if early_exit:
        np.testing.assert_array_equal(bk >= 0, bp >= 0)
        return
    diff = bk != bp
    ties = diff & (bk >= 0) & (bp >= 0) & (tk == tp)
    assert not (diff & ~ties).any()
    assert ties.sum() <= 1e-4 * n
    np.testing.assert_allclose(tk[bk >= 0], tp[bk >= 0], rtol=1e-5)


@pytest.mark.parametrize("width", [8, 32])
def test_kernel_other_widths(cuda_scene, width):
    """The W=8 and W=32 instantiations on tables of those widths."""
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
    g = render(scene, s, "cuda")
    assert min(intersect_tris_bvh8t.launches.values()) > 0
    c = render(scene, s, "cpu")
    assert np.isfinite(g.beauty).all() and g.beauty.mean() > 0
    assert abs(g.rays_traced - c.rays_traced) <= 0.005 * c.rays_traced
    np.testing.assert_allclose(g.beauty.mean(), c.beauty.mean(), rtol=0.01)
