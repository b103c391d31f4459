"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result):

1. card: `nvidia-smi` name and power limit, and torch's device name;
2. build: the CUDA kernels from tpu_raytracing_torch/csrc (nvcc, sm_90a);
3. kernel vs plain: the bvh8t walk against its plain PyTorch version on the
   same CUDA tensors, on the coated_diffuse_bunny tables: closest-hit on
   65,536 random rays plus the frame's camera rays, any-hit on random rays
   plus the frame's shadow rays; both timed at the path's shape;
4. full frame: render coated_diffuse_bunny at 500x500, 8 spp, depth 8 and
   one light sample on cuda, through the kernel (launch counts reset just
   before, read just after);
5. slice parity: two blocks of 4,096 Morton-order pixels (2 spp, depth 8),
   one of walls and floor and one mostly on the bunny, on cuda with the
   kernel against cpu with the plain versions.

The last two lines are {"kernels": [...]} and {"ok": true, "device": ...}.
Needs one CUDA device; the port never imports jax.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

SCENE = "coated_diffuse_bunny"
KERNEL_SOURCE = "tpu_raytracing_torch/csrc/bvh8t_walk.cu"
KERNEL_REPLACES = "tpu_raytracing/ops/traverse_pallas.py:931"  # _t8_kernel
N_RANDOM_RAYS = 65536
PARITY_PIXELS = 4096
# closest-hit: equal-t ties between different leaves may pick different
# triangles (the kernel and the plain walk visit leaves in another order)
MAX_TIE_FRACTION = 1e-4
T_RTOL = 1e-5
# slice parity. Both devices draw the same random numbers and trace the
# same camera rays bit for bit; they differ in the last bits of sin, cos,
# exp and log1p, and the card computes x / scalar as x * (1 / scalar). A
# path keeps its branches unless such a bit flips a comparison, so most
# pixels agree to ~1e-6. The coated BSDF's evaluation, however, hashes the
# bit patterns of (wo, wi) into its random stream (ops/layered.py), so once
# a bounce direction differs in a last bit, every later coat evaluation
# draws a different, equally valid estimate: on the bunny those pixels
# agree in distribution only (measured on the H100: 99.29% of wall pixels
# and 93.77% of the bunny block within rtol 1e-3, means within 5e-5).
PARITY_BLOCKS = {  # Morton offset -> least share of pixels within rtol
    "walls and floor": (125000, 0.98),
    "65% bunny": (147456, 0.90),
}
PARITY_MEAN_RTOL = 0.01
PARITY_PIXEL_RTOL = 1e-3
PARITY_RAYS_RTOL = 0.005


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds per call over `reps` calls, by CUDA events."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_rays(ds, n: int, seed: int, device):
    """tests/test_pallas_traverse.py::_rays on the port's scene."""
    rng = np.random.default_rng(seed)
    c = ds.bounds_center.cpu().numpy()
    r = float(ds.bounds_radius)
    o = (c[None, :] + rng.normal(0, 0.15, (n, 3)) * r).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


def phase_kernel(ds, settings) -> dict:
    """Kernel vs plain in both modes; returns per-mode stats."""
    from tpu_raytracing_torch.integrator.render import _pixel_grid
    from tpu_raytracing_torch.ops.camera_rays import generate_rays
    from tpu_raytracing_torch.ops.light_sampling import sample_light
    from tpu_raytracing_torch.ops.rng import SamplerConfig, make_stream
    from tpu_raytracing_torch.ops.traverse import intersect_scene
    from tpu_raytracing_torch.ops.traverse_bvh8t import (
        intersect_tris_bvh8t, intersect_tris_plain,
    )

    dev = ds.device
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    px, py, _ = _pixel_grid(ds.meta.width, ds.meta.height)
    px = torch.from_numpy(px.astype(np.int64)).to(dev)
    py = torch.from_numpy(py.astype(np.int64)).to(dev)
    stream = make_stream(px, py, 0)
    cam_o, cam_d, _, _ = generate_rays(ds, px, py, cfg, stream,
                                       settings.samples_per_pixel, True)
    n_cam = cam_o.shape[0]
    full = lambda n, v: torch.full((n,), v, dtype=torch.float32, device=dev)  # noqa: E731
    yes = lambda n: torch.ones(n, dtype=torch.bool, device=dev)  # noqa: E731

    # shadow rays of the frame's primary hits toward the point light
    t_cam, prim = intersect_scene(ds, cam_o, cam_d, full(n_cam, ds.meta.near_clip),
                                  full(n_cam, ds.meta.far_clip))
    point = cam_o + t_cam[:, None] * cam_d
    ls, _ = sample_light(ds, 0, torch.where((prim >= 0)[:, None], point, 0.0),
                         cfg, stream)
    sh_o, sh_d = ls.origin.contiguous(), ls.direction.contiguous()
    sh_tmin, sh_tmax, sh_act = full(n_cam, 1e-3), ls.distance - 1e-3, prim >= 0

    ro, rd = random_rays(ds, N_RANDOM_RAYS, 3, dev)
    so, sd = random_rays(ds, N_RANDOM_RAYS, 4, dev)
    batches = {
        "closest_hit": (
            torch.cat([ro, cam_o]), torch.cat([rd, cam_d]),
            torch.cat([full(N_RANDOM_RAYS, 1e-3), full(n_cam, ds.meta.near_clip)]),
            torch.cat([full(N_RANDOM_RAYS, float("inf")),
                       full(n_cam, ds.meta.far_clip)]),
            yes(N_RANDOM_RAYS + n_cam), False),
        "any_hit": (
            torch.cat([so, sh_o]), torch.cat([sd, sh_d]),
            torch.cat([full(N_RANDOM_RAYS, 1e-3), sh_tmin]),
            torch.cat([full(N_RANDOM_RAYS, 10.0), sh_tmax]),
            torch.cat([yes(N_RANDOM_RAYS), sh_act]), True),
    }
    # the path's shapes: one frame of camera rays / of shadow rays
    path_shape = {
        "closest_hit": (cam_o, cam_d, full(n_cam, ds.meta.near_clip),
                        full(n_cam, ds.meta.far_clip), yes(n_cam), False),
        "any_hit": (sh_o, sh_d, sh_tmin, sh_tmax, sh_act, True),
    }
    stats = {}
    ok = True
    for mode, args in batches.items():
        tk, bk = intersect_tris_bvh8t(ds, *args)
        tp, bp = intersect_tris_plain(ds, *args)
        torch.cuda.synchronize()
        tk, bk, tp, bp = (x.cpu().numpy() for x in (tk, bk, tp, bp))
        n = bk.shape[0]
        if mode == "closest_hit":
            both = (bk >= 0) & (bp >= 0)
            diff = bk != bp
            ties = diff & both & (tk == tp)
            wrong = int((diff & ~ties).sum())
            err = float(np.max(np.abs(tk[both] - tp[both]))) if both.any() else 0.0
            t_ok = bool(np.allclose(tk[both], tp[both], rtol=T_RTOL, atol=0.0))
            mode_ok = wrong == 0 and ties.sum() < MAX_TIE_FRACTION * n and t_ok
            print(f"# {mode}: {n} rays, {int((bk >= 0).sum())} hits, "
                  f"{int(ties.sum())} equal-t ties, {wrong} other winner "
                  f"mismatches, max |dt| {err:.3g} (rtol {T_RTOL}): "
                  f"{'ok' if mode_ok else 'FAIL'}", flush=True)
        else:
            wrong = int(((bk >= 0) != (bp >= 0)).sum())
            err = float(wrong > 0)
            mode_ok = wrong == 0
            print(f"# {mode}: {n} rays, {int((bk >= 0).sum())} occluded, "
                  f"{wrong} hit-bit mismatches: {'ok' if mode_ok else 'FAIL'}",
                  flush=True)
        ok = ok and mode_ok
        shape = path_shape[mode]
        ms = time_ms(lambda: intersect_tris_bvh8t(ds, *shape), reps=20)
        plain_ms = time_ms(lambda: intersect_tris_plain(ds, *shape), reps=1,
                           warmup=False)
        print(f"# {mode} at the path's shape ({shape[0].shape[0]} rays): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms", flush=True)
        stats[mode] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    if not ok:
        raise AssertionError("kernel disagrees with its plain version")
    return stats


def phase_full_frame(scene, settings, card: str) -> dict:
    from tpu_raytracing_torch.integrator.render import render
    from tpu_raytracing_torch.ops.traverse_bvh8t import (
        intersect_tris_bvh8t, reset_launch_counts,
    )

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = render(scene, settings, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(intersect_tris_bvh8t.launches)
    img = out.beauty
    mean = float(img.mean())
    print(f"# full frame {img.shape[1]}x{img.shape[0]}, "
          f"{settings.samples_per_pixel} spp, depth {settings.max_ray_depth}: "
          f"{wall:.3f} s wall (scene compile included), {out.rays_traced} "
          f"rays, {out.rays_traced / wall / 1e6:.3f} Mrays/s on {card}; "
          f"mean {mean:.6g}; launches {launches}", flush=True)
    if not np.isfinite(img).all():
        raise AssertionError("non-finite beauty pixels")
    if not mean > 0.0:
        raise AssertionError("beauty mean is not positive")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel mode never launched: {launches}")
    return launches


def phase_parity(scene, settings) -> None:
    from tpu_raytracing_torch.device import compile_scene
    from tpu_raytracing_torch.integrator.render import (
        StaticSettings, _pixel_grid, render_beauty_chunk,
    )
    from tpu_raytracing_torch.ops.rng import SamplerConfig

    torch.set_num_threads(os.cpu_count() or 1)
    s = dataclasses.replace(settings, samples_per_pixel=2)
    cfg = SamplerConfig.from_settings(s.sampler, s.seed)
    st = StaticSettings.from_settings(s)
    px, py, _ = _pixel_grid(scene.camera.raster_width, scene.camera.raster_height)
    scenes = {dev: compile_scene(scene, dev) for dev in ("cuda", "cpu")}
    ok = True
    for name, (start, min_close) in PARITY_BLOCKS.items():
        sel = slice(start, start + PARITY_PIXELS)
        res = {}
        for dev, ds in scenes.items():
            t0 = time.perf_counter()
            r, n = render_beauty_chunk(
                ds, cfg, st,
                torch.from_numpy(px[sel].astype(np.int64)).to(dev),
                torch.from_numpy(py[sel].astype(np.int64)).to(dev),
                torch.ones(PARITY_PIXELS, dtype=torch.bool, device=dev))
            res[dev] = (r.cpu().numpy(), int(n), time.perf_counter() - t0)
        (g, ng, tg), (c, nc, tc) = res["cuda"], res["cpu"]
        close = np.all(np.abs(g - c) <= PARITY_PIXEL_RTOL * np.abs(c) + 1e-6,
                       axis=-1).mean()
        mean_rel = abs(float(g.mean()) - float(c.mean())) / abs(float(c.mean()))
        rays_rel = abs(ng - nc) / nc
        block_ok = (mean_rel <= PARITY_MEAN_RTOL and close >= min_close
                    and rays_rel <= PARITY_RAYS_RTOL and np.isfinite(g).all())
        ok = ok and block_ok
        print(f"# slice parity, {name} ({PARITY_PIXELS} pixels at {start}, "
              f"2 spp): mean cuda {g.mean():.6g} vs cpu {c.mean():.6g} (rel "
              f"{mean_rel:.2e}, limit {PARITY_MEAN_RTOL}); {close * 100:.2f}% "
              f"of pixels within rtol {PARITY_PIXEL_RTOL} (limit "
              f"{min_close * 100:.0f}%); rays {ng} vs {nc} (rel "
              f"{rays_rel:.2e}); cuda {tg:.2f} s, cpu {tc:.2f} s: "
              f"{'ok' if block_ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("slice parity outside its tolerance")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tpu_raytracing.scene.test_scenes import get_test_scene
    from tpu_raytracing.settings import AovFlags, RaytracerSettings
    from tpu_raytracing_torch import native_cuda
    from tpu_raytracing_torch.device import compile_scene

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"# card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; device 0: {name}", flush=True)

    path, secs, log = native_cuda.build()
    ptxas = [ln for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"# build: {path.name} in {secs:.2f} s", flush=True)
    for ln in ptxas:
        print(f"#   {ln.strip()}")
    native_cuda.load()

    scene = get_test_scene(SCENE).scene_func()
    settings = RaytracerSettings(
        samples_per_pixel=8, light_sample_count=1, max_ray_depth=8,
        outputs=AovFlags.BEAUTY,
    )
    failed = []
    stats = launches = None
    try:
        stats = phase_kernel(compile_scene(scene, "cuda"), settings)
    except Exception:
        traceback.print_exc()
        failed.append("kernel vs plain")
    try:
        launches = phase_full_frame(scene, settings, card)
    except Exception:
        traceback.print_exc()
        failed.append("full frame")
    try:
        phase_parity(scene, settings)
    except Exception:
        traceback.print_exc()
        failed.append("slice parity")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1

    kernels = [
        dict(name=f"bvh8t_walk<{mode}>", route="cuda", source=KERNEL_SOURCE,
             replaces=KERNEL_REPLACES, launches=launches[mode], **stats[mode])
        for mode in ("closest_hit", "any_hit")
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
