"""Check the PyTorch/CUDA port on one NVIDIA GPU where no card test does,
and time each kernel alone.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result):

1. card: `nvidia-smi` name and power limit, and torch's device name;
2. build: the CUDA kernels from tpu_raytracing_torch/csrc (nvcc, sm_90a,
   one nvcc per source, all started together), with ptxas's registers,
   spills and stack frame of every kernel;
3. card tests: `pytest -m cuda` over the port's card file
   (tests/test_torch_cuda.py) in a subprocess: every kernel against its
   plain version, bit for bit where it is, and the card's blocks against
   the CPU's;
4. frames: coated_diffuse_bunny at the bench path's settings (500x500,
   8 spp, depth 8, one light sample) and at its builtin ones (32 spp, 4
   light samples), the five beauty scenes with a sphere, checkered_plane
   and environment_light at theirs, native_cuda's launch counts reset
   just before each and read just after (every kernel of its path above
   0, no walk where there is no triangle, no any-hit walk where there is
   no light; the coat's, the shading and the hit_details kernels' launches
   in the bunny frames); the normals-only scenes (sphere, cube,
   cube_orthographic) and the textured cubes' albedo and mip-level AOVs at
   400x400 on cuda against cpu;
5. the kernel switch: the 500x500 frame at 1 spp, depth 8, rendered with
   bvh8t and then with each walk the JAX switch selects
   (TPU_RT_PALLAS_KERNEL, TPU_RT_BRUTE_GROUPS), only that walk launching,
   held against the bvh8t frame;
6. cli and scene files: a glTF file of the port's bunny mesh under four
   node transforms (four instances over one BLAS) on a two-triangle floor,
   with a camera node and a point light (tests/torch_fixtures.py::
   bunnies_glb), rendered by `tpu_raytracing_torch.cli` (`full
   --scene-path`, 600x600, 8 spp, depth 8, one light sample: two chunks),
   1 + 4 walks a query, 4 of them on the BLAS, as many any-hit launches as
   closest-hit; its EXR read back bit for bit; a 1,024-pixel block at 2 spp
   on cuda against cpu; `pixel` on cuda against cpu; and `--checkpoint
   --spp-chunk 3` against the one-shot frame;
7. rttest gate: the frames of phase 4 at the settings the port's committed
   references name (tpu_raytracing_torch/rttest/references: a digest of
   the JAX package's CPU renders, and the normals rows' EXRs), each held
   against its reference with the rttest harness's statistical gate at
   its default tolerances; then the harness itself, `python -m
   tpu_raytracing_torch.rttest cuda`, on one row through the CLI
   subprocess. One line a row, 12 rows; a FAIL fails the phase;
8. multi-gpu: the distributed driver (tpu_raytracing_torch/parallel) with
   a world of one rank through NCCL on a file:// store: render_distributed
   of tests/test_parallel.py's 37x27 checkered_plane (2 spp, depth 2)
   against render on the card; that frame split into 4 and 8 tiles, each
   tile's shard run through the per-rank function one after the other and
   assembled, against render; render_accumulated_distributed interrupted
   after its first chunk and resumed, against render_accumulated; the
   CLI's `full --multichip` started alone (one rank), its EXR read back,
   against render; then TPU_RT_DUMP_RAYS=1 on a 1,024-pixel block of the
   bench path (one batch a bvh8t launch, the kinds, a save/load round
   trip) and the block's time with the dump off and on. Every comparison
   is bit for bit. More than one rank runs only on the CPU
   (tests/test_torch_parallel.py);
9. kernel times: every kernel alone, each mean by CUDA events: the six
   walks in both modes at the path's shape (the bench frame's camera rays,
   their shadow rays: 20 launches), with the card's bound for the same
   work from the kernel's per-ray counters; the coat's kernels on every
   call of one 1-spp bunny pass and the shading kernels on every call of
   one 1-spp rough_dielectric pass (the benchmark's lane counts), with
   their bounds; the hit_details kernel on the bounce after the camera's
   of one 1-spp rough_dielectric pass and of one bunny pass, with its byte
   bound and its launches a pass; and the probes' mains (P1 at 4,096
   visits).

The last two lines are {"kernels": [...]} and {"ok": true, "device": ...},
with the card's name and power limit on a line before them. Needs one CUDA
device; the port imports neither jax nor the JAX package.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(1, os.path.join(ROOT, "tests"))

from torch_fixtures import (  # noqa: E402
    BUNNY_NODES, COAT_SETTINGS, bunnies_glb, coat_calls, hit_calls,
    path_rays, shade_calls, textured_cubes, tiny_frame,
)

SCENE = "coated_diffuse_bunny"
CSRC = "tpu_raytracing_torch/csrc/"
PALLAS = "tpu_raytracing/ops/traverse_pallas.py"
SWITCH = ("TPU_RT_PALLAS_KERNEL", "TPU_RT_BRUTE_GROUPS")
MODES = ("closest_hit", "any_hit")
# the JSON entries: name, walk, modes, source, the TPU kernel it replaces
KERNELS = (
    ("bvh8t_walk<closest_hit>", "bvh8t", ("closest_hit",), "bvh8t_walk.cu",
     ":931"),  # _t8_kernel
    ("bvh8t_walk<any_hit>", "bvh8t", ("any_hit",), "bvh8t_walk.cu", ":931"),
    ("t8_brute", "brute", MODES, "t8_brute.cu", ":1470"),  # _t8_brute_kernel
    ("quad_walk<quad>", "quad", MODES, "quad_walk.cu", ":494"),  # _quad_kernel
    ("quad_walk<quadrow>", "quadrow", MODES, "quad_walk.cu", ":494"),
    ("pair_walk", "pair", MODES, "pair_walk.cu", ":288"),  # _pair_kernel
    ("skip_walk", "walk", MODES, "skip_walk.cu", ":171"),  # _walk_kernel
)
WALK_NAMES = ("bvh8t", "brute", "quad", "quadrow", "pair", "walk")
# each walk's CUDA kernel, as ptxas names it
KERNEL_OF = {"bvh8t": "bvh8t_walk", "brute": "t8_brute", "quad": "quad_walk",
             "quadrow": "quad_walk", "pair": "pair_walk", "walk": "skip_walk"}
# the card's bound (H100 SXM datasheet peaks at 700 W): bytes
# over 3.35 TB/s or fp32 operations over 67 TFLOP/s, whichever is longer.
# Bytes: o, d, t_min, t_max, active in (33 B) and t, best out (8 B) per
# active ray; t_max, active in (5 B) and t, best out (8 B) per inactive
# ray, whose origin, direction and t_min no walk loads; plus the words of
# the scene tables the query needs (table_words).
# Operations, from the kernels' own counters, which count real triangles
# and real child boxes only: 24 per slab test (6 subtracts, 6 multiplies,
# 12 min/max) and 44 per Moller-Trumbore test (24 multiplies, 17 adds or
# subtracts, 3 divides).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
RAY_BYTES = 33 + 8
IDLE_RAY_BYTES = 5 + 8
SLAB_OPS = 24
MT_OPS = 44
# the coat kernel (csrc/layered_walk.cu) at one 1-spp bunny pass's calls
# (COAT_SETTINGS). Its bound counts, from the source, the f32 operations
# of a depth step a lane begins (the `steps` that ops/layered.py's
# `_eval_kernel` and `_sample_kernel` return) in its cheapest case: eval a
# step over a smooth coat's top (the flight 7, the transit 2, the smooth
# reflection 25, beta 9), sample a step on the bottom (the flight 7, the
# transit 2, the diffuse sample 12, f and pdf 7); divides, square roots
# and transcendentals count one
COAT_STEP_OPS = {"eval": 43, "sample": 28}
COAT_LANE_BYTES = {"eval": 88, "sample": 105}  # read once, written once
# the shading kernel (csrc/bsdf_kinds.cu) on one 1-spp pass of the
# rough_dielectric scene at the same settings; its bound is bytes, each
# lane's inputs read once and its outputs written once: kind, albedo, eta,
# kappa, the roughnesses and wo (60 B), then wi and f (eval) or the three
# draws and the sample (wi, f, pdf, component, valid)
SHADE_SCENE = "rough_dielectric"
SHADE_LANE_BYTES = {"eval": 60 + 12 + 12, "sample": 60 + 12 + 33}
# the hit_details kernel (csrc/hit_details.cu) on the same passes; its
# bound is a triangle lane's bytes: origin, direction, t and prim (32 B),
# the tri_shade row's first 28 words (112 B), the nine outputs (69 B)
HIT_KEY = ("tpu_rt_hit_details", "")
HIT_LANE_BYTES = 32 + 112 + 69
# the kernel switch: every walk finds the bvh8t walk's winners (t
# bit-equal) except on equal-t ties between leaves, so the frames are the
# same but for the pixels whose paths meet such a tie, and the coat
# streams those re-seed
SWITCH_RAYS_RTOL = 1e-3
SWITCH_MEAN_RTOL = 1e-3
SWITCH_PIXEL_RTOL = 1e-5
SWITCH_MIN_CLOSE = 0.99
# the builtin beauty scenes with a sphere, at their builtin settings
BEAUTY_SCENES = ("out_of_focus_sphere", "dielectric", "metal", "rough_metal",
                 "rough_dielectric")
# the textures and lights frames at their builtin settings: frame ->
# whether the any-hit walk launches (environment_light has no light)
TEXTURE_FRAMES = {"checkered_plane": True, "environment_light": False}
# the normals-only scenes: hit masks and normals (within AOV_ATOL) agree
# on at least AOV_MIN_SHARE of the pixels
AOV_SCENES = ("sphere", "cube", "cube_orthographic")
AOV_ATOL = 1e-5
AOV_MIN_SHARE = 0.999
TEXTURED_CUBES = 400  # the textured cubes' AOV frame, pixels a side
# the cli phase: the bench path's settings on the glTF frame; the first
# pixel of its 32x32 block held against cpu (all on the front-left bunny)
# and the pixel `pixel` replays; the block's least share within rtol 1e-3
# and its mean and rays limits, and the checkpointed frame's tolerance
# against the one-shot one (tests/test_accumulate.py's)
CLI_FLAGS = ("-s", "8", "-d", "8", "-l", "1")
CLI_BLOCK = (128, 320)
CLI_PIXEL = (144, 336)
CLI_MIN_CLOSE = 0.999
BLOCK_PIXELS = 1024
PIXEL_RTOL = 1e-3
MEAN_RTOL = 0.01
RAYS_RTOL = 0.005
CHECKPOINT_RTOL, CHECKPOINT_ATOL = 1e-5, 1e-6
# the probes: name, source, the Pallas probe it replaces, the key of its
# configurations and the one whose time heads its entry; P1 timed at
# P1_ITERS visits, not the script's 200,000
PROBE_KERNELS = (
    ("probe_iter_cost", "probe_iter_cost.cu", "scripts/probe_iter_cost.py:155",
     "config", None),
    ("probe_bf16_vpu", "probe_bf16_vpu.cu", "scripts/probe_bf16_vpu.py:56",
     "dtype", None),
    ("probe_slab_cost", "probe_slab_cost.cu", "scripts/probe_slab_cost.py:210",
     "variant", "cur"),
    ("probe_walk_cost", "probe_walk_cost.cu", "scripts/probe_walk_cost.py:240",
     "level", "cond50"),
)
P1_ITERS = 4096
# the rttest gate: the reference row of the bench frame, the rows of the
# builtin frames (their suite names), and the row the harness itself
# renders through the CLI subprocess
BENCH_ROW = "coated_diffuse_bunny_8spp"
GATE_ROWS = (BENCH_ROW, SCENE, *BEAUTY_SCENES, *TEXTURE_FRAMES, *AOV_SCENES)
HARNESS_ROW = "checkered_plane"
# the multi-gpu phase: tests/test_parallel.py's 37x27 checkered_plane
# (999 pixels, so 4 and 8 tiles pad dead lanes) at 2 spp, depth 2, one
# light sample; its accumulation at ACCUM_SPP in chunks of ACCUM_CHUNK; the
# CLI's builtin checkered_plane at the same settings; the ray dump's block
# of the bench path at 1 spp (Morton offset, pixels): the walls and floor
SPLIT_TILES = (4, 8)
ACCUM_SPP, ACCUM_CHUNK = 4, 2
MULTI_CLI_FLAGS = ("--scene-name", "checkered_plane", "-s", "2", "-d", "2",
                   "-l", "1")
DUMP_BLOCK = (125000, 1024)


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


def ptxas_report(log: str, kernel: str) -> list:
    """ptxas -v's lines for each instantiation of `kernel`: registers,
    spill stores and loads, stack frame and static shared memory bytes."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = dict(entry=m.group(1)) if kernel in m.group(1) else None
            if cur is not None:
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack_frame=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


def walk_launches() -> dict:
    """walk -> mode -> the launches native_cuda counted since its reset."""
    from tpu_raytracing_torch.native_cuda import launch_counts
    from tpu_raytracing_torch.ops.walk_common import launch_key

    counts = launch_counts()
    return {w: {m: counts.get(launch_key(w, m == "any_hit"), 0)
                for m in MODES} for w in WALK_NAMES}


def layer_launches() -> dict:
    """{"coat": {"eval": n, "sample": n}, "shade": {...}, "hit": {"details":
    n}}: the coat's, the shading and the hit_details kernels' launches
    since native_cuda's reset."""
    from tpu_raytracing_torch.native_cuda import launch_counts

    counts = launch_counts()
    out = {layer: {kind: counts.get((f"tpu_rt_{pre}_{kind}", ""), 0)
                   for kind in ("eval", "sample")}
           for layer, pre in (("coat", "layered"), ("shade", "bsdf"))}
    out["hit"] = {"details": counts.get(HIT_KEY, 0)}
    return out


@contextlib.contextmanager
def kernel_switch(**env):
    """Set the JAX kernel switch's variables for the block (None unsets)."""
    old = {k: os.environ.get(k) for k in SWITCH}
    try:
        for k in SWITCH:
            v = env.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def timed_render(scene, s, device="cuda"):
    """(render's result, wall seconds), launch counts reset just before."""
    from tpu_raytracing_torch.integrator.render import render
    from tpu_raytracing_torch.native_cuda import reset_launch_counts

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = render(scene, s, device)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def frame_line(name: str, res, wall: float, s, card: str) -> str:
    img = res.beauty
    return (f"# {name}: {img.shape[1]}x{img.shape[0]}, {s.samples_per_pixel} "
            f"spp, depth {s.max_ray_depth}, {s.light_sample_count} light "
            f"samples: {wall:.3f} s wall, {res.rays_traced} rays, "
            f"{res.rays_traced / wall / 1e6:.3f} Mrays/s on {card}; mean "
            f"{float(img.mean()):.6g}")


def phase_card_tests() -> None:
    """`pytest -m cuda` over the card file in a subprocess; its summary
    line, and its tail where it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q",
         "-p", "no:cacheprovider", "-m", "cuda", "tests/test_torch_cuda.py"],
        capture_output=True, text=True, timeout=1800, cwd=ROOT)
    lines = proc.stdout.strip().splitlines()
    print(f"# card tests (pytest -m cuda tests/test_torch_cuda.py): "
          f"{lines[-1] if lines else 'no output'}; exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if proc.returncode != 0:
        print(proc.stdout[-8000:], proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError("a card test failed")


def phase_frames(scene, settings, card: str, frames: dict) -> dict:
    """The rttest rows' frames on cuda with their launch patterns, and the
    AOV frames against cpu. Returns the launches: "bvh8t" -> mode -> n of
    the bench frame, and per layer ("coat", "shade", "hit") row -> kind ->
    n."""
    from tpu_raytracing_torch.device import compile_scene
    from tpu_raytracing_torch.scene.test_scenes import get_test_scene
    from tpu_raytracing_torch.settings import AovFlags

    ok, out = True, {"coat": {}, "shade": {}, "hit": {}}
    builtin = get_test_scene(SCENE).settings_func()
    builtin.outputs |= AovFlags.BEAUTY
    for row, s in ((BENCH_ROW, settings), (SCENE, builtin)):
        res, wall = timed_render(scene, s)
        walks, layers = walk_launches(), layer_launches()
        img = res.beauty
        row_ok = (bool(np.isfinite(img).all()) and float(img.mean()) > 0
                  and min(walks["bvh8t"].values()) > 0
                  and min(n for c in layers.values() for n in c.values()) > 0)
        ok = ok and row_ok
        print(f"{frame_line(row, res, wall, s, card)}; bvh8t launches "
              f"{walks['bvh8t']}, coat, shade and hit {layers}: "
              f"{'ok' if row_ok else 'FAIL'}", flush=True)
        frames[row] = ("RGB", img, s)
        if row == BENCH_ROW:
            out["bvh8t"] = walks["bvh8t"]
        for layer in layers:
            out[layer][row] = layers[layer]
    for name in (*BEAUTY_SCENES, *TEXTURE_FRAMES):
        ts = get_test_scene(name)
        ds, s = compile_scene(ts.scene_func()), ts.settings_func()
        res, wall = timed_render(ds, s)
        launches = walk_launches()["bvh8t"]
        img = res.beauty
        walked = ds.meta.n_tris > 0  # no triangle, no walk
        row_ok = (bool(np.isfinite(img).all()) and float(img.mean()) > 0
                  and (launches["closest_hit"] > 0) == walked
                  and (launches["any_hit"] > 0)
                  == (walked and TEXTURE_FRAMES.get(name, True)))
        ok = ok and row_ok
        print(f"{frame_line(name, res, wall, s, card)}; bvh8t launches "
              f"{launches}: {'ok' if row_ok else 'FAIL'}", flush=True)
        frames[name] = ("RGB", img, s)
    ok = aov_frames(card, frames) and ok
    if not ok:
        raise AssertionError("a frame failed its check")
    return out


def aov_frames(card: str, frames: dict) -> bool:
    """The normals-only scenes and the textured cubes' albedo and
    mip-level AOVs at 400x400, on cuda against cpu; keeps the normals rows'
    cuda frames in `frames`."""
    from tpu_raytracing_torch.integrator.render import render
    from tpu_raytracing_torch.scene.test_scenes import get_test_scene
    from tpu_raytracing_torch.settings import AovFlags, RaytracerSettings

    torch.set_num_threads(os.cpu_count() or 1)
    ok = True
    for name in AOV_SCENES:
        ts = get_test_scene(name)
        scene, s = ts.scene_func(), ts.settings_func()
        g, c = (render(scene, s, dev).normals for dev in ("cuda", "cpu"))
        frames[name] = ("Normal", g, s)
        hit_g, hit_c = np.any(g != 0, axis=-1), np.any(c != 0, axis=-1)
        mask_same = float((hit_g == hit_c).mean())
        close = float(np.all(np.abs(g - c) <= AOV_ATOL, axis=-1).mean())
        aov_ok = (g.shape == (400, 400, 3) and bool(np.isfinite(g).all())
                  and mask_same >= AOV_MIN_SHARE and close >= AOV_MIN_SHARE
                  and 0 < hit_c.mean() < 1)
        ok = ok and aov_ok
        print(f"# {name} normals {g.shape[1]}x{g.shape[0]}, cuda vs cpu: hit "
              f"masks equal on {mask_same * 100:.4f}%, normals within "
              f"{AOV_ATOL} on {close * 100:.4f}% of pixels (limit "
              f"{AOV_MIN_SHARE * 100:.1f}%), {hit_c.mean() * 100:.2f}% hit, "
              f"on {card}: {'ok' if aov_ok else 'FAIL'}", flush=True)
    scene = textured_cubes(TEXTURED_CUBES)
    s = RaytracerSettings(
        outputs=AovFlags.NORMALS | AovFlags.ALBEDO | AovFlags.MIP_LEVEL)
    g, c = (render(scene, s, dev) for dev in ("cuda", "cpu"))
    hit_g, hit_c = np.any(g.normals != 0, -1), np.any(c.normals != 0, -1)
    alb = float(np.all(np.abs(g.albedo - c.albedo) <= AOV_ATOL, -1).mean())
    mip = float((np.abs(g.mip_level - c.mip_level) <= AOV_ATOL).mean())
    on_mip = c.mip_level != 0
    aov_ok = (bool(np.array_equal(hit_g, hit_c))
              and bool(np.isfinite(g.albedo).all())
              and bool(np.isfinite(g.mip_level).all())
              and alb >= AOV_MIN_SHARE and mip >= AOV_MIN_SHARE
              and 0 < on_mip.mean() < hit_c.mean())
    print(f"# textured cubes {TEXTURED_CUBES}x{TEXTURED_CUBES}, cuda vs cpu: "
          f"hit masks {'equal' if np.array_equal(hit_g, hit_c) else 'DIFFER'} "
          f"({hit_c.mean() * 100:.2f}% hit); albedo within {AOV_ATOL} on "
          f"{alb * 100:.4f}%, mip level within {AOV_ATOL} on {mip * 100:.4f}% "
          f"of pixels (limit {AOV_MIN_SHARE * 100:.1f}%); mip level on "
          f"{on_mip.mean() * 100:.2f}% of pixels: "
          f"{'ok' if aov_ok else 'FAIL'}", flush=True)
    return ok and aov_ok


def phase_switch(scene, settings, card: str) -> dict:
    """The 1-spp frame through each walk of the kernel switch, only that
    walk launching, against the bvh8t frame; returns walk -> mode ->
    launches."""
    from tpu_raytracing_torch.device import compile_scene
    from tpu_raytracing_torch.ops.traverse_kernels import t8_groups

    ds = compile_scene(scene)
    s = dataclasses.replace(settings, samples_per_pixel=1)
    runs = {
        "bvh8t": {},
        "brute": dict(TPU_RT_PALLAS_KERNEL="bvh8t",
                      TPU_RT_BRUTE_GROUPS=str(t8_groups(ds))),
        "quad": dict(TPU_RT_PALLAS_KERNEL="quad"),
        "quadrow": dict(TPU_RT_PALLAS_KERNEL="quadrow"),
        "pair": dict(TPU_RT_PALLAS_KERNEL="pair"),
        "walk": dict(TPU_RT_PALLAS_KERNEL="walk"),
    }
    out, ok, ref = {}, True, None
    for walk, env in runs.items():
        with kernel_switch(**env):
            res, wall = timed_render(ds, s)
        launches = walk_launches()
        img, mine = res.beauty, launches[walk]
        others = {w: c for w, c in launches.items()
                  if w != walk and any(c.values())}
        run_ok = (min(mine.values()) > 0 and not others
                  and bool(np.isfinite(img).all()) and float(img.mean()) > 0)
        note = ""
        if ref is None:
            ref = res
        else:
            b = ref.beauty
            close = float(np.all(np.isclose(img, b, rtol=SWITCH_PIXEL_RTOL,
                                            atol=0), axis=-1).mean())
            mean_rel = abs(float(img.mean()) - float(b.mean())) / float(
                b.mean())
            rays_rel = abs(res.rays_traced - ref.rays_traced) / ref.rays_traced
            run_ok = (run_ok and close >= SWITCH_MIN_CLOSE
                      and mean_rel <= SWITCH_MEAN_RTOL
                      and rays_rel <= SWITCH_RAYS_RTOL)
            note = (f"; against bvh8t: {close * 100:.4f}% of pixels within "
                    f"rtol {SWITCH_PIXEL_RTOL} (limit "
                    f"{SWITCH_MIN_CLOSE * 100:.0f}%), mean rel {mean_rel:.2e} "
                    f"(limit {SWITCH_MEAN_RTOL}), rays rel {rays_rel:.2e} "
                    f"(limit {SWITCH_RAYS_RTOL})")
        ok = ok and run_ok
        print(f"{frame_line(f'switch {walk} {env}', res, wall, s, card)}; "
              f"launches {mine}, other walks {others}{note}: "
              f"{'ok' if run_ok else 'FAIL'}", flush=True)
        out[walk] = mine
    if not ok:
        raise AssertionError("a walk of the kernel switch failed its frame")
    return out


def parity(g, ng, c, nc) -> tuple:
    """(share of pixels within PIXEL_RTOL, relative mean difference,
    relative rays_traced difference) of a cuda block against its cpu
    block."""
    close = float(np.all(np.abs(g - c) <= PIXEL_RTOL * np.abs(c) + 1e-6,
                         axis=-1).mean())
    mean_rel = abs(float(g.mean()) - float(c.mean())) / abs(float(c.mean()))
    return close, mean_rel, abs(ng - nc) / nc


@contextlib.contextmanager
def blas_walks(counter: collections.Counter):
    """Count in `counter` the bvh8t walk's calls in the block by (over a
    BLAS, mode)."""
    from tpu_raytracing_torch.device.scene_buffers import BlasTables
    from tpu_raytracing_torch.ops import traverse_kernels as TK

    fn = TK.WALKS["bvh8t"]

    def count(ds, *args, **kwargs):
        early_exit = kwargs.get("early_exit", len(args) > 5 and args[5])
        counter[isinstance(ds, BlasTables), MODES[bool(early_exit)]] += 1
        return fn(ds, *args, **kwargs)

    TK.WALKS["bvh8t"] = count
    try:
        yield
    finally:
        TK.WALKS["bvh8t"] = fn


def pixel_lines(argv) -> list:
    """Run the CLI's pixel command; per sample (hit, uv, normal,
    radiance) as it prints them."""
    from tpu_raytracing_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main(argv)
    if code != 0:
        raise AssertionError(f"pixel {argv}: exit code {code}")
    text = buf.getvalue()
    vec = lambda key: [np.array([float(v) for v in m.split(", ")])  # noqa: E731
                       for m in re.findall(rf"{key}: \(([^)]*)\)", text)]
    return list(zip(re.findall(r"hit: (\w+)", text), vec("uv"),
                    vec("normal"), vec("radiance")))


def phase_cli(card: str) -> dict:
    """The CLI on the four-bunny glTF file: the frame through `cli.run(
    ["full", ...])` with its launches (main and BLAS walks), its EXR read
    back, a 1,024-pixel block on cuda against cpu, `pixel` on cuda against
    cpu, and `--checkpoint --spp-chunk 3` against the one-shot frame.
    Returns its bvh8t launches by mode."""
    from tpu_raytracing_torch import cli
    from tpu_raytracing_torch.device import compile_scene
    from tpu_raytracing_torch.integrator.render import (
        StaticSettings, _pixel_grid, render_beauty_chunk,
    )
    from tpu_raytracing_torch.native_cuda import reset_launch_counts
    from tpu_raytracing_torch.ops.rng import SamplerConfig
    from tpu_raytracing_torch.scene import scene_from_file
    from tpu_raytracing_torch.settings import RaytracerSettings
    from tpu_raytracing_torch.utils.exr import read_exr

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        path = os.path.join(tmp, "bunnies.glb")
        bunnies_glb(path, True)

        def full(name, *extra):
            return cli.run(["full", "--scene-path", path, *CLI_FLAGS, "-o",
                            name, *extra])

        per = 1 + len(BUNNY_NODES)  # walks a query: main + each instance
        calls = collections.Counter()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with blas_walks(calls):
            code, out = full("cli_instanced.exr")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = walk_launches()["bvh8t"]
        on_blas = {m: calls[True, m] for m in MODES}
        img = out.beauty
        frame_ok = (code == 0 and bool(np.isfinite(img).all())
                    and float(img.mean()) > 0
                    and launches["closest_hit"] > 0
                    and launches["closest_hit"] % per == 0
                    and launches["any_hit"] == launches["closest_hit"]
                    and on_blas["closest_hit"] * per
                    == (per - 1) * launches["closest_hit"])
        print(f"# cli frame (instanced glTF, {len(BUNNY_NODES)} instances "
              f"over one BLAS): {img.shape[1]}x{img.shape[0]}, "
              f"{' '.join(CLI_FLAGS)}: {wall:.3f} s wall (scene load and "
              f"compile included), {out.rays_traced} rays, "
              f"{out.rays_traced / wall / 1e6:.3f} Mrays/s on {card}; mean "
              f"{float(img.mean()):.6g}; bvh8t launches {launches}, on the "
              f"BLAS {on_blas} ({per} walks a query): "
              f"{'ok' if frame_ok else 'FAIL'}", flush=True)

        channels, w, h = read_exr(os.path.join("scenes", "output",
                                               "cli_instanced.exr"))
        exr_ok = (w, h) == (img.shape[1], img.shape[0]) and all(
            channels[c].tobytes() == np.ascontiguousarray(img[..., k])
            .tobytes() for k, c in enumerate("RGB"))
        print(f"# cli frame's EXR read back ({sorted(channels)}): "
              f"{'bit-equal' if exr_ok else 'DIFFERS'}", flush=True)

        # one 1,024-pixel block on the front bunny, cuda against cpu
        scene = scene_from_file(path)
        s = RaytracerSettings(samples_per_pixel=2, light_sample_count=1,
                              max_ray_depth=8)
        cfg = SamplerConfig.from_settings(s.sampler, s.seed)
        st = StaticSettings.from_settings(s)
        px, py, _ = _pixel_grid(scene.camera.raster_width,
                                scene.camera.raster_height)
        x0, y0 = CLI_BLOCK
        start = int(np.nonzero((px == x0) & (py == y0))[0][0])
        sel = slice(start, start + BLOCK_PIXELS)
        blk = {}
        for d in ("cuda", "cpu"):
            r, n = render_beauty_chunk(
                compile_scene(scene, d), cfg, st,
                torch.from_numpy(px[sel].astype(np.int64)).to(d),
                torch.from_numpy(py[sel].astype(np.int64)).to(d),
                torch.ones(BLOCK_PIXELS, dtype=torch.bool, device=d))
            blk[d] = (r.cpu().numpy(), int(n))
        (g, ng), (c, nc) = blk["cuda"], blk["cpu"]
        close, mean_rel, rays_rel = parity(g, ng, c, nc)
        block_ok = (close >= CLI_MIN_CLOSE and mean_rel <= MEAN_RTOL
                    and rays_rel <= RAYS_RTOL and bool(np.isfinite(g).all()))
        print(f"# cli block ({BLOCK_PIXELS} pixels from ({x0}, {y0}), 2 spp), "
              f"cuda vs cpu: {close * 100:.2f}% of pixels within rtol "
              f"{PIXEL_RTOL} (limit {CLI_MIN_CLOSE * 100:.2f}%); mean rel "
              f"{mean_rel:.2e}, rays {ng} vs {nc}: "
              f"{'ok' if block_ok else 'FAIL'}", flush=True)

        # pixel, cuda against cpu
        x, y = CLI_PIXEL
        argv = ["pixel", str(x), str(y), "2", "--scene-path", path,
                *CLI_FLAGS]
        got, want = pixel_lines(argv), pixel_lines(argv + ["--backend",
                                                           "cpu"])
        pixel_ok = len(got) == len(want) == 2 and all(
            gh == wh and np.allclose(gu, wu, rtol=0, atol=AOV_ATOL)
            and np.allclose(gn, wn, rtol=0, atol=AOV_ATOL)
            and np.allclose(gr, wr, rtol=PIXEL_RTOL, atol=1e-6)
            for (gh, gu, gn, gr), (wh, wu, wn, wr) in zip(got, want))
        rad = lambda res: [  # noqa: E731
            " ".join(f"{v:.7g}" for v in r) for *_, r in res]
        print(f"# cli pixel ({x}, {y}), samples 0 and 1, cuda vs cpu: "
              f"radiance {rad(got)} vs {rad(want)}, hits "
              f"{[h for h, *_ in got]}: {'ok' if pixel_ok else 'FAIL'}",
              flush=True)

        # --checkpoint in chunks of 3 samples against the one-shot frame
        ck = os.path.join(tmp, "ck.npz")
        code_c, acc = full("cli_checkpoint.exr", "--checkpoint", ck,
                           "--spp-chunk", "3")
        err = float(np.max(np.abs(acc.beauty - img)))
        with np.load(ck) as f:
            done = int(f["spp_done"])
        ck_ok = (code_c == 0 and done == 8 and acc.rays_traced
                 == out.rays_traced and bool(np.allclose(
                     acc.beauty, img, rtol=CHECKPOINT_RTOL,
                     atol=CHECKPOINT_ATOL)))
        print(f"# cli --checkpoint --spp-chunk 3: {done} spp in the "
              f"checkpoint, rays {acc.rays_traced} vs {out.rays_traced}; max "
              f"|diff| against the one-shot frame {err:.3g} (rtol "
              f"{CHECKPOINT_RTOL}, atol {CHECKPOINT_ATOL}): "
              f"{'ok' if ck_ok else 'FAIL'}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not (frame_ok and exr_ok and block_ok and pixel_ok and ck_ok):
        raise AssertionError("the cli phase failed a check")
    return launches


def phase_rttest(frames: dict, card: str) -> None:
    """Each frame of GATE_ROWS, as phase 4 rendered it on cuda, held
    against the port's committed reference of its row (the JAX package's
    CPU render) with the rttest statistical gate at its default tolerances
    (and the suite's per-scene overrides, where tests.toml has any); then
    the harness on HARNESS_ROW through the CLI subprocess."""
    from tpu_raytracing_torch.rttest import diff, digest, main as rt
    from tpu_raytracing_torch.rttest.test_spec import load_test_suite

    refs = digest.References(rt.REFERENCES)
    specs = {sp.name: sp.settings for sp in load_test_suite(rt.SUITE)}
    ok = True
    for name in GATE_ROWS:
        group, img, s = frames[name]
        rec, exr = refs.lookup(name)
        want = rec["settings"]
        rendered = (group, [img.shape[1], img.shape[0]], s.samples_per_pixel,
                    s.light_sample_count, s.max_ray_depth)
        if rendered != (rec["group"], want["resolution"], want["spp"],
                        want["light_samples"], want["max_depth"]):
            raise AssertionError(f"{name}: rendered at {rendered}, the "
                                 f"reference at {want}")
        if exr is not None:
            d = diff.compare_arrays(group, img,
                                    diff.load_exr_channels(exr)[1])
        else:
            d = diff.compare_digest(group, img, rec)
        tols = specs.get(name)
        row_ok = d.stat_passes(*((tols.stat_rel_mean, tols.stat_block_rel)
                                 if tols else ()))
        ok = ok and row_ok
        mse = "null" if d.mse is None else f"{d.mse:.3e}"
        print(f"# rttest gate {name} [{d.channel_group}]: rel_mean "
              f"{d.rel_mean:.6f} block_rel {d.block_rel:.6f} mse {mse}: "
              f"{'PASS' if row_ok else 'FAIL'}", flush=True)

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_raytracing_torch.rttest", "cuda",
         "--scenes", HARNESS_ROW, "--json", "--no-perf"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    wall = time.perf_counter() - t0
    try:
        res = json.loads(proc.stdout.strip().splitlines()[-1])["results"][0]
    except (IndexError, KeyError, ValueError):
        print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"the harness printed no result (exit "
                             f"{proc.returncode})")
    ok = ok and proc.returncode == 0 and res["status"] == "PASS"
    mse = "null" if res["mse"] is None else f"{res['mse']:.3e}"
    print(f"# rttest gate {HARNESS_ROW} through `python -m "
          f"tpu_raytracing_torch.rttest cuda` [{res['group']}]: rel_mean "
          f"{res['rel_mean']:.6f} block_rel {res['block_rel']:.6f} mse {mse}; "
          f"render {res['render_time_seconds']:.3f} s, harness {wall:.3f} s "
          f"on {card}, exit {proc.returncode}: {res['status']}", flush=True)
    if not ok:
        raise AssertionError("a row failed the rttest statistical gate")


def same_frame(label: str, got, want, card: str, extra: str = "") -> bool:
    """Print one check line: got's beauty and rays against want's, bit for
    bit."""
    ok = (got.beauty is not None and got.beauty.shape == want.beauty.shape
          and bool(np.array_equal(got.beauty, want.beauty))
          and got.rays_traced == want.rays_traced > 0)
    diff = (float(np.abs(got.beauty - want.beauty).max())
            if got.beauty is not None
            and got.beauty.shape == want.beauty.shape else float("nan"))
    print(f"# multi-gpu, {label}: {got.rays_traced} rays vs "
          f"{want.rays_traced}, max |difference| {diff:g}{extra} on {card}: "
          f"{'ok (bit-equal)' if ok else 'FAIL'}", flush=True)
    return ok


def phase_multigpu(ds_bench, settings, card: str) -> None:
    """The distributed driver and the ray dump on cuda:0: (a) a world of
    one rank through NCCL on a file:// store, render_distributed of the
    37x27 frame against render; (b) that frame split into 4 and 8 tiles,
    each tile's shard through the per-rank function (shard_sum) one after
    the other, assembled, against render; (c) render_accumulated_distributed
    in chunks, interrupted after the first and resumed, against
    render_accumulated; (d) the CLI's `full --multichip` started alone (one
    rank), its EXR read back, against render of the same frame; (e)
    TPU_RT_DUMP_RAYS=1 on a block of the bench path: one batch a bvh8t
    launch, the kinds, a save/load round trip, and the block's time with
    the dump off and on. The launch counts are reset just before (a), (d)
    and (e) and read just after. More than one rank runs only on the CPU
    (tests/test_torch_parallel.py): the card's machine has one card, and
    NCCL refuses two ranks on one."""
    import torch.distributed as dist

    from tpu_raytracing_torch import cli
    from tpu_raytracing_torch.device import compile_scene
    from tpu_raytracing_torch.integrator.accumulate import render_accumulated
    from tpu_raytracing_torch.integrator.render import (
        StaticSettings, _pixel_grid, render, render_beauty_chunk,
    )
    from tpu_raytracing_torch.native_cuda import reset_launch_counts
    from tpu_raytracing_torch.ops.rng import SamplerConfig
    from tpu_raytracing_torch.parallel import (
        init_render_group, make_render_mesh, render_accumulated_distributed,
        render_distributed, shard_sum,
    )
    from tpu_raytracing_torch.parallel.mesh import _padded_grid
    from tpu_raytracing_torch.scene.test_scenes import get_test_scene
    from tpu_raytracing_torch.settings import AovFlags
    from tpu_raytracing_torch.utils import raydump
    from tpu_raytracing_torch.utils.exr import read_exr

    print(f"# multi-gpu: world size 1 on {card} (the machine has "
          f"{torch.cuda.device_count()} card; runs of 2-8 ranks are gloo "
          f"ranks on the CPU only, tests/test_torch_parallel.py)", flush=True)
    scene, s = tiny_frame()
    ds = compile_scene(scene)
    ref = render(ds, s)
    ok = True

    # (b) the tile shards, one after the other in this process
    cfg = SamplerConfig.from_settings(s.sampler, s.seed)
    st = StaticSettings.from_settings(s)
    w, h = ds.meta.width, ds.meta.height
    for n_tiles in SPLIT_TILES:
        px, py, act = _padded_grid(w, h, n_tiles)
        parts, rays = [], 0
        for tile in range(n_tiles):
            part, r = shard_sum(ds, cfg, st, px, py, act, tile, n_tiles, 0,
                                s.samples_per_pixel)
            parts.append((part / s.samples_per_pixel).cpu().numpy())
            rays += int(r)
        got = dataclasses.replace(ref, beauty=np.concatenate(parts)[
            :w * h].reshape(h, w, 3), rays_traced=rays)
        ok &= same_frame(f"{n_tiles} tile shards assembled vs render", got,
                         ref, card, f", {px.shape[0] - w * h} dead lanes")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        # (a) a world of one rank through NCCL
        t0 = time.perf_counter()
        init_render_group("cuda", f"file://{tmp}/store", 0, 1)
        try:
            mesh = make_render_mesh()
            probe = torch.ones(1, device="cuda")
            dist.all_reduce(probe)
            torch.cuda.synchronize()
            start_s = time.perf_counter() - t0
            reset_launch_counts()
            out = render_distributed(ds, s, mesh=mesh)
            launches = walk_launches()["bvh8t"]
            ok &= same_frame(
                "render_distributed, NCCL world size 1, vs render", out, ref,
                card, f"; NCCL start (group, mesh, first all_reduce) "
                f"{start_s:.3f} s, bvh8t launches {launches}")
            ok &= min(launches.values()) > 0

            # (c) accumulation, interrupted after the first chunk, resumed
            sa = dataclasses.replace(s, samples_per_pixel=ACCUM_SPP)
            want = render_accumulated(ds, sa, spp_chunk=ACCUM_CHUNK)
            ck = os.path.join(tmp, "ck.npz")
            seen = []

            def interrupt(img, spp_done):
                seen.append(spp_done)
                raise KeyboardInterrupt

            try:
                render_accumulated_distributed(
                    ds, sa, mesh=mesh, spp_chunk=ACCUM_CHUNK,
                    checkpoint_path=ck, on_chunk=interrupt)
            except KeyboardInterrupt:
                pass
            got = render_accumulated_distributed(
                ds, sa, mesh=mesh, spp_chunk=ACCUM_CHUNK, checkpoint_path=ck,
                on_chunk=lambda img, n: seen.append(n))
            ok &= seen == [ACCUM_CHUNK, ACCUM_SPP]
            ok &= same_frame(
                f"render_accumulated_distributed, {ACCUM_SPP} spp in chunks "
                f"of {ACCUM_CHUNK}, interrupted after the first and resumed, "
                f"vs render_accumulated", got, want, card,
                f"; chunks seen {seen}")
        finally:
            dist.destroy_process_group()

        # (d) the CLI started alone: one rank
        builtin = get_test_scene("checkered_plane")
        sc = builtin.settings_func()
        sc.samples_per_pixel, sc.max_ray_depth = 2, 2
        sc.light_sample_count, sc.accumulate_bounces = 1, True
        sc.outputs = AovFlags.BEAUTY
        want = render(builtin.scene_func(), sc)
        reset_launch_counts()
        code, out = cli.run([*MULTI_CLI_FLAGS, "--multichip", "-o",
                             "multigpu.exr", "full"])
        launches = walk_launches()["bvh8t"]
        channels, _, _ = read_exr(os.path.join("scenes", "output",
                                               "multigpu.exr"))
        exr = np.stack([channels[c] for c in "RGB"], axis=-1)
        ok &= code == 0 and not dist.is_initialized()
        ok &= min(launches.values()) > 0
        ok &= same_frame(
            f"cli `{' '.join(MULTI_CLI_FLAGS)} --multichip full` "
            f"(480x270), its EXR read back, vs render",
            dataclasses.replace(out, beauty=exr), want, card,
            f"; bvh8t launches {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (e) the ray dump on a block of the bench path
    start, n_pix = DUMP_BLOCK
    sd = dataclasses.replace(settings, samples_per_pixel=1)
    cfg = SamplerConfig.from_settings(sd.sampler, sd.seed)
    st = StaticSettings.from_settings(sd)
    px, py, _ = _pixel_grid(ds_bench.meta.width, ds_bench.meta.height)
    sel = slice(start, start + n_pix)
    tpx = torch.from_numpy(px[sel].astype(np.int64)).cuda()
    tpy = torch.from_numpy(py[sel].astype(np.int64)).cuda()
    act = torch.ones(n_pix, dtype=torch.bool, device="cuda")

    def block(dump: bool) -> float:
        os.environ["TPU_RT_DUMP_RAYS"] = "1" if dump else "0"
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r, _ = render_beauty_chunk(ds_bench, cfg, st, tpx, tpy, act)
            r.sum().item()
            return time.perf_counter() - t0
        finally:
            os.environ.pop("TPU_RT_DUMP_RAYS")

    raydump.clear()
    try:  # the kernels and the block's ops are warm from the phases before
        times = {False: [], True: []}
        for dump in (False, True, True, False):
            raydump.clear()
            reset_launch_counts()
            times[dump].append(block(dump))
            if not dump:
                ok &= not raydump.BATCHES
                continue
            counts = walk_launches()["bvh8t"]
            batches = list(raydump.BATCHES)
            kinds = [b["kind"] for b in batches]
            ok &= (len(batches) == sum(counts.values())
                   and kinds.count(0) == counts["closest_hit"] > 0
                   and kinds.count(1) == counts["any_hit"] > 0
                   and kinds[0] == 0 and batches[0]["o"].shape == (n_pix, 3))
        path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_dump_"),
                            "rays.npz")
        raydump.clear()
        raydump.BATCHES.extend(batches)  # the last dumped run's
        raydump.save(path)
        loaded = raydump.load(path)
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
        round_trip = len(batches) > 0 and len(loaded) == len(batches) and all(
            np.array_equal(a[k], b[k]) for a, b in zip(loaded, batches)
            for k in b)
        ok &= round_trip
    finally:
        raydump.clear()
    print(f"# multi-gpu, ray dump ({n_pix} pixels of the bench path at "
          f"{start}, 1 spp): {len(batches)} batches, kinds "
          f"{kinds.count(0)} closest-hit + {kinds.count(1)} any-hit = bvh8t "
          f"launches {counts}; save/load round trip "
          f"{'bit-equal' if round_trip else 'FAIL'}; block wall dump off "
          f"{[round(t, 4) for t in times[False]]} s, on "
          f"{[round(t, 4) for t in times[True]]} s (off, on, on, off) on "
          f"{card}", flush=True)
    if not ok:
        raise AssertionError("multi-gpu phase failed a check")


def table_words(ds, walk: str) -> int:
    """f32 words of the scene tables that the walk's query needs, each read
    once: the records that hold data, and of each only the words the kernel
    reads. Padding is not counted: the zero rows that fill a bvh8t group or
    a tri_rows row, the empty slots of a node, the zero records past the
    last, and lanes 32-127 of the bvh4_rows records."""
    def table(name, cols):
        return getattr(ds, name).cpu().numpy().reshape(-1, cols)

    def used(recs):  # records that hold data: padding is all zero
        return int(np.any(recs != 0, axis=1).sum())

    tri_pack = int(ds.meta.n_tris) * 9  # p0 p1 p2 of each triangle
    if walk in ("bvh8t", "brute"):
        lg = int(ds.meta.t8_leaf)
        rows = table("t8_tris", 128).reshape(-1, lg, 128)[:, :, :120]
        words = used(rows.reshape(-1, 10)[:, :9]) * 10  # p0 e1 e2 id
        if walk == "brute":
            return words
        meta = ds.t8_meta.cpu().numpy()
        fld = 6 if int(ds.meta.t8_width) == 32 else 5
        slots = int((meta & ((1 << fld) - 1)).sum())  # children with a box
        return words + slots * 6 + meta.size
    if walk in ("quad", "quadrow"):
        recs = (table("bvh4_rows", 128)[:, :32] if walk == "quadrow"
                else table("bvh4_recs_pk", 32))
        axes = np.ascontiguousarray(recs[:, 28]).view(np.int32)
        nkids = (axes >> 6) & 7
        # a record: the boxes of its children, 4 metas and the axes word
        words = int(np.where(nkids > 0, 5 + 6 * nkids, 0).sum())
        if walk == "quad":
            return words + tri_pack
        return words + used(table("tri_rows", 16)[:, :9]) * 10  # + the id
    if walk == "pair":
        return used(table("bvh2_rows_pk", 16)[:, :15]) * 15 + tri_pack
    return int(ds.meta.n_bvh_nodes) * 8 + tri_pack  # the skip-link walk


def bound_entry(ops: float, nbytes: float) -> tuple:
    """(bound_ms, bound_by): the longer of bytes over the memory rate and
    fp32 operations over the fp32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bound(ds, walk, counts, active):
    """(bound_ms, bound_by, visits, boxes, tests per live ray) of one
    launch, from its per-ray counters and the batch's `active` mask."""
    c = counts.to(torch.int64)
    live = c[:, 0] > 0
    tot = c.sum(dim=0).tolist()
    n_live = max(int(live.sum()), 1)
    n_active = int(active.sum())
    nbytes = (n_active * RAY_BYTES
              + (active.numel() - n_active) * IDLE_RAY_BYTES
              + 4 * table_words(ds, walk))
    ops = tot[1] * SLAB_OPS + tot[2] * MT_OPS
    return (*bound_entry(ops, nbytes),
            tot[0] / n_live, tot[1] / n_live, tot[2] / n_live)


def walk_times(ds, settings, card: str) -> dict:
    """Every walk in both modes at the path's shape: its counters read
    once, its bound, and 20 launches timed. Returns (walk, mode) -> stats."""
    from tpu_raytracing_torch.ops.traverse_kernels import WALKS

    stats, shapes = {}, path_rays(ds, settings)
    for walk in WALK_NAMES:
        for mode, shape in shapes.items():
            kernel, n = WALKS[walk], shape[0].shape[0]
            counts = torch.zeros((n, 3), dtype=torch.int32,
                                 device=shape[0].device)
            kernel(ds, *shape, counts=counts)
            bound_ms, bound_by, visits, boxes, tests = bound(
                ds, walk, counts, shape[4])
            ms = time_ms(lambda: kernel(ds, *shape), reps=20)
            print(f"# {walk} {mode} at the path's shape ({n} rays, "
                  f"{int((counts[:, 0] > 0).sum())} live): kernel {ms:.4f} "
                  f"ms; per live ray {visits:.2f} visits, {boxes:.2f} box "
                  f"tests, {tests:.2f} triangle tests; bound {bound_ms:.4f} "
                  f"ms by {bound_by} ({bound_ms / ms * 100:.2f}% of the "
                  f"kernel time) on {card}", flush=True)
            stats[walk, mode] = dict(
                ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                visits_per_ray=visits, box_tests_per_ray=boxes,
                tri_tests_per_ray=tests)
    return stats


def coat_times(scene, card: str) -> dict:
    """The coat kernels on every coat call of one 1-spp bunny pass
    (COAT_SETTINGS), 5 launches a call timed, bounded by the depth steps
    the lanes began. Returns kind -> stats."""
    from tpu_raytracing_torch.ops import layered as L
    from tpu_raytracing_torch.settings import RaytracerSettings

    calls = coat_calls(scene, RaytracerSettings(**COAT_SETTINGS))
    kernel = {"eval": L._eval_kernel, "sample": L._sample_kernel}
    out = {}
    for kind in ("eval", "sample"):
        mine = [c[1:] for c in calls if c[0] == kind]
        lanes = [c[1].shape[0] for c in mine]
        k_ms, steps = 0.0, 0
        for args in mine:
            st = torch.zeros(args[1].shape[0], dtype=torch.int32,
                             device=args[1].device)
            kernel[kind](*args, steps=st)
            steps += int(st.sum())
            k_ms += time_ms(lambda: kernel[kind](*args), 5)
        n = sum(lanes)
        bound_ms, bound_by = bound_entry(steps * COAT_STEP_OPS[kind],
                                         n * COAT_LANE_BYTES[kind])
        print(f"# coat {kind}: {len(mine)} calls of {min(lanes)}-"
              f"{max(lanes)} lanes ({n} in all), kernel "
              f"{k_ms / len(mine):.4f} ms a call; {steps / n:.2f} depth "
              f"steps a lane; bound {bound_ms / len(mine):.5f} ms a call (by "
              f"{bound_by}), {bound_ms / k_ms * 100:.3f}% of the kernel time "
              f"on {card}", flush=True)
        out[kind] = dict(pass_calls=len(mine), lanes=lanes,
                         ms=k_ms / len(mine), bound_ms=bound_ms / len(mine),
                         bound_by=bound_by, steps_per_lane=steps / n)
    return out


def shade_times(card: str) -> dict:
    """The shading kernels on every BSDF dispatch call of one 1-spp
    rough_dielectric pass (COAT_SETTINGS), 20 launches a call timed, with
    the byte bound and the pass's launches. Returns kind -> stats."""
    from tpu_raytracing_torch.native_cuda import reset_launch_counts
    from tpu_raytracing_torch.ops import bsdf_dispatch as D
    from tpu_raytracing_torch.ops.rng import sample_uniform, sample_uniform2
    from tpu_raytracing_torch.scene.test_scenes import get_test_scene
    from tpu_raytracing_torch.settings import RaytracerSettings

    scene = get_test_scene(SHADE_SCENE).scene_func()
    reset_launch_counts()
    calls = shade_calls(scene, RaytracerSettings(**COAT_SETTINGS))
    launches = layer_launches()["shade"]
    out = {}
    for kind in ("eval", "sample"):
        mine = [c[1:] for c in calls if c[0] == kind]
        lanes = [c[1].shape[0] for c in mine]
        k_ms = 0.0
        for args in mine:
            if kind == "eval":
                params, wo, wi, kinds, _ = args
                run = (lambda: D._eval_kernel(
                    params, wo, wi, D._rough_kinds(kinds)))
            else:
                params, wo, allowed, cfg, stream, kinds, _ = args
                u2, s2 = sample_uniform2(cfg, stream)
                u1, _ = sample_uniform(cfg, s2)
                run = (lambda: D._sample_kernel(
                    params, wo, u2, u1, allowed, D._rough_kinds(kinds)))
            k_ms += time_ms(run, 20)
        n = sum(lanes)
        bound_ms, bound_by = bound_entry(0, n * SHADE_LANE_BYTES[kind])
        print(f"# shade {kind}: {len(mine)} calls of {min(lanes)}-"
              f"{max(lanes)} lanes ({n} in all), {launches[kind]} kernel "
              f"launches; kernel {k_ms / len(mine):.4f} ms a call; bound "
              f"{bound_ms / len(mine):.5f} ms a call (by {bound_by}), "
              f"{bound_ms / k_ms * 100:.2f}% of the kernel time on {card}",
              flush=True)
        out[kind] = dict(pass_calls=len(mine), lanes=lanes,
                         scene_launches={SHADE_SCENE: launches[kind]},
                         ms=k_ms / len(mine), bound_ms=bound_ms / len(mine),
                         bound_by=bound_by)
    return out


def hit_times(card: str) -> dict:
    """The hit_details kernel on the bounce after the camera's of one 1-spp
    pass (COAT_SETTINGS) of rough_dielectric and of the bunny, 20 launches
    timed, with the byte bound and the pass's launches. Returns scene ->
    stats."""
    from tpu_raytracing_torch.native_cuda import (
        launch_counts, reset_launch_counts,
    )
    from tpu_raytracing_torch.ops.traverse import hit_details
    from tpu_raytracing_torch.scene.test_scenes import get_test_scene
    from tpu_raytracing_torch.settings import RaytracerSettings

    out = {}
    for name in (SHADE_SCENE, SCENE):
        reset_launch_counts()
        calls = hit_calls(get_test_scene(name).scene_func(),
                          RaytracerSettings(**COAT_SETTINGS))
        launches = launch_counts().get(HIT_KEY, 0)
        ds, *lanes = calls[1]
        n = lanes[0].shape[0]
        ms = time_ms(lambda: hit_details(ds, *lanes), 20)
        bound_ms, bound_by = bound_entry(0, n * HIT_LANE_BYTES)
        print(f"# hit_details {name}: {len(calls)} calls a pass, "
              f"{launches} kernel launches; kernel {ms:.4f} ms a call of "
              f"{n} lanes; bound {bound_ms:.5f} ms (by {bound_by}), "
              f"{bound_ms / ms * 100:.2f}% of the kernel time on {card}",
              flush=True)
        out[name] = dict(pass_calls=len(calls), lanes=n,
                         pass_launches=launches, ms=ms, bound_ms=bound_ms,
                         bound_by=bound_by)
    return out


def probe_times(card: str) -> dict:
    """The probes' mains at the scripts' counts (P1 at P1_ITERS visits):
    each configuration's kernel time and launches. Returns name ->
    configurations."""
    from tpu_raytracing_torch.native_cuda import (
        launch_counts, reset_launch_counts,
    )
    from tpu_raytracing_torch.probes import bf16_vpu, iter_cost, slab_cost
    from tpu_raytracing_torch.probes import walk_cost

    print(f"# probes on {card}", flush=True)
    reset_launch_counts()
    results = dict(probe_iter_cost=iter_cost.main([]),
                   probe_bf16_vpu=bf16_vpu.main([]),
                   probe_slab_cost=slab_cost.main([]),
                   probe_walk_cost=walk_cost.main(
                       ["--iters", str(P1_ITERS)]))
    counts = launch_counts()
    out = {}
    for name, _, _, key, _ in PROBE_KERNELS:
        out[name] = [dict(res, launches=counts.get(("tpu_rt_" + name,
                                                    res[key]), 0))
                     for res in results[name]]
        for c in out[name]:
            print(f"# {name} {c[key]}: kernel {c['ms']:.4f} ms, launches "
                  f"{c['launches']}", flush=True)
    return out


def phase_times(ds, scene, settings, card: str) -> dict:
    return dict(walks=walk_times(ds, settings, card),
                coat=coat_times(scene, card), shade=shade_times(card),
                hit=hit_times(card), probes=probe_times(card))


def kernel_entries(times: dict, frames: dict, switch: dict,
                   ptxas_log: str) -> list:
    """The {"kernels": [...]} entries: each kernel's time and bound
    (phase 9) and its ptxas lines. bvh8t's launches are the bench frame's
    (phase 4), the other walks' their switch frame's (phase 5), the coat's,
    the shading and the hit_details kernels' the bench frame's, with the
    builtin bunny frame's beside them."""
    kernels = []
    for kname, walk, modes, source, line in KERNELS:
        entry = dict(
            name=kname, route="cuda", source=CSRC + source,
            replaces=PALLAS + line,
            launches=(frames["bvh8t"][modes[0]] if walk == "bvh8t"
                      else sum(switch[walk].values())),
            **times["walks"][walk, modes[0]], mode=modes[0],
            ptxas=ptxas_report(ptxas_log, KERNEL_OF[walk]), library_ms=None,
            library="none: no PyTorch call computes a BVH walk")
        if len(modes) > 1:
            entry["launches_by_mode"] = switch[walk]
            entry["any_hit"] = times["walks"][walk, "any_hit"]
        kernels.append(entry)
    for layer, source, pre, xla, lib in (
            ("coat", "layered_walk.cu", "layered", "layered",
             "a layered BSDF"),
            ("shade", "bsdf_kinds.cu", "bsdf", "bsdf_dispatch", "a BSDF")):
        for kind in ("eval", "sample"):
            name = f"{pre}_{kind}_kernel"
            kernels.append(dict(
                name=name, route="cuda", source=CSRC + source,
                replaces=f"none: XLA code (tpu_raytracing/ops/{xla}.py)",
                **times[layer][kind],
                launches=frames[layer][BENCH_ROW][kind],
                builtin_frame_launches=frames[layer][SCENE][kind],
                ptxas=ptxas_report(ptxas_log, name), library_ms=None,
                library=f"none: no PyTorch call computes {lib}"))
    hit = times["hit"]
    kernels.append(dict(
        name="hit_details_kernel", route="cuda",
        source=CSRC + "hit_details.cu",
        replaces="none: XLA code (tpu_raytracing/ops/traverse.py::"
                 "hit_details)",
        **hit[SHADE_SCENE], bunny=hit[SCENE],
        launches=frames["hit"][BENCH_ROW]["details"],
        builtin_frame_launches=frames["hit"][SCENE]["details"],
        ptxas=ptxas_report(ptxas_log, "hit_details_kernel"), library_ms=None,
        library="none: no PyTorch call computes hit details"))
    for name, source, replaces, key, main in PROBE_KERNELS:
        configs = times["probes"][name]
        head = next((c for c in configs if c[key] == main), configs[0])
        kernels.append(dict(
            name=name, route="cuda", source=CSRC + source, replaces=replaces,
            launches=sum(c["launches"] for c in configs), ms=head["ms"],
            config=head[key], configs=configs,
            ptxas=ptxas_report(ptxas_log, name), library_ms=None,
            library="none: no single PyTorch call computes the probe"))
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tpu_raytracing_torch import native, native_cuda
    from tpu_raytracing_torch.device import compile_scene
    from tpu_raytracing_torch.scene.test_scenes import get_test_scene
    from tpu_raytracing_torch.settings import AovFlags, RaytracerSettings

    for k in SWITCH:  # the switch's defaults: bvh8t, no brute kernel
        os.environ.pop(k, None)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"# card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; device 0: {name}", flush=True)

    path, secs, log = native_cuda.build()
    print(f"# build: {path.name} in {secs:.2f} s", flush=True)
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(f"#   {ln.strip()}")
    native_cuda.load()

    scene = get_test_scene(SCENE).scene_func()
    settings = RaytracerSettings(
        samples_per_pixel=8, light_sample_count=1, max_ray_depth=8,
        outputs=AovFlags.BEAUTY,
    )
    if native.disabled():
        builder = "numpy BVH builder (TPU_RAYTRACING_NO_NATIVE)"
    else:
        path, secs = native.build()
        builder = f"native BVH builder, {path.name} (g++ {secs:.2f} s)"
    t0 = time.perf_counter()
    ds = compile_scene(scene)
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    compile_scene(scene)
    print(f"# scene compile ({builder}): {secs:.3f} s on {card} (the CUDA "
          f"context's start included); again {time.perf_counter() - t0:.3f} "
          f"s", flush=True)
    failed, results = [], {}
    frames = {}  # rttest row -> (channel group, cuda frame, settings)
    phases = (
        ("card tests", phase_card_tests),
        ("frames", lambda: phase_frames(scene, settings, card, frames)),
        ("kernel switch", lambda: phase_switch(scene, settings, card)),
        ("cli and scene files", lambda: phase_cli(card)),
        ("rttest gate", lambda: phase_rttest(frames, card)),
        ("multi-gpu", lambda: phase_multigpu(ds, settings, card)),
        ("kernel times", lambda: phase_times(ds, scene, settings, card)),
    )
    for phase, run in phases:
        t0 = time.perf_counter()
        try:
            results[phase] = run()
        except Exception:
            traceback.print_exc()
            failed.append(phase)
        print(f"# phase {phase}: {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    kernels = kernel_entries(results["kernel times"], results["frames"],
                             results["kernel switch"], log)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
