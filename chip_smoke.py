"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result):

1. card: `nvidia-smi` name and power limit, and torch's device name;
2. build: the CUDA kernels from tpu_raytracing_torch/csrc (nvcc, sm_90a,
   one nvcc per source, all started together);
3. kernel vs plain: every traversal kernel (bvh8t, brute, quad, quadrow,
   pair, skip-link walk) against its plain PyTorch version on the same
   CUDA tensors, on the coated_diffuse_bunny tables: closest-hit on 65,536
   random rays plus the frame's camera rays, any-hit on random rays plus
   the frame's shadow rays; the brute kernel also on rays at its
   prefilter's edges (`edge_rays`), on the bunny and on a mesh whose every
   hit is an equal-t tie (`repeated_triangles`), then with t_min or t_max
   at each hit's t; the quad, quadrow, pair, skip-link and bvh8t kernels
   also on rays with zero direction components from node box planes
   (`axis_rays`), then at their hits' t. The brute, quad, quadrow, pair and
   skip-link kernels are held bit for bit (`EXACT`); the bvh8t kernel, whose
   plain version walks another tree, on axis rays by the traversal
   contract with ties as common as on the CPU (`AXIS_TIE_SHARE`), where
   each lane outside it must be fault F3, a hit in a box that one tree's
   box test culls and the brute force finds (`compare_trees`). At the
   path's shape (the frame's camera rays, its shadow rays) each is timed
   (the wrapper by CUDA events) and its per-ray counters are read once,
   from which the card's bound for the same work is computed. ptxas's
   registers, spills and stack frame of the bvh8t, brute, quad, pair and
   skip-link kernels' instantiations are printed beside the card layout's
   sizes, the brute kernel's times beside those before its redesign
   (`BRUTE_BEFORE`), and the bvh8t, quad, quadrow, pair and skip-link
   kernels' beside those of commit 5695c8b (`WALK_BEFORE`);
4. full frame: render coated_diffuse_bunny at 500x500, 8 spp, depth 8 and
   one light sample on cuda, through the bvh8t kernel (launch counts reset
   just before, read just after). A copy of every ray batch the frame hands
   the walk is kept for phase 12, and the frame for phase 9;
5. slice parity: two blocks of 4,096 Morton-order pixels (2 spp, depth 8),
   one of walls and floor and one mostly on the bunny, on cuda with the
   kernels against cpu with the plain versions;
6. the kernel switch: the 500x500 frame at 1 spp, depth 8, rendered on cuda
   with bvh8t and then with each walk the JAX switch selects
   (TPU_RT_PALLAS_KERNEL, TPU_RT_BRUTE_GROUPS), its launch counts reset
   just before and read just after and each call of its walk timed by
   CUDA events, and held against the bvh8t frame;
7. builtin scenes: the five beauty scenes with a sphere as full frames on
   cuda at their builtin settings (out_of_focus_sphere 36 spp, 6x6
   stratified; dielectric, metal, rough_metal and rough_dielectric 32 spp;
   depth 8, 4 light samples), launch counts reset just before and read
   just after each and its walk's calls timed by CUDA events; on metal,
   the bvh8t walk on camera rays with and without the sphere's cut of
   t_max, and on shadow rays with and without the sphere-occluded lanes,
   then the metal frame again through the brute kernel
   (TPU_RT_BRUTE_GROUPS=12, its one triangle block), its calls timed too,
   held against its bvh8t frame with phase 6's limits; one 1,024-pixel
   block on each sphere at 2 spp on cuda against cpu; the normals-only scenes
   (sphere, cube, cube_orthographic) at 400x400 on cuda against cpu; then
   the textures and lights: checkered_plane (480x270, 1 spp),
   environment_light (500x500, 32 spp) and the emissive Cornell box
   (500x500, 32 spp, 4 light samples), each a full frame with its launch
   counts reset just before and read just after (the any-hit walk must
   launch in the first and last and never in environment_light, which has
   no light), and a 1,024-pixel block of each on cuda against cpu (and
   the whole checkered frame's share, not gated); bounce 1's first
   area-light shadow batch of the emissive frame (250,000 lanes, per-lane
   t_max) held against the plain walk, then timed and bounded; and the
   textured cubes' albedo and mip-level AOVs at 400x400 on cuda against
   cpu;
8. cli and scene files: a glTF file of the port's bunny mesh under four
   node transforms (four instances over one BLAS) on a two-triangle floor,
   with a camera node and a point light, rendered by
   `tpu_raytracing_torch.cli` (`full --scene-path`, 600x600 at the
   loader's raster, 8 spp, depth 8, one light sample) on cuda, launch
   counts reset just before and read just after (1 + 4 walks a query, as
   many any-hit launches as closest-hit) and each walk call timed by CUDA
   events; its EXR read back bit for bit; a 1,024-pixel block at 2 spp on
   cuda against cpu; the same scene with each bunny its own mesh (all
   baked world-space) within an MSE of 1e-6 of it; bounce 1's first
   instance batch of each mode held against the plain walk on the BLAS
   view, then timed and bounded by the BLAS's own tables; `pixel` on cuda
   against cpu; and `--checkpoint --spp-chunk 3` against the one-shot
   frame;
9. rttest gate: the frames phases 4 and 7 rendered at the settings the
   port's committed references name (tpu_raytracing_torch/rttest/
   references: a digest of the JAX package's CPU renders, and the normals
   rows' EXRs), each held against its reference with the rttest harness's
   statistical gate at its default tolerances: phase 4's bunny (8 spp, one
   light sample, depth 8), and phase 7's five sphere beauty scenes,
   checkered_plane, environment_light and the sphere, cube and
   cube_orthographic normals at their builtin settings; then the harness
   itself, `python -m tpu_raytracing_torch.rttest cuda`, on one row
   through the CLI subprocess. One line a row; a FAIL fails the phase;
10. the probes (tpu_raytracing_torch/probes): the mains of P3 (iteration
   cost), P4 (bf16 slab), P2 (slab cost) and P1 (walk-visit ablation), at
   the scripts' counts (P1 at 4,096 visits, not the script's 200,000: its
   plain version takes about a millisecond a visit), their launch counts
   reset just before and read just after, then each configuration's plain
   version at the same counts, timed once, held bit for bit against one
   launch of its kernel on the same inputs (P3 also on small-id inputs;
   P2 and P1 in their outputs, stats and every visit's drained mask, and
   also on a second seeded input set whose drains vary);
11. multi-gpu: the distributed driver (tpu_raytracing_torch/parallel) with
   a world of one rank through NCCL on a file:// store: render_distributed
   of tests/test_parallel.py's 37x27 checkered_plane (2 spp, depth 2)
   against render on the card; that frame split into 4 and 8 tiles, each
   tile's shard run through the per-rank function one after the other and
   assembled, against render (the card's own check that a lane does not
   depend on its batch); render_accumulated_distributed interrupted after
   its first chunk and resumed, against render_accumulated; the CLI's `full
   --multichip` started alone (one rank), its EXR read back, against render;
   then TPU_RT_DUMP_RAYS=1 on a 1,024-pixel block of the bench path (one
   batch a bvh8t launch, the kinds, a save/load round trip) and the block's
   time with the dump off and on. Every comparison is bit for bit, launch
   counts reset just before and read just after each path. More than one
   rank runs only on the CPU (tests/test_torch_parallel.py);
12. device times and the frame's traversal: every walk's kernel time alone
   at the path's shape, from torch.profiler's kernel events; the frame's
   bounce-2 batches (closest-hit and its shadow rays) held against the plain
   walk and timed like the camera rays; then all of the frame's bvh8t
   batches replayed, sample 0 bounce by bounce with counters and bounds,
   the whole frame summed by mode. It comes last because a profiler session
   slows the host-bound phases that follow it in the same process.

The last two lines are {"kernels": [...]} and {"ok": true, "device": ...},
with the card's name and power limit on a line before them. Needs one CUDA
device; the port imports neither jax nor the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import re
import struct
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

SCENE = "coated_diffuse_bunny"
CSRC = "tpu_raytracing_torch/csrc/"
PALLAS = "tpu_raytracing/ops/traverse_pallas.py"
SWITCH = ("TPU_RT_PALLAS_KERNEL", "TPU_RT_BRUTE_GROUPS")
# the JSON entries: name, walk, modes, source, the TPU kernel it replaces
KERNELS = (
    ("bvh8t_walk<closest_hit>", "bvh8t", ("closest_hit",), "bvh8t_walk.cu",
     ":931"),  # _t8_kernel
    ("bvh8t_walk<any_hit>", "bvh8t", ("any_hit",), "bvh8t_walk.cu", ":931"),
    ("t8_brute", "brute", ("closest_hit", "any_hit"), "t8_brute.cu",
     ":1470"),  # _t8_brute_kernel
    ("quad_walk<quad>", "quad", ("closest_hit", "any_hit"), "quad_walk.cu",
     ":494"),  # _quad_kernel
    ("quad_walk<quadrow>", "quadrow", ("closest_hit", "any_hit"),
     "quad_walk.cu", ":494"),
    ("pair_walk", "pair", ("closest_hit", "any_hit"), "pair_walk.cu",
     ":288"),  # _pair_kernel
    ("skip_walk", "walk", ("closest_hit", "any_hit"), "skip_walk.cu",
     ":171"),  # _walk_kernel
)
# the walks of the kernel switch, in the order phase 3 holds them
WALK_NAMES = ("bvh8t", "brute", "quad", "quadrow", "pair", "walk")
# the walks on the persistent grid redesigned after bvh8t: K4, K5 and K6
PERSISTENT = ("quad", "quadrow", "pair", "walk")
# each walk's CUDA kernel, as the profiler names it
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
N_RANDOM_RAYS = 65536
N_EDGE_RAYS = 16384  # rays at the brute kernel's prefilter edges (phase 3)
# closest-hit: equal-t ties between different leaves may pick different
# triangles (a kernel and its plain version may visit leaves in another
# order); the brute, quad, quadrow, pair and skip-link kernels repeat their
# plain versions' order bit for bit
EXACT = ("brute", "quad", "quadrow", "pair", "walk")
# K3 before its redesign: the kernel of commit 70d5b21, wrapper ms at the
# path's shape on an H100 80GB HBM3 at 700 W (PERF.md section 6, K3's row)
BRUTE_BEFORE = dict(commit="70d5b21", ms=46.818, any_hit_ms=33.053,
                    card="NVIDIA H100 80GB HBM3, 700.00 W")
# The walks of commit 5695c8b (K5 before its redesign), wrapper ms
# (closest-hit, any-hit) at the path's shape in that commit's final run
# (PERF.md section 6): K4, K5 and K6 from phase 3 of chip_smoke.py, K1/K2
# from scripts/torch_walk_ab.py in the same call
WALK_BEFORE = dict(commit="5695c8b", card="NVIDIA H100 80GB HBM3, 700.00 W",
                   ms={"bvh8t": (0.1098, 0.0905), "quad": (0.0893, 0.0876),
                       "quadrow": (0.0917, 0.0892), "pair": (0.1125, 0.1117),
                       "walk": (0.1277, 0.1012)})
MAX_TIE_FRACTION = 1e-4
# axis rays from snapped box planes often run through a shared vertex or
# edge, where two walks that order leaves differently may pick different
# triangles at t within T_RTOL (tests/test_torch_walks.py's axis cases):
# a share of the live rays, which t limits at the hits do not change
AXIS_TIE_SHARE = 0.02
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
PARITY_PIXELS = 4096
PARITY_BLOCKS = {  # Morton offset -> least share of pixels within rtol
    "walls and floor": (125000, 0.98),
    "65% bunny": (147456, 0.90),
}
PARITY_MEAN_RTOL = 0.01
PARITY_PIXEL_RTOL = 1e-3
PARITY_RAYS_RTOL = 0.005
# the kernel switch: every walk finds the bvh8t walk's winners (t
# bit-equal) except on equal-t ties between leaves, so the frames are the
# same but for the pixels whose paths meet such a tie, and the coat
# streams those re-seed
SWITCH_RAYS_RTOL = 1e-3
SWITCH_MEAN_RTOL = 1e-3
SWITCH_PIXEL_RTOL = 1e-5
SWITCH_MIN_CLOSE = 0.99
# the builtin scenes with a sphere (phase 7), rendered at their builtin
# settings: scene -> (the first pixel of its 32x32 block on the sphere, the
# least share of the block's pixels within PARITY_PIXEL_RTOL of cpu).
# Mirror and glass bounces carry a last-bit difference from bounce to
# bounce; measured on the H100: 100% on every block (two chip runs).
BEAUTY_SCENES = {
    "out_of_focus_sphere": ((160, 224), 0.99),
    "dielectric": ((192, 288), 0.98),
    "metal": ((192, 288), 0.98),
    "rough_metal": ((192, 288), 0.98),
    "rough_dielectric": ((192, 288), 0.98),
}
SCENE_BLOCK = 1024
SPHERE_CUT_ROUNDS = 3
# the normals-only scenes: hit masks and normals (within AOV_ATOL) agree
# on at least AOV_MIN_SHARE of the pixels
AOV_SCENES = ("sphere", "cube", "cube_orthographic")
AOV_ATOL = 1e-5
AOV_MIN_SHARE = 0.999
# the frames of the textures and lights slice (phase 7), at their builtin
# settings (the emissive box: RaytracerSettings' defaults): frame -> (the
# first pixel of its 32x32 block held against cpu, the block's spp, whether
# the any-hit walk launches). The checkered plane's block lies in the near
# half, where a cell covers many pixels; environment_light's straddles the
# cube's silhouette against the sky (it has no light, so no shadow ray);
# the emissive box's is the ceiling at the quad's edge. Limits as the
# sphere blocks': mean 1%, rays 0.5%, TEXTURE_MIN_CLOSE within rtol 1e-3.
TEXTURE_FRAMES = {
    "checkered_plane": ((224, 224), 1, True),
    "environment_light": ((256, 224), 2, False),
    "emissive_box": ((192, 96), 2, True),
}
TEXTURE_MIN_CLOSE = 0.98
TEXTURED_CUBES = 400  # the textured cubes' AOV frame, pixels a side
# the cli phase (phase 8): the bench path's settings on the glTF frame; the
# first pixel of its 32x32 block held against cpu (all on the front-left
# bunny) and the pixel `pixel` replays; the block's least share within
# PARITY_PIXEL_RTOL (PR 7/8's), the instanced frame's MSE against the
# baked one (tests/test_instancing.py's), and the checkpointed frame's
# tolerance against the one-shot one (tests/test_accumulate.py's)
CLI_FLAGS = ("-s", "8", "-d", "8", "-l", "1")
CLI_BLOCK = (128, 320)
CLI_PIXEL = (144, 336)
CLI_MIN_CLOSE = 0.999
CLI_MAX_MSE = 1e-6
CHECKPOINT_RTOL, CHECKPOINT_ATOL = 1e-5, 1e-6
# the probes (phase 10): name, source, the Pallas probe it replaces. One SM
# runs each, by design, so a bound's share of one SM is its card share
# times the SMs.
PROBE_KERNELS = (
    ("probe_iter_cost", "probe_iter_cost.cu", "scripts/probe_iter_cost.py:155"),
    ("probe_bf16_vpu", "probe_bf16_vpu.cu", "scripts/probe_bf16_vpu.py:56"),
    ("probe_slab_cost", "probe_slab_cost.cu", "scripts/probe_slab_cost.py:210"),
    ("probe_walk_cost", "probe_walk_cost.cu", "scripts/probe_walk_cost.py:240"),
)
# the configuration whose numbers head each probe's entry: the first, but
# P2's visitk slab replica and P1's level with every part of a visit
PROBE_MAIN = {"probe_slab_cost": "cur", "probe_walk_cost": "cond50"}
P1_ITERS = 4096        # P1's timed and checked count (the script: 200,000)
P2_VARIED_ITERS = 1024  # the second input set's checked counts
P1_VARIED_ITERS = 512
# operations a visit: needed, and as the script writes them. P2: a slab
# test is SLAB_OPS; cur/hoist test 16 slots x 512 rays, twice as written
# (KN = 2, the same box); row0 16 x 128 tests plus 16 interval slabs of 42
# (3 axes: 2 subtracts, 4 products, 6 min/max, 2 folds); mxu the float32
# product, 2 x 16 x 128 x 128 needed (6 identical groups written); floor
# 16 compares (the script's 16 x 128). P1 (P1_SLAB_OPS, P1_TRIP_OPS) as
# written: 16 x 512 slab tests a visit, and 16 x 512 Moller-Trumbore tests a
# leaf trip; needed: the slots below the visit's ni (the drain masks the
# others out), and in a leaf trip the rays its gate lets through, as the
# plain run counts them (walk_cost_plain's `work`).
P2_OPS = {
    "floor": (16, 16 * 128),
    "cur": (16 * 512 * SLAB_OPS, 2 * 16 * 512 * SLAB_OPS),
    "hoist": (16 * 512 * SLAB_OPS, 2 * 16 * 512 * SLAB_OPS),
    "row0": (16 * 128 * SLAB_OPS + 16 * 42,) * 2,
    "mxu": (2 * 16 * 128 * 128, 2 * 96 * 128 * 128),
}
# the rttest gate (phase 9): the reference row of phase 4's frame, the
# rows of phase 7's frames (their suite names), and the row the harness
# itself renders through the CLI subprocess
BENCH_ROW = "coated_diffuse_bunny_8spp"
GATE_ROWS = (BENCH_ROW, *BEAUTY_SCENES, "checkered_plane",
             "environment_light", *AOV_SCENES)
HARNESS_ROW = "checkered_plane"
# the multi-gpu phase: tests/test_parallel.py's 37x27 checkered_plane
# (999 pixels, so 4 and 8 tiles pad dead lanes) at 2 spp, depth 2, one
# light sample; its accumulation at ACCUM_SPP in chunks of ACCUM_CHUNK; the
# CLI's builtin checkered_plane at the same settings; the ray dump's block
# of the bench path (Morton offset, pixels) at 1 spp: the walls and floor,
# since a block on the coated bunny took 11.7-14.5 s a run on the card
# (6.1-7.4 s on the walls). Every
# comparison is bit for bit (np.array_equal) and rays_traced equal.
SPLIT_TILES = (4, 8)
ACCUM_SPP, ACCUM_CHUNK = 4, 2
MULTI_CLI_FLAGS = ("--scene-name", "checkered_plane", "-s", "2", "-d", "2",
                   "-l", "1")
DUMP_BLOCK = (PARITY_BLOCKS["walls and floor"][0], 1024)
P1_SLAB_OPS = 16 * 512 * SLAB_OPS
P1_TRIP_OPS = 16 * 512 * MT_OPS
SMS = 132
FP32_LANES = 128  # fp32 lanes of an SM; a bf16x2 lane does two elements


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


def device_ms(fn, reps: int, kernel: str) -> float | None:
    """Mean device milliseconds a launch of the CUDA kernels whose name
    holds `kernel`, from torch.profiler's kernel events over `reps` calls
    after a warm-up; None where three sessions record no device time (a
    session now and then records none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for ev in prof.key_averages():
            if kernel in ev.key:
                us = getattr(ev, "device_time_total", None)
                total_us += us if us is not None else ev.cuda_time_total
                count += ev.count
        if count and total_us > 0:
            return total_us / count / 1e3
    return None


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
    for c in out:  # the mangled template arguments: W, ROWREC, EARLY_EXIT
        m = re.search(r"I((?:L[ib]\d+E)+)E", c["entry"])
        if m is None:
            c["instance"] = c["entry"]
            continue
        args = re.findall(r"L([ib])(\d+)E", m.group(1))
        parts = [f"W={v}" for kind, v in args if kind == "i"]
        flags = [v == "1" for kind, v in args if kind == "b"]
        if len(flags) == 2:  # quad_walk<ROWREC, EARLY_EXIT>
            parts.append("quadrow" if flags[0] else "quad")
        parts.append("any_hit" if flags and flags[-1] else "closest_hit")
        c["instance"] = ", ".join(parts)
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


def random_rays(ds, n: int, seed: int, device):
    """tests/test_pallas_traverse.py::_rays on the port's scene."""
    rng = np.random.default_rng(seed)
    c = ds.bounds_center.cpu().numpy()
    r = float(ds.bounds_radius)
    o = (c[None, :] + rng.normal(0, 0.15, (n, 3)) * r).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


def edge_rays(ds, n: int, seed: int) -> tuple:
    """Rays aimed at the edges of the brute kernel's prefilter on the
    triangle rows of ds's card layout, from either side at a random tilt: a
    quarter at vertices, a quarter on edges (u or v 0, u + v 1), a quarter
    just inside or outside an edge (by 1e-7, 1e-5, 1.2e-5, 2^-16 or 1.6e-5
    of the triangle), a quarter nearly parallel to the triangle (den near
    0, tilts of 0 to 1e-3). t_min 1e-4; half the lanes have a finite
    t_max; every 7th lane is inactive. Returns numpy (o, d, t_min, t_max,
    active)."""
    g = np.random.default_rng(seed)
    tris = ds.t8_card.tris.cpu().numpy().astype(np.float64)
    rows = g.integers(0, tris.shape[0], n)
    p0, e1, e2 = tris[rows, 0:3], tris[rows, 3:6], tris[rows, 6:9]

    def unit(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True),
                              1e-30)

    nrm = unit(np.cross(e1, e2))
    kind, side = g.integers(0, 4, n), g.integers(0, 3, n)
    w = g.uniform(0.0, 1.0, n)
    off = (np.array([1e-7, 1e-5, 1.2e-5, 2.0 ** -16, 1.6e-5])[
        g.integers(0, 5, n)] * g.choice([-1.0, 1.0], n))
    at = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])[side]  # vertices
    edge = np.stack([np.where(side == 0, w, 0.0),  # v = 0, u = 0, u + v = 1
                     np.where(side == 1, w, np.where(side == 2, 1 - w, 0.0))],
                    axis=1)
    edge[side == 2, 0] = w[side == 2]
    near = edge.copy()  # the edge moved out (off > 0) or in by `off`
    near[side == 0, 1] = -off[side == 0]
    near[side == 1, 0] = -off[side == 1]
    near[side == 2] *= (1.0 + off[side == 2])[:, None]
    uv = np.where((kind == 0)[:, None], at,
                  np.where((kind == 1)[:, None], edge,
                           np.where((kind == 2)[:, None], near,
                                    np.stack([w / 2, np.full(n, 0.25)], 1))))
    p = p0 + uv[:, :1] * e1 + uv[:, 1:] * e2
    size = np.linalg.norm(e1, axis=1) + np.linalg.norm(e2, axis=1)
    h = g.uniform(0.05, 2.0, n) * size * g.choice([-1.0, 1.0], n)
    o = p + nrm * h[:, None] + g.normal(0.0, 0.5, (n, 3)) * np.abs(h)[:, None]
    d = unit(p - o)
    flat = kind == 3  # nearly in the triangle's plane, through p
    tilt = np.array([0.0, 1e-7, 1e-5, 1e-3])[g.integers(0, 4, n)]
    d_flat = unit(unit(e1 - e2 * g.uniform(-1, 1, (n, 1)))
                  + nrm * (tilt * g.choice([-1.0, 1.0], n))[:, None])
    d = np.where(flat[:, None], d_flat, d)
    o = np.where(flat[:, None], p - d_flat * np.abs(h)[:, None], o)
    t_max = np.where(np.arange(n) % 2 == 0, np.inf,
                     g.uniform(0.5, 3.0, n) * np.abs(h))
    return (o.astype(np.float32), d.astype(np.float32),
            np.full(n, 1e-4, np.float32), t_max.astype(np.float32),
            np.arange(n) % 7 != 3)


def axis_limits(ds, walk, kernel, plain, axis) -> tuple:
    """(t, best) to put an axis batch's t limits at (at_t_limits): the plain
    version's closest hits; for a walk not in EXACT only on the lanes where
    its kernel finds the same winner at the same t bits (best -1
    elsewhere), as tests/test_torch_walks.py::_hard_rays does."""
    tp, bp = plain(ds, *axis)
    if walk not in EXACT:
        tk, bk = kernel(ds, *axis)
        bp = torch.where((bk == bp) & (tk.view(torch.int32)
                                       == tp.view(torch.int32)), bp, -1)
    return tp, bp


def at_t_limits(args, t, best) -> list:
    """A ray batch with each hit lane's t limits at its hit: a third with
    t_min = t, a third with t_max = t, a third with t_max one float below
    t."""
    o, d, t_min, t_max, active = args
    hit = best >= 0
    k = torch.arange(t.shape[0], device=t.device) % 3
    below = torch.nextafter(t, torch.full_like(t, -float("inf")))
    return [o, d, torch.where(hit & (k == 0), t, t_min),
            torch.where(hit & (k == 1), t,
                        torch.where(hit & (k == 2), below, t_max)), active]


def axis_rays(ds, n: int, seed: int) -> tuple:
    """Rays with zero direction components, from inside the scene's node
    boxes: each from a random point of a random box of bvh_nodes (the
    skip-link walk's; the BVH4 records keep a subset of them), along an axis
    (half the rays: one nonzero component) or a diagonal of two axes (the
    other half), its coordinate on each zero axis snapped to that box's
    min or max, so the slab test meets (box - o) * inf = 0 * inf = NaN
    there. t_min 1e-4, t_max inf; every 7th lane inactive. Returns numpy
    (o, d, t_min, t_max, active)."""
    g = np.random.default_rng(seed)
    nodes = ds.bvh_nodes_pk.cpu().numpy().reshape(-1, 8)[:int(
        ds.meta.n_bvh_nodes)]
    box = nodes[g.integers(0, nodes.shape[0], n)]
    lo, hi = box[:, 0:3], box[:, 3:6]
    o = (lo + g.uniform(0.0, 1.0, (n, 3)) * (hi - lo)).astype(np.float32)
    axis = g.integers(0, 3, n)
    two = np.arange(n) % 2 == 1  # a second nonzero axis
    other = (axis + g.integers(1, 3, n)) % 3
    nonzero = np.zeros((n, 3), bool)
    nonzero[np.arange(n), axis] = True
    nonzero[two, other[two]] = True
    sign = g.choice(np.float32([-1.0, 1.0]), (n, 3))
    size = np.where(two, np.float32(np.sqrt(0.5)), np.float32(1.0))
    d = np.where(nonzero, sign * size[:, None], np.float32(0.0))
    snap = np.where(g.integers(0, 2, (n, 3)) == 0, lo, hi)
    o = np.where(nonzero, o, snap).astype(np.float32)
    return (o, d.astype(np.float32), np.full(n, 1e-4, np.float32),
            np.full(n, np.inf, np.float32), np.arange(n) % 7 != 3)


def walks():
    """walk -> (kernel wrapper, plain version)."""
    from tpu_raytracing_torch.ops import traverse_kernels as TK
    from tpu_raytracing_torch.ops.traverse_bvh8t import intersect_tris_plain

    plains = {
        "bvh8t": intersect_tris_plain,
        "brute": TK.intersect_tris_brute_plain,
        "quad": TK.intersect_tris_quad_plain,
        "quadrow": lambda *a: TK.intersect_tris_quad_plain(*a, rowrec=True),
        "pair": TK.intersect_tris_pair_plain,
        "walk": TK.intersect_tris_skiplink_plain,
    }
    return {w: (TK.WALKS[w], plains[w]) for w in WALK_NAMES}


def compare(walk, mode, tk, bk, tp, bp):
    """Hold a kernel's (t, best) against its plain version's; returns
    (ok, max |dt| or hit-bit mismatches, report)."""
    tk, bk, tp, bp = (x.cpu().numpy() for x in (tk, bk, tp, bp))
    n = bk.shape[0]
    if walk in EXACT:
        wrong = int((bk != bp).sum()
                    + (tk.view(np.int32) != tp.view(np.int32)).sum())
        return wrong == 0, float(wrong), (
            f"{n} rays, {int((bk >= 0).sum())} hits, {wrong} winner or t-bit "
            "differences (bit-equal required)")
    if mode == "any_hit":
        wrong = int(((bk >= 0) != (bp >= 0)).sum())
        return wrong == 0, float(wrong), (
            f"{n} rays, {int((bk >= 0).sum())} occluded, {wrong} hit-bit "
            "mismatches")
    both = (bk >= 0) & (bp >= 0)
    diff = bk != bp
    ties = diff & both & (tk == tp)
    wrong = int((diff & ~ties).sum())
    err = float(np.max(np.abs(tk[both] - tp[both]))) if both.any() else 0.0
    t_ok = bool(np.allclose(tk[both], tp[both], rtol=T_RTOL, atol=0.0))
    ok = wrong == 0 and ties.sum() < MAX_TIE_FRACTION * n and t_ok
    return ok, err, (
        f"{n} rays, {int((bk >= 0).sum())} hits, {int(ties.sum())} equal-t "
        f"ties, {wrong} other winner mismatches, max |dt| {err:.3g} (rtol "
        f"{T_RTOL})")


def compare_trees(ds, mode, args, tk, bk, tp, bp, limit: int = 8) -> tuple:
    """Hold the bvh8t kernel against its plain version, which walks another
    tree (the XLA stack walk over the child-pair rows), on axis rays. Hit
    bits equal; winners equal but for ties (a different winner at t within
    T_RTOL, up to AXIS_TIE_SHARE of the live rays); t within T_RTOL. Except
    for fault F3 (ROADMAP section 3): a walk's box test can cull a box that
    holds a hit, (a) where the ray lies in the plane of a box face across
    which its direction is zero (0 * inf = NaN in the slab test), or (b)
    where the box's entry t rounds above the hit's t and t_best lies
    between them (t_max at a hit's t), so the hit is lost in the tree that
    has that box and found in the other. A lane outside the contract passes
    as F3 only where the brute force plain version, which culls nothing,
    finds a hit too: at the nearer of the two walks' t (within T_RTOL) in
    closest-hit. Prints the first `limit` lanes outside the contract (the
    ray, both answers, the brute force's). Returns (ok, report)."""
    from tpu_raytracing_torch.ops.traverse_kernels import (
        intersect_tris_brute_plain,
    )

    tk, bk, tp, bp = (x.cpu().numpy() for x in (tk, bk, tp, bp))
    hits = bk >= 0
    mismatch = hits != (bp >= 0)
    if mode == "any_hit":
        rest, ties = mismatch, np.zeros_like(mismatch)
    else:
        close = np.isclose(tk, tp, rtol=T_RTOL, atol=0.0)
        ties = (bk != bp) & hits & ~mismatch & close
        rest = (bk != bp) & ~ties
    lanes = np.nonzero(rest)[0]
    f3 = np.zeros(lanes.size, bool)
    if lanes.size:
        sub = torch.from_numpy(lanes).to(args[0].device)
        tb, bb = (x.cpu().numpy() for x in intersect_tris_brute_plain(
            ds, *[x[sub] for x in args]))
        near = np.minimum(np.where(bk[lanes] >= 0, tk[lanes], np.inf),
                          np.where(bp[lanes] >= 0, tp[lanes], np.inf))
        f3 = (bb >= 0) & (mode == "any_hit"
                          or np.isclose(near, tb, rtol=T_RTOL, atol=0.0))
        o, d, t_min, t_max, _ = (x.cpu().numpy() for x in args)
        for j, i in enumerate(lanes[:limit]):
            print(f"#   lane {i}{' (F3)' if f3[j] else ''}: o {o[i].tolist()} "
                  f"d {d[i].tolist()} t_min {t_min[i]!r} t_max {t_max[i]!r}: "
                  f"kernel ({tk[i]!r}, {bk[i]}), plain ({tp[i]!r}, {bp[i]}), "
                  f"brute force ({tb[j]!r}, {bb[j]})", flush=True)
        if lanes.size > limit:
            print(f"#   ... {lanes.size - limit} more lanes", flush=True)
    same = hits & (bk == bp)
    t_ok = bool(np.allclose(tk[same], tp[same], rtol=T_RTOL, atol=0.0))
    few = ties.sum() <= AXIS_TIE_SHARE * int(args[4].sum())
    ok = bool(f3.all()) and few and t_ok
    return ok, (
        f"{bk.shape[0]} rays, {int(hits.sum())} hits, {int(mismatch.sum())} "
        f"hit-bit mismatches, {int(ties.sum())} equal-t ties, {int(f3.sum())} "
        f"lanes of fault F3 (a hit the brute force finds, in a box one tree "
        f"culls), {int((~f3).sum())} other differences")


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


def bound_entry(ops: float, nbytes: float, ops_per_s: float) -> tuple:
    """(bound_ms, bound_by): the longer of bytes over the memory rate and
    operations over `ops_per_s`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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
    return (*bound_entry(ops, nbytes, FP32_OPS_PER_S),
            tot[0] / n_live, tot[1] / n_live, tot[2] / n_live)


def path_shapes(ds, settings) -> tuple:
    """The frame's camera rays and their shadow rays toward the point light,
    and the phase 3 batches: random rays before each. Returns (batches,
    path_shape), each mode -> (origin, direction, t_min, t_max, active,
    early_exit)."""
    from tpu_raytracing_torch.integrator.render import _pixel_grid
    from tpu_raytracing_torch.ops.camera_rays import generate_rays
    from tpu_raytracing_torch.ops.light_sampling import sample_light
    from tpu_raytracing_torch.ops.rng import SamplerConfig, make_stream
    from tpu_raytracing_torch.ops.traverse import intersect_scene

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
    return batches, path_shape


def hold_and_time(ds, walk, kernel, plain, held, shape, label) -> tuple:
    """Hold a walk's kernel against its plain version on the `held` batch,
    then at `shape` read its counters once, time it (20 wrapper calls by
    CUDA events) and its plain version (one call), and compute its bound.
    Returns (ok, stats)."""
    mode = "any_hit" if held[-1] else "closest_hit"
    tp, bp = plain(ds, *held)
    tk, bk = kernel(ds, *held)
    torch.cuda.synchronize()
    ok, err, report = compare(walk, mode, tk, bk, tp, bp)
    print(f"# {walk} {mode}{label}: {report}: {'ok' if ok else 'FAIL'}",
          flush=True)
    n = shape[0].shape[0]
    counts = torch.zeros((n, 3), dtype=torch.int32, device=shape[0].device)
    kernel(ds, *shape, counts=counts)
    bound_ms, bound_by, visits, boxes, tests = bound(ds, walk, counts,
                                                      shape[4])
    ms = time_ms(lambda: kernel(ds, *shape), reps=20)
    plain_ms = time_ms(lambda: plain(ds, *shape), reps=1, warmup=False)
    print(f"# {walk} {mode}{label} timed ({n} rays, "
          f"{int((counts[:, 0] > 0).sum())} live): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms; per live ray {visits:.2f} visits, {boxes:.2f} "
          f"box tests, {tests:.2f} triangle tests; bound {bound_ms:.4f} ms by "
          f"{bound_by} ({bound_ms / ms * 100:.2f}% of the kernel time)",
          flush=True)
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    visits_per_ray=visits, box_tests_per_ray=boxes,
                    tri_tests_per_ray=tests)


def phase_kernel(ds, settings, ptxas_log: str) -> dict:
    """Every kernel vs its plain version in both modes; per (walk, mode)
    stats at the path's shape; the bvh8t walk's ptxas report."""
    batches, path_shape = path_shapes(ds, settings)
    card = ds.t8_card
    print(f"# bvh8t card layout: {card.nodes.shape[0]} node records, "
          f"{card.children.shape[0]} child records, {card.tris.shape[0]} "
          f"triangle rows", flush=True)
    ptxas = {}  # kernel -> its instantiations' reports
    for kernel in ("bvh8t_walk", "t8_brute", "quad_walk", "pair_walk",
                   "skip_walk"):
        ptxas[kernel] = ptxas_report(ptxas_log, kernel)
        for r in ptxas[kernel]:
            print(f"# ptxas {kernel} {r['instance']}: "
                  f"{r.get('registers')} registers, {r.get('spill_stores')} / "
                  f"{r.get('spill_loads')} bytes spill stores / loads, "
                  f"{r.get('stack_frame')} bytes stack frame, {r.get('smem')} "
                  f"bytes shared memory", flush=True)
    stats = {}
    ok = True
    for walk, (kernel, plain) in walks().items():
        for mode, args in batches.items():
            mode_ok, stats[walk, mode] = hold_and_time(
                ds, walk, kernel, plain, args, path_shape[mode],
                " at the path's shape")
            ok = ok and mode_ok
    # the brute kernel at its prefilter's edges, on the bunny and on a mesh
    # whose every hit is an equal-t tie
    from tpu_raytracing_torch.device import compile_scene

    kernel, plain = walks()["brute"]
    ties = compile_scene(repeated_triangles(), ds.device)
    for (mode, seed), (name, accel) in itertools.product(
            (("closest_hit", 5), ("any_hit", 6)),
            (("the bunny", ds), ("repeated triangles", ties))):
        edges = [torch.from_numpy(x).to(ds.device)
                 for x in edge_rays(accel, N_EDGE_RAYS, seed)]
        held = (edges, at_t_limits(edges, *plain(accel, *edges)))
        for label, args in zip(("edge rays", "edge rays at their hits' t"),
                               held):
            tp, bp = plain(accel, *args, mode == "any_hit")
            tk, bk = kernel(accel, *args, mode == "any_hit")
            torch.cuda.synchronize()
            edge_ok, _, report = compare("brute", mode, tk, bk, tp, bp)
            print(f"# brute {mode} on {name}, {label}: {report}: "
                  f"{'ok' if edge_ok else 'FAIL'}", flush=True)
            ok = ok and edge_ok
    # K4, K5, K6 and K1/K2 on axis rays (NaN slabs) and at their hits' t
    for walk, mode in itertools.product((*PERSISTENT, "bvh8t"),
                                        ("closest_hit", "any_hit")):
        kernel, plain = walks()[walk]
        ee = mode == "any_hit"
        axis = [torch.from_numpy(x).to(ds.device)
                for x in axis_rays(ds, N_EDGE_RAYS, 7)]
        held = (axis, at_t_limits(axis, *axis_limits(ds, walk, kernel,
                                                      plain, axis)))
        for label, args in zip(("axis rays", "axis rays at their hits' t"),
                               held):
            tp, bp = plain(ds, *args, ee)
            tk, bk = kernel(ds, *args, ee)
            torch.cuda.synchronize()
            if walk in EXACT:
                hard_ok, _, report = compare(walk, mode, tk, bk, tp, bp)
            else:
                hard_ok, report = compare_trees(ds, mode, args, tk, bk, tp,
                                                bp)
            print(f"# {walk} {mode}, {label}: {report}: "
                  f"{'ok' if hard_ok else 'FAIL'}", flush=True)
            ok = ok and hard_ok
    for walk, mode in itertools.product(("bvh8t", *PERSISTENT),
                                        ("closest_hit", "any_hit")):
        st = stats[walk, mode]
        if walk != "bvh8t":
            st["ptxas"] = ptxas[KERNEL_OF[walk]]
        was = WALK_BEFORE["ms"][walk][mode == "any_hit"]
        print(f"# {walk} {mode}{' (redesigned)' if walk != 'bvh8t' else ''} "
              f"at the path's shape: kernel {st['ms']:.4f} ms against {was} "
              f"ms at {WALK_BEFORE['commit']} ({WALK_BEFORE['card']}, another "
              f"call), {was / st['ms']:.2f}x; bound {st['bound_ms']:.4f} ms, "
              f"{st['bound_ms'] / st['ms'] * 100:.2f}% of the kernel time",
              flush=True)
    for mode in batches:
        st = stats["brute", mode]
        st["ptxas"] = ptxas["t8_brute"]
        was = BRUTE_BEFORE["ms" if mode == "closest_hit" else "any_hit_ms"]
        print(f"# brute {mode} (redesigned) at the path's shape: kernel "
              f"{st['ms']:.4f} ms against {was} ms before the redesign "
              f"({BRUTE_BEFORE['commit']}, {BRUTE_BEFORE['card']}), "
              f"{was / st['ms']:.2f}x; "
              f"bound {st['bound_ms']:.4f} ms, "
              f"{st['bound_ms'] / st['ms'] * 100:.2f}% of the kernel time",
              flush=True)
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version")
    return stats


def launch_counts() -> dict:
    from tpu_raytracing_torch.ops.traverse_kernels import WALKS

    return {w: dict(fn.launches) for w, fn in WALKS.items()}


@contextlib.contextmanager
def kept_batches(walk: str, store: list, calls=None, accels=None,
                 spans=None):
    """Keep a copy of every ray batch the kernel switch hands `walk` in the
    block (or of the `calls`-th ones only, counted from 0), as (origin,
    direction, t_min, t_max, active, early_exit), and the accel it walks
    in `accels` where given; where `spans` is given, bracket every call of
    the walk with CUDA events and append (the accel is a BLAS, mode, start
    event, end event) to it. The walk's own wrapper still runs and counts
    its launches."""
    from tpu_raytracing_torch.device.scene_buffers import BlasTables
    from tpu_raytracing_torch.ops import traverse_kernels as TK

    fn = TK.WALKS[walk]
    seen = [0]

    def keep(ds, origin, direction, t_min, t_max, active, early_exit=False):
        if calls is None or seen[0] in calls:
            store.append((*(x.clone() for x in (origin, direction, t_min,
                                                 t_max, active)), early_exit))
            if accels is not None:
                accels.append(ds)
        seen[0] += 1
        if spans is None:
            return fn(ds, origin, direction, t_min, t_max, active, early_exit)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn(ds, origin, direction, t_min, t_max, active, early_exit)
        end.record()
        spans.append((isinstance(ds, BlasTables),
                      "any_hit" if early_exit else "closest_hit", start, end))
        return res

    TK.WALKS[walk] = keep
    try:
        yield
    finally:
        TK.WALKS[walk] = fn


def fmt_walk_ms(in_frame: dict) -> str:
    return ", ".join(f"{mode} {n} in {ms:.3f} ms"
                     for mode, (n, ms) in sorted(in_frame.items()))


def walk_ms(spans) -> dict:
    """mode -> (calls, milliseconds of the walk calls in all, by their CUDA
    events) from kept_batches' `spans`, after a synchronize."""
    out = {}
    for _, mode, start, end in spans:
        n, ms = out.get(mode, (0, 0.0))
        out[mode] = (n + 1, ms + start.elapsed_time(end))
    return out


def timed_frame(walk: str, ds, s, env: dict) -> tuple:
    """Render ds at settings s through the kernel switch set to `env`, the
    launch counts reset just before and read just after, every call of
    `walk` bracketed by CUDA events. Returns (result, wall seconds, launch
    counts, walk_ms)."""
    from tpu_raytracing_torch.integrator.render import render
    from tpu_raytracing_torch.ops.traverse_kernels import reset_launch_counts

    spans = []
    with kernel_switch(**env):
        reset_launch_counts()
        with kept_batches(walk, [], calls=(), spans=spans):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = render(ds, s)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = launch_counts()
    return res, wall, launches, walk_ms(spans)


def phase_full_frame(scene, settings, card: str, store: list,
                     frames: dict) -> dict:
    from tpu_raytracing_torch.integrator.render import render
    from tpu_raytracing_torch.ops.traverse_kernels import reset_launch_counts

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with kept_batches("bvh8t", store):
        out = render(scene, settings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    img = out.beauty
    mean = float(img.mean())
    print(f"# full frame {img.shape[1]}x{img.shape[0]}, "
          f"{settings.samples_per_pixel} spp, depth {settings.max_ray_depth}: "
          f"{wall:.3f} s wall (scene compile and the batch copies "
          f"included), {out.rays_traced} "
          f"rays, {out.rays_traced / wall / 1e6:.3f} Mrays/s on {card}; "
          f"mean {mean:.6g}; launches {launches['bvh8t']}", flush=True)
    if not np.isfinite(img).all():
        raise AssertionError("non-finite beauty pixels")
    if not mean > 0.0:
        raise AssertionError("beauty mean is not positive")
    if min(launches["bvh8t"].values()) <= 0:
        raise AssertionError(f"a kernel mode never launched: {launches}")
    frames[BENCH_ROW] = ("RGB", img, settings)
    return launches["bvh8t"]


def parity(g, ng, c, nc) -> tuple:
    """(share of pixels within PARITY_PIXEL_RTOL, relative mean difference,
    relative rays_traced difference) of a cuda block against its cpu
    block."""
    close = float(np.all(np.abs(g - c) <= PARITY_PIXEL_RTOL * np.abs(c) + 1e-6,
                         axis=-1).mean())
    mean_rel = abs(float(g.mean()) - float(c.mean())) / abs(float(c.mean()))
    return close, mean_rel, abs(ng - nc) / nc


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
        close, mean_rel, rays_rel = parity(g, ng, c, nc)
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


def phase_switch(scene, settings, card: str) -> dict:
    """The 1-spp frame through each walk of the kernel switch, against the
    bvh8t frame of the same phase; returns walk -> launch counts."""
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
    out, ok = {}, True
    ref = None
    for walk, env in runs.items():
        res, wall, launches, in_frame = timed_frame(walk, ds, s, env)
        img = res.beauty
        mine = launches[walk]
        others = {w: c for w, c in launches.items()
                  if w != walk and any(c.values())}
        run_ok = (min(mine.values()) > 0 and not others
                  and bool(np.isfinite(img).all()) and float(img.mean()) > 0)
        note = ""
        if ref is None:
            ref = res
        else:
            a, b = img, ref.beauty
            close = float(np.all(np.isclose(a, b, rtol=SWITCH_PIXEL_RTOL, atol=0),
                                 axis=-1).mean())
            mean_rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
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
        print(f"# switch {walk} {env}: {img.shape[1]}x{img.shape[0]}, 1 spp, "
              f"depth {s.max_ray_depth}: {wall:.3f} s wall, {res.rays_traced} "
              f"rays, "
              f"{res.rays_traced / wall / 1e6:.3f} Mrays/s on {card}; mean "
              f"{float(img.mean()):.6g}; launches {mine}, other walks "
              f"{others}; the walk's calls in the frame {fmt_walk_ms(in_frame)}"
              f"{note}: {'ok' if run_ok else 'FAIL'}", flush=True)
        out[walk] = mine
    if not ok:
        raise AssertionError("a walk of the kernel switch failed its frame")
    return out


def sphere_cut_effect(ds, settings, card: str) -> tuple:
    """What the sphere pass does to the bvh8t walk on a Cornell scene with a
    sphere: the frame's camera rays with t_max cut at the sphere hit
    against the same rays with the far clip, and their shadow rays with
    the sphere-occluded lanes taken out against all of them. Each batch is
    held against the plain walk, run once with counters, then timed in
    SPHERE_CUT_ROUNDS round-robin rounds of 20 launches by CUDA events;
    returns (ok, batch -> stats)."""
    from tpu_raytracing_torch.integrator.render import _pixel_grid
    from tpu_raytracing_torch.ops.camera_rays import generate_rays
    from tpu_raytracing_torch.ops.light_sampling import sample_light
    from tpu_raytracing_torch.ops.rng import SamplerConfig, make_stream
    from tpu_raytracing_torch.ops.traverse import (
        _intersect_spheres, intersect_scene,
    )
    from tpu_raytracing_torch.ops.traverse_bvh8t import intersect_tris_plain
    from tpu_raytracing_torch.ops.traverse_kernels import WALKS

    dev = ds.device
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    px, py, _ = _pixel_grid(ds.meta.width, ds.meta.height)
    px = torch.from_numpy(px.astype(np.int64)).to(dev)
    py = torch.from_numpy(py.astype(np.int64)).to(dev)
    stream = make_stream(px, py, 0)
    o, d, _, _ = generate_rays(ds, px, py, cfg, stream,
                               settings.samples_per_pixel, True)
    n = o.shape[0]
    full = lambda v: torch.full((n,), v, dtype=torch.float32, device=dev)  # noqa: E731
    yes = torch.ones(n, dtype=torch.bool, device=dev)
    t_min, far = full(ds.meta.near_clip), full(ds.meta.far_clip)
    t_sph, _ = _intersect_spheres(ds, o, d, t_min, far)
    t_cut = torch.where(torch.isfinite(t_sph), t_sph, far)
    t_cam, prim = intersect_scene(ds, o, d, t_min, far)
    ls, _ = sample_light(ds, 0, torch.where((prim >= 0)[:, None],
                                            o + t_cam[:, None] * d, 0.0),
                         cfg, stream)
    so, sd = ls.origin.contiguous(), ls.direction.contiguous()
    s_min, s_max = full(1e-3), ls.distance - 1e-3
    s_sph, _ = _intersect_spheres(ds, so, sd, s_min, s_max)
    lit = prim >= 0
    batches = {
        "camera rays, far clip": (o, d, t_min, far, yes, False),
        "camera rays, t_max cut at the sphere": (o, d, t_min, t_cut, yes,
                                                 False),
        "shadow rays, all": (so, sd, s_min, s_max, lit, True),
        "shadow rays, sphere-occluded lanes out": (
            so, sd, s_min, s_max, lit & ~torch.isfinite(s_sph), True),
    }
    kernel = WALKS["bvh8t"]
    out, ok = {}, True
    for label, b in batches.items():
        mode = "any_hit" if b[-1] else "closest_hit"
        tp, bp = intersect_tris_plain(ds, *b)
        tk, bk = kernel(ds, *b)
        torch.cuda.synchronize()
        b_ok, err, report = compare("bvh8t", mode, tk, bk, tp, bp)
        ok = ok and b_ok
        print(f"# sphere cut, {label}, bvh8t {mode} against the plain walk: "
              f"{report}: {'ok' if b_ok else 'FAIL'}", flush=True)
        counts = torch.zeros((n, 3), dtype=torch.int32, device=dev)
        kernel(ds, *b, counts=counts)
        bound_ms, _, visits, boxes, tests = bound(ds, "bvh8t", counts, b[4])
        out[label] = dict(live=int((counts[:, 0] > 0).sum()), ms=[],
                          max_abs_err=err, visits_per_ray=visits,
                          box_tests_per_ray=boxes, tri_tests_per_ray=tests,
                          bound_ms=bound_ms)
    for _ in range(SPHERE_CUT_ROUNDS):  # round-robin, so order biases none
        for label, b in batches.items():
            out[label]["ms"].append(time_ms(lambda: kernel(ds, *b), reps=20))
    for label, st in out.items():
        ms = float(np.median(st["ms"]))
        st["ns_per_live_ray"] = ms * 1e6 / max(st["live"], 1)
        print(f"# sphere cut, {label}: {st['live']} live of {n} rays, kernel "
              f"{', '.join(f'{t:.4f}' for t in st['ms'])} ms (median "
              f"{st['ns_per_live_ray']:.3f} ns a live ray) on {card}; per "
              f"live ray {st['visits_per_ray']:.2f} visits, "
              f"{st['box_tests_per_ray']:.2f} box tests, "
              f"{st['tri_tests_per_ray']:.2f} triangle tests; bound "
              f"{st['bound_ms']:.4f} ms", flush=True)
    return ok, out


def brute_frame(name: str, ds, s, bvh8t, card: str) -> tuple:
    """Scene `name`'s frame through the brute kernel (TPU_RT_BRUTE_GROUPS
    at its group count), its calls timed by CUDA events, held against the
    phase's bvh8t frame with phase 6's limits. bvh8t: that frame's
    (result, wall seconds, walk_ms). Returns (ok, stats)."""
    from tpu_raytracing_torch.ops.traverse_kernels import t8_groups

    ref, ref_wall, bvh8t_ms = bvh8t
    groups = t8_groups(ds)
    res, wall, launches, brute_ms = timed_frame(
        "brute", ds, s, dict(TPU_RT_PALLAS_KERNEL="bvh8t",
                             TPU_RT_BRUTE_GROUPS=str(groups)))
    img, want = res.beauty, ref.beauty
    mine = launches["brute"]
    others = {w: c for w, c in launches.items() if w != "brute"
              and any(c.values())}
    close = float(np.all(np.isclose(img, want, rtol=SWITCH_PIXEL_RTOL,
                                    atol=0), axis=-1).mean())
    mean_rel = abs(float(img.mean()) - float(want.mean())) / float(want.mean())
    rays_rel = abs(res.rays_traced - ref.rays_traced) / ref.rays_traced
    ok = (min(mine.values()) > 0 and not others
          and bool(np.isfinite(img).all()) and close >= SWITCH_MIN_CLOSE
          and mean_rel <= SWITCH_MEAN_RTOL and rays_rel <= SWITCH_RAYS_RTOL)
    mrays = res.rays_traced / wall / 1e6
    bvh8t_mrays = ref.rays_traced / ref_wall / 1e6
    print(f"# scene {name} through brute (TPU_RT_BRUTE_GROUPS={groups}, "
          f"{ds.t8_card.tris.shape[0]} triangle rows): {wall:.3f} s wall, "
          f"{res.rays_traced} rays, {mrays:.3f} Mrays/s, brute calls "
          f"{fmt_walk_ms(brute_ms)}; through bvh8t {ref_wall:.3f} s wall, "
          f"{bvh8t_mrays:.3f} Mrays/s, bvh8t calls {fmt_walk_ms(bvh8t_ms)}; "
          f"on {card}; launches {mine}, other walks {others}; against "
          f"bvh8t: {close * 100:.4f}% of pixels within rtol "
          f"{SWITCH_PIXEL_RTOL} (limit {SWITCH_MIN_CLOSE * 100:.0f}%), mean "
          f"rel {mean_rel:.2e} (limit {SWITCH_MEAN_RTOL}), rays rel "
          f"{rays_rel:.2e} (limit {SWITCH_RAYS_RTOL}): "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok, dict(groups=groups, launches=mine, wall_s=wall,
                    mrays_per_s=mrays, walk_ms=brute_ms,
                    bvh8t_wall_s=ref_wall, bvh8t_mrays_per_s=bvh8t_mrays,
                    bvh8t_walk_ms=bvh8t_ms, close=close, mean_rel=mean_rel)


def phase_builtin_scenes(card: str, frames: dict) -> dict:
    """The builtin scenes this slice brings: the five beauty scenes with a
    sphere as full frames on cuda at their builtin settings, one block of
    each on cuda against cpu, and the three normals-only scenes' AOVs on
    cuda against cpu. Returns scene -> bvh8t launch counts, plus the
    sphere-cut measurement; keeps each rttest row's cuda frame in
    `frames`."""
    from tpu_raytracing_torch.device import compile_scene
    from tpu_raytracing_torch.integrator.render import (
        StaticSettings, _pixel_grid, render, render_beauty_chunk,
    )
    from tpu_raytracing_torch.ops.rng import SamplerConfig
    from tpu_raytracing_torch.ops.traverse_kernels import reset_launch_counts
    from tpu_raytracing_torch.scene.test_scenes import get_test_scene

    torch.set_num_threads(os.cpu_count() or 1)
    ok, out = True, {}
    for name, ((x0, y0), min_close) in BEAUTY_SCENES.items():
        ts = get_test_scene(name)
        scene, s = ts.scene_func(), ts.settings_func()
        ds = compile_scene(scene)
        res, wall, launches, in_frame = timed_frame("bvh8t", ds, s, {})
        launches = launches["bvh8t"]
        img = res.beauty
        mean = float(img.mean())
        cornell = ds.meta.n_tris > 0
        frame_ok = (bool(np.isfinite(img).all()) and mean > 0.0
                    and (min(launches.values()) > 0 if cornell
                         else not any(launches.values())))
        ok = ok and frame_ok
        out[name] = launches
        frames[name] = ("RGB", img, s)
        print(f"# scene {name}: {img.shape[1]}x{img.shape[0]}, "
              f"{s.samples_per_pixel} spp, depth {s.max_ray_depth}, "
              f"{s.light_sample_count} light samples: {wall:.3f} s wall, "
              f"{res.rays_traced} rays, "
              f"{res.rays_traced / wall / 1e6:.3f} Mrays/s on {card}; mean "
              f"{mean:.6g}; bvh8t launches {launches}"
              f"{'' if cornell else ' (no triangles: no walk, by design)'}"
              f"{'; its calls ' + fmt_walk_ms(in_frame) if cornell else ''}: "
              f"{'ok' if frame_ok else 'FAIL'}", flush=True)
        if name == "metal":
            cut_ok, out["sphere_cut"] = sphere_cut_effect(ds, s, card)
            brute_ok, out["metal_brute"] = brute_frame(
                name, ds, s, (res, wall, in_frame), card)
            ok = ok and cut_ok and brute_ok

        # one 1,024-pixel block on the sphere, cuda against cpu, at 2 spp
        s2 = dataclasses.replace(s, samples_per_pixel=2)
        cfg = SamplerConfig.from_settings(s2.sampler, s2.seed)
        st = StaticSettings.from_settings(s2)
        px, py, _ = _pixel_grid(ds.meta.width, ds.meta.height)
        start = int(np.nonzero((px == x0) & (py == y0))[0][0])
        sel = slice(start, start + SCENE_BLOCK)
        blk = {}
        for dev, dsd in (("cuda", ds), ("cpu", compile_scene(scene, "cpu"))):
            t0 = time.perf_counter()
            r, n = render_beauty_chunk(
                dsd, cfg, st,
                torch.from_numpy(px[sel].astype(np.int64)).to(dev),
                torch.from_numpy(py[sel].astype(np.int64)).to(dev),
                torch.ones(SCENE_BLOCK, dtype=torch.bool, device=dev))
            blk[dev] = (r.cpu().numpy(), int(n), time.perf_counter() - t0)
        (g, ng, tg), (c, nc, tc) = blk["cuda"], blk["cpu"]
        close, mean_rel, rays_rel = parity(g, ng, c, nc)
        block_ok = (mean_rel <= PARITY_MEAN_RTOL and close >= min_close
                    and rays_rel <= PARITY_RAYS_RTOL
                    and bool(np.isfinite(g).all()))
        ok = ok and block_ok
        print(f"# scene {name} block ({SCENE_BLOCK} pixels from ({x0}, {y0}), "
              f"2 spp), cuda vs cpu: mean {g.mean():.6g} vs {c.mean():.6g} "
              f"(rel {mean_rel:.2e}, limit {PARITY_MEAN_RTOL}); "
              f"{close * 100:.2f}% of pixels within rtol {PARITY_PIXEL_RTOL} "
              f"(limit {min_close * 100:.0f}%); rays {ng} vs {nc} (rel "
              f"{rays_rel:.2e}, limit {PARITY_RAYS_RTOL}); cuda {tg:.2f} s, "
              f"cpu {tc:.2f} s: {'ok' if block_ok else 'FAIL'}", flush=True)

    for name in AOV_SCENES:
        ts = get_test_scene(name)
        scene, s = ts.scene_func(), ts.settings_func()
        res = {}
        for dev in ("cuda", "cpu"):
            reset_launch_counts()
            t0 = time.perf_counter()
            res[dev] = (render(scene, s, dev).normals,
                        time.perf_counter() - t0, launch_counts()["bvh8t"])
        (g, tg, launches), (c, tc, _) = res["cuda"], res["cpu"]
        frames[name] = ("Normal", g, s)
        hit_g, hit_c = np.any(g != 0, axis=-1), np.any(c != 0, axis=-1)
        mask_same = float((hit_g == hit_c).mean())
        close = float(np.all(np.abs(g - c) <= AOV_ATOL, axis=-1).mean())
        aov_ok = (g.shape == (400, 400, 3) and bool(np.isfinite(g).all())
                  and mask_same >= AOV_MIN_SHARE and close >= AOV_MIN_SHARE
                  and 0 < hit_c.mean() < 1)
        ok = ok and aov_ok
        print(f"# scene {name} normals {g.shape[1]}x{g.shape[0]}, cuda vs "
              f"cpu: hit masks equal on {mask_same * 100:.4f}%, normals within "
              f"{AOV_ATOL} on {close * 100:.4f}% of pixels (limit "
              f"{AOV_MIN_SHARE * 100:.1f}%), {hit_c.mean() * 100:.2f}% hit; "
              f"cuda {tg:.3f} s on {card}, cpu {tc:.3f} s (scene compile "
              f"included); bvh8t launches "
              f"{launches}: {'ok' if aov_ok else 'FAIL'}", flush=True)
    frames_ok, launches = texture_frames(card, frames)
    out.update(launches)
    if not (ok and frames_ok):
        raise AssertionError("a builtin scene failed its frame or parity")
    return out


def _scene_modules(tmod, mmod, geom):
    """The port's scene, materials and geometry modules unless given."""
    if tmod is None:
        import tpu_raytracing_torch.geometry as geom
        import tpu_raytracing_torch.materials as mmod
        import tpu_raytracing_torch.scene.test_scenes as tmod
    return tmod, mmod, geom


def emissive_box(tmod=None, mmod=None, geom=None):
    """The Cornell box template (cornell_box(): five walls, a point light
    under the ceiling, a 500x500 camera) with a 0.5 x 0.5 quad just under
    the ceiling that emits (5, 5, 5) down into the box. Built from the
    port's modules, or from the ones given (tests build the JAX package's
    copy the same way)."""
    tmod, mmod, geom = _scene_modules(tmod, mmod, geom)
    sb = tmod.cornell_box()
    quad = tmod.make_plane(  # wound to face down
        tmod.v3(-0.25, -0.25, 1.49), tmod.v3(-0.25, 0.25, 1.49),
        tmod.v3(0.25, 0.25, 1.49), tmod.v3(0.25, -0.25, 1.49),
        tmod.v3(0, 0, -1))
    white = sb.add_constant_texture(tmod.v4(1, 1, 1, 1))
    mat = sb.add_material(mmod.Diffuse(albedo=white))
    sb.add_shape_with_transform(
        geom.TriangleMesh(quad), mat, geom.Transform.identity(),
        area_light_radiance=np.array([5.0, 5.0, 5.0], np.float32))
    return sb.build()


def repeated_triangles(tmod=None, mmod=None, geom=None):
    """A mesh of 12 seeded triangles that overlap in depth, each listed 20
    times, under a 32x32 camera at the origin looking down -z: the bvh8t
    layout splits the copies of a triangle over two groups of 10, so a ray
    meets equal-t ties inside a group and across groups. Modules as
    emissive_box's."""
    tmod, mmod, geom = _scene_modules(tmod, mmod, geom)
    g = np.random.default_rng(3)
    verts, tris = [], []
    for k in range(12):
        c = np.array([(k % 3) * 0.5 - 0.5, (k // 3 % 2) * 0.5 - 0.25,
                      -2.0 - 0.25 * k])
        verts.extend(c + g.uniform(-0.5, 0.5, (3, 3)) * [1.0, 1.0, 0.1])
        tris.extend([[3 * k, 3 * k + 1, 3 * k + 2]] * 20)
    sb = tmod.SceneBuilder()
    white = sb.add_constant_texture(tmod.v4(1, 1, 1, 1))
    mat = sb.add_material(mmod.Diffuse(albedo=white))
    mesh = tmod.make_mesh(np.array(verts, np.float32), tris,
                          np.tile([0.0, 0.0, 1.0], (len(verts), 1)))
    sb.add_shape_at_position(geom.TriangleMesh(mesh), mat, tmod.v3(0, 0, 0))
    sb.add_camera(tmod.Camera.lookat_camera_perspective(
        tmod.v3(0, 0, 0), tmod.v3(0, 0, -3), tmod.v3(0, 1, 0), False,
        np.deg2rad(60.0), 32, 32))
    return sb.build()


def textured_cubes(size: int, tmod=None, mmod=None, geom=None):
    """Three cubes in a row under a size x size camera, uv from -1.25 to
    2.5 on every face, whose albedos are: a seeded 48x40 image, TRILINEAR
    and MIRROR (its pyramid pads to 64x64); that image scaled by a
    checker; and a mix of the two by a constant. Modules as emissive_box's."""
    tmod, mmod, geom = _scene_modules(tmod, mmod, geom)
    sb = tmod.SceneBuilder()
    data = np.random.default_rng(7).uniform(0.05, 1.0, (40, 48, 3))
    img = sb.add_image(mmod.Image(data.astype(np.float32)))
    image = sb.add_texture(mmod.ImageTexture(
        image=img, sampler=mmod.TextureSampler(
            filter=mmod.FilterMode.TRILINEAR, wrap=mmod.WrapMode.MIRROR)))
    checker = sb.add_texture(mmod.CheckerTexture(
        color1=tmod.v4(0.9, 0.8, 0.2, 1), color2=tmod.v4(0.1, 0.3, 0.7, 1)))
    scale = sb.add_texture(mmod.ScaleTexture(a=image, b=checker))
    c = sb.add_constant_texture(tmod.v4(0.3, 0.3, 0.3, 1))
    mix = sb.add_texture(mmod.MixTexture(a=image, b=scale, c=c))
    face_uv = np.array([[-1.25, -1.25], [2.5, -1.25], [2.5, 2.5],
                        [-1.25, 2.5]], np.float32)
    for x, tex in ((-1.3, image), (0.0, scale), (1.3, mix)):
        mesh = tmod.make_cube(1.0)
        mesh.uvs = np.tile(face_uv, (6, 1))
        mat = sb.add_material(mmod.Diffuse(albedo=tex))
        sb.add_shape_at_position(geom.TriangleMesh(mesh), mat,
                                 tmod.v3(x, 0, -4))
    sb.add_camera(tmod.Camera.lookat_camera_perspective(
        tmod.v3(0, 1.5, 0), tmod.v3(0, 0, -4), tmod.v3(0, 1, 0), False,
        np.deg2rad(45.0), size, size))
    return sb.build()


def _lookat_matrix(eye, target, up) -> np.ndarray:
    """Row-major camera-to-world matrix of a glTF camera node (it looks
    down its local -z, +y up) at `eye` facing `target`."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    back = eye - target
    back /= np.linalg.norm(back)
    right = np.cross(up, back)
    right /= np.linalg.norm(right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2] = right, np.cross(back, right), back
    m[:3, 3] = eye
    return m


def write_glb(path, meshes, nodes, materials, camera, light) -> None:
    """Write a binary glTF 2.0 scene that both packages' loaders read.

    meshes: (vertices (V, 3), normals (V, 3), triangles (T, 3), material
    index) each; nodes: (mesh index, row-major 4x4 matrix) each, in scene
    order, the camera node and the light node after them; materials: the
    base colour (r, g, b) of a diffuse material each; camera: (eye, target,
    up, yfov in radians), aspect 1; light: a KHR_lights_punctual point light
    (position, colour, intensity). Two nodes that name one mesh make the
    loader emit one primitive under two transforms (an instance)."""
    blob = bytearray()
    views, accessors, gmeshes = [], [], []

    def add(arr, target_type, acc_type, comp):
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": arr.nbytes})
        blob.extend(arr.tobytes())
        acc = {"bufferView": len(views) - 1, "componentType": comp,
               "count": int(arr.shape[0]), "type": acc_type}
        if target_type == "POSITION":
            acc["min"] = arr.min(axis=0).tolist()
            acc["max"] = arr.max(axis=0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    for verts, norms, tris, mat in meshes:
        pos = add(np.ascontiguousarray(verts, np.float32), "POSITION",
                  "VEC3", 5126)
        nrm = add(np.ascontiguousarray(norms, np.float32), "NORMAL",
                  "VEC3", 5126)
        idx = add(np.ascontiguousarray(tris, np.uint32).reshape(-1, 1),
                  "", "SCALAR", 5125)
        gmeshes.append({"primitives": [{
            "attributes": {"POSITION": pos, "NORMAL": nrm},
            "indices": idx, "material": int(mat)}]})
    gnodes = [{"mesh": int(mi),
               "matrix": np.asarray(m, np.float64).T.reshape(-1).tolist()}
              for mi, m in nodes]
    eye, target, up, yfov = camera
    gnodes.append({"camera": 0, "matrix": _lookat_matrix(eye, target, up)
                   .T.reshape(-1).tolist()})
    pos, color, intensity = light
    gnodes.append({"translation": [float(v) for v in pos],
                   "extensions": {"KHR_lights_punctual": {"light": 0}}})
    tree = {
        "asset": {"version": "2.0"},
        "extensionsUsed": ["KHR_lights_punctual"],
        "extensions": {"KHR_lights_punctual": {"lights": [{
            "type": "point", "color": [float(c) for c in color],
            "intensity": float(intensity)}]}},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(gnodes)))}],
        "nodes": gnodes,
        "meshes": gmeshes,
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [float(c) for c in rgb] + [1.0],
            "metallicFactor": 0.0, "roughnessFactor": 1.0}}
            for rgb in materials],
        "cameras": [{"type": "perspective", "perspective": {
            "yfov": float(yfov), "aspectRatio": 1.0, "znear": 0.01,
            "zfar": 100.0}}],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    js = json.dumps(tree).encode()
    js += b" " * (-len(js) % 4)
    blob.extend(b"\0" * (-len(blob) % 4))
    chunks = (struct.pack("<II", len(js), 0x4E4F534A) + js
              + struct.pack("<II", len(blob), 0x004E4942) + bytes(blob))
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(chunks)))
        f.write(chunks)


def _z_turn(deg: float, scale: float, x: float, y: float) -> np.ndarray:
    """Row-major matrix: a turn about +z, a uniform scale, a shift in xy."""
    a = np.deg2rad(deg)
    m = np.eye(4)
    m[:2, :2] = scale * np.array([[np.cos(a), -np.sin(a)],
                                  [np.sin(a), np.cos(a)]])
    m[2, 2] = scale
    m[:2, 3] = x, y
    return m


# the cli phase's four bunnies: (turn about z in degrees, scale, x, y)
BUNNY_NODES = ((0.0, 1.0, -0.55, -0.35), (90.0, 0.8, 0.55, -0.35),
               (200.0, 0.9, -0.5, 0.55), (300.0, 1.1, 0.5, 0.6))


def bunnies_glb(path, instanced: bool) -> None:
    """The cli phase's scene: the port's bunny mesh (28,576 triangles)
    under the four transforms of BUNNY_NODES on a 3 x 3 two-triangle floor,
    a camera above the front edge and one point light, diffuse materials.
    instanced: the four nodes name one mesh (four instances over one
    BLAS); else each names its own mesh entry, and all is baked
    world-space."""
    from tpu_raytracing_torch.scene.test_scenes import load_bunny

    b = load_bunny()
    bunny = (b.vertices, b.normals, b.tris, 0)
    floor = (np.array([[-1.5, -1.5, 0], [1.5, -1.5, 0], [1.5, 1.5, 0],
                       [-1.5, 1.5, 0]]), np.tile([[0.0, 0.0, 1.0]], (4, 1)),
             np.array([[0, 1, 2], [0, 2, 3]]), 1)
    n = len(BUNNY_NODES)
    meshes = [floor] + [bunny] * (1 if instanced else n)
    nodes = [(0, np.eye(4))] + [(1 if instanced else 1 + k, _z_turn(*xf))
                                for k, xf in enumerate(BUNNY_NODES)]
    write_glb(path, meshes, nodes, materials=[(0.8, 0.3, 0.2),
                                              (0.7, 0.7, 0.7)],
              camera=((0.0, -2.8, 1.6), (0.0, 0.1, 0.3), (0.0, 0.0, 1.0),
                      np.deg2rad(45.0)),
              light=((0.6, -1.0, 2.6), (1.0, 1.0, 1.0), 20.0))


def area_shadow_call(ds, settings) -> int:
    """The index, among the walk calls of a frame, of bounce 1's first
    area-light shadow batch in sample 0. A bounce makes one closest-hit
    call, then each light's shadow calls in light order (one for a point
    or direction light, light_sample_count for an area light)."""
    from tpu_raytracing_torch.device.scene_buffers import (
        LIGHT_AREA, LIGHT_DIRECTION, LIGHT_POINT,
    )

    kinds = ds.meta.light_kinds
    n_s = [1 if k in (LIGHT_POINT, LIGHT_DIRECTION)
           else settings.light_sample_count for k in kinds]
    return (1 + sum(n_s)) + 1 + sum(n_s[:kinds.index(LIGHT_AREA)])


def texture_frames(card: str, frames: dict) -> tuple:
    """The frames of the textures and lights slice: checkered_plane,
    environment_light and the emissive box on cuda at their builtin
    settings, launch counts reset just before each and read just after,
    with the launch pattern each must show and one 1,024-pixel block of
    each on cuda against cpu; bounce 1's first area-light shadow batch of
    the emissive frame held against the plain walk, then timed and bounded;
    and the textured cubes' albedo and mip-level AOVs on cuda against cpu.
    Returns (ok, frame -> bvh8t launches, with "area_shadow" -> the
    batch's stats); keeps each rttest row's cuda frame in `frames`."""
    from tpu_raytracing_torch.device import compile_scene
    from tpu_raytracing_torch.integrator.render import (
        StaticSettings, _pixel_grid, render, render_beauty_chunk,
    )
    from tpu_raytracing_torch.ops.rng import SamplerConfig
    from tpu_raytracing_torch.ops.traverse_bvh8t import intersect_tris_plain
    from tpu_raytracing_torch.ops.traverse_kernels import (
        WALKS, reset_launch_counts,
    )
    from tpu_raytracing_torch.scene.test_scenes import get_test_scene
    from tpu_raytracing_torch.settings import AovFlags, RaytracerSettings

    ok, out = True, {}
    for name, ((x0, y0), block_spp, any_hit) in TEXTURE_FRAMES.items():
        if name == "emissive_box":
            scene, s = emissive_box(), RaytracerSettings()
        else:
            ts = get_test_scene(name)
            scene, s = ts.scene_func(), ts.settings_func()
        ds = compile_scene(scene)
        store = []
        keep = (kept_batches("bvh8t", store, {area_shadow_call(ds, s)})
                if name == "emissive_box" else contextlib.nullcontext())
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with keep:
            res = render(ds, s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()["bvh8t"]
        img = res.beauty
        mean = float(img.mean())
        frame_ok = (bool(np.isfinite(img).all()) and mean > 0.0
                    and launches["closest_hit"] > 0
                    and (launches["any_hit"] > 0) == any_hit)
        ok = ok and frame_ok
        out[name] = launches
        if name in GATE_ROWS:
            frames[name] = ("RGB", img, s)
        print(f"# scene {name}: {img.shape[1]}x{img.shape[0]}, "
              f"{s.samples_per_pixel} spp, depth {s.max_ray_depth}, "
              f"{s.light_sample_count} light samples: {wall:.3f} s wall, "
              f"{res.rays_traced} rays, "
              f"{res.rays_traced / wall / 1e6:.3f} Mrays/s on {card}; mean "
              f"{mean:.6g}; bvh8t launches {launches} (any-hit "
              f"{'expected' if any_hit else 'none expected: no light'}): "
              f"{'ok' if frame_ok else 'FAIL'}", flush=True)

        # one 1,024-pixel block, cuda against cpu
        sb = dataclasses.replace(s, samples_per_pixel=block_spp)
        cfg = SamplerConfig.from_settings(sb.sampler, sb.seed)
        st = StaticSettings.from_settings(sb)
        px, py, _ = _pixel_grid(ds.meta.width, ds.meta.height)
        start = int(np.nonzero((px == x0) & (py == y0))[0][0])
        sel = slice(start, start + SCENE_BLOCK)
        ds_cpu = compile_scene(scene, "cpu")
        blk = {}
        for dev, dsd in (("cuda", ds), ("cpu", ds_cpu)):
            t0 = time.perf_counter()
            r, n = render_beauty_chunk(
                dsd, cfg, st,
                torch.from_numpy(px[sel].astype(np.int64)).to(dev),
                torch.from_numpy(py[sel].astype(np.int64)).to(dev),
                torch.ones(SCENE_BLOCK, dtype=torch.bool, device=dev))
            blk[dev] = (r.cpu().numpy(), int(n), time.perf_counter() - t0)
        (g, ng, tg), (c, nc, tc) = blk["cuda"], blk["cpu"]
        close, mean_rel, rays_rel = parity(g, ng, c, nc)
        block_ok = (mean_rel <= PARITY_MEAN_RTOL
                    and close >= TEXTURE_MIN_CLOSE
                    and rays_rel <= PARITY_RAYS_RTOL
                    and bool(np.isfinite(g).all()))
        ok = ok and block_ok
        print(f"# scene {name} block ({SCENE_BLOCK} pixels from ({x0}, {y0}), "
              f"{block_spp} spp), cuda vs cpu: mean {g.mean():.6g} vs "
              f"{c.mean():.6g} (rel {mean_rel:.2e}, limit {PARITY_MEAN_RTOL}); "
              f"{close * 100:.2f}% of pixels within rtol {PARITY_PIXEL_RTOL} "
              f"(limit {TEXTURE_MIN_CLOSE * 100:.0f}%); rays {ng} vs {nc} (rel "
              f"{rays_rel:.2e}, limit {PARITY_RAYS_RTOL}); cuda {tg:.2f} s, "
              f"cpu {tc:.2f} s: {'ok' if block_ok else 'FAIL'}", flush=True)
        if name == "checkered_plane":  # the whole 1-spp frame, not gated
            t0 = time.perf_counter()
            whole = render(ds_cpu, s, "cpu")
            fc, fmean, frays = parity(img, res.rays_traced, whole.beauty,
                                      whole.rays_traced)
            print(f"# scene {name} whole frame, cuda vs cpu (not gated): "
                  f"{fc * 100:.3f}% of pixels within rtol "
                  f"{PARITY_PIXEL_RTOL}; mean rel {fmean:.2e}, rays rel "
                  f"{frays:.2e}; cpu {time.perf_counter() - t0:.2f} s",
                  flush=True)

        if name == "emissive_box":
            b_ok, out["area_shadow"] = area_shadow_batch(
                ds, store, WALKS["bvh8t"], intersect_tris_plain)
            ok = ok and b_ok

    # the textured cubes: albedo and mip-level AOVs, cuda against cpu
    scene = textured_cubes(TEXTURED_CUBES)
    s = RaytracerSettings(
        outputs=AovFlags.NORMALS | AovFlags.ALBEDO | AovFlags.MIP_LEVEL)
    res = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[dev] = (render(scene, s, dev), time.perf_counter() - t0)
    (g, tg), (c, tc) = res["cuda"], res["cpu"]
    hit_g, hit_c = np.any(g.normals != 0, -1), np.any(c.normals != 0, -1)
    alb = float(np.all(np.abs(g.albedo - c.albedo) <= AOV_ATOL, -1).mean())
    mip = float((np.abs(g.mip_level - c.mip_level) <= AOV_ATOL).mean())
    on_mip = c.mip_level != 0
    aov_ok = (bool(np.array_equal(hit_g, hit_c))
              and bool(np.isfinite(g.albedo).all())
              and bool(np.isfinite(g.mip_level).all())
              and alb >= AOV_MIN_SHARE and mip >= AOV_MIN_SHARE
              and 0 < on_mip.mean() < hit_c.mean())
    ok = ok and aov_ok
    print(f"# textured cubes {TEXTURED_CUBES}x{TEXTURED_CUBES}, cuda vs cpu: "
          f"hit masks {'equal' if np.array_equal(hit_g, hit_c) else 'DIFFER'} "
          f"({hit_c.mean() * 100:.2f}% hit); albedo within {AOV_ATOL} on "
          f"{alb * 100:.4f}%, mip level within {AOV_ATOL} on {mip * 100:.4f}% "
          f"of pixels (limit {AOV_MIN_SHARE * 100:.1f}%); mip level on "
          f"{on_mip.mean() * 100:.2f}% of pixels, "
          f"{c.mip_level[on_mip].min():.4f} to {c.mip_level[on_mip].max():.4f}"
          f"; cuda {tg:.3f} s on {card}, cpu {tc:.3f} s (scene compile "
          f"included): {'ok' if aov_ok else 'FAIL'}", flush=True)
    return ok, out


def area_shadow_batch(ds, store, kernel, plain) -> tuple:
    """The emissive frame's kept area-light shadow batch: its origins on
    the emitter and per-lane t_max, held against the plain walk, then timed
    and bounded (hold_and_time). Returns (ok, stats)."""
    if len(store) != 1 or not store[0][-1]:
        print(f"# area-light shadow batch: kept {len(store)} batches, want "
              "one any-hit batch: FAIL", flush=True)
        return False, {}
    batch = store[0]
    o, _, _, t_max, act = batch[:5]
    z, tm = o[act][:, 2], t_max[act]
    shape_ok = (o.shape[0] == ds.meta.width * ds.meta.height
                and bool(act.any())
                and bool(torch.all(torch.abs(z - 1.49) < 1e-5))
                and bool(torch.isfinite(tm).all()) and float(tm.std()) > 0)
    print(f"# area-light shadow batch (bounce 1, sample 0): {o.shape[0]} "
          f"lanes, {int(act.sum())} live, origins at z {float(z.min()):.4f} "
          f"to {float(z.max()):.4f}, t_max {float(tm.min()):.4f} to "
          f"{float(tm.max()):.4f} (std {float(tm.std()):.4f}): "
          f"{'ok' if shape_ok else 'FAIL'}", flush=True)
    held_ok, stats = hold_and_time(ds, "bvh8t", kernel, plain, batch, batch,
                                   " area-light shadow batch")
    return shape_ok and held_ok, dict(stats, live=int(act.sum()))


def pixel_lines(argv) -> list:
    """Run the CLI's pixel command; per sample (hit, uv, normal,
    radiance) as it prints them."""
    import io

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
    """The CLI on glTF files (phase 8): the four bunnies over one BLAS
    through `cli.run(["full", ...])` at the loader's 600x600, launch counts
    reset just before and read just after, each walk call timed by CUDA
    events; its EXR read back; a 1,024-pixel block on cuda against cpu; the
    baked scene's frame against it; bounce 1's first BLAS batch (instance
    0) of each mode held against the plain walk on the BLAS view, timed and
    bounded; `pixel` on cuda against cpu; and `--checkpoint` with
    `--spp-chunk 3` against the one-shot frame. Returns its launches and
    the BLAS batches' stats."""
    import shutil
    import tempfile

    from tpu_raytracing_torch import cli
    from tpu_raytracing_torch.device import compile_scene
    from tpu_raytracing_torch.integrator.render import (
        StaticSettings, _pixel_grid, render_beauty_chunk,
    )
    from tpu_raytracing_torch.ops.rng import SamplerConfig
    from tpu_raytracing_torch.ops.traverse_bvh8t import intersect_tris_plain
    from tpu_raytracing_torch.ops.traverse_kernels import (
        WALKS, reset_launch_counts,
    )
    from tpu_raytracing_torch.scene import scene_from_file
    from tpu_raytracing_torch.settings import RaytracerSettings
    from tpu_raytracing_torch.utils.exr import read_exr

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        paths = {}
        for instanced in (True, False):
            paths[instanced] = os.path.join(tmp, f"{instanced}.glb")
            bunnies_glb(paths[instanced], instanced)

        def full(instanced, name, *extra):
            return cli.run(["full", "--scene-path", paths[instanced],
                            *CLI_FLAGS, "-o", name, *extra])

        per = 1 + len(BUNNY_NODES)  # walks a query: main + each instance
        store, accels, spans = [], [], []
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with kept_batches("bvh8t", store, {2 * per + 1, 3 * per + 1},
                          accels, spans):
            code, out = full(True, "cli_instanced.exr")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()["bvh8t"]
        dev = {(blas, mode): sum(s.elapsed_time(e) for b, m, s, e in spans
                                 if (b, m) == (blas, mode))
               for blas in (False, True) for mode in launches}
        n_blas = {m: sum(1 for b, mm, _, _ in spans if b and mm == m)
                  for m in launches}
        img = out.beauty
        mean = float(img.mean())
        frame_ok = (code == 0 and bool(np.isfinite(img).all()) and mean > 0
                    and launches["closest_hit"] > 0
                    and launches["closest_hit"] % per == 0
                    and launches["any_hit"] == launches["closest_hit"]
                    and n_blas["closest_hit"] * per
                    == (per - 1) * launches["closest_hit"])
        print(f"# cli frame (instanced glTF, {len(BUNNY_NODES)} instances "
              f"over one BLAS): {img.shape[1]}x{img.shape[0]}, "
              f"{' '.join(CLI_FLAGS)}: {wall:.3f} s wall (scene load and "
              f"compile included), {out.rays_traced} rays, "
              f"{out.rays_traced / wall / 1e6:.3f} Mrays/s on {card}; mean "
              f"{mean:.6g}; bvh8t launches {launches}, on the BLAS "
              f"{n_blas} ({per} walks a query); traversal device time by "
              f"CUDA events: closest-hit {dev[False, 'closest_hit']:.3f} ms "
              f"main + {dev[True, 'closest_hit']:.3f} ms BLAS, any-hit "
              f"{dev[False, 'any_hit']:.3f} + {dev[True, 'any_hit']:.3f} ms: "
              f"{'ok' if frame_ok else 'FAIL'}", flush=True)

        channels, w, h = read_exr(os.path.join("scenes", "output",
                                               "cli_instanced.exr"))
        exr_ok = (w, h) == (img.shape[1], img.shape[0]) and all(
            channels[c].tobytes() == np.ascontiguousarray(img[..., k])
            .tobytes() for k, c in enumerate("RGB"))
        print(f"# cli frame's EXR read back ({sorted(channels)}): "
              f"{'bit-equal' if exr_ok else 'DIFFERS'}", flush=True)

        # one 1,024-pixel block on the front bunny, cuda against cpu
        scene = scene_from_file(paths[True])
        s = RaytracerSettings(samples_per_pixel=2, light_sample_count=1,
                              max_ray_depth=8)
        cfg = SamplerConfig.from_settings(s.sampler, s.seed)
        st = StaticSettings.from_settings(s)
        px, py, _ = _pixel_grid(scene.camera.raster_width,
                                scene.camera.raster_height)
        x0, y0 = CLI_BLOCK
        start = int(np.nonzero((px == x0) & (py == y0))[0][0])
        sel = slice(start, start + SCENE_BLOCK)
        blk = {}
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            r, n = render_beauty_chunk(
                compile_scene(scene, d), cfg, st,
                torch.from_numpy(px[sel].astype(np.int64)).to(d),
                torch.from_numpy(py[sel].astype(np.int64)).to(d),
                torch.ones(SCENE_BLOCK, dtype=torch.bool, device=d))
            blk[d] = (r.cpu().numpy(), int(n), time.perf_counter() - t0)
        (g, ng, tg), (c, nc, tc) = blk["cuda"], blk["cpu"]
        close, mean_rel, rays_rel = parity(g, ng, c, nc)
        block_ok = (close >= CLI_MIN_CLOSE and mean_rel <= PARITY_MEAN_RTOL
                    and rays_rel <= PARITY_RAYS_RTOL
                    and bool(np.isfinite(g).all()))
        print(f"# cli block ({SCENE_BLOCK} pixels from ({x0}, {y0}), 2 spp), "
              f"cuda vs cpu: {close * 100:.2f}% of pixels within rtol "
              f"{PARITY_PIXEL_RTOL} (limit {CLI_MIN_CLOSE * 100:.2f}%); mean "
              f"rel {mean_rel:.2e}, rays {ng} vs {nc}; cuda {tg:.2f} s, cpu "
              f"{tc:.2f} s (compiles included): "
              f"{'ok' if block_ok else 'FAIL'}", flush=True)

        # the same scene with every bunny baked world-space
        reset_launch_counts()
        t0 = time.perf_counter()
        code_b, baked = full(False, "cli_baked.exr")
        torch.cuda.synchronize()
        wall_b = time.perf_counter() - t0
        launches_b = launch_counts()["bvh8t"]
        mse = float(np.mean((baked.beauty - img) ** 2))
        baked_ok = (code_b == 0 and mse < CLI_MAX_MSE
                    and launches_b["any_hit"] == launches_b["closest_hit"])
        print(f"# cli baked frame (every bunny world-space): {wall_b:.3f} s "
              f"wall, {baked.rays_traced} rays, launches {launches_b}; MSE "
              f"against the instanced frame {mse:.3e} (limit {CLI_MAX_MSE}): "
              f"{'ok' if baked_ok else 'FAIL'}", flush=True)

        # bounce 1's first BLAS batch of each mode against the plain walk
        held_ok = len(store) == 2 and all(
            type(a).__name__ == "BlasTables" for a in accels)
        blas_stats = {}
        for av, b in zip(accels, store):
            mode = "any_hit" if b[-1] else "closest_hit"
            good, blas_stats[mode] = hold_and_time(
                av, "bvh8t", WALKS["bvh8t"], intersect_tris_plain, b, b,
                " on the cli frame's bounce-1 BLAS batch (instance 0)")
            held_ok = held_ok and good
        if not held_ok:
            print(f"# cli BLAS batches: kept {len(store)}, want one of each "
                  "mode on a BLAS: FAIL", flush=True)

        # pixel, cuda against cpu
        x, y = CLI_PIXEL
        argv = ["pixel", str(x), str(y), "2", "--scene-path", paths[True],
                *CLI_FLAGS]
        got, want = pixel_lines(argv), pixel_lines(argv + ["--backend",
                                                           "cpu"])
        pixel_ok = len(got) == len(want) == 2 and all(
            gh == wh and np.allclose(gu, wu, rtol=0, atol=AOV_ATOL)
            and np.allclose(gn, wn, rtol=0, atol=AOV_ATOL)
            and np.allclose(gr, wr, rtol=PARITY_PIXEL_RTOL, atol=1e-6)
            for (gh, gu, gn, gr), (wh, wu, wn, wr) in zip(got, want))
        rad = lambda res: [  # noqa: E731
            " ".join(f"{v:.7g}" for v in r) for *_, r in res]
        print(f"# cli pixel ({x}, {y}), samples 0 and 1, cuda vs cpu: "
              f"radiance {rad(got)} vs {rad(want)}, hits "
              f"{[h for h, *_ in got]}: {'ok' if pixel_ok else 'FAIL'}",
              flush=True)

        # --checkpoint in chunks of 3 samples against the one-shot frame
        ck = os.path.join(tmp, "ck.npz")
        t0 = time.perf_counter()
        code_c, acc = full(True, "cli_checkpoint.exr", "--checkpoint", ck,
                           "--spp-chunk", "3")
        wall_c = time.perf_counter() - t0
        err = float(np.max(np.abs(acc.beauty - img)))
        with np.load(ck) as f:
            done = int(f["spp_done"])
        ck_ok = (code_c == 0 and done == 8 and acc.rays_traced
                 == out.rays_traced and bool(np.allclose(
                     acc.beauty, img, rtol=CHECKPOINT_RTOL,
                     atol=CHECKPOINT_ATOL)))
        print(f"# cli --checkpoint --spp-chunk 3: {wall_c:.3f} s wall, "
              f"{done} spp in the checkpoint, rays {acc.rays_traced} vs "
              f"{out.rays_traced}; max |diff| against the one-shot frame "
              f"{err:.3g} (rtol {CHECKPOINT_RTOL}, atol {CHECKPOINT_ATOL}): "
              f"{'ok' if ck_ok else 'FAIL'}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not (frame_ok and exr_ok and block_ok and baked_ok and held_ok
            and pixel_ok and ck_ok):
        raise AssertionError("the cli phase failed a check")
    return dict(launches=launches, blas_launches=n_blas, blas=blas_stats)


def phase_rttest(frames: dict, card: str) -> None:
    """Each frame of GATE_ROWS, as phases 4 and 7 rendered it on cuda, held
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
        capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(os.path.abspath(__file__)))
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


def max_clock_hz() -> float:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(res.stdout.strip().splitlines()[0]) * 1e6


def bits_compare(got, want) -> tuple[bool, float, str]:
    """(bit-equal, max |got - want| where both are finite, report)."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    differ = int((g.view(np.int32) != w.view(np.int32)).sum())
    both = np.isfinite(g) & np.isfinite(w)
    err = float(np.max(np.abs(g[both] - w[both]))) if both.any() else 0.0
    return differ == 0, err, (
        f"{g.size} elements, {int(np.isfinite(w).sum())} finite, {differ} "
        f"bit differences, max |diff| {err:.3g}")


def plain_run(fn) -> tuple:
    """(output, milliseconds by CUDA events) of one call of a plain
    version."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_probes(card: str) -> list:
    """The probes' mains (launches counted), then at the same counts each
    configuration's plain version (timed) against one kernel launch, bit for
    bit, and the bounds; returns the four {"kernels": ...} entries."""
    from tpu_raytracing_torch.probes import PROBES, reset_launch_counts
    from tpu_raytracing_torch.probes import bf16_vpu as P4
    from tpu_raytracing_torch.probes import iter_cost as P3
    from tpu_raytracing_torch.probes import slab_cost as P2
    from tpu_raytracing_torch.probes import walk_cost as P1

    print(f"# probes on {card}", flush=True)
    reset_launch_counts()
    torch.cuda.synchronize()
    p3, p4 = P3.main([]), P4.main([])
    p2, p1 = P2.main([]), P1.main(["--iters", str(P1_ITERS)])
    torch.cuda.synchronize()
    launches = {name: dict(fn.launches) for name, fn in PROBES.items()}
    ok = True
    p3_configs = []
    for config, res in zip(P3.CONFIGS, p3):
        R, err, n = config[0], 0.0, res["iters"]
        for small_ids in (False, True):
            ins = P3.script_inputs("cuda", small_ids)
            want, ms = plain_run(lambda: P3.iter_cost_plain(*ins, *config, n))
            if not small_ids:
                plain_ms = ms
            equal, e, report = bits_compare(P3.iter_cost(*ins, *config, n),
                                            want)
            ok, err = ok and equal, max(err, e)
            print(f"# probe_iter_cost {res['config']}, "
                  f"{'small ids' if small_ids else 'script inputs'}, {n} "
                  f"iterations: {report} (bit-equal required): "
                  f"{'ok' if equal else 'FAIL'}", flush=True)
        ops = res["iters_run"] * R * P3.LANE * P3.LG * MT_OPS
        nbytes = 4 * (P3.NB * P3.LG + 6 * P3.RMAX + P3.RMAX + R) * P3.LANE
        bound_ms, bound_by = bound_entry(ops, nbytes, FP32_OPS_PER_S)
        p3_configs.append(dict(
            res, launches=launches["probe_iter_cost"][res["config"]],
            max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, share=bound_ms / res["ms"],
            sm_share=bound_ms / res["ms"] * SMS))
    # one convention for both types, an FMA counted as two operations: the
    # datasheet's fp32 rate, and bf16x2 (no datasheet rate) derived as the
    # fp32 lanes x 2 elements x 2 x the max clock
    clock = max_clock_hz()
    bf16_ops_per_s = SMS * FP32_LANES * 2 * 2 * clock
    print(f"# probes: max SM clock {clock / 1e6:.0f} MHz; fp32 peak "
          f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s (datasheet, an FMA counted as "
          f"two); bf16x2 peak derived as {SMS} SMs x {FP32_LANES} lanes x 2 "
          f"elements x 2 (an FMA) x the max clock = "
          f"{bf16_ops_per_s / 1e12:.2f} Tops/s", flush=True)
    p4_configs = []
    for res in p4:
        name = res["dtype"]
        box, ray = P4.script_inputs("cuda")[name]
        want, plain_ms = plain_run(
            lambda: P4.bf16_vpu_plain(box, ray, res["iters"]))
        equal, err, report = bits_compare(P4.bf16_vpu(box, ray, res["iters"]),
                                          want)
        ok = ok and equal
        print(f"# probe_bf16_vpu {name}, {res['iters']} iterations: {report} "
              f"(bit-equal required): {'ok' if equal else 'FAIL'}", flush=True)
        n = box.numel()
        ops = res["iters"] * n * P4.OPS_PER_ELEMENT
        nbytes = n * (2 * box.element_size() + 4)
        peak = bf16_ops_per_s if name == "bfloat16" else FP32_OPS_PER_S
        bound_ms, bound_by = bound_entry(ops, nbytes, peak)
        # the loop's SASS instructions issued by the block's warps, a clock
        # at the max clock, against one SM's 4 schedulers
        issue = (sum(res["sass"].values()) * P4.THREADS / 32 * res["iters"]
                 / (res["ms"] * 1e-3 * clock) if res["sass"] else None)
        if issue is not None:
            print(f"# probe_bf16_vpu {name}: {issue:.3f} warp instructions a "
                  f"clock at the max clock ({issue / 4 * 100:.1f}% of one "
                  f"SM's 4 issue slots)", flush=True)
        p4_configs.append(dict(
            res, launches=launches["probe_bf16_vpu"][name], max_abs_err=err,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            peak_ops_per_s=peak, share=bound_ms / res["ms"],
            sm_share=bound_ms / res["ms"] * SMS, issue_per_clock=issue))
    eq2, varied2, p2_configs = check_p2(p2, launches["probe_slab_cost"])
    eq1, varied1, p1_configs = check_p1(p1, launches["probe_walk_cost"])
    ok = ok and eq2 and eq1
    entries = []
    for (kname, source, replaces), configs, key in zip(
            PROBE_KERNELS, (p3_configs, p4_configs, p2_configs, p1_configs),
            ("config", "dtype", "variant", "level")):
        for c in configs:
            print(f"# {kname} {c[key]}: kernel {c['ms']:.4f} ms, plain "
                  f"{c['plain_ms']:.2f} ms, bound {c['bound_ms']:.6f} ms by "
                  f"{c['bound_by']} ({c['share'] * 100:.4f}% of the card, "
                  f"{c['sm_share'] * 100:.2f}% of one SM), launches "
                  f"{c['launches']}", flush=True)
        main = next((c for c in configs if c[key] == PROBE_MAIN.get(kname)),
                    configs[0])
        entries.append(dict(
            name=kname, route="cuda", source=CSRC + source, replaces=replaces,
            launches=sum(c["launches"] for c in configs),
            max_abs_err=max(c["max_abs_err"] for c in configs),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            library_ms=None,
            library="none: no single PyTorch call computes the probe",
            config=main[key], configs=configs))
    if not ok:
        raise AssertionError("a probe kernel differs from its plain version")
    if not (varied2 and varied1):
        raise AssertionError("a P2 or P1 input set does not show its slab: "
                             "the drains do not vary, or the share of finite "
                             "outputs is not what the level gives")
    return entries


def check_probe_run(name, case, kernel, plain, n: int, label: str) -> tuple:
    """Run a P2/P1 kernel and its plain version (timed once) at n visits
    with a visits buffer each, and hold them bit for bit: output, stats
    (visits run, the drains' fold) and every visit's mask_s. Returns (ok,
    max |output difference| where both are finite, plain ms, the drains,
    the plain output)."""
    vk, vp = (torch.full((n,), -7, dtype=torch.int32, device="cuda")
              for _ in range(2))
    (want, sp), plain_ms = plain_run(lambda: plain(vp))
    got, sk = kernel(vk)
    torch.cuda.synchronize()
    equal, err, report = bits_compare(got, want)
    same_stats = torch.equal(sk, sp)
    same_visits = torch.equal(vk, vp)
    ok = equal and same_stats and same_visits
    n_run = int(sp[0])
    seq = vp[:n_run].cpu().tolist()
    parities = sorted({m & 1 for m in seq})
    print(f"# {name} {case}, {label}, {n} visits: {report}; stats "
          f"{sk.tolist()} vs {sp.tolist()}; {n_run} visits run, "
          f"{len(set(seq))} distinct masks, parities {parities}, visits "
          f"{'equal' if same_visits else 'DIFFER'} (bit-equal required): "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok, err, plain_ms, seq, want


def probe_bound(ops_needed, ops_written, nbytes, ms) -> dict:
    """Bounds of one probe launch, needed and as written: fp32 operations
    at 67 TFLOP/s or bytes at 3.35 TB/s, each with its card and one-SM
    share of the kernel's time."""
    bound_ms, bound_by = bound_entry(ops_needed, nbytes, FP32_OPS_PER_S)
    written_ms, _ = bound_entry(ops_written, nbytes, FP32_OPS_PER_S)
    return dict(bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms,
                sm_share=bound_ms / ms * SMS, written_bound_ms=written_ms,
                written_sm_share=written_ms / ms * SMS, ops=ops_needed,
                ops_written=ops_written, bytes=nbytes)


def sass_note(name, case, sass) -> int | None:
    n = sum(sass.values()) if sass else None
    print(f"# {name} {case}: visit loop in SASS, "
          + (f"{n} instructions: {dict(sorted(sass.items()))}" if sass
             else "not found"), flush=True)
    return n


def check_drain_probe(name, key, results, launches, kernel, plain, inputs,
                      n_varied, assess) -> tuple:
    """P2 or P1: each configuration at its timed count on the script's
    inputs (the plain version, plain(inputs, case, n, visits, work),
    timed, and filling `work` where it counts what the visits needed) and
    on the varied inputs at n_varied, bit for bit; assess(res, seq, work,
    outputs) -> (bounds, note, fields, the outputs are as the level gives).
    Returns (every kernel equals its plain version, the varied drains vary
    and the outputs are as expected, the configurations)."""
    script, varied = inputs
    equal, shown, configs = True, True, []
    for res in results:
        case, n, work = res[key], res["iters"], {}
        good, err, plain_ms, seq, want = check_probe_run(
            name, case, lambda b: kernel(*script, case, n, visits=b),
            lambda b: plain(script, case, n, b, work), n, "script inputs")
        good2, err2, _, seq2, want2 = check_probe_run(
            name, case, lambda b: kernel(*varied, case, n_varied, visits=b),
            lambda b: plain(varied, case, n_varied, b, {}), n_varied,
            "varied inputs")
        b, note, fields, outputs_ok = assess(res, seq, work, (want, want2))
        equal = equal and good and good2
        shown = shown and len(set(seq2)) > 1 and outputs_ok
        print(f"# {name} {case}: {note}; bound needed {b['bound_ms']:.6f} ms "
              f"by {b['bound_by']} ({b['ops']} operations, "
              f"{b['sm_share'] * 100:.2f}% of one SM), as written "
              f"{b['written_bound_ms']:.6f} ms ({b['ops_written']}, "
              f"{b['written_sm_share'] * 100:.2f}% of one SM)", flush=True)
        configs.append(dict(
            res, **b, **fields, launches=launches[case],
            max_abs_err=max(err, err2), plain_ms=plain_ms,
            sass_instructions=sass_note(name, case, res["sass"])))
    return equal, shown, configs


def check_p2(results, launches) -> tuple:
    """P2 through check_drain_probe; bounds from this run's visits."""
    from tpu_raytracing_torch.probes import slab_cost as P2

    torch.backends.cuda.matmul.allow_tf32 = False

    def assess(res, seq, work, outputs):
        v = res["variant"]
        # bytes: the node words this run's visits read, each once (floor
        # lo.x of 16 slots, mxu a node's whole 16-row block, else 16
        # boxes), the rays it reads, the output
        q, nids = 0, set()
        for m in seq:
            nids.add(q % P2.NODES)
            q += 1 + (m & 1)
        if v == "mxu":
            node_words = len({nid // 16 for nid in nids}) * 16 * P2.LANE
        else:
            node_words = len(nids) * 16 * (1 if v == "floor" else 6)
        ray_words = {"floor": 0, "mxu": 6 * 512}.get(v, 8 * 512)
        nbytes = 4 * (node_words + ray_words + 512) + 8
        need, written = P2_OPS[v]
        b = probe_bound(len(seq) * need, len(seq) * written, nbytes,
                        res["ms"])
        return b, (f"{len(seq)} visits run, {res['ns_per_visit_run']:.1f} ns "
                   f"each, {need} operations a visit needed, {written} "
                   f"written"), {}, True

    return check_drain_probe(
        "probe_slab_cost", "variant", results, launches, P2.slab_cost,
        lambda ins, v, n, visits, work: P2.slab_cost_plain(*ins, v, n,
                                                           visits),
        (P2.script_inputs("cuda"), P2.varied_inputs("cuda")),
        P2_VARIED_ITERS, assess)


def check_p1(results, launches) -> tuple:
    """P1 through check_drain_probe; bounds from this run's visits and the
    work its plain run counted."""
    from tpu_raytracing_torch.probes import walk_cost as P1

    def assess(res, seq, work, outputs):
        trips = work["leaf_trips"]
        fin = [float(torch.isfinite(w).float().mean()) for w in outputs]
        leaves = res["level"] in ("inner50", "cond50")
        # bytes, an upper bound that the operations bound exceeds 100-fold:
        # every node's 16 boxes, meta from the smem level on, the triangle
        # table where leaf trips run, the rays, the output
        nbytes = 4 * (P1.NODES * 16 * 6 + (2048 if res["level"] != "slab"
                                             else 0)
                      + (P1.NODES * P1.LANE if trips else 0) + 7 * 512 + 512)
        needed = (work["slab_tests"] * SLAB_OPS
                  + work["leaf_tests"] * MT_OPS)
        b = probe_bound(needed, len(seq) * P1_SLAB_OPS + trips * P1_TRIP_OPS,
                        nbytes, res["ms"])
        slots = work["slab_tests"] / max(len(seq), 1) / 512
        rays = work["leaf_tests"] / max(trips, 1) / P1.LG
        return b, (f"{len(seq)} visits, {slots:.3f} slots below ni a visit "
                   f"(of 16), {trips} leaf trips with {rays:.1f} rays gated "
                   f"on a trip (of 512), finite outputs {fin[0] * 100:.2f}% "
                   f"/ {fin[1] * 100:.2f}% (script / varied inputs)"), dict(
            leaf_trips=trips, slots_needed=slots, leaf_rays=rays), all(
            (f > 0.0) == leaves for f in fin)

    return check_drain_probe(
        "probe_walk_cost", "level", results, launches, P1.walk_cost,
        lambda ins, lv, n, visits, work: P1.walk_cost_plain(
            *ins, lv, n, visits, work),
        (P1.script_inputs("cuda"), P1.varied_inputs("cuda")),
        P1_VARIED_ITERS, assess)


def tiny_frame():
    """checkered_plane with tests/test_parallel.py's 37x27 camera and
    settings (the port's scene modules): (scene, settings)."""
    from tpu_raytracing_torch.scene.camera import create_perspective_transform
    from tpu_raytracing_torch.scene.test_scenes import get_test_scene

    ts = get_test_scene("checkered_plane")
    scene = ts.scene_func()
    cam = scene.camera
    w, h = 37, 27
    c2r = create_perspective_transform(
        cam.far_clip, cam.near_clip, cam.camera_type.yfov, w, h)
    cam.raster_width, cam.raster_height = w, h
    cam.world_to_raster = cam.camera_to_world.invert().compose(c2r)
    cam.raster_to_camera = c2r.invert()
    settings = ts.settings_func()
    settings.samples_per_pixel = 2
    settings.light_sample_count = 1
    settings.max_ray_depth = 2
    return scene, settings


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


def phase_multigpu(ds_bench, settings, card: str) -> dict:
    """The distributed driver and the ray dump on cuda:0 (phase 11): (a) a
    world of one rank through NCCL on a file:// store, render_distributed
    of the 37x27 frame against render; (b) that frame split into 4 and 8
    tiles, each tile's shard through the per-rank function (shard_sum) one
    after the other, assembled, against render; (c)
    render_accumulated_distributed in chunks, interrupted after the first
    and resumed, against render_accumulated; (d) the CLI's `full
    --multichip` started alone (one rank), its EXR read back, against render
    of the same frame; (e) TPU_RT_DUMP_RAYS=1 on a block of the bench path:
    one batch a bvh8t launch, the kinds, a save/load round trip, and the
    block's time with the dump off and on. The launch counts are reset just
    before (a), (d) and (e) and read just after. More than one rank runs
    only on the CPU (tests/test_torch_parallel.py): the card's machine has
    one card, and NCCL refuses two ranks on one."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from tpu_raytracing_torch import cli
    from tpu_raytracing_torch.device import compile_scene
    from tpu_raytracing_torch.integrator.accumulate import render_accumulated
    from tpu_raytracing_torch.integrator.render import (
        StaticSettings, _pixel_grid, render, render_beauty_chunk,
    )
    from tpu_raytracing_torch.ops.rng import SamplerConfig
    from tpu_raytracing_torch.ops.traverse_kernels import reset_launch_counts
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
    launches = {}

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
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render_distributed(ds, s, mesh=mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches["render_distributed"] = launch_counts()["bvh8t"]
            ok &= same_frame(
                "render_distributed, NCCL world size 1, vs render", out, ref,
                card, f"; NCCL start (group, mesh, first all_reduce) "
                f"{start_s:.3f} s, render {wall:.3f} s, bvh8t launches "
                f"{launches['render_distributed']}")
            ok &= min(launches["render_distributed"].values()) > 0

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
        launches["cli"] = launch_counts()["bvh8t"]
        channels, _, _ = read_exr(os.path.join("scenes", "output",
                                               "multigpu.exr"))
        exr = np.stack([channels[c] for c in "RGB"], axis=-1)
        ok &= code == 0 and not dist.is_initialized()
        ok &= min(launches["cli"].values()) > 0
        ok &= same_frame(
            f"cli `{' '.join(MULTI_CLI_FLAGS)} --multichip full` "
            f"(480x270), its EXR read back, vs render",
            dataclasses.replace(out, beauty=exr), want, card,
            f"; bvh8t launches {launches['cli']}")
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
            counts = launch_counts()["bvh8t"]
            batches = list(raydump.BATCHES)
            kinds = [b["kind"] for b in batches]
            ok &= (len(batches) == sum(counts.values())
                   and kinds.count(0) == counts["closest_hit"] > 0
                   and kinds.count(1) == counts["any_hit"] > 0
                   and kinds[0] == 0 and batches[0]["o"].shape == (n_pix, 3))
        launches["dump"] = counts
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
    return launches


def phase_device(ds, settings, stats: dict, frame: list) -> dict:
    """Device times at the path's shape into `stats`; the frame's bounce-2
    batches held and timed; the frame's traversal replayed, sample 0 by
    bounce (counters and bound from one counting launch a batch) and the
    whole frame by mode."""
    from tpu_raytracing_torch.ops.traverse_bvh8t import intersect_tris_plain
    from tpu_raytracing_torch.ops.traverse_kernels import WALKS

    _, path_shape = path_shapes(ds, settings)
    for walk, (kernel, _) in walks().items():
        for mode, shape in path_shape.items():
            st = stats[walk, mode]
            st["device_ms"] = device_ms(lambda: kernel(ds, *shape), 20,
                                        KERNEL_OF[walk])
            dev_txt = ("not measured" if st["device_ms"] is None
                       else f"{st['device_ms']:.4f} ms")
            print(f"# {walk} {mode} at the path's shape: kernel "
                  f"{st['ms']:.4f} ms, device time {dev_txt}", flush=True)
    kernel = WALKS["bvh8t"]
    depth = settings.max_ray_depth + 1  # closest-hit launches a sample
    modes = ["any_hit" if b[-1] else "closest_hit" for b in frame]
    n_closest = modes.count("closest_hit")
    if n_closest != settings.samples_per_pixel * depth or len(frame) < 4:
        raise AssertionError(f"the frame handed the walk {len(frame)} "
                             f"batches, {n_closest} closest-hit")
    # bounce 2 of sample 0: the third closest-hit batch, then its shadow rays
    i2 = [i for i, m in enumerate(modes) if m == "closest_hit"][2]
    ok, out = True, {}
    for b in (frame[i2], frame[i2 + 1]):
        mode = "any_hit" if b[-1] else "closest_hit"
        good, st = hold_and_time(ds, "bvh8t", kernel, intersect_tris_plain, b,
                                 b, " on the frame's bounce-2 rays")
        st["device_ms"] = device_ms(lambda: kernel(ds, *b), 20,
                                    KERNEL_OF["bvh8t"])
        dev_txt = ("not measured" if st["device_ms"] is None
                   else f"{st['device_ms']:.4f} ms")
        print(f"# bvh8t {mode} on the frame's bounce-2 rays: device time "
              f"{dev_txt}", flush=True)
        ok = ok and good
        out["bounce2_" + mode] = st
    # sample 0 bounce by bounce: one counting launch and 5 timed launches
    for i, b in enumerate(frame[:2 * depth]):
        n = b[0].shape[0]
        counts = torch.zeros((n, 3), dtype=torch.int32, device=b[0].device)
        kernel(ds, *b, counts=counts)
        bound_ms, _, visits, boxes, tests = bound(ds, "bvh8t", counts, b[4])
        ms = time_ms(lambda: kernel(ds, *b), reps=5)
        print(f"# frame sample 0, bounce {i // 2}, {modes[i]}: "
              f"{int((counts[:, 0] > 0).sum())} live of {n} rays, kernel "
              f"{ms:.4f} ms; per live ray {visits:.2f} visits, {boxes:.2f} "
              f"box tests, {tests:.2f} triangle tests; bound {bound_ms:.4f} "
              f"ms", flush=True)
    # the whole frame's traversal, by mode: wrapper time by CUDA events
    # (one warm-up replay), then the kernels' device time in one session
    for mode in ("closest_hit", "any_hit"):
        mine = [b for b, m in zip(frame, modes) if m == mode]

        def replay(mine=mine):
            for b in mine:
                kernel(ds, *b)

        ms = time_ms(replay, reps=1)
        dev = device_ms(replay, 1, KERNEL_OF["bvh8t"])
        dev_txt = "not measured" if dev is None else f"{dev * len(mine):.4f}"
        print(f"# frame traversal, {mode}: {len(mine)} launches, {ms:.4f} "
              f"ms by CUDA events, {dev_txt} ms device time, in all",
              flush=True)
        out["frame_" + mode] = dict(launches=len(mine), ms=ms,
                                    device_ms=None if dev is None
                                    else dev * len(mine))
    if not ok:
        raise AssertionError("the bvh8t walk disagrees with its plain "
                             "version on the frame's bounce-2 rays")
    return out


def kernel_entries(stats: dict, frame: dict, switch: dict,
                   traversal: dict, scenes: dict, cli: dict,
                   multigpu: dict) -> list:
    """The {"kernels": [...]} entries. bvh8t's launches are the full
    frame's (phase 4), the other walks' their switch frame's (phase 6, both
    modes); times and bounds are at the path's shape of the entry's mode
    (closest-hit for the walks, whose any-hit numbers ride along). bvh8t's
    entries also carry their mode's bounce-2 batch and the frame's
    traversal in all (phase 12), their launches in each builtin scene's
    frame (phase 7), in the cli frame (phase 8) and on the multi-gpu paths
    (phase 11: render_distributed, the cli, the dumped block); the any-hit
    entry also
    the emissive frame's area-light shadow batch (phase 7). Then one entry
    a mode for the bvh8t kernel on a BLAS: the cli frame's bounce-1 batch
    of instance 0, with the frame's launches over a BLAS."""
    kernels = []
    for kname, walk, modes, source, line in KERNELS:
        main_mode = modes[0]
        entry = dict(
            name=kname, route="cuda", source=CSRC + source,
            replaces=PALLAS + line,
            launches=(frame[main_mode] if walk == "bvh8t"
                      else sum(switch[walk].values())),
            **stats[walk, main_mode], library_ms=None,
            library="none: no PyTorch call computes a BVH walk",
            mode=main_mode)
        if walk == "bvh8t":
            entry["bounce2"] = traversal["bounce2_" + main_mode]
            entry["frame_traversal"] = traversal["frame_" + main_mode]
            entry["scene_launches"] = {
                name: c[main_mode] for name, c in scenes.items()
                if name in BEAUTY_SCENES or name in TEXTURE_FRAMES}
            entry["scene_launches"]["cli_instanced"] = cli["launches"][
                main_mode]
            for path, counts in multigpu.items():
                entry["scene_launches"]["multi_gpu_" + path] = counts[
                    main_mode]
            if main_mode == "any_hit":
                entry["area_shadow_batch"] = scenes["area_shadow"]
        if len(modes) > 1:
            entry["launches_by_mode"] = switch[walk]
            entry["any_hit"] = stats[walk, "any_hit"]
        if walk == "brute":
            entry["redesigned"] = True
            entry["metal_frame"] = scenes["metal_brute"]
        if walk in PERSISTENT:
            entry["redesigned"] = True
        kernels.append(entry)
    for mode in ("closest_hit", "any_hit"):
        kernels.append(dict(
            name=f"bvh8t_walk<{mode}> on a BLAS", route="cuda",
            source=CSRC + "bvh8t_walk.cu", replaces=PALLAS + ":931",
            launches=cli["blas_launches"][mode], **cli["blas"][mode],
            library_ms=None,
            library="none: no PyTorch call computes a BVH walk", mode=mode,
            batch="the cli frame's bounce 1, instance 0, object-space rays"))
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
    ptxas = [ln for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    print(f"# build: {path.name} in {secs:.2f} s", flush=True)
    for ln in ptxas:
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
    failed = []
    batches = []  # every ray batch the full frame hands the bvh8t walk
    frames = {}  # rttest row -> (channel group, cuda frame, settings)
    results = {}
    phases = (
        ("kernel vs plain", lambda: phase_kernel(ds, settings, log)),
        ("full frame", lambda: phase_full_frame(scene, settings, card,
                                                batches, frames)),
        ("slice parity", lambda: phase_parity(scene, settings)),
        ("kernel switch", lambda: phase_switch(scene, settings, card)),
        ("builtin scenes", lambda: phase_builtin_scenes(card, frames)),
        ("cli and scene files", lambda: phase_cli(card)),
        ("rttest gate", lambda: phase_rttest(frames, card)),
        ("probes", lambda: phase_probes(card)),
        ("multi-gpu", lambda: phase_multigpu(ds, settings, card)),
        ("device times", lambda: phase_device(
            ds, settings, results["kernel vs plain"], batches)),
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
    kernels = kernel_entries(results["kernel vs plain"],
                             results["full frame"], results["kernel switch"],
                             results["device times"],
                             results["builtin scenes"],
                             results["cli and scene files"],
                             results["multi-gpu"])
    kernels += results["probes"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
