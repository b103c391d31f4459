"""Triangle closest-hit / any-hit: the CUDA bvh8t walk and its plain twin.

Counterpart of tpu_raytracing/ops/traverse_pallas.py. `intersect_tris_bvh8t`
has the contract of `intersect_tris_pallas`: it returns (t, best) with t the
hit distance (t_max where there is no hit) and best the winning triangle in
BVH order (-1 where there is none); inactive lanes return (t_max, -1).

- On a CUDA tensor it launches csrc/bvh8t_walk.cu (the port of the TPU's
  `_t8_kernel`, over the card layout `t8_card` that
  device/scene_buffers.py::bvh8t_card_layout builds from the JAX tables, of
  the main accel or of one BLAS) or raises. There is no fallback.
- On a CPU tensor it runs `intersect_tris_plain`, a PyTorch port of the
  JAX package's XLA stack walk (`ops/traverse.py::_intersect_stack`) over
  the child-pair rows, which is what JAX itself runs on the CPU.

The two walk different trees over the same triangles, so winners agree
except on equal-t ties between triangles of different leaves.
"""
from __future__ import annotations

import torch

from ..device.scene_buffers import Accel
from .intersect import ray_aabb
from .walk_common import (
    DONE, STACK_CAP, check_aligned, launch_ray_kernel, leaf_first_min,
    leaf_records, no_hits, pop, ray_counter,
)


def intersect_tris_plain(ds: Accel, origin, direction, t_min, t_max,
                         active, early_exit: bool = False):
    """Near-first stack walk over child-pair rows (plain PyTorch).

    Per lane the same walk as `_intersect_stack`: internal steps test both
    children of one row, descend into the nearer hit child and push the
    farther; parked leaves intersect their <= MAX_LEAF_SIZE triangles and
    keep the first minimum. Each loop step works on the lanes it moves."""
    B = origin.shape[0]
    dev = origin.device
    t_best = t_max.to(torch.float32).expand(B).clone()
    best = torch.full((B,), -1, dtype=torch.int32, device=dev)
    n_tris = ds.meta.n_tris
    if n_tris == 0 or B == 0:
        return t_best, best
    rows_tab, tri_pack = ds.bvh2_rows, ds.tri_pack
    depth = max(int(ds.meta.bvh2_depth), 1)
    inv_dir = 1.0 / direction
    cur = torch.where(active, ds.meta.root_meta, DONE).to(torch.int32)
    sp = torch.zeros(B, dtype=torch.int64, device=dev)
    stack = torch.zeros((B, depth), dtype=torch.int32, device=dev)

    def inner():
        while True:
            lanes = torch.nonzero((cur != DONE) & ((cur & 7) == 0))[:, 0]
            if lanes.numel() == 0:
                return
            c = cur[lanes]
            row = rows_tab[(c >> 3).long()]
            o, inv = origin[lanes], inv_dir[lanes]
            tmn, tb = t_min[lanes], t_best[lanes]
            tl0, tl1 = ray_aabb(o, inv, row[:, 0:3], row[:, 3:6])
            tr0, tr1 = ray_aabb(o, inv, row[:, 6:9], row[:, 9:12])
            hit_l = (tl0 <= tl1) & (tl1 >= tmn) & (tl0 <= tb)
            hit_r = (tr0 <= tr1) & (tr1 >= tmn) & (tr0 <= tb)
            meta_l = row[:, 12].contiguous().view(torch.int32)
            meta_r = row[:, 13].contiguous().view(torch.int32)
            both = hit_l & hit_r
            l_near = tl0 <= tr0
            near = torch.where(l_near, meta_l, meta_r)
            far = torch.where(l_near, meta_r, meta_l)
            s = sp[lanes]
            stack[lanes[both], s[both]] = far[both]
            s = s + both.long()
            one = hit_l ^ hit_r
            nxt = torch.where(both, near, torch.where(hit_l, meta_l, meta_r))
            c = torch.where(both | one, nxt, c)
            c, s = pop(c, s, stack, lanes, ~hit_l & ~hit_r)
            cur[lanes] = c
            sp[lanes] = s

    while bool((cur != DONE).any()):
        inner()
        lanes = torch.nonzero((cur != DONE) & ((cur & 7) > 0))[:, 0]
        if lanes.numel() == 0:
            continue
        c = cur[lanes]
        count = c & 7
        first = c >> 3
        tb = t_best[lanes]
        t_leaf, k, leaf_hit = leaf_first_min(
            origin[lanes], direction[lanes], t_min[lanes], tb,
            leaf_records(tri_pack, first, n_tris), count)
        t_best[lanes] = torch.where(leaf_hit, t_leaf, tb)
        b = torch.where(leaf_hit, first + k.to(torch.int32), best[lanes])
        best[lanes] = b
        s = sp[lanes]
        do = torch.ones_like(leaf_hit)
        if early_exit:
            fin = b >= 0
            c = torch.where(fin, torch.full_like(c, DONE), c)
            s = torch.where(fin, torch.zeros_like(s), s)
            do = ~fin
        c, s = pop(c, s, stack, lanes, do)
        cur[lanes] = c
        sp[lanes] = s
    return t_best, best


def intersect_tris_bvh8t(ds: Accel, origin, direction, t_min, t_max,
                         active, early_exit: bool = False, counts=None):
    """Closest-hit (or any-hit with early_exit) over the scene's triangles.

    `ds` is an accel (traverse_kernels.py::accel_of): a DeviceScene's main
    tables or one BlasTables. CPU tensors take the plain walk; CUDA tensors
    launch the kernel over its card layout (`ds.t8_card`). `counts` (card
    only) is launch_ray_kernel's."""
    dev = origin.device
    if dev.type == "cpu":
        return intersect_tris_plain(ds, origin, direction, t_min, t_max,
                                    active, early_exit)
    if dev.type != "cuda":
        raise ValueError(f"bvh8t walk: unsupported device {dev}")
    if ds.meta.t8_stack > STACK_CAP:
        raise ValueError(
            f"bvh8t stack bound {ds.meta.t8_stack} exceeds {STACK_CAP}")
    B = origin.shape[0]
    if B == 0 or ds.meta.n_tris == 0:
        return no_hits(t_max, B)
    if ds.meta.t8_leaf > 32:  # the warp tests a group a row a lane
        raise ValueError(f"bvh8t groups of {ds.meta.t8_leaf} rows exceed 32")
    card = ds.t8_card
    tables = [("t8_card.nodes", card.nodes, torch.int32),
              ("t8_card.children", card.children, torch.float32),
              ("t8_card.tris", card.tris, torch.float32)]
    check_aligned(tables)
    return launch_ray_kernel(
        "bvh8t", early_exit, [*tables, ray_counter(dev)],
        origin, direction, t_min, t_max, active,
        [int(ds.meta.t8_width), int(early_exit)],
        counts)
