"""Triangle closest-hit / any-hit: the CUDA bvh8t walk and its plain twin.

Counterpart of tpu_raytracing/ops/traverse_pallas.py. `intersect_tris_bvh8t`
has the contract of `intersect_tris_pallas`: it returns (t, best) with t the
hit distance (t_max where there is no hit) and best the winning triangle in
BVH order (-1 where there is none); inactive lanes return (t_max, -1).

- On a CUDA tensor it launches csrc/bvh8t_walk.cu (the port of the TPU's
  `_t8_kernel`) or raises. There is no fallback.
- On a CPU tensor it runs `intersect_tris_plain`, a PyTorch port of the
  JAX package's XLA stack walk (`ops/traverse.py::_intersect_stack`) over
  the child-pair rows, which is what JAX itself runs on the CPU.

The two walk different trees over the same triangles, so winners agree
except on equal-t ties between triangles of different leaves.
"""
from __future__ import annotations

import torch

from tpu_raytracing.accel.bvh import MAX_LEAF_SIZE

from .. import native_cuda
from ..device.scene_buffers import DeviceScene
from .intersect import ray_aabb, ray_triangle

STACK_CAP = 64  # local-memory stack entries of the kernel (kStackCap)
_DONE = -1


def _pop(cur, sp, stack, rows, do):
    """Lanes `rows` where `do` pop their stack (or finish when empty)."""
    can = sp > 0
    top = stack[rows, torch.clamp(sp - 1, min=0)]
    cur = torch.where(do, torch.where(can, top, torch.full_like(top, _DONE)),
                      cur)
    sp = torch.where(do & can, sp - 1, sp)
    return cur, sp


def intersect_tris_plain(ds: DeviceScene, origin, direction, t_min, t_max,
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
    cur = torch.where(active, ds.meta.root_meta, _DONE).to(torch.int32)
    sp = torch.zeros(B, dtype=torch.int64, device=dev)
    stack = torch.zeros((B, depth), dtype=torch.int32, device=dev)
    offs = torch.arange(MAX_LEAF_SIZE, dtype=torch.int32, device=dev)

    def inner():
        while True:
            lanes = torch.nonzero((cur != _DONE) & ((cur & 7) == 0))[:, 0]
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
            c, s = _pop(c, s, stack, lanes, ~hit_l & ~hit_r)
            cur[lanes] = c
            sp[lanes] = s

    while bool((cur != _DONE).any()):
        inner()
        lanes = torch.nonzero((cur != _DONE) & ((cur & 7) > 0))[:, 0]
        if lanes.numel() == 0:
            continue
        c = cur[lanes]
        count = c & 7
        first = c >> 3
        tid = torch.clamp(first[:, None] + offs[None, :], max=n_tris - 1)
        pack = tri_pack[tid.long()]
        tb = t_best[lanes]
        valid, t, _, _ = ray_triangle(
            origin[lanes][:, None, :], direction[lanes][:, None, :],
            pack[..., 0:3], pack[..., 3:6], pack[..., 6:9],
            t_min[lanes][:, None], tb[:, None],
        )
        ok = valid & (offs[None, :] < count[:, None])
        t = torch.where(ok, t, torch.full_like(t, float("inf")))
        k = torch.argmin(t, dim=1)
        t_leaf = torch.gather(t, 1, k[:, None])[:, 0]
        leaf_hit = torch.isfinite(t_leaf)
        t_best[lanes] = torch.where(leaf_hit, t_leaf, tb)
        b = torch.where(leaf_hit, first + k.to(torch.int32), best[lanes])
        best[lanes] = b
        s = sp[lanes]
        do = torch.ones_like(leaf_hit)
        if early_exit:
            fin = b >= 0
            c = torch.where(fin, torch.full_like(c, _DONE), c)
            s = torch.where(fin, torch.zeros_like(s), s)
            do = ~fin
        c, s = _pop(c, s, stack, lanes, do)
        cur[lanes] = c
        sp[lanes] = s
    return t_best, best


def _check(name, x, shape, dtype, device):
    if x.shape != shape or x.dtype != dtype or x.device != device:
        raise ValueError(
            f"{name}: expected {tuple(shape)} {dtype} on {device}, got "
            f"{tuple(x.shape)} {x.dtype} on {x.device}")
    return x.contiguous()


def intersect_tris_bvh8t(ds: DeviceScene, origin, direction, t_min, t_max,
                         active, early_exit: bool = False):
    """Closest-hit (or any-hit with early_exit) over the scene's triangles.

    CPU tensors take the plain walk; CUDA tensors launch the kernel, and
    each launch adds one to `intersect_tris_bvh8t.launches[mode]`."""
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
    origin = _check("origin", origin, (B, 3), torch.float32, dev)
    direction = _check("direction", direction, (B, 3), torch.float32, dev)
    t_min = _check("t_min", t_min, (B,), torch.float32, dev)
    t_max = _check("t_max", t_max, (B,), torch.float32, dev)
    active = _check("active", active, (B,), torch.bool, dev)
    nodes = _check("t8_nodes", ds.t8_nodes, ds.t8_nodes.shape,
                   torch.float32, dev)
    tris = _check("t8_tris", ds.t8_tris, ds.t8_tris.shape, torch.float32, dev)
    meta = _check("t8_meta", ds.t8_meta, ds.t8_meta.shape, torch.int32, dev)
    if B == 0 or ds.meta.n_tris == 0:
        return t_max.clone(), torch.full((B,), -1, dtype=torch.int32,
                                         device=dev)
    t = torch.empty(B, dtype=torch.float32, device=dev)
    best = torch.empty(B, dtype=torch.int32, device=dev)
    rc = native_cuda.load().tpu_rt_bvh8t_walk(
        nodes.data_ptr(), tris.data_ptr(), meta.data_ptr(),
        origin.data_ptr(), direction.data_ptr(), t_min.data_ptr(),
        t_max.data_ptr(), active.data_ptr(), t.data_ptr(), best.data_ptr(),
        B, int(ds.meta.t8_width), int(ds.meta.t8_leaf), int(early_exit),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"bvh8t walk launch failed: CUDA error {rc}")
    intersect_tris_bvh8t.launches["any_hit" if early_exit else "closest_hit"] += 1
    return t, best


intersect_tris_bvh8t.launches = {"closest_hit": 0, "any_hit": 0}


def reset_launch_counts() -> None:
    for k in intersect_tris_bvh8t.launches:
        intersect_tris_bvh8t.launches[k] = 0
