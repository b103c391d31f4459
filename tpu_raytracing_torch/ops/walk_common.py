"""What every triangle walk shares: the kernel launch and the plain leaf phase.

- `launch_ray_kernel` checks a ray batch on the card and launches a walk's
  C entry of native_cuda (csrc/*.cu) on the current stream, counted under
  `launch_key`; `check_aligned` and `ray_counter` serve the walks that read
  16-byte records on a persistent grid (bvh8t, quad, pair, skip-link).
- `no_hits` is the answer of an empty batch or scene.
- `leaf_records`, `leaf_first_min` and `pop` are the pieces of the plain
  PyTorch walks: a leaf's triangle records, its first-minimum hit, and a
  per-lane stack pop.

The walks themselves are ops/traverse_bvh8t.py (the default) and
ops/traverse_kernels.py (the rest of the kernel switch).
"""
from __future__ import annotations

import torch

from ..accel.bvh import MAX_LEAF_SIZE
from ..native_cuda import check_tensor, launch
from .intersect import ray_triangle

STACK_CAP = 64  # local-memory stack entries of the kernels (kStackCap)
DONE = -1       # the node pointer of a lane whose walk has ended
# each walk's C entry; quad and quadrow share one
WALK_ENTRIES = {"bvh8t": "tpu_rt_bvh8t_walk", "brute": "tpu_rt_t8_brute",
                "quad": "tpu_rt_quad_walk", "quadrow": "tpu_rt_quad_walk",
                "pair": "tpu_rt_pair_walk", "walk": "tpu_rt_skip_walk"}


def launch_key(walk: str, early_exit: bool) -> tuple[str, str]:
    """The (entry, tag) under which native_cuda counts a launch of `walk`
    in its mode."""
    return (WALK_ENTRIES[walk],
            f"{walk} {'any_hit' if early_exit else 'closest_hit'}")


def pop(cur, sp, stack, rows, do):
    """Lanes `rows` where `do` pop their stack (or finish when empty)."""
    can = sp > 0
    top = stack[rows, torch.clamp(sp - 1, min=0)]
    cur = torch.where(do, torch.where(can, top, torch.full_like(top, DONE)),
                      cur)
    sp = torch.where(do & can, sp - 1, sp)
    return cur, sp


def leaf_records(tris, first, n_tris: int):
    """(L, MAX_LEAF_SIZE, C) rows first .. first + MAX_LEAF_SIZE - 1 of a
    triangle table, clamped to its last triangle."""
    offs = torch.arange(MAX_LEAF_SIZE, dtype=torch.int64, device=first.device)
    return tris[torch.clamp(first[:, None].long() + offs[None, :],
                            max=n_tris - 1)]


def leaf_first_min(origin, direction, t_min, t_best, pack, count):
    """The leaf phase of every walk on (L,) lanes: Moller-Trumbore against
    the (L, K, >= 9) vertex records `pack` (p0 p1 p2), of which the first
    `count` are the leaf's, in [t_min, t_best]; the first minimum wins.
    Returns (t_leaf, k, leaf_hit)."""
    valid, t, _, _ = ray_triangle(
        origin[:, None, :], direction[:, None, :], pack[..., 0:3],
        pack[..., 3:6], pack[..., 6:9], t_min[:, None], t_best[:, None])
    offs = torch.arange(pack.shape[1], device=origin.device)
    t = torch.where(valid & (offs[None, :] < count[:, None]), t,
                    torch.full_like(t, float("inf")))
    k = torch.argmin(t, dim=1)
    t_leaf = torch.gather(t, 1, k[:, None])[:, 0]
    return t_leaf, k, torch.isfinite(t_leaf)


def no_hits(t_max, B: int):
    """(t_max, -1) for every ray: an empty batch or scene."""
    return (t_max.to(torch.float32).expand(B).clone(),
            torch.full((B,), -1, dtype=torch.int32, device=t_max.device))


def check_aligned(tables) -> None:
    """Raise unless every (name, tensor, dtype) table is contiguous and
    16-byte aligned: the kernels read its records with 16-byte loads."""
    for name, x, _ in tables:
        if x.data_ptr() % 16 or not x.is_contiguous():
            raise ValueError(f"{name}: the kernel reads aligned 16-byte "
                             "records of a contiguous tensor")


def ray_counter(dev):
    """The fetch counter of a persistent walk (the launch zeroes it), as
    the table the kernel takes after its scene tables."""
    return ("next_ray", torch.empty(1, dtype=torch.int32, device=dev),
            torch.int32)


def launch_ray_kernel(walk: str, early_exit: bool, tables, origin,
                      direction, t_min, t_max, active, ints, counts=None):
    """Check a ray batch on the card and launch the C entry of `walk` on
    the current stream, counted under launch_key(walk, early_exit);
    returns (t, best).

    tables: (name, tensor, dtype) of the scene tables the kernel reads, in
    its argument order; ints: the int arguments after n_rays; counts: None,
    or a contiguous (B, 3) int32 tensor the kernel fills with node visits,
    box tests and triangle tests per ray. A launch the card refuses
    raises."""
    dev = origin.device
    B = origin.shape[0]
    # held in locals until the launch is queued, so that no contiguous copy
    # is freed (and its block reused by t or best) before the kernel runs
    tabs = [check_tensor(n, x, x.shape, dt, dev) for n, x, dt in tables]
    rays = [
        check_tensor("origin", origin, (B, 3), torch.float32, dev),
        check_tensor("direction", direction, (B, 3), torch.float32, dev),
        check_tensor("t_min", t_min, (B,), torch.float32, dev),
        check_tensor("t_max", t_max, (B,), torch.float32, dev),
        check_tensor("active", active, (B,), torch.bool, dev),
    ]
    t = torch.empty(B, dtype=torch.float32, device=dev)
    best = torch.empty(B, dtype=torch.int32, device=dev)
    if counts is not None:
        check_tensor("counts", counts, (B, 3), torch.int32, dev)
        if not counts.is_contiguous():
            raise ValueError("counts: expected a contiguous tensor")
    entry, tag = launch_key(walk, early_exit)
    launch(entry, dev, *[x.data_ptr() for x in tabs],
           *[x.data_ptr() for x in rays], t.data_ptr(), best.data_ptr(),
           None if counts is None else counts.data_ptr(), B, *ints, tag=tag)
    return t, best
