"""The triangle query behind the JAX kernel switch: dispatch, the CUDA walks
beside bvh8t, and their plain PyTorch versions.

Counterpart of the dispatch in tpu_raytracing/ops/traverse_pallas.py::
intersect_tris_pallas (:1792-1881). `intersect_tris` reads the same two
environment variables, at call time, with the same defaults and rule:

- TPU_RT_PALLAS_KERNEL=bvh8t (the default): the bvh8t walk
  (ops/traverse_bvh8t.py), or the treeless brute kernel when the scene has
  at most TPU_RT_BRUTE_GROUPS (default 0) triangle groups;
- quad / quadrow: the BVH4 walk over bvh4_recs_pk + tri_pack_pk, or over
  bvh4_rows + tri_rows;
- pair: the child-pair walk over bvh2_rows_pk + tri_pack_pk;
- any other value: the stackless skip-link walk over bvh_nodes_pk +
  tri_pack_pk.

Every wrapper has the contract of intersect_tris_pallas: (t, best) with t
the hit distance (t_max where there is none) and best the winning triangle
in BVH order (-1 where there is none); inactive lanes return (t_max, -1).
On a CUDA tensor it launches its kernel (csrc/*.cu), which native_cuda
counts under walk_common.launch_key, or raises; a stack bound above the
kernel's cap raises too (the JAX package degrades to its XLA walk there
instead), and so does a table that the quad, pair or skip-link kernel
cannot read with 16-byte loads. On a CPU tensor it runs its plain version:

- brute: `intersect_tris_brute_plain`, dense over the t8 groups, bit-equal
  to the kernel;
- walk: `intersect_tris_skiplink_plain`, a port of ops/traverse.py::
  _intersect_skiplink over the records of bvh_nodes_pk + tri_pack,
  bit-equal to the kernel;
- pair: `intersect_tris_pair_plain`, a per-lane child-pair walk over the
  records of bvh2_rows_pk + tri_pack, in the kernel's child order,
  bit-equal to the kernel;
- quad / quadrow: `intersect_tris_quad_plain`, a per-lane BVH4 walk over the
  tables the kernel reads, in the kernel's child order, bit-equal to the
  kernel.

Walks that order children differently reach the same leaves, so their
winners agree except on equal-t ties between leaves.

A walk reads one accel: the scene's main tables (the DeviceScene itself) or
one shared BLAS (a BlasTables, which carries the same attribute names).
`accel_of` picks it, as traverse_pallas.py::_accel_of does, and the switch
decides per accel: the brute kernel takes a BLAS of at most
TPU_RT_BRUTE_GROUPS groups too.
"""
from __future__ import annotations

import os

import torch

from ..accel.bvh import MAX_LEAF_SIZE
from ..device.scene_buffers import Accel, DeviceScene
from ..native_cuda import on_card
from .intersect import ray_aabb, ray_triangle_edges
from .traverse_bvh8t import intersect_tris_bvh8t
from .walk_common import (
    DONE, STACK_CAP, check_aligned, launch_ray_kernel, leaf_first_min,
    leaf_records, no_hits, pop, ray_counter,
)

G8_PER_BLOCK = 12  # bvh8t tri groups per triangle block (10 columns each)
_F32 = torch.float32
# elements of the brute plain version's (rays, groups, rows) working tensors
_BRUTE_CHUNK = 1 << 22


def kernel_kind() -> str:
    """traverse_pallas.py::_kernel_kind."""
    return os.environ.get("TPU_RT_PALLAS_KERNEL", "bvh8t")


def brute_groups_max() -> int:
    """traverse_pallas.py::brute_groups_max: 0 (never) unless set."""
    return int(os.environ.get("TPU_RT_BRUTE_GROUPS", "0"))


def accel_of(ds: DeviceScene, blas: int | None = None) -> Accel:
    """The tables a walk reads: the main ones, or BLAS `blas`'s."""
    return ds if blas is None else ds.blas_tables[blas]


def t8_groups(ds: Accel) -> int:
    """Triangle groups of the bvh8t blocks, padding groups included (the
    count the brute kernel tests, traverse_pallas.py:1836)."""
    return ds.t8_tris.shape[0] // int(ds.meta.t8_leaf) * G8_PER_BLOCK


def select_walk(ds: Accel) -> str:
    """The walk the switch selects: bvh8t, brute, quad, quadrow, pair or
    walk (the skip-link walk)."""
    kind = kernel_kind()
    if kind == "bvh8t":
        return "brute" if t8_groups(ds) <= brute_groups_max() else "bvh8t"
    if kind in ("quad", "quadrow", "pair"):
        return kind
    return "walk"


def intersect_tris(ds: Accel, origin, direction, t_min, t_max, active,
                   early_exit: bool = False, blas: int | None = None):
    """Closest-hit (or any-hit) through the walk the switch selects, over
    the main tables or over BLAS `blas` (object-space rays; `best` is
    BLAS-local)."""
    av = accel_of(ds, blas)
    return WALKS[select_walk(av)](av, origin, direction, t_min, t_max, active,
                                  early_exit)


# --------------------------------------------------------------------------
# K3: treeless brute force (csrc/t8_brute.cu)


def intersect_tris_brute_plain(ds: Accel, origin, direction, t_min,
                               t_max, active, early_exit: bool = False):
    """Every ray tests every bvh8t group, padding included, in group order
    (plain PyTorch). Inside a group the least t wins and equal t goes to
    the lowest id; across groups the later group wins an equal t. Groups go
    by chunks: within a chunk, filtered by the t_best from before it, the
    winner is the last group whose minimum is the chunk's minimum, which is
    what a group-by-group <= update leaves. No early exit (as in JAX)."""
    B = origin.shape[0]
    t_best, best = no_hits(t_max, B)
    if B == 0 or ds.meta.n_tris == 0:
        return t_best, best
    lg = int(ds.meta.t8_leaf)
    ng = t8_groups(ds)
    groups = (ds.t8_tris.reshape(-1, lg, 128)[:, :, :G8_PER_BLOCK * 10]
              .reshape(-1, lg, G8_PER_BLOCK, 10).permute(0, 2, 1, 3)
              .reshape(ng, lg, 10))
    p0, e1, e2 = groups[..., 0:3], groups[..., 3:6], groups[..., 6:9]
    ids = groups[..., 9].contiguous().view(torch.int32)
    gc = max(1, min(ng, _BRUTE_CHUNK // (lg * 64)))
    rc = max(1, _BRUTE_CHUNK // (gc * lg))
    big = torch.iinfo(torch.int32).max
    for r0 in range(0, B, rc):
        rs = slice(r0, r0 + rc)
        o = origin[rs][:, None, None, :]
        d = direction[rs][:, None, None, :]
        tmn = t_min[rs][:, None, None]
        tb, bs = t_best[rs], best[rs]
        for g0 in range(0, ng, gc):
            gs = slice(g0, g0 + gc)
            _, t, _, _ = ray_triangle_edges(o, d, p0[gs], e1[gs], e2[gs], tmn,
                                            tb[:, None, None])
            m = t.amin(dim=2)                       # (R, G) group minima
            t_new = m.amin(dim=1)                   # (R,) chunk minimum
            gidx = torch.arange(m.shape[1], device=m.device)
            last = torch.where(m == t_new[:, None], gidx, 0).amax(dim=1)
            t_w = t[torch.arange(t.shape[0], device=t.device), last]
            id_w = torch.where(t_w == t_new[:, None], ids[gs][last],
                               big).amin(dim=1)  # (R,) lowest id at t_new
            upd = t_new < float("inf")
            tb = torch.where(upd, t_new, tb)
            bs = torch.where(upd, id_w, bs)
        t_best[rs] = torch.where(active[rs], tb, t_best[rs])
        best[rs] = torch.where(active[rs], bs, best[rs])
    return t_best, best


def intersect_tris_brute(ds: Accel, origin, direction, t_min, t_max,
                         active, early_exit: bool = False, counts=None):
    """K3: the brute kernel on the card, its plain version on the CPU. The
    kernel reads the rows of the card layout that hold a triangle
    (`t8_card.tris`) and their groups (`t8_card.groups`)."""
    if not on_card("brute kernel", origin):
        return intersect_tris_brute_plain(ds, origin, direction, t_min, t_max,
                                          active, early_exit)
    B = origin.shape[0]
    if B == 0 or ds.meta.n_tris == 0:
        return no_hits(t_max, B)
    card = ds.t8_card
    rows = card.tris.shape[0]
    if card.groups.shape[0] != -(-rows // 4) * 4:
        raise ValueError("t8_card.groups: expected the tris rows rounded up "
                         f"to 4 entries, got {card.groups.shape[0]} for "
                         f"{rows} rows")
    if card.tris.data_ptr() % 16 or card.groups.data_ptr() % 16:
        raise ValueError("t8_card: the brute kernel's bulk copies read "
                         "16-byte-aligned tables")
    return launch_ray_kernel(
        "brute", early_exit, [("t8_card.tris", card.tris, _F32),
                              ("t8_card.groups", card.groups, torch.int32)],
        origin, direction, t_min, t_max, active, [rows], counts)


# --------------------------------------------------------------------------
# K6: stackless skip-link walk (csrc/skip_walk.cu)


def intersect_tris_skiplink_plain(ds: Accel, origin, direction, t_min,
                                  t_max, active, early_exit: bool = False):
    """ops/traverse.py::_intersect_skiplink per lane (plain PyTorch) over the
    node records that bvh_nodes_pk packs: on an internal hit descend to
    node + 1, else jump to skip, until the sentinel n_bvh_nodes; a hit leaf
    takes its first minimum, then a <= update. Each step works on the lanes
    still walking."""
    B = origin.shape[0]
    t_best, best = no_hits(t_max, B)
    n_tris = ds.meta.n_tris
    if B == 0 or n_tris == 0:
        return t_best, best
    sentinel = int(ds.meta.n_bvh_nodes)
    nodes = ds.bvh_nodes_pk.reshape(-1, 8)
    inv_dir = 1.0 / direction
    node = torch.where(active, 0, sentinel).to(torch.int64)
    while True:
        lanes = torch.nonzero(node < sentinel)[:, 0]
        if lanes.numel() == 0:
            return t_best, best
        n = node[lanes]
        nd = nodes[n]
        o, tmn, tb = origin[lanes], t_min[lanes], t_best[lanes]
        t0, t1 = ray_aabb(o, inv_dir[lanes], nd[:, 0:3], nd[:, 3:6])
        hit = (t0 <= t1) & (t1 >= tmn) & (t0 <= tb)
        ints = nd[:, 6:8].contiguous().view(torch.int32)
        meta, skip = ints[:, 0], ints[:, 1].long()
        count = meta & 7
        nxt = torch.where(hit & (count == 0), n + 1, skip)
        leaf = torch.nonzero(hit & (count > 0))[:, 0]
        if leaf.numel():
            li = lanes[leaf]
            first = meta[leaf] >> 3
            t_leaf, k, lh = leaf_first_min(
                o[leaf], direction[li], tmn[leaf], tb[leaf],
                leaf_records(ds.tri_pack, first, n_tris), count[leaf])
            t_best[li] = torch.where(lh, t_leaf, tb[leaf])
            b = torch.where(lh, first + k.to(torch.int32), best[li])
            best[li] = b
            if early_exit:
                nxt[leaf] = torch.where(b >= 0, sentinel, nxt[leaf])
        node[lanes] = nxt


def intersect_tris_skiplink(ds: Accel, origin, direction, t_min, t_max,
                            active, early_exit: bool = False, counts=None):
    """K6: the skip-link kernel on the card, its plain version on the CPU."""
    if not on_card("skip-link walk", origin):
        return intersect_tris_skiplink_plain(ds, origin, direction, t_min,
                                             t_max, active, early_exit)
    B = origin.shape[0]
    if B == 0 or ds.meta.n_tris == 0:
        return no_hits(t_max, B)
    tables = [("bvh_nodes_pk", ds.bvh_nodes_pk, _F32),
              ("tri_pack_pk", ds.tri_pack_pk, _F32)]
    check_aligned(tables)
    return launch_ray_kernel(
        "walk", early_exit, [*tables, ray_counter(origin.device)],
        origin, direction, t_min, t_max, active,
        [int(ds.meta.n_bvh_nodes), int(ds.meta.n_tris), int(early_exit)],
        counts)


# --------------------------------------------------------------------------
# K5: child-pair walk (csrc/pair_walk.cu)


def intersect_tris_pair_plain(ds: Accel, origin, direction, t_min, t_max,
                              active, early_exit: bool = False):
    """Per-lane child-pair walk (plain PyTorch) over the records of
    bvh2_rows_pk and tri_pack, in the kernel's order: a visit tests both
    child boxes against the t_best it opens with, intersects the hit leaf
    children left, then right (each the first minimum, then a <= update),
    descends into the near internal hit (the left child unless the ray's
    direction on the row's split axis is negative) and pushes the far one,
    or pops. Any-hit stops after the visit that found a hit."""
    B = origin.shape[0]
    t_best, best = no_hits(t_max, B)
    n_tris = ds.meta.n_tris
    root = int(ds.meta.root_meta)
    if B == 0 or n_tris == 0 or root < 0:
        return t_best, best
    dev = origin.device
    inv_dir = 1.0 / direction

    def leaf(li, meta, tb, bs):
        """The leaf phase of lanes `li` at leaf metas `meta`: (tb, bs)."""
        first = meta >> 3
        t_leaf, k, lh = leaf_first_min(
            origin[li], direction[li], t_min[li], tb,
            leaf_records(ds.tri_pack, first, n_tris), meta & 7)
        return (torch.where(lh, t_leaf, tb),
                torch.where(lh, first + k.to(torch.int32), bs))

    if root & 7:  # single-leaf tree: every live lane tests the leaf
        lanes = torch.nonzero(active)[:, 0]
        meta = torch.full((lanes.numel(),), root, dtype=torch.int32,
                          device=dev)
        t_best[lanes], best[lanes] = leaf(lanes, meta, t_best[lanes],
                                          best[lanes])
        return t_best, best

    rows = ds.bvh2_rows_pk.reshape(-1, 16)
    cur = torch.where(active, root, DONE).to(torch.int32)
    sp = torch.zeros(B, dtype=torch.int64, device=dev)
    stack = torch.zeros((B, max(int(ds.meta.bvh2_depth), 1)),
                        dtype=torch.int32, device=dev)
    while True:
        lanes = torch.nonzero(cur != DONE)[:, 0]
        if lanes.numel() == 0:
            return t_best, best
        row = rows[(cur[lanes] >> 3).long()]
        ints = row.contiguous().view(torch.int32)
        meta_l, meta_r, axis = ints[:, 12], ints[:, 13], ints[:, 14]
        o, inv = origin[lanes], inv_dir[lanes]
        tmn, tb, bs = t_min[lanes], t_best[lanes], best[lanes]
        tl0, tl1 = ray_aabb(o, inv, row[:, 0:3], row[:, 3:6])
        tr0, tr1 = ray_aabb(o, inv, row[:, 6:9], row[:, 9:12])
        hit_l = (tl0 <= tl1) & (tl1 >= tmn) & (tl0 <= tb)
        hit_r = (tr0 <= tr1) & (tr1 >= tmn) & (tr0 <= tb)
        leaf_l, leaf_r = (meta_l & 7) != 0, (meta_r & 7) != 0
        for meta, take in ((meta_l, hit_l & leaf_l), (meta_r, hit_r & leaf_r)):
            sub = torch.nonzero(take)[:, 0]
            if sub.numel():
                tb[sub], bs[sub] = leaf(lanes[sub], meta[sub], tb[sub],
                                        bs[sub])
        go_l, go_r = hit_l & ~leaf_l, hit_r & ~leaf_r
        both = go_l & go_r
        neg = torch.gather(direction[lanes], 1, axis[:, None].long())[:, 0] < 0
        s = sp[lanes]
        stack[lanes[both], s[both]] = torch.where(neg, meta_l, meta_r)[both]
        s = s + both.long()
        nxt = torch.where(go_l, meta_l, torch.full_like(meta_l, DONE))
        nxt = torch.where(go_r, meta_r, nxt)
        nxt = torch.where(both, torch.where(neg, meta_r, meta_l), nxt)
        c, s = pop(nxt, s, stack, lanes, nxt == DONE)
        if early_exit:
            c = torch.where(bs >= 0, torch.full_like(c, DONE), c)
        cur[lanes] = c
        sp[lanes] = s
        t_best[lanes] = tb
        best[lanes] = bs


def intersect_tris_pair(ds: Accel, origin, direction, t_min, t_max,
                        active, early_exit: bool = False, counts=None):
    """K5: the child-pair kernel on the card, its plain version on the
    CPU."""
    if not on_card("pair walk", origin):
        return intersect_tris_pair_plain(ds, origin, direction, t_min, t_max,
                                         active, early_exit)
    if ds.meta.bvh2_depth > STACK_CAP:
        raise ValueError(
            f"BVH depth {ds.meta.bvh2_depth} exceeds stack cap {STACK_CAP}")
    B = origin.shape[0]
    if B == 0 or ds.meta.n_tris == 0:
        return no_hits(t_max, B)
    tables = [("bvh2_rows_pk", ds.bvh2_rows_pk, _F32),
              ("tri_pack_pk", ds.tri_pack_pk, _F32)]
    check_aligned(tables)
    return launch_ray_kernel(
        "pair", early_exit, [*tables, ray_counter(origin.device)],
        origin, direction, t_min, t_max, active,
        [int(ds.meta.root_meta), int(ds.meta.n_tris), int(early_exit)],
        counts)


# --------------------------------------------------------------------------
# K4: BVH4 walk, quad and quadrow (csrc/quad_walk.cu)


def _quad_tables(ds: Accel, rowrec: bool):
    """(records (K, 32), leaf table, root meta) of one BVH4 layout."""
    if rowrec:
        return ds.bvh4_rows[:, :32], ds.tri_rows, int(ds.meta.root_meta4r)
    return (ds.bvh4_recs_pk.reshape(-1, 32), ds.tri_pack_pk.reshape(-1, 16),
            int(ds.meta.root_meta4))


def _quad_order(d, axes, nkids, nleft, early_exit: bool):
    """(L, 4) slot order of each lane, near to far (-1: none), as the
    kernel orders them: by the ray's own direction sign on the record's
    split axes; storage order for any-hit."""
    L = axes.shape[0]
    if early_exit:
        return torch.arange(4, device=axes.device).expand(L, 4)

    def neg(ax):
        return torch.gather(d, 1, ax[:, None].long())[:, 0] < 0.0

    sgn_top = neg(axes & 3)
    sgn_l, sgn_r = neg((axes >> 2) & 3), neg((axes >> 4) & 3)
    two_l = nleft == 2
    two_r = (nkids - nleft) == 2
    one = torch.ones_like(nleft)
    zero = torch.zeros_like(nleft)
    l0 = torch.where(two_l & sgn_l, one, zero)
    l1 = torch.where(two_l, 1 - l0, -one)
    r0 = nleft + torch.where(two_r & sgn_r, one, zero)
    r1 = torch.where(two_r, nleft + (1 - (r0 - nleft)), -one)
    near_l = torch.stack([l0, l1, r0, r1], dim=1)
    near_r = torch.stack([r0, r1, l0, l1], dim=1)
    return torch.where(sgn_top[:, None], near_r, near_l)


def intersect_tris_quad_plain(ds: Accel, origin, direction, t_min,
                              t_max, active, early_exit: bool = False,
                              rowrec: bool = False):
    """Per-lane BVH4 walk (plain PyTorch) over the record and leaf tables
    the quad kernel reads, in the kernel's slot order: a visit tests the
    (up to) 4 child boxes, intersects hit leaves near to far, descends into
    the nearest internal hit and pushes the others far to near. quadrow
    leaves are rows of tri_rows whose slots carry the triangle ids."""
    B = origin.shape[0]
    t_best, best = no_hits(t_max, B)
    n_tris = ds.meta.n_tris
    recs, tris, root = _quad_tables(ds, rowrec)
    if B == 0 or n_tris == 0 or root < 0:
        return t_best, best
    dev = origin.device
    inv_dir = 1.0 / direction

    def leaf(li, meta, tb):
        """Leaf phase of lanes `li` at leaf metas `meta`: (t, id, hit)."""
        first, count = meta >> 3, meta & 7
        pack = (tris[first.long()].reshape(-1, 8, 16)[:, :MAX_LEAF_SIZE]
                if rowrec else leaf_records(tris, first, n_tris))
        t_leaf, k, lh = leaf_first_min(origin[li], direction[li], t_min[li],
                                       tb, pack, count)
        if not rowrec:
            return t_leaf, first + k.to(torch.int32), lh
        ids = pack[..., 9].contiguous().view(torch.int32)
        return t_leaf, torch.gather(ids, 1, k[:, None])[:, 0], lh

    if root & 7:  # single-leaf tree: every live lane tests the leaf
        lanes = torch.nonzero(active)[:, 0]
        meta = torch.full((lanes.numel(),), root, dtype=torch.int32,
                          device=dev)
        t_leaf, ids, lh = leaf(lanes, meta, t_best[lanes])
        t_best[lanes] = torch.where(lh, t_leaf, t_best[lanes])
        best[lanes] = torch.where(lh, ids, best[lanes])
        return t_best, best

    cur = torch.where(active, root, DONE).to(torch.int32)
    sp = torch.zeros(B, dtype=torch.int64, device=dev)
    stack = torch.zeros((B, max(int(ds.meta.bvh4_stack), 4)),
                        dtype=torch.int32, device=dev)
    slot = torch.arange(4, device=dev)
    while True:
        lanes = torch.nonzero(cur != DONE)[:, 0]
        if lanes.numel() == 0:
            return t_best, best
        L = lanes.numel()
        rec = recs[(cur[lanes] >> 3).long()]
        ints = rec.contiguous().view(torch.int32)
        metas, axes = ints[:, 24:28], ints[:, 28]
        nkids, nleft = (axes >> 6) & 7, (axes >> 9) & 3
        boxes = rec[:, :24].reshape(L, 4, 6)
        tmn, tb, bs = t_min[lanes], t_best[lanes], best[lanes]
        t0, t1 = ray_aabb(origin[lanes][:, None, :], inv_dir[lanes][:, None, :],
                          boxes[..., 0:3], boxes[..., 3:6])
        hits = ((t0 <= t1) & (t1 >= tmn[:, None]) & (t0 <= tb[:, None])
                & (slot[None, :] < nkids[:, None]))
        order = _quad_order(direction[lanes], axes, nkids, nleft, early_exit)
        go = []
        for o in range(4):
            s = order[:, o]
            sc = s.clamp(min=0)[:, None].long()
            m = torch.gather(metas, 1, sc)[:, 0]
            a = torch.gather(hits, 1, sc)[:, 0] & (s >= 0) & (m != DONE)
            is_leaf = (m & 7) != 0
            sub = torch.nonzero(a & is_leaf)[:, 0]
            if sub.numel():
                t_leaf, ids, lh = leaf(lanes[sub], m[sub], tb[sub])
                tb[sub] = torch.where(lh, t_leaf, tb[sub])
                bs[sub] = torch.where(lh, ids, bs[sub])
            go.append((m, a & ~is_leaf))
        nxt = torch.full((L,), DONE, dtype=torch.int32, device=dev)
        s_ = sp[lanes]
        for m, g in reversed(go):
            push = g & (nxt != DONE)
            stack[lanes[push], s_[push]] = nxt[push]
            s_ = s_ + push.long()
            nxt = torch.where(g, m, nxt)
        c, s_ = pop(nxt, s_, stack, lanes, nxt == DONE)
        if early_exit:
            c = torch.where(bs >= 0, torch.full_like(c, DONE), c)
        cur[lanes] = c
        sp[lanes] = s_
        t_best[lanes] = tb
        best[lanes] = bs


def _quad(rowrec: bool, ds: Accel, origin, direction, t_min, t_max,
          active, early_exit: bool, counts):
    if not on_card("quad walk", origin):
        return intersect_tris_quad_plain(ds, origin, direction, t_min, t_max,
                                         active, early_exit, rowrec)
    if ds.meta.bvh4_stack > STACK_CAP:
        raise ValueError(
            f"BVH4 stack bound {ds.meta.bvh4_stack} exceeds {STACK_CAP}")
    B = origin.shape[0]
    if B == 0 or ds.meta.n_tris == 0:
        return no_hits(t_max, B)
    recs, tris = ((ds.bvh4_rows, ds.tri_rows) if rowrec
                  else (ds.bvh4_recs_pk, ds.tri_pack_pk))
    _, _, root = _quad_tables(ds, rowrec)
    tables = [("bvh4 records", recs, _F32), ("bvh4 leaves", tris, _F32)]
    check_aligned(tables)
    return launch_ray_kernel(
        "quadrow" if rowrec else "quad", early_exit,
        [*tables, ray_counter(origin.device)],
        origin, direction, t_min, t_max, active,
        [root, int(ds.meta.n_tris), int(rowrec), int(early_exit)], counts)


def intersect_tris_quad(ds: Accel, origin, direction, t_min, t_max,
                        active, early_exit: bool = False, counts=None):
    """K4 `quad`: the BVH4 kernel over bvh4_recs_pk + tri_pack_pk."""
    return _quad(False, ds, origin, direction, t_min, t_max, active,
                 early_exit, counts)


def intersect_tris_quadrow(ds: Accel, origin, direction, t_min, t_max,
                           active, early_exit: bool = False, counts=None):
    """K4 `quadrow`: the BVH4 kernel over bvh4_rows + tri_rows."""
    return _quad(True, ds, origin, direction, t_min, t_max, active,
                 early_exit, counts)


WALKS = {
    "bvh8t": intersect_tris_bvh8t,
    "brute": intersect_tris_brute,
    "quad": intersect_tris_quad,
    "quadrow": intersect_tris_quadrow,
    "pair": intersect_tris_pair,
    "walk": intersect_tris_skiplink,
}
