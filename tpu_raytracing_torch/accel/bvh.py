"""Binned-SAH BVH build (host) -> skip-link linear layout.

The port's copy of tpu_raytracing/accel/bvh.py, numpy builder only. It
builds the same tree as the JAX package's native C++ builder
(csrc/bvh_builder.cpp), array for array (tests/test_torch_isolation.py);
the port's own compiled builder is a ROADMAP item. Nodes are emitted in
depth-first order with skip links:

    hit AABB   -> next = node + 1            (descend into first child)
    miss/leaf  -> next = skip[node]          (jump over the subtree)

The left child is biased to the lower half along the split axis.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

F = np.float32
# Max prims per leaf. The node encodings pack the count in 3 bits
# ((first<<3)|count in the skip-link/pair/quad layouts), so 7 is the
# ceiling without an encoding change. Read once at import so the builder
# and every kernel's static leaf unroll agree; default 4 keeps the
# blessed snapshots' BVHs byte-identical. TPU_RT_BVH_LEAF=5..7 trades
# deeper leaves for fewer internal nodes (the lockstep tile union pays
# per NODE, docs/PERF_LOG.md round 3).
import os as _os

MAX_LEAF_SIZE = min(7, max(1, int(_os.environ.get("TPU_RT_BVH_LEAF", "4"))))
N_BINS = 16


@dataclass
class LinearBVH:
    node_min: np.ndarray    # (N, 3) f32
    node_max: np.ndarray    # (N, 3) f32
    left_first: np.ndarray  # (N,) i32: leaf -> first prim; internal -> left child
    count: np.ndarray       # (N,) i32: 0 internal, >0 leaf prim count
    skip: np.ndarray        # (N,) i32: next node when subtree is skipped
    prim_order: np.ndarray  # (P,) i32: BVH-order -> input prim index

    @property
    def n_nodes(self) -> int:
        return self.node_min.shape[0]

    def sah_cost(self) -> float:
        """Surface-area heuristic cost (diagnostic)."""
        ext = np.maximum(self.node_max - self.node_min, 0.0)
        area = 2.0 * (
            ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 0] * ext[:, 2]
        )
        root = max(area[0], 1e-30)
        is_leaf = self.count > 0
        return float(
            (area[~is_leaf].sum() + (area * self.count)[is_leaf].sum()) / root
        )


def build_bvh(
    prim_min: np.ndarray,
    prim_max: np.ndarray,
    max_leaf_size: int = MAX_LEAF_SIZE,
) -> LinearBVH:
    """Build a BVH over primitive AABBs. Deterministic for fixed input."""
    prim_min = np.asarray(prim_min, F).reshape(-1, 3)
    prim_max = np.asarray(prim_max, F).reshape(-1, 3)
    n = prim_min.shape[0]

    if n == 0:
        return LinearBVH(
            node_min=np.zeros((1, 3), F),
            node_max=np.full((1, 3), -1.0, F),
            left_first=np.zeros(1, np.int32),
            count=np.zeros(1, np.int32),
            skip=np.ones(1, np.int32),
            prim_order=np.zeros(0, np.int32),
        )

    centroids = (prim_min + prim_max) * 0.5
    order = np.arange(n, dtype=np.int32)

    node_min, node_max, left_first, count, children = [], [], [], [], []

    def emit(lo: int, hi: int) -> int:
        """Build the subtree over order[lo:hi]; returns node index."""
        idx = len(node_min)
        ids = order[lo:hi]
        bb_min = prim_min[ids].min(axis=0)
        bb_max = prim_max[ids].max(axis=0)
        node_min.append(bb_min)
        node_max.append(bb_max)
        node_count = hi - lo

        split = None
        if node_count > max_leaf_size:
            split = _binned_sah_split(
                prim_min, prim_max, centroids, order, lo, hi
            )
        if split is None and node_count > max_leaf_size:
            # fall back to median split on the longest axis (stable sort so
            # the layout is reproducible across builder implementations)
            axis = int(np.argmax(bb_max - bb_min))
            c = centroids[ids, axis]
            mid_pos = node_count // 2
            part = np.argsort(c, kind="stable")
            order[lo:hi] = ids[part]
            split = lo + mid_pos

        if split is None:
            left_first.append(lo)
            count.append(node_count)
            children.append((-1, -1))
            return idx

        left_first.append(-1)  # patched below
        count.append(0)
        children.append((-1, -1))
        l = emit(lo, split)
        r = emit(split, hi)
        children[idx] = (l, r)
        left_first[idx] = l
        return idx

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 1000))
    try:
        emit(0, n)
    finally:
        sys.setrecursionlimit(old_limit)

    n_nodes = len(node_min)
    skip = np.full(n_nodes, n_nodes, np.int32)

    def fill_skip(idx: int, skip_to: int):
        stack = [(idx, skip_to)]
        while stack:
            i, s = stack.pop()
            skip[i] = s
            l, r = children[i]
            if l >= 0:
                stack.append((l, r))
                stack.append((r, s))

    fill_skip(0, n_nodes)

    return LinearBVH(
        node_min=np.stack(node_min).astype(F),
        node_max=np.stack(node_max).astype(F),
        left_first=np.array(left_first, np.int32),
        count=np.array(count, np.int32),
        skip=skip,
        prim_order=order,
    )


def _binned_sah_split(prim_min, prim_max, centroids, order, lo, hi):
    """Best binned-SAH split of order[lo:hi]; partitions order in place.

    Returns the split position, or None if a leaf is cheaper / unsplittable.
    """
    ids = order[lo:hi]
    c = centroids[ids]
    c_min, c_max = c.min(axis=0), c.max(axis=0)
    extent = c_max - c_min

    best = None  # (cost, axis, bin_edge)
    for axis in range(3):
        if extent[axis] <= 0.0:
            continue
        scale = N_BINS / extent[axis]
        bins = np.minimum(
            ((c[:, axis] - c_min[axis]) * scale).astype(np.int32), N_BINS - 1
        )
        # per-bin counts + bounds
        counts = np.bincount(bins, minlength=N_BINS)
        bin_lo = np.full((N_BINS, 3), np.inf, F)
        bin_hi = np.full((N_BINS, 3), -np.inf, F)
        np.minimum.at(bin_lo, bins, prim_min[ids])
        np.maximum.at(bin_hi, bins, prim_max[ids])

        # prefix/suffix sweeps
        lcnt = np.cumsum(counts)[:-1]
        rcnt = (hi - lo) - lcnt
        l_lo = np.minimum.accumulate(bin_lo, axis=0)[:-1]
        l_hi = np.maximum.accumulate(bin_hi, axis=0)[:-1]
        r_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1][1:]
        r_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1][1:]

        def area(lo_, hi_):
            e = np.maximum(hi_ - lo_, 0.0)
            return 2.0 * (e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 0] * e[:, 2])

        cost = area(l_lo, l_hi) * lcnt + area(r_lo, r_hi) * rcnt
        cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
        b = int(np.argmin(cost))
        if np.isfinite(cost[b]) and (best is None or cost[b] < best[0]):
            best = (cost[b], axis, b)

    if best is None:
        return None

    _, axis, b = best
    scale = N_BINS / extent[axis]
    go_left = (
        np.minimum(((c[:, axis] - c_min[axis]) * scale).astype(np.int32), N_BINS - 1)
        <= b
    )
    n_left = int(go_left.sum())
    if n_left == 0 or n_left == len(ids):
        return None
    order[lo:hi] = np.concatenate([ids[go_left], ids[~go_left]])
    return lo + n_left
