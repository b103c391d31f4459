"""P1: a bvh8t node visit rebuilt level by level, to see what each part
costs.

Counterpart of scripts/probe_walk_cost.py (the Pallas kernel that
`make(level)` builds, pallas_call at :240). A loop of ITERS visits over
R x 128 rays; visit q reads one node of a (256, 128) table (16 slots, the
box of slot w at lanes s .. s + 5 of row (nid // 16) * 16 + w,
s = (nid % 16) * 8), runs the slab of every ray against every slot, and
drains the slots below the node's child count ni that some ray hit into
one int32 mask_s. The levels add to that, one part at a time:

  slab     nid = q % 256, ni = 8, leaf base q % 64
  smem     + a 64-entry stack in scalar memory: pop the top entry
           (stack[max(sp - 1, 0)]), clear its lowest set bit, and take
           nid = (base + slot + q) % 256 from it; ni and the leaf base
           from a (1024, 2) int32 meta table
  when     + push (128 << 16) | mask_s where mask_s != 0 (sp capped at 60)
  inner0   + a leaf loop whose trip count is 0
  inner50  + a leaf loop that runs on even visits whose mask_s is odd: P3's
           Moller-Trumbore of triangle group (lbase + 15) % 192 (a 16-row
           block of a (256, 128) table, rolled by (group % 12) * 10 lanes),
           each ray gated on its own hit of slot 0
  cond     `when`, with the loop's condition reading the last mask_s
  cond50   `inner50`, likewise

The output is t_best + float(best), (4, 128) float32, as in the script:
inf everywhere but in inner50 and cond50, since the other levels write
t_best only when mask_s > 1 << 20, which a 16-slot mask never is. So the
port records what the visits do: each visit's mask_s (`visits`) and `stats`
= (visits run, a wrapping fold of the drains), from the kernel and from the
plain version alike.

`walk_cost` launches csrc/probe_walk_cost.cu for CUDA tensors and runs
`walk_cost_plain` for CPU tensors. The kernel tests only the slots below
ni and, in a leaf trip, only the rays its gate lets through, across the
lanes of their warps; `walk_cost_plain(work=)` counts both. The port is
built for the script's defaults NB = 16 and TILES = 1, constants here: the
kernel's wrapper rejects tables of another shape. `python -m
tpu_raytracing_torch.probes.walk_cost` times every level on the card
(`--device cpu` runs the plain version).
"""
from __future__ import annotations

import os
import sys
from collections import Counter

import numpy as np
import torch

from ..native_cuda import check_tensor, launch, on_card
from . import common
from .common import (LANE, LG, Drains, best_ms, bits, check_buffers,
                     device_name, ffs16, group, parse_args, slab)

W = 16           # slots of a node
R = 4            # ray rows
NB = 16          # node and triangle blocks (the script's default)
TILES = 1        # ray tiles (the script's default)
NODES = NB * 16  # nodes of the table
GROUPS = NB * 12 # triangle groups of the table
META_ROWS = 1024
STACK = 64
SP_CAP = 60
PUSH_BASE = NODES // 2
LEVELS = ("slab", "smem", "when", "inner0", "inner50", "cond", "cond50")
ITERS = int(os.environ.get("PROBE_ITERS", "200000"))  # as in the script
_F32 = torch.float32
_INF = float("inf")


def flags(level: str) -> dict:
    """The script's switches of a level (probe_walk_cost.py:49-54)."""
    if level not in LEVELS:
        raise ValueError(f"level must be one of {LEVELS}, got {level!r}")
    return dict(
        smem=level not in ("slab",),
        when=level not in ("slab", "smem"),
        inner=level in ("inner0", "inner50", "cond50"),
        leaf_rate=level in ("inner50", "cond50"),
        cond=level in ("cond", "cond50"))


def walk_cost_plain(nodes, tris, meta, o, d, t_min, level: str, iters: int,
                    visits=None, work=None):
    """The probe in plain PyTorch, one visit at a time. nodes and tris
    (256, 128) float32, meta (1024, 2) int32, o and d (12, 128) float32
    (row ax * 4 + r), t_min (4, 128) float32. Returns (out (4, 128)
    float32, stats (2,) int32); `visits`, an int32 buffer of `iters`,
    receives each visit's mask_s. A dict `work` receives what the visits
    needed of what they computed: `slab_tests`, the (slot, ray) pairs of
    the slots below each visit's ni (the others are masked out of the
    drain), `leaf_trips`, and `leaf_tests`, the (triangle, ray) pairs of
    the rays a trip's gate lets through."""
    f = flags(level)
    dev = nodes.device
    ids = tris.contiguous().view(torch.int32)
    o3 = o.reshape(3, R, LANE)
    d3 = d.reshape(3, R, LANE)
    inv = 1.0 / d3
    meta_h = meta.cpu().numpy().astype(np.int64)
    t_best = torch.full((R, LANE), _INF, dtype=_F32, device=dev)
    best = torch.full((R, LANE), -1, dtype=torch.int32, device=dev)
    stack = [0] * STACK
    stack[0] = 1
    sp, ms, q = 1, 0, 0
    rec = Drains()
    need = dict(slab_tests=0, leaf_trips=0, leaf_tests=0)
    while q < iters and (not f["cond"] or ms >= 0):
        if f["smem"]:
            top = max(sp - 1, 0)
            e = stack[top]
            mask, base = e & 0xFFFF, (e & 0xFFFFFFFF) >> 16
            slot, low = ffs16(mask)
            stack[top] = common.int32((base << 16) | (mask - low))
            nid = (base + slot + q) % NODES
            m0, m1 = meta_h[nid & (META_ROWS - 1)]
            ni, lbase = int(m0) & 31, (int(m1) & 0xFFFFFFFF) >> 5
        else:
            nid, ni, lbase = q % NODES, 8, q % 64
        b, s = (nid // 16) * W, (nid % 16) * 8   # s + 5 <= 125: no wrap
        t0, t1 = slab(nodes[b:b + W, s:s + 6], o3, inv)
        hits = ((t0 <= t1) & (t1 >= t_min[:, None, :])
                & (t0 <= t_best[:, None, :]))               # (R, W, LANE)
        mask_s = bits(hits.any(dim=2).any(dim=0)[:min(ni, W)])
        need["slab_tests"] += min(ni, W) * R * LANE
        rec.add(mask_s)
        imask = mask_s & ((1 << ni) - 1)
        if f["when"]:
            if imask:
                stack[sp] = (PUSH_BASE << 16) | imask
                sp = min(sp + 1, SP_CAP)
        elif f["smem"]:
            sp = max(sp, 1)
        if f["inner"]:
            lm = (mask_s & 1 if (q & 1) == 0 else 0) if f["leaf_rate"] else 0
            while lm:
                s_leaf, llow = ffs16(lm)
                lm -= llow
                gq = (lbase + W - 1 - s_leaf) % GROUPS
                gate = hits[:, s_leaf, :]
                need["leaf_trips"] += 1
                need["leaf_tests"] += int(gate.sum()) * LG
                t_best, best = group(
                    tris, ids, o3[:, :, None, :], d3[:, :, None, :],
                    t_min[:, None, :], t_best, best, gq // 12, (gq % 12) * 10,
                    gate=gate)
        elif mask_s > 1 << 20:  # never: keeps the slab live on the TPU
            t_best = torch.where(hits[0, :R, :], t_best * 0.5, t_best)
        ms = mask_s
        q += 1
    if work is not None:
        work.update(need)
    return t_best + best.to(_F32), rec.finish(dev, visits)


def walk_cost(nodes, tris, meta, o, d, t_min, level: str,
              iters: int = ITERS, visits=None):
    """P1: the kernel for CUDA tensors, walk_cost_plain for CPU tensors;
    the same arguments and results."""
    flags(level)
    if not on_card("probe_walk_cost", nodes):
        return walk_cost_plain(nodes, tris, meta, o, d, t_min, level, iters,
                               visits)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    dev = nodes.device
    ins = [check_tensor("nodes", nodes, (NODES, LANE), _F32, dev),
           check_tensor("tris", tris, (NB * LG, LANE), _F32, dev),
           check_tensor("meta", meta, (META_ROWS, 2), torch.int32, dev),
           check_tensor("o", o, (3 * R, LANE), _F32, dev),
           check_tensor("d", d, (3 * R, LANE), _F32, dev),
           check_tensor("t_min", t_min, (R, LANE), _F32, dev)]
    check_buffers(ins, visits, iters, dev)
    if visits is not None:
        visits.zero_()
    out = torch.empty((R, LANE), dtype=_F32, device=dev)
    stats = torch.empty(2, dtype=torch.int32, device=dev)
    launch("tpu_rt_probe_walk_cost", dev, *[x.data_ptr() for x in ins],
           out.data_ptr(), None if visits is None else visits.data_ptr(),
           stats.data_ptr(), LEVELS.index(level), iters, tag=level)
    return out, stats


def script_inputs(device="cpu"):
    """The script's inputs (probe_walk_cost.py:254-263), drawn in its
    order: nodes, tris, meta, o, d; t_min 1e-3."""
    rng = np.random.default_rng(0)
    nodes = rng.standard_normal((NODES, LANE)).astype(np.float32)
    tris = rng.standard_normal((NB * LG, LANE)).astype(np.float32)
    meta = rng.integers(0, 1 << 10, (META_ROWS, 2)).astype(np.int32)
    o = rng.standard_normal((3 * R, LANE)).astype(np.float32)
    d = rng.standard_normal((3 * R, LANE)).astype(np.float32)
    tmn = np.full((R, LANE), 1e-3, np.float32)
    return [torch.from_numpy(a).to(device)
            for a in (nodes, tris, meta, o, d, tmn)]


def varied_inputs(device="cpu", seed: int = 1):
    """Inputs on which the slab and the leaves decide the outcome: two
    bundles of nearly parallel rays (rows 0-1 and rows 2-3) from near one
    point; boxes with lo <= hi strewn about their paths, so that the drains
    vary from visit to visit and take both parities; triangles across the
    paths that some rays hit and others miss; ids small integers (as int32
    bits), so that t shows in t_best + float(best); meta as the script
    draws it."""
    rng = np.random.default_rng(seed)
    org, dirs, o, d, boxes = common.ray_bundles(rng, NODES, R)
    tris = rng.standard_normal((NB * LG, LANE)).astype(np.float32)
    tg = tris[:, :120].reshape(NB * LG, 12, 10)
    tt = rng.uniform(1.0, 3.0, (NB * LG, 12))
    bundle = rng.integers(0, 2, (NB * LG, 12))
    tg[..., 0:3] = (org + tt[..., None] * dirs[bundle]
                    + 0.08 * rng.standard_normal((NB * LG, 12, 3)) - 0.05)
    tg[..., 3:9] = 0.15 * rng.standard_normal((NB * LG, 12, 6))
    tg[..., 9] = rng.integers(0, 4096, (NB * LG, 12)).astype(np.int32).view(
        np.float32)
    tris[:, :120] = tg.reshape(NB * LG, 120)
    meta = rng.integers(0, 1 << 10, (META_ROWS, 2)).astype(np.int32)
    arrays = (boxes.reshape(NODES, LANE).astype(np.float32), tris, meta,
              o.reshape(3 * R, LANE).astype(np.float32),
              d.reshape(3 * R, LANE).astype(np.float32),
              np.full((R, LANE), 1e-3, np.float32))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def main(argv=None) -> list[dict]:
    """Time each level at --iters visits (default PROBE_ITERS, 200,000) on
    the script's inputs and print the script's line for it."""
    args = parse_args(argv, __doc__.splitlines()[0], ITERS)
    dev = args.device
    ins = script_inputs(dev)
    print(f"device={device_name(dev)} iters={args.iters} tiles={TILES} "
          f"nb={NB}", flush=True)
    results = []
    for level in LEVELS:
        ms = best_ms(lambda: walk_cost(*ins, level, args.iters), dev)
        ns = ms * 1e6 / max(args.iters * TILES, 1)
        print(f"{level:8s}: {ns:8.1f} ns/iter", flush=True)
        sass = (common.loop_instructions(
            f"probe_walk_costILi{LEVELS.index(level)}E")
            if dev == "cuda" else None)
        if sass is not None:
            print(f"{level:8s}: visit loop in SASS, {sum(sass.values())} "
                  f"instructions", flush=True)
        results.append(dict(level=level, ms=ms, iters=args.iters,
                            ns_per_visit=ns,
                            sass=None if sass is None else dict(sass)))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
