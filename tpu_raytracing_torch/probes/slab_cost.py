"""P2: the cost of a bvh8t visit's slab phase, in five variants.

Counterpart of scripts/probe_slab_cost.py (the Pallas kernel that
`make(variant)` builds, pallas_call at :210). A while loop visits nodes
until q reaches ITERS; visit q reads node nid = q % 1024 of a (1024, 128)
table, whose 16-row block nid // 16 holds one child box a row at lanes
s .. s + 5, s = (nid % 16) * 8 (lo xyz, hi xyz), runs the variant's slab
against the rays, drains the slots that were hit into one int32 mask_s,
and steps q by 1 + (mask_s & 1):

  floor       the block read and the drain only: mask_s = 128 * (the bits
              of the slots whose lo.x > 0), a sum over 128 lanes
  cur, hoist  each of R x 128 rays against each slot, twice (KN = 2 nodes,
              the same box standing in for both); a hit needs t0 <= t1,
              t1 >= t_min, t0 <= t_best and act > 0; mask_s = 2 * the OR
              of the slots hit. They differ only in where the TPU kept the
              rays' broadcasts, so the port runs one kernel for both
  row0        the row-0 rays only, plus an interval slab of each slot
              against the tile's envelope (the min and max of o, inv and
              t_min); t_best of every row takes min(t_best, |t0 of slot
              0| + 1)
  mxu         g = (the block, stacked 6 times) @ (the rays' o and inv rows,
              cycled into 128 rows), (96, 128) @ (128, 128) in float32; a
              slot is hit where some lane has g >= 0

The output is t_best + float(best), (4, 128) float32, as in the script: inf
everywhere but row0, since only row0 writes t_best (cur and hoist take
min(t_best, t_best + ... + 1e30)). So the port records what the slab does:
each visit's mask_s (`visits`) and `stats` = (visits run, a wrapping fold
of the drains), from the kernel and from the plain version alike.

`slab_cost` launches csrc/probe_slab_cost.cu for CUDA tensors and runs
`slab_cost_plain` for CPU tensors. The kernel streams the node blocks
through a ring in shared memory in the order the walk meets them, so a
visit's boxes never wait on L2. `python -m
tpu_raytracing_torch.probes.slab_cost` times every variant on the card
(`--device cpu` runs the plain version).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..native_cuda import check_tensor, launch, on_card
from . import common
from .common import (LANE, Drains, best_ms, bits, check_buffers, device_name,
                     parse_args, slab)

W = 16           # slots (rows) of a node block
R = 4            # ray rows
KN = 2           # nodes a cur/hoist visit tests, all the same box
NB = 64          # node blocks of the table
NODES = NB * 16  # nodes: a visit reads node q % NODES
VARIANTS = ("floor", "cur", "hoist", "row0", "mxu")
# the kernel's instantiation of each variant: hoist runs cur's
KERNEL_OF = {"floor": 0, "cur": 1, "hoist": 1, "row0": 2, "mxu": 3}
ITERS = int(os.environ.get("PROBE_ITERS", "4096"))  # as in the script
_F32 = torch.float32
_INF = float("inf")


def _boxes(nodes, nid: int):
    """(W, 6) lo xyz, hi xyz of node nid's 16 slots. The script rolls the
    block by s = (nid % 16) * 8 lanes, and s + 5 <= 125: no lane wraps."""
    b, s = (nid // 16) * W, (nid % 16) * 8
    return nodes[b:b + W, s:s + 6]


def _rhs(o, inv):
    """The script's (128, 128) right-hand side: [o0, o1, o2, inv0, inv1,
    inv2] cycled by blocks of R rows (probe_slab_cost.py:101-103)."""
    x = [o[0], o[1], o[2], inv[0], inv[1], inv[2]]
    return torch.cat([x[b % 6] for b in range(LANE // R)])


def _envelope(o, inv, t_min):
    """row0's tile envelope: per axis (o lo, o hi, inv lo, inv hi), and the
    least t_min."""
    return [(o[ax].min(), o[ax].max(), inv[ax].min(), inv[ax].max())
            for ax in range(3)], t_min.min()


def _interval_hits(box, env, tmn_lo):
    """row0's (W,) interval slab of each slot against the envelope
    (probe_slab_cost.py:137-153)."""
    i0 = torch.full((W,), -_INF, dtype=_F32, device=box.device)
    i1 = torch.full((W,), _INF, dtype=_F32, device=box.device)
    for ax in range(3):
        olo, ohi, ilo, ihi = env[ax]
        dlo, dhi = box[:, ax] - ohi, box[:, 3 + ax] - olo
        p1, p2, p3, p4 = dlo * ilo, dlo * ihi, dhi * ilo, dhi * ihi
        i0 = torch.maximum(i0, torch.minimum(torch.minimum(p1, p2),
                                             torch.minimum(p3, p4)))
        i1 = torch.minimum(i1, torch.maximum(torch.maximum(p1, p2),
                                             torch.maximum(p3, p4)))
    return (i0 <= i1) & (i1 >= tmn_lo)


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")


def slab_cost_plain(nodes, o, inv, t_min, act, variant: str, iters: int,
                    visits=None):
    """The probe in plain PyTorch, one visit at a time. nodes (1024, 128),
    o and inv (3, 4, 128), t_min and act (4, 128), all float32. Returns
    (out (4, 128) float32, stats (2,) int32); `visits`, an int32 buffer of
    `iters`, receives each visit's mask_s (zeros past the last visit)."""
    _check_variant(variant)
    if variant == "mxu" and nodes.is_cuda:
        assert not torch.backends.cuda.matmul.allow_tf32, (
            "the plain mxu needs a float32 matmul: TF32 is allowed")
    dev = nodes.device
    t_best = torch.full((R, LANE), _INF, dtype=_F32, device=dev)
    best = torch.full((R, LANE), -1, dtype=torch.int32, device=dev)
    live = act > 0
    rhs = _rhs(o, inv) if variant == "mxu" else None
    env, tmn_lo = (_envelope(o, inv, t_min) if variant == "row0"
                   else (None, None))
    rec = Drains()
    q = 0
    while q < iters:
        nid = q % NODES
        box = _boxes(nodes, nid)
        if variant == "floor":
            mask_s = LANE * bits(box[:, 0] > 0.0)
        elif variant == "mxu":
            b, s = (nid // 16) * W, (nid % 16) * 8
            blk = torch.roll(nodes[b:b + W], -s, dims=1)  # lane k reads k + s
            g = (torch.cat([blk] * 6) @ rhs).view(6, W, LANE)
            t0 = torch.maximum(torch.maximum(torch.minimum(g[0], g[3]),
                                             torch.minimum(g[1], g[4])),
                               torch.minimum(g[2], g[5]))
            t1 = torch.minimum(torch.minimum(torch.maximum(g[0], g[3]),
                                             torch.maximum(g[1], g[4])),
                               torch.maximum(g[2], g[5]))
            mask_s = bits(((t0 <= t1) & (t1 >= 0.0)).any(dim=1))
        elif variant == "row0":
            t0, t1 = slab(box, o[:, :1], inv[:, :1])
            h = ((t0[0] <= t1[0]) & (t1[0] >= t_min[0]) & (t0[0] <= t_best[0]))
            mask_s = bits(h.any(dim=1) | _interval_hits(box, env, tmn_lo))
            t_best = torch.minimum(t_best, (t0[0, 0].abs() + 1.0)[None, :])
        else:  # cur, hoist: KN passes over the same box
            t0, t1 = slab(box, o, inv)
            h = ((t0 <= t1) & (t1 >= t_min[:, None, :])
                 & (t0 <= t_best[:, None, :]) & live[:, None, :])
            mask_s = KN * bits(h.any(dim=2).any(dim=0))
            t_best = torch.minimum(
                t_best, t_best + torch.tensor(float(mask_s), dtype=_F32,
                                              device=dev) * 0.0 + 1e30)
        rec.add(mask_s)
        q += 1 + (mask_s & 1)
    return t_best + best.to(_F32), rec.finish(dev, visits)


def slab_cost(nodes, o, inv, t_min, act, variant: str, iters: int = ITERS,
              visits=None):
    """P2: the kernel for CUDA tensors, slab_cost_plain for CPU tensors;
    the same arguments and results."""
    _check_variant(variant)
    if not on_card("probe_slab_cost", nodes):
        return slab_cost_plain(nodes, o, inv, t_min, act, variant, iters,
                               visits)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    dev = nodes.device
    ins = [check_tensor("nodes", nodes, (NODES, LANE), _F32, dev),
           check_tensor("o", o, (3, R, LANE), _F32, dev),
           check_tensor("inv", inv, (3, R, LANE), _F32, dev),
           check_tensor("t_min", t_min, (R, LANE), _F32, dev),
           check_tensor("act", act, (R, LANE), _F32, dev)]
    check_buffers(ins, visits, iters, dev)
    if visits is not None:
        visits.zero_()
    out = torch.empty((R, LANE), dtype=_F32, device=dev)
    stats = torch.empty(2, dtype=torch.int32, device=dev)
    launch("tpu_rt_probe_slab_cost", dev, *[x.data_ptr() for x in ins],
           out.data_ptr(), None if visits is None else visits.data_ptr(),
           stats.data_ptr(), KERNEL_OF[variant], iters, tag=variant)
    return out, stats


def script_inputs(device="cpu"):
    """The script's inputs (probe_slab_cost.py:220-225), drawn in its order:
    nodes, then ox, oy, oz, ix, iy, iz; t_min 1e-3 and act 1 everywhere.
    Returns (nodes, o, inv, t_min, act)."""
    rng = np.random.default_rng(0)
    nodes = rng.standard_normal((NODES, LANE)).astype(np.float32)
    rows = np.stack([rng.standard_normal((R, LANE)).astype(np.float32)
                     for _ in range(6)])
    arrays = (nodes, rows[:3], rows[3:], np.full((R, LANE), 1e-3, np.float32),
              np.ones((R, LANE), np.float32))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def varied_inputs(device="cpu", seed: int = 1):
    """Inputs on which the slab decides the drains: two bundles of nearly
    parallel rays from near one point (rows 0-1 and rows 2-3, the second
    inactive), inv = 1 / d, and boxes with lo <= hi strewn about their
    paths, which cross the origin. So each slot is hit by some visits and
    missed by others, mask_s varies from visit to visit and, in row0 and
    mxu, takes both parities (mxu's g changes sign with the boxes). The
    lanes past a box (s + 6, s + 7) hold noise."""
    rng = np.random.default_rng(seed)
    _, _, o, d, boxes = common.ray_bundles(rng, NODES, R,
                                           offset=(-1.6, -1.2, -0.6))
    act = np.zeros((R, LANE))
    act[:2] = 1.0
    arrays = (boxes.reshape(NODES, LANE), o, (1.0 / d.astype(np.float32)),
              np.full((R, LANE), 1e-3), act)
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
            .to(device) for a in arrays]


def main(argv=None) -> list[dict]:
    """Time each variant at --iters (default PROBE_ITERS, 4096) on the
    script's inputs and print the script's line for it, plus the ns per
    visit actually run (an odd drain skips a node)."""
    args = parse_args(argv, __doc__.splitlines()[0], ITERS)
    dev = args.device
    ins = script_inputs(dev)
    print(f"device={device_name(dev)}", flush=True)
    results = []
    for variant in VARIANTS:
        ms = best_ms(lambda: slab_cost(*ins, variant, args.iters), dev)
        _, stats = slab_cost(*ins, variant, args.iters)
        n_run = int(stats[0])
        ns = ms * 1e6 / max(args.iters, 1)
        ns_run = ms * 1e6 / max(n_run, 1)
        print(f"{variant:6s}: {ns:8.1f} ns/visit ({ns_run:8.1f} ns per visit "
              f"run; {n_run} of {args.iters} run)", flush=True)
        found = (common.loop_instructions(
            f"probe_slab_costILi{KERNEL_OF[variant]}E", inner=True)
            if dev == "cuda" else None)
        sass, inner = found if found is not None else (None, None)
        if sass is not None:
            print(f"{variant:6s}: visit loop in SASS, {sum(sass.values())} "
                  f"instructions", flush=True)
        results.append(dict(variant=variant, ms=ms, iters=args.iters,
                            visits_run=n_run, ns_per_visit=ns,
                            ns_per_visit_run=ns_run,
                            sass=None if sass is None else dict(sass),
                            sass_inner=None if inner is None else dict(inner)))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
