"""P3: the cost of one iteration of a brute-group-shaped loop body.

Counterpart of scripts/probe_iter_cost.py (the Pallas kernel that
`make(R, roll, dynamic, chain, loop)` builds, pallas_call at :155). Each of
ITERS iterations reads one 16-row triangle block, rolls its lanes, runs
Moller-Trumbore of the block's 16 triangles against R x 128 rays and keeps
each ray's least t and its triangle id. With `chain`, a tile-wide drain of
the ids picks the next block, so the iterations depend on each other as a
walk's visits do. The output is t_best + float(best), (R, 128) float32.

Inputs, as the script passes them whatever R is:
- tris (128, 128) float32: 8 blocks of 16 rows, one triangle a row; lanes
  s .. s + 9 hold p0, e1, e2 and the triangle id as int32 bits, where
  s = (q % 12) * 10 in iteration q (with roll; 0 without);
- o, d (12, 128) float32: ray (r, lane) reads rows ax * R + r, ax = 0..2;
- t_min (4, 128) float32: row r.

`iter_cost` launches csrc/probe_iter_cost.cu for CUDA tensors and runs
`iter_cost_plain` for CPU tensors; it takes only the script's five
configurations (CONFIGS). The kernel runs K3's exact prefilter before the
divides, a ray a thread; `kept` and `deferred_trips` count, on the host,
the full tests that the prefilter leaves it. `python -m
tpu_raytracing_torch.probes.iter_cost` times the configurations on the
card (`--device cpu` runs the plain version).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..native_cuda import check_tensor, launch, on_card
from ..ops.intersect import prefilter_rejects
from . import common
from .common import LANE, LG, best_ms, device_name, group, mt_rows, parse_args

NB = 8         # blocks of tris
RMAX = 4       # ray rows the inputs hold
LOOPS = ("fori", "dynfori", "while")
# the script's grid (probe_iter_cost.py:171-175): R, roll, dynamic, chain,
# loop
CONFIGS = (
    (4, True, True, False, "fori"),
    (4, True, True, False, "dynfori"),
    (4, True, True, False, "while"),
    (4, True, True, True, "while"),
    (1, True, True, True, "while"),
)
ITERS = int(os.environ.get("PROBE_ITERS", "4096"))  # as in the script
# the trip counts fori's kernel is compiled for: the card tests' count and
# the script's default
FORI_ITERS = (256, 4096)
# the kernel's rays a thread, S (probe_iter_cost.cu::kRaysPerThread)
RAYS_PER_THREAD = 1
_F32 = torch.float32


def label(config) -> str:
    """The script's name of a configuration."""
    R, roll, dynamic, chain, loop = config
    return (f"R={R} roll={int(roll)} dyn={int(dynamic)} chain={int(chain)} "
            f"loop={loop}")


def _check_plain_config(R, chain, loop) -> None:
    if not 1 <= R <= RMAX or loop not in LOOPS:
        raise ValueError(f"R must be 1..{RMAX} and loop one of {LOOPS}")
    if chain and loop == "dynfori":
        raise ValueError("the script's dynfori loop has no chain")


def _drain_parity(best) -> int:
    """The parity of the script's wrapping int32 sum of min(best, 1): the
    parity of the number of odd terms."""
    return int((torch.clamp(best, max=1) & 1).sum()) & 1


def iter_cost_plain(tris, o, d, t_min, R: int, roll: bool, dynamic: bool,
                    chain: bool, loop: str, iters: int, counts=None,
                    trace=None):
    """The probe in plain PyTorch, one iteration at a time; any R of 1..4,
    roll and dynamic on or off. `counts`, a (1,) int32 tensor, receives
    the iterations run (fewer than `iters` with the chain); `trace`, a
    list, each iteration's (block, shift)."""
    _check_plain_config(R, chain, loop)
    ids = tris.contiguous().view(torch.int32)
    o3 = o[:3 * R].reshape(3, R, 1, LANE)
    d3 = d[:3 * R].reshape(3, R, 1, LANE)
    tmn = t_min[:R][:, None, :]
    t_best = torch.full((R, LANE), float("inf"), dtype=_F32, device=tris.device)
    best = torch.full((R, LANE), -1, dtype=torch.int32, device=tris.device)

    def body(q, addr):
        block = addr % NB if chain else (q % NB if dynamic else 0)
        shift = (q % 12) * 10 if roll else 0
        if trace is not None:
            trace.append((block, shift))
        return group(tris, ids, o3, d3, tmn, t_best, best, block, shift)

    q = addr = n_run = 0
    if chain and loop == "while":  # q is the address (the script's wbody)
        while q < iters:
            t_best, best = body(q, q)
            q += 1 + _drain_parity(best)
            n_run += 1
    else:
        for q in range(iters):
            t_best, best = body(q, addr)
            if chain:
                addr += 1 + _drain_parity(best)
        n_run = iters
    if counts is not None:
        counts.fill_(n_run)
    return t_best + best.to(_F32)


def iter_cost(tris, o, d, t_min, R: int, roll: bool, dynamic: bool,
              chain: bool, loop: str, iters: int, counts=None):
    """P3: the kernel for CUDA tensors, iter_cost_plain for CPU tensors.
    Takes the script's five configurations only; on the card, fori (whose
    trip count is compiled in) takes iters in FORI_ITERS. `counts`: None,
    or a (1,) int32 tensor that receives the iterations run."""
    config = (R, roll, dynamic, chain, loop)
    if config not in CONFIGS:
        raise ValueError(f"{config} is not one of the script's "
                         f"configurations {CONFIGS}")
    if not on_card("probe_iter_cost", tris):
        return iter_cost_plain(tris, o, d, t_min, R, roll, dynamic, chain,
                               loop, iters, counts)
    if loop == "fori" and iters not in FORI_ITERS:
        raise ValueError(f"fori is compiled for iters in {FORI_ITERS}; got "
                         f"{iters}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    dev = tris.device
    ins = [check_tensor("tris", tris, (NB * LG, LANE), _F32, dev),
           check_tensor("o", o, (3 * RMAX, LANE), _F32, dev),
           check_tensor("d", d, (3 * RMAX, LANE), _F32, dev),
           check_tensor("t_min", t_min, (RMAX, LANE), _F32, dev)]
    if counts is not None:
        check_tensor("counts", counts, (1,), torch.int32, dev)
        if not counts.is_contiguous():
            raise ValueError("counts: expected a contiguous tensor")
    out = torch.empty((R, LANE), dtype=_F32, device=dev)
    launch("tpu_rt_probe_iter_cost", dev, *[x.data_ptr() for x in ins],
           out.data_ptr(), None if counts is None else counts.data_ptr(),
           R, int(chain), LOOPS.index(loop), iters, tag=label(config))
    return out


def sass_name(config, iters: int) -> str:
    """The part of the mangled name of the kernel a configuration launches
    (its template arguments R, S, CHAIN, LOOP, FIXED)."""
    R, _, _, chain, loop = config
    S = RAYS_PER_THREAD
    fixed = iters if loop == "fori" else 0
    return (f"probe_iter_costILi{R}ELi{S}ELb{int(chain)}ELi"
            f"{LOOPS.index(loop)}ELi{fixed}EE")


def kept(tris, o, d, t_min, R: int, block: int, shift: int):
    """The (row, ray) tests of one iteration that K3's prefilter leaves the
    kernel's full test (its gate is open for every ray): (R, LG, LANE)
    bool, from the plain version's den and numerators (common.mt_rows)."""
    o3 = o[:3 * R].reshape(3, R, 1, LANE)
    d3 = d[:3 * R].reshape(3, R, 1, LANE)
    t_best = torch.full((R, LANE), float("inf"), dtype=_F32, device=o.device)
    den, nu, nv, _, _ = mt_rows(tris, o3, d3, t_min[:R][:, None, :], t_best,
                                block, shift)
    return ~prefilter_rejects(den, nu, nv)


def deferred_trips(tris, o, d, t_min, R: int, S: int, trace) -> int:
    """Warp trips of the kernel's second pass over the iterations `trace`
    ((block, shift) each, as iter_cost_plain records them) at S rays a
    thread: for each iteration and warp, the most full tests any of its
    threads takes (thread x holds rays x, x + R * 128 / S, ...)."""
    threads = R * LANE // S
    per_it = {}
    total = 0
    for key in trace:
        if key not in per_it:
            n = kept(tris, o, d, t_min, R, *key).sum(dim=1).reshape(-1)
            per_thread = n.reshape(S, threads).sum(dim=0)
            per_it[key] = int(per_thread.reshape(-1, 32).amax(dim=1).sum())
        total += per_it[key]
    return total


def script_inputs(device="cpu", small_ids: bool = False):
    """The script's inputs (probe_iter_cost.py:165-170): tris, o, d, t_min.
    With `small_ids`, every lane that a roll makes an id lane (9, 19 ..
    119) holds an integer below 4,096 instead, as int32 bits (denormal
    floats), so that t shows in t_best + float(best)."""
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((NB * LG, LANE), (3 * RMAX, LANE), (3 * RMAX, LANE))]
    arrays.append(np.full((RMAX, LANE), 1e-3, np.float32))
    if small_ids:
        ids = np.random.default_rng(1).integers(0, 4096, size=(NB * LG, 12))
        arrays[0].view(np.int32)[:, 9:120:10] = ids
    return [torch.from_numpy(a).to(device) for a in arrays]


def main(argv=None) -> list[dict]:
    """Time each configuration at --iters iterations (default PROBE_ITERS,
    4096) and print the script's line for it, plus the ns per iteration
    actually run (the chain runs fewer), and on the card the iteration
    loop's SASS instructions (the second pass's loop, inside it, apart).
    Returns one dict a configuration."""
    args = parse_args(argv, __doc__.splitlines()[0], ITERS)
    dev = args.device
    ins = script_inputs(dev)
    counts = torch.zeros(1, dtype=torch.int32, device=dev)
    print(f"device={device_name(dev)}", flush=True)
    results = []
    for config in CONFIGS:
        run = lambda: iter_cost(*ins, *config, args.iters)  # noqa: E731
        ms = best_ms(run, dev)
        iter_cost(*ins, *config, args.iters, counts=counts)
        n_run = int(counts.item())
        ns = ms * 1e6 / args.iters
        ns_run = ms * 1e6 / max(n_run, 1)
        print(f"{label(config)}: {ns:8.1f} ns/iter ({ns_run:8.1f} ns per "
              f"iteration run; {n_run} of {args.iters} run)", flush=True)
        res = dict(config=label(config), ms=ms, iters=args.iters,
                   iters_run=n_run, ns_per_iter=ns, ns_per_iter_run=ns_run,
                   sass=None, sass_inner=None)
        if dev == "cuda":
            found = common.loop_instructions(sass_name(config, args.iters),
                                             inner=True)
            if found is not None:
                res["sass"], res["sass_inner"] = (
                    dict(c) if c is not None else None for c in found)
                inner = sum(found[1].values()) if found[1] else 0
                print(f"{label(config)}: iteration loop in SASS, "
                      f"{sum(found[0].values())} instructions, {inner} of "
                      f"them in the second pass's loop", flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
