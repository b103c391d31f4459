"""What the probes share: the device choice and the timing of their mains,
the Moller-Trumbore group body of P3 and P1 (and the values of its rows
that K3's prefilter reads), the slab, the second input set and the drain
record of P2 and P1, and the reading of a kernel's loop in SASS."""
from __future__ import annotations

import argparse
import functools
import re
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from .. import native_cuda

LANE = 128
LG = 16            # triangle rows of a block
NO_ID = 1 << 30    # the scripts' id of a row that did not win
_U32 = (1 << 32) - 1


def parse_args(argv, doc: str, iters: int) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the kernel, the default) or cpu (the plain "
                    "version)")
    ap.add_argument("--iters", type=int, default=iters,
                    help=f"iterations of the probe's loop (default {iters})")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probe times its kernel on the "
                           "card (pass --device cpu for the plain version)")
    return args


def best_ms(fn, device: str, reps: int = 5) -> float:
    """Least milliseconds of `reps` calls after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def device_name(device: str) -> str:
    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"


def mt_rows(tris, o, d, t_min, t_best, block, shift):
    """Moller-Trumbore of a 16-row triangle block against R x 128 rays, op
    for op as the scripts write it (probe_iter_cost.py:83-111,
    probe_walk_cost.py:154-197): rows block * 16 .. + 15 of `tris`, lanes
    shift .. shift + 9 (p0, e1, e2; lane shift + 9 holds the id). o, d
    (3, R, 1, LANE), t_min (R, 1, LANE), t_best (R, LANE). Returns den and
    the numerators nu, nv of u = nu / den and v = nv / den (the values
    K3's prefilter reads), whether the row is hit, and t, each (R, LG,
    LANE)."""
    rows = slice(block * LG, (block + 1) * LG)
    cols = (torch.arange(9, device=tris.device) + shift) % LANE
    tb = tris[rows][:, cols]                        # (LG, 9)
    p0, e1, e2 = ([tb[:, k][None, :, None] for k in range(j, j + 3)]
                  for j in (0, 3, 6))
    pv0 = d[1] * e2[2] - d[2] * e2[1]
    pv1 = d[2] * e2[0] - d[0] * e2[2]
    pv2 = d[0] * e2[1] - d[1] * e2[0]
    den = pv0 * e1[0] + pv1 * e1[1] + pv2 * e1[2]
    sden = torch.where(den == 0.0, 1.0, den)
    tv = [o[k] - p0[k] for k in range(3)]
    nu = pv0 * tv[0] + pv1 * tv[1] + pv2 * tv[2]
    u = nu / sden
    qv0 = tv[1] * e1[2] - tv[2] * e1[1]
    qv1 = tv[2] * e1[0] - tv[0] * e1[2]
    qv2 = tv[0] * e1[1] - tv[1] * e1[0]
    nv = qv0 * d[0] + qv1 * d[1] + qv2 * d[2]
    v = nv / sden
    t = (qv0 * e2[0] + qv1 * e2[1] + qv2 * e2[2]) / sden
    ok = ((den != 0.0) & (u >= -1e-5) & (u <= 1.00001) & (v >= -1e-5)
          & (u + v <= 1.00001) & (t >= t_min) & (t <= t_best[:, None, :]))
    return den, nu, nv, ok, t


def group(tris, ids, o, d, t_min, t_best, best, block, shift, gate=None):
    """One Moller-Trumbore pass (mt_rows) of a 16-row triangle block
    against R x 128 rays, with the id of each row as int32 bits in `ids`
    at lane shift + 9; a ray whose `gate` (R, LANE) is False takes no hit.
    Returns the new (t_best, best), (R, LANE): the least t, and of equal t
    the least id, where an id is NO_ID unless all 16 rows hold that t."""
    *_, ok, t = mt_rows(tris, o, d, t_min, t_best, block, shift)
    idb = ids[block * LG:(block + 1) * LG, (shift + 9) % LANE][None, :, None]
    if gate is not None:
        ok = ok & gate[:, None, :]
    t_sl = torch.where(ok, t, float("inf"))
    tg = t_sl.amin(dim=1)                           # (R, LANE)
    idw = torch.where(t_sl == tg[:, None, :], idb, NO_ID).amin(dim=1)
    take = tg < float("inf")
    return torch.where(take, tg, t_best), torch.where(take, idw, best)


def slab(box, o, inv):
    """t0, t1 of each (ray row, slot, lane): box (W, 6) lo xyz, hi xyz, o and
    inv (3, n, LANE) -> (n, W, LANE) each, axis by axis from -inf and inf as
    the scripts fold them."""
    n, w = o.shape[1], box.shape[0]
    t0 = torch.full((n, w, LANE), -float("inf"), dtype=torch.float32,
                    device=box.device)
    t1 = torch.full((n, w, LANE), float("inf"), dtype=torch.float32,
                    device=box.device)
    for ax in range(3):
        oa, ia = o[ax][:, None, :], inv[ax][:, None, :]
        a = (box[None, :, ax, None] - oa) * ia
        b = (box[None, :, 3 + ax, None] - oa) * ia
        t0 = torch.maximum(t0, torch.minimum(a, b))
        t1 = torch.minimum(t1, torch.maximum(a, b))
    return t0, t1


def bits(hit) -> int:
    """The int of a bool vector, bit w for slot w."""
    return int((hit.to(torch.int64) << torch.arange(
        len(hit), device=hit.device)).sum())


def ray_bundles(rng, nodes: int, rows: int, offset=(0.0, 0.0, 0.0)):
    """The rays and boxes of P2's and P1's second input set, drawn from
    `rng`: two bundles of nearly parallel rays (the first rows // 2 rows
    and the rest) from near one point org = offset + U(-0.2, 0.2)^3, and
    `nodes` x 16 boxes, lanes 0-5 of each slot's 8 (lo xyz, hi xyz, lo <=
    hi), strewn about the bundles' paths; lanes 6 and 7 hold noise.
    Returns (org, dirs (2, 3), o and d (3, rows, LANE), boxes (nodes * 16,
    8)), float64."""
    org = np.asarray(offset) + rng.uniform(-0.2, 0.2, 3)
    dirs = np.array([[1.0, 0.6, 0.3], [0.4, 1.0, 0.5]])
    o = org[:, None, None] + 1e-3 * rng.standard_normal((3, rows, LANE))
    d = np.concatenate([
        dirs[r * 2 // rows][:, None, None]
        + 0.02 * rng.standard_normal((3, 1, LANE)) for r in range(rows)],
        axis=1)
    t = rng.uniform(0.5, 4.0, (nodes, 16))
    centre = (org + t[..., None] * dirs[rng.integers(0, 2, (nodes, 16))]
              + 0.6 * rng.standard_normal((nodes, 16, 3)))
    half = 0.05 + 0.4 * rng.random((nodes, 16, 3))
    boxes = rng.standard_normal((nodes, 16, 8))
    boxes[..., 0:3] = centre - half
    boxes[..., 3:6] = centre + half
    return org, dirs, o, d, boxes.reshape(nodes * 16, 8)


def ffs16(m: int) -> tuple[int, int]:
    """traverse_pallas.py::_ffs(m, 16) on a host int: (index of the lowest
    set bit, that bit), and (0, 0) for m = 0."""
    low = m & -m
    return (low.bit_length() - 1 if low else 0), low


def int32(x: int) -> int:
    """x wrapped to a signed 32-bit value, as int32 arithmetic wraps."""
    x &= _U32
    return x - (1 << 32) if x >> 31 else x


class Drains:
    """The record every P2 and P1 launch keeps of its visits: each visit's
    drained mask_s (into `visits`, when given) and `stats` = (visits run,
    the wrapping int32 fold f = f * 33 + mask_s over them). The fold makes
    every visit's slab and drain an input of the launch's output."""

    def __init__(self):
        self.seq: list[int] = []
        self.fold = 0

    def add(self, mask_s: int) -> None:
        self.seq.append(mask_s)
        self.fold = (self.fold * 33 + mask_s) & _U32

    def finish(self, device, visits=None):
        if visits is not None:
            visits.zero_()
            if self.seq:
                visits[:len(self.seq)] = torch.tensor(
                    [int32(m) for m in self.seq], dtype=torch.int32)
        return torch.tensor([len(self.seq), int32(self.fold)],
                            dtype=torch.int32, device=device)


def check_buffers(ins, visits, iters: int, device) -> None:
    """Raise unless the inputs `ins` start on 16 bytes (the kernels read
    them in 16-byte vectors) and `visits` is None or a contiguous int32
    buffer of `iters` on the kernel's device (which the wrapper zeroes, as
    the plain version does, before the kernel writes the visits run)."""
    for x in ins:
        if x.data_ptr() % 16:
            raise ValueError("inputs: expected 16-byte aligned tensors")
    if visits is not None:
        native_cuda.check_tensor("visits", visits, (iters,), torch.int32,
                                 device)
        if not visits.is_contiguous():
            raise ValueError("visits: expected a contiguous tensor")


@functools.lru_cache(maxsize=None)
def _sass(library: Path) -> str | None:
    """cuobjdump -sass of the built library, once a library."""
    tool = shutil.which("cuobjdump") or str(
        Path(native_cuda._nvcc()).with_name("cuobjdump"))
    res = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                         text=True)
    return res.stdout if res.returncode == 0 else None


def _branches(kernel: str, library: Path | None = None):
    """(instructions as (address, opcode), branches as (address, target))
    of the first function in the SASS of `library` (default: the built
    library) whose mangled name holds `kernel`; None where cuobjdump or the
    function is not found."""
    sass = _sass(library or native_cuda.library_path())
    if sass is None:
        return None
    for section in sass.split("Function : ")[1:]:
        if kernel not in section.split(None, 1)[0]:
            continue
        ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            section)]
        branches = []
        for addr, op in ins:
            if not op.startswith("BRA"):
                continue
            line = section[section.find(f"/*{addr:04x}*/"):].split("\n", 1)[0]
            # BRA [.mod] [predicate operand,] target, e.g. "BRA P2, 0x1650"
            target = re.search(
                r"BRA(?:\.\w+)*\s+(?:!?U?P\w+,\s*)?(?:`\()?(?:0x)?([0-9a-f]+)",
                line)
            if target:
                branches.append((addr, int(target.group(1), 16)))
        return ins, branches
    return None


def _widest(spans):
    return max(spans, key=lambda span: span[1] - span[0])


def loop_instructions(kernel: str, inner: bool = False,
                      library: Path | None = None):
    """Opcodes of a kernel's loop body in SASS, from cuobjdump on the built
    library (or `library`): in the first function whose mangled name holds
    `kernel`, the instructions from the target of a backward branch to the
    branch, for the branch that spans most (an outer loop, its inner loops
    included once). None where cuobjdump or a loop is not found. With
    `inner`, a pair: that, and the opcodes of the widest loop inside it
    (None if it holds none)."""
    found = _branches(kernel, library)
    if found is None:
        return None
    ins, branches = found
    loops = [(b, a) for a, b in branches if b < a]
    if not loops:
        return None
    lo, hi = _widest(loops)
    body = Counter(o for a, o in ins if lo <= a <= hi)
    if not inner:
        return body
    inside = [(a, b) for a, b in loops
              if lo <= a and b <= hi and (a, b) != (lo, hi)]
    if not inside:
        return body, None
    ilo, ihi = _widest(inside)
    return body, Counter(o for a, o in ins if ilo <= a <= ihi)


def source_int(source: str, decl: str) -> int:
    """N of the line `<decl> = N;` in the kernel source csrc/<source>: a
    kernel's layout, read where the kernel sets it."""
    text = (native_cuda.CSRC / source).read_text()
    m = re.search(re.escape(decl) + r"\s*=\s*(\d+);", text)
    if m is None:
        raise LookupError(f"{source}: no line `{decl} = N;`")
    return int(m.group(1))
