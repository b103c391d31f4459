#!/usr/bin/env python3
"""The port's own tracing (tpu_raytracing_torch/tracing.py) read over a
benchmark cell's passes on the card.

    python3 scripts/torch_trace_cells.py --cell bunny-beauty --seed 7 \
        [--passes N] [--sessions on,off,on,off] [--bare] [--out FILE]

builds the cell's program as rtbench/run.py does (the scene, settings and
warm-up of its files), renders its 1-spp passes with
`render_accumulated(spp_chunk=1)` and:

- pass 0 runs with tracing on and `torch.cuda.set_sync_debug_mode`
  warning, so each host sync the card reports is put beside the
  program's own count by site (`sync_check`);
- each session then profiles `--passes` passes (the cell's `trace_passes`
  by default) under `torch.profiler`, with the program's tracing on or
  off as `--sessions` says, and reads from the raw events, on the
  profiler's one clock: kernel launches and host syncs a pass (as the
  benchmark's `device.launches_per_pass` and `integrator.syncs_per_pass`
  count them), the runtime's launch calls inside `rt.coat.*` spans, idle
  seconds by the innermost open `rt.` span, the program's counters
  (`sync.<site>`, `lanes.*`, `coat.kernel_lanes` and
  `shade.kernel_lanes`: the lanes the coat kernel and the shading kernel
  took) and the pass times. With `--bare` the
  sessions run without the profiler, for their pass times and counters.

Prints one JSON object a cell (also written to `--out`).
"""
from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "rtbench"))
sys.path.insert(1, str(REPO))

NOT_KERNELS = ("Memcpy", "Memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
PORT = "tpu_raytracing_torch"


def union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def innermost(spans, lo, hi) -> list:
    """(start, end, name of the innermost open span or None) segments
    covering [lo, hi); `spans` (name, start, end) nest on one thread."""
    edges = sorted([(s, 1, -(e - s), n) for n, s, e in spans]
                   + [(e, 0, 0, n) for n, s, e in spans])
    segs, stack, t = [], [], lo
    for x, opening, _, name in edges:
        x = min(max(x, lo), hi)
        if x > t:
            segs.append((t, x, stack[-1] if stack else None))
            t = x
        if opening:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    if hi > t:
        segs.append((t, hi, stack[-1] if stack else None))
    return segs


def idle_by_span(busy, spans, lo, hi) -> dict:
    """Idle ns of [lo, hi) (no interval of `busy` open) by innermost span."""
    gaps, prev = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, min(s, hi)))
        prev = max(prev, e)
    out, j = {}, 0
    segs = innermost(spans, lo, hi)
    for gs, ge in gaps:
        while j < len(segs) and segs[j][1] <= gs:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < ge:
            a, b = max(segs[k][0], gs), min(segs[k][1], ge)
            name = segs[k][2] or "(no span)"
            out[name] = out.get(name, 0) + (b - a)
            k += 1
    return out


def read_session(prof, lo, hi, n_passes):
    kernels, annotations, runtime, spans = [], 0, [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if str(ev.device_type()).endswith("CUDA"):
            if name.startswith("rt."):
                annotations += 1  # the device's copy of a span
            else:
                kernels.append((name, s, e))
        elif name.startswith("rt."):
            spans.append((name, s, e))
        elif name.startswith("cu"):
            runtime.append((name, s, e))
    busy = union((max(s, lo), min(e, hi)) for _, s, e in kernels
                 if e > lo and s < hi)
    coat = union((s, e) for n, s, e in spans if n.startswith("rt.coat."))
    starts = [s for s, _ in coat]
    coat_launches = 0
    for n, s, _ in runtime:
        if n in LAUNCH_CALLS:
            i = bisect.bisect_right(starts, s) - 1
            coat_launches += i >= 0 and s < coat[i][1]
    idle = idle_by_span(busy, spans, lo, hi)
    window = hi - lo
    return {
        "window_s": window / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "launches_per_pass": sum(1 for n, _, _ in kernels
                                 if not n.startswith(NOT_KERNELS)) / n_passes,
        "runtime_launches_per_pass": sum(
            1 for n, _, _ in runtime if n in LAUNCH_CALLS) / n_passes,
        "syncs_per_pass": sum(1 for n, _, _ in runtime
                              if n in SYNC_CALLS) / n_passes,
        "device_annotations": annotations,
        "spans": len(spans),
        "coat_launches_per_pass": coat_launches / n_passes,
        "idle_s_by_span": {k: v / 1e9 for k, v in
                           sorted(idle.items(), key=lambda kv: -kv[1])},
        "accumulate_idle_pct": 100.0 * idle.get("rt.accumulate", 0) / window,
    }


def summarize(counts: dict, n_passes: int) -> dict:
    syncs = {k[5:]: v / n_passes for k, v in sorted(counts.items())
             if k.startswith("sync.")}
    coat = sum(v for k, v in syncs.items() if k.startswith("coat."))
    run = counts.get("lanes.run", 0)
    return {"syncs_by_site_per_pass": syncs,
            "coat_syncs_per_pass": coat,
            "loop_syncs_per_pass": sum(syncs.values()) - coat,
            "coat_kernel_lanes_per_pass":
                counts.get("coat.kernel_lanes", 0) / n_passes,
            "shade_kernel_lanes_per_pass":
                counts.get("shade.kernel_lanes", 0) / n_passes,
            "lane_use_pct": (100.0 * counts.get("lanes.alive", 0) / run
                             if run else None)}


def port_frames(stack) -> str:
    """The innermost two frames of the port in a stack, as file:line, or
    "" where the port is not on it."""
    mine = [f for f in stack if PORT in f.filename][-2:]
    return " < ".join(f"{Path(f.filename).name}:{f.lineno}"
                      for f in reversed(mine))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--passes", type=int, default=0)
    ap.add_argument("--sessions", default="on,off")
    ap.add_argument("--bare", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from harness import spec
    from harness.program import Program
    from tpu_raytracing_torch import native_cuda, tracing

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.cell, REPO / "BENCHMARK.json")
    n = args.passes or int(cell.settings["trace_passes"])
    modes = args.sessions.split(",")
    native_cuda.load()
    prog = Program(cell.config, cell.root, "cuda")
    for w in range(int(cell.settings["warmup_passes"])):
        prog.accumulate((args.seed - 1 - w) & 0xFFFFFFFF, 1)
    torch.cuda.synchronize()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = {"cell": cell.name, "seed": args.seed, "card": card,
           "passes_a_session": n, "sessions": []}
    stamps = []   # (perf_counter, epoch ns) at each pass's end

    def on_chunk(image, spp_done):
        stamps.append((time.perf_counter(), time.time_ns()))

    def job(j, spp):
        stamps[:] = [(time.perf_counter(), time.time_ns())]
        prog.accumulate((args.seed + j) & 0xFFFFFFFF, spp, on_chunk)
        return [b[0] - a[0] for a, b in zip(stamps, stamps[1:])]

    # pass 0: the program's counts by site against the card's own syncs
    warned = []

    def show(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()[:-1]
        warned.append(port_frames(stack) or " < ".join(
            f"{Path(f.filename).name}:{f.lineno}" for f in stack[-3:]))

    torch.cuda.set_sync_debug_mode(1)  # warns of itself: before the hook
    show_orig = warnings.showwarning
    warnings.showwarning = show
    warnings.simplefilter("always")
    tracing.reset()
    tracing.enable()
    try:
        pass_s = job(0, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        warnings.showwarning = show_orig
        tracing.disable()
    got = tracing.snapshot()
    by_frame = {}
    for w in warned:
        by_frame[w] = by_frame.get(w, 0) + 1
    out["sync_check"] = {
        "pass_s": pass_s, "card_syncs": len(warned),
        "card_by_frame": dict(sorted(by_frame.items(), key=lambda kv: -kv[1])),
        **summarize(got, 1)}
    print(json.dumps(out["sync_check"]), file=sys.stderr, flush=True)

    # profiled sessions of n passes, each the same job of its own, started
    # and stopped outside every span of the program; the window ends with
    # the last pass's image on the host
    for mode in modes:
        tracing.reset()
        if mode == "on":
            tracing.enable()
        rec = {"tracing": mode}
        if args.bare:
            rec["pass_s"] = job(1, n)
        else:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                rec["pass_s"] = job(1, n)
            rec.update(read_session(prof, stamps[0][1], stamps[-1][1], n))
        tracing.disable()
        if mode == "on":
            rec.update(summarize(tracing.snapshot(), n))
        out["sessions"].append(rec)
        print(json.dumps({k: v for k, v in rec.items()
                          if k != "syncs_by_site_per_pass"}),
              file=sys.stderr, flush=True)
    text = json.dumps(out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
