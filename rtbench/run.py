#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (tpu_raytracing_torch).

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s>
                           --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. A run sets up (CUDA context, the port's kernel and host-library
builds, which stay in tpu_raytracing_torch/_build of the checkout, the
scene compile), renders the cell's passes in a closed loop for `--seconds`
(with `--trace 1`, a fixed slice of passes under torch.profiler instead),
then frees the program's state and holds what the passes produced against
the plain reference (reference/). It prints the numbers compared beside
their limits as its last lines on standard error, and one JSON object as
the last line of standard output. See PERF.md for the cells and metrics.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
CACHE = REPO / ".rtbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_raytracing")

# every build or kernel cache a library could write goes inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "nv"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(REPO))

from harness import check, spec  # noqa: E402
from harness.program import Program, Taps  # noqa: E402
from harness.trace import Slice  # noqa: E402


def process_start() -> float:
    """The process's start on the epoch clock (from /proc), or now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        boot = next(float(ln.split()[1]) for ln in
                    Path("/proc/stat").read_text().splitlines()
                    if ln.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_PROCESS = process_start()


def loaded_forbidden() -> list:
    """Top-level names in sys.modules that are JAX or its package."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info(torch) -> dict:
    import subprocess
    info = {"power_limit": "not read"}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        info["power_limit"] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload, REPO / "BENCHMARK.json")
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"rtbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import tpu_raytracing_torch  # noqa: F401
    except ImportError as e:
        print(f"rtbench: the program is missing: {e}", file=sys.stderr)
        return 4
    return measure(cell, args, torch, on_card=True)


def measure(cell, args, torch, on_card: bool) -> int:
    """One run of `cell`; the result line on stdout. Off the card (tests
    only) the traced slice runs without the profiler and no device metric
    is read."""
    device = "cuda" if on_card else "cpu"
    config, job, knobs = cell.config, cell.job, cell.settings
    seed = args.seed
    if on_card:
        from tpu_raytracing_torch import native_cuda
        native_cuda.load()
    prog = Program(config, cell.root, device)
    job.warm_up(prog, cell.traffic, seed, int(knobs["warmup_passes"]))
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.time() - T_PROCESS

    pixels = check.pick_pixels(seed, prog.width, prog.height,
                               int(knobs["check_pixels"]))
    taps = Taps(torch.as_tensor(pixels, device=prog.device), prog.width,
                prog.height)
    taps.install(Taps.TRAVERSAL)
    trace = None
    if args.trace:
        names = set(Taps.TRAVERSAL)
        for m in cell.per_layer:
            names |= set(getattr(m.reader, "SPANS", ()))
        taps.install(names)
        sliced = Slice(int(knobs["trace_passes"]), taps, names, on_card)
        window = job.drive(prog, cell.traffic, seed, taps, pixels,
                           capture=(0,), after_pass=sliced.after_pass)
        trace, traced_passes = sliced.trace, sliced.passes
    else:
        def release(i):
            # the captured passes are done: the timed path runs bare
            if i == 1:
                taps.uninstall(Taps.TRAVERSAL)
            return False

        window = job.drive(prog, cell.traffic, seed, taps, pixels,
                           seconds=args.seconds, after_pass=release)
        traced_passes = 0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    taps.uninstall()
    prog.close()
    from reference.scene import RefScene
    sc = RefScene(config["scene"], prog.width, prog.height, cell.root,
                  device)

    # what a metric reader reads
    run = SimpleNamespace(setup_s=setup_s, window=window, trace=trace,
                          traced_passes=traced_passes, n_tris=sc.n_tris)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = m.reader.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}

    times = [r.end_s - r.start_s for r in window.passes]
    q = np.quantile(times, [0.1, 0.5, 0.9]) if times else [0, 0, 0]
    print(f"passes {len(times)} in {window.seconds:.3f} s, first "
          f"{times[0]:.4f} s, p10 {q[0]:.4f} median {q[1]:.4f} p90 {q[2]:.4f}"
          f"; rays {sum(r.rays for r in window.passes)}; setup {setup_s:.2f} s",
          file=sys.stderr)
    t_ref = time.perf_counter()
    followed = {}
    numbers = job.compare(sc, config, window, pixels,
                          int(knobs["check_pairs"]), seed, followed)
    correct = check.verdict(numbers, cell.limits, job.NUMBERS)
    import resource
    print(f"reference took {time.perf_counter() - t_ref:.2f} s; host peak "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} KiB",
          file=sys.stderr)
    print("reference followed {pairs} (pass, pixel) pairs of {passes} "
          "passes, {k} pixels an uncaptured pass, {jobs} of {all_jobs} jobs,"
          " in {calls} calls of {call_s:.2f} s".format(**followed),
          file=sys.stderr)

    found = loaded_forbidden()
    if found:
        print(f"rtbench: loaded {', '.join(found)}; the benchmark runs the "
              "port alone", file=sys.stderr)
        return 5

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(window.passes),
              "failed": 0, "metrics": metrics, "device": dev}
    if trace is not None:
        from harness.trace import breakdown, busy_ns
        busy = busy_ns(trace)
        dev["busy_s"] = busy / 1e9
        dev["window_s"] = (trace.window_ns[1] - trace.window_ns[0]) / 1e9
        dev["card"] = card_info(torch)
        result["breakdown"] = breakdown(trace)
    result["check"] = {k: {"value": numbers[k], "limit": cell.limits[k]}
                       for k in job.NUMBERS}
    for k in job.NUMBERS:
        print(f"check {k} {numbers[k]!r} limit {cell.limits[k]!r}",
              file=sys.stderr)
    print(f"check correct {correct}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
