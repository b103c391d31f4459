#!/usr/bin/env python3
"""The check's control: the reference in the program's place, computed in
TF32 (the cell's traffic kind's `control_window`), on the cell's own
pixels and passes, for each of several seeds. It
prints each number the check compares beside the cell's limit; every
seed has to fail at least one of them. The benchmark's runs do not run
it.

    python3 rtbench/control.py --workload <cell> --seeds 1,2,3 \
        --passes <the passes a run renders>
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from harness import check, spec  # noqa: E402
from reference.scene import RefScene  # noqa: E402


def control_numbers(cell, seed: int, n_passes: int, device) -> dict:
    config = cell.config
    s = config["settings"]
    sc = RefScene(config["scene"], s["width"], s["height"], cell.root, device)
    pixels = check.pick_pixels(seed, s["width"], s["height"],
                               int(cell.settings["check_pixels"]))
    window = cell.job.control_window(sc, config, cell.traffic, seed,
                                     n_passes, pixels)
    return cell.job.compare(sc, config, window, pixels,
                            int(cell.settings["check_pairs"]), seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--passes", type=int, required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, HERE.parent / "BENCHMARK.json")
    all_fail = True
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = control_numbers(cell, seed, args.passes, "cuda")
        failed = [k for k in cell.job.NUMBERS
                  if numbers[k] > cell.limits[k]]
        all_fail &= bool(failed)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "numbers": numbers, "failed": failed,
                          "seconds": time.perf_counter() - t0}))
    return 0 if all_fail else 1


if __name__ == "__main__":
    sys.exit(main())
