"""Helpers of the benchmark's tests: the cells cut to a few pixels
so a run fits the CPU, and a run's result line."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
if str(REPO) not in sys.path:
    sys.path.insert(1, str(REPO))

SEED = 2**31 + 4242  # runs take seeds wider than 32 signed bits


def tiny_cell(name: str, width: int = 16, pixels: int | None = None,
              benchmark: Path = REPO / "BENCHMARK.json", root: Path = BENCH):
    """The cell `name` at width x width pixels, `pixels` of them compared
    (all by default, so the rays a pixel are compared whole), two passes
    traced."""
    from harness import spec
    cell = spec.load_cell(name, benchmark, root)
    cfg = copy.deepcopy(cell.config)
    cfg["settings"]["width"] = cfg["settings"]["height"] = width
    knobs = dict(cell.settings, check_pixels=pixels or width * width,
                 trace_passes=2)
    return cell._replace(config=cfg, settings=knobs)


class Args:
    def __init__(self, seed=SEED, seconds=0.2, trace=0):
        self.seed, self.seconds, self.trace = seed, seconds, trace


def run_cell(cell, capsys, **kw) -> dict:
    """One run of `cell` on the CPU; its result line."""
    import run as bench_run
    import torch
    rc = bench_run.measure(cell, Args(**kw), torch, on_card=False)
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
