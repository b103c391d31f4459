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


def program_window(cell, n_passes: int, seed: int = SEED):
    """The program's window of `n_passes` passes of `cell` on the CPU,
    passes 0-1 captured as a run captures them; with its check pixels and
    the reference's scene."""
    import torch
    from harness import check
    from harness.program import Program, Taps
    from reference.scene import RefScene
    prog = Program(cell.config, cell.root, "cpu")
    pixels = check.pick_pixels(seed, prog.width, prog.height,
                               int(cell.settings["check_pixels"]))
    taps = Taps(torch.as_tensor(pixels), prog.width, prog.height)
    taps.install(Taps.TRAVERSAL)
    try:
        window = cell.job.drive(prog, cell.traffic, seed, taps, pixels,
                                after_pass=lambda i: i + 1 >= n_passes)
    finally:
        taps.uninstall()
    prog.close()
    sc = RefScene(cell.config["scene"], prog.width, prog.height, cell.root,
                  "cpu")
    return window, pixels, sc


def short_jobs(name: str, width: int, job_spp: int = 2):
    """`tiny_cell` with jobs of `job_spp` passes, so a short window holds
    several jobs."""
    cell = tiny_cell(name, width)
    return cell._replace(traffic=dict(cell.traffic, job_spp=job_spp))


def regimes(cell, n: int, K: int) -> dict:
    """A budget of (pass, pixel) pairs in each regime of the check, for a
    window of `n` passes, the first two captured, K > K_MIN check pixels
    and jobs of two passes: all pairs; every uncaptured pass at K_MIN
    pixels; whole jobs at K_MIN, the one after job 0 left out (n >= 5)."""
    k = cell.job.K_MIN
    return {"under": n * K, "pixels": 2 * K + (n - 2) * k,
            "jobs": 2 * K + (n - 2) * k - 1}
