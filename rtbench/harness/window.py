"""The measured window's record: one entry a pass, each stamped on the
host's clock from the window's start, and the arithmetic of the
end-to-end metrics over all of it. A traffic kind (kinds/traffic/) fills
it.
"""
from __future__ import annotations

import statistics
from typing import List, NamedTuple, Optional

import numpy as np


class Pass(NamedTuple):
    index: int   # the pass's place in the run
    job: int
    seed: int    # the job's settings.seed
    sample: int  # the pass's first sample index


class PassRecord(NamedTuple):
    p: Pass
    start_s: float   # from the window's start: the previous pass's end
    end_s: float     # its image on the host
    rays: int
    values: np.ndarray  # (K, 3) radiance at the check's pixels
    captured: Optional[list]
    active_total: Optional[object]


class Window(NamedTuple):
    passes: List[PassRecord]
    seconds: float          # window start to the end of its last pass
    accumulated: dict       # job -> (K, 3) the program's sum, check pixels
    all_finite: bool


def rate(window: Window) -> float:
    """Rays over all passes of the window per second of the window, in
    Mrays/s."""
    return sum(r.rays for r in window.passes) / window.seconds / 1e6


def percentile_ms(window: Window, q: int) -> float:
    """The q-th percentile of all pass times of the window, in ms
    (`statistics.quantiles`, exclusive method)."""
    times = [(r.end_s - r.start_s) * 1e3 for r in window.passes]
    if len(times) < 2:
        raise ValueError("a percentile needs two passes or more")
    return statistics.quantiles(times, n=100)[q - 1]
