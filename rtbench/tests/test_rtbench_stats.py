"""The window's arithmetic: the pass in flight at the deadline completes
and counts, the rate takes all rays over all the window's time, and the
percentile takes every pass."""
import statistics

import numpy as np
import pytest
import torch

from harness import window as W
from reference.kinds import load_kind
from rtbench_helpers import BENCH

TRAFFIC = {"kind": "beauty", "spp_per_pass": 1, "job_spp": 3}
BEAUTY = load_kind(BENCH, "traffic", "beauty")


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeTaps:
    """What the taps hand the window at the end of a pass."""

    def __init__(self):
        self.rows = torch.zeros(2, dtype=torch.int64)
        self.capture = False
        self.pending = None

    def end_pass(self):
        return (*self.pending, None, None)


class FakeProgram:
    """Jobs of passes of the given durations: pass k (from 1) traces 10 k
    rays and gives radiance k everywhere."""

    def __init__(self, clock, taps, durations):
        self.clock, self.taps, self.durations = clock, taps, durations
        self.seen = []

    def accumulate(self, seed, spp, on_chunk=None):
        total = np.zeros((2, 2, 3), np.float32)
        for sample in range(spp):
            self.seen.append((seed, sample))
            k = len(self.seen)
            self.clock.t += self.durations[k - 1]
            self.taps.pending = (torch.tensor(10 * k),
                                 torch.full((2, 3), float(k)))
            total += k
            on_chunk(total / np.float32(sample + 1), sample + 1)


def test_window_counts_the_pass_in_flight(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(BEAUTY.time, "perf_counter", clock)
    taps = FakeTaps()
    prog = FakeProgram(clock, taps, [0.4, 0.3, 0.5, 0.7, 0.2])
    w = BEAUTY.drive(prog, TRAFFIC, 7, taps, np.array([0, 2]), seconds=1.0)
    # 0.4, 0.7 < 1.0; the third pass starts at 0.7 and ends at 1.2: counted
    assert len(w.passes) == 3 and w.seconds == pytest.approx(1.2)
    assert [(r.start_s, r.end_s) for r in w.passes] == pytest.approx(
        [(0.0, 0.4), (0.4, 0.7), (0.7, 1.2)])
    assert W.rate(w) == pytest.approx((10 + 20 + 30) / 1.2 / 1e6)
    assert prog.seen == [(7, 0), (7, 1), (7, 2)]
    np.testing.assert_allclose(w.accumulated[0], np.full((2, 3), 6.0))


def test_jobs_restart_samples_with_the_next_seed(monkeypatch):
    gen = BEAUTY.passes(TRAFFIC, 2**32 - 1)
    got = [next(gen) for _ in range(5)]
    assert [(p.job, p.seed, p.sample) for p in got] == [
        (0, 2**32 - 1, 0), (0, 2**32 - 1, 1), (0, 2**32 - 1, 2),
        (1, 0, 0), (1, 0, 1)]
    # the window's jobs follow the same plan, the cut job accumulated
    clock = Clock()
    monkeypatch.setattr(BEAUTY.time, "perf_counter", clock)
    taps = FakeTaps()
    prog = FakeProgram(clock, taps, [0.1] * 5)
    w = BEAUTY.drive(prog, TRAFFIC, 2**32 - 1, taps, np.array([1, 3]),
                     seconds=0.45)
    assert [r.p for r in w.passes] == got
    assert prog.seen == [(p.seed, p.sample) for p in got]
    np.testing.assert_allclose(w.accumulated[1], np.full((2, 3), 9.0))


def test_percentile_uses_every_pass():
    recs = [W.PassRecord(None, float(i), float(i) + d, 1, None, None, None)
            for i, d in enumerate([0.1, 0.2, 0.3, 0.4, 5.0, 0.6, 0.7, 0.8,
                                   0.9, 1.0, 1.1])]
    w = W.Window(recs, 12.0, {}, True)
    ms = [r.end_s * 1e3 - r.start_s * 1e3 for r in recs]
    assert W.percentile_ms(w, 90) == pytest.approx(
        statistics.quantiles(ms, n=100)[89])
    assert W.percentile_ms(w, 90) > 1100  # the 5 s pass is in the tail
