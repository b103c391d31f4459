"""The traced slice: `torch.profiler` over a fixed number of passes,
read in memory from the profiler's raw events (no chrome trace is
written).

A session now and then records no device events; the slice is then
rendered again in a new session, up to three times in all, as the
port's card checks read kernel times.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

ATTEMPTS = 3


class Trace(NamedTuple):
    kernels: List[Tuple[str, int, int]]   # (name, start_ns, end_ns)
    runtime: List[Tuple[str, int, int]]   # CUDA runtime calls on the host
    window_ns: Tuple[int, int]            # the traced passes' host interval
    spans: list                           # the taps' spans in the slice
    clock_shift_ns: int                   # epoch ns minus perf_counter ns


class Slice:
    """Profiles the `n` passes after the first: `after_pass(i)`, called at
    the end of each pass of the window, starts a session after pass 0 and
    ends it `n` passes later, when it returns true (the window closes)
    unless the session saw no device events and is tried again. The taps
    record spans of `span_names` inside a session only. Off the card (the
    tests) no profiler runs, and `trace` stays None."""

    def __init__(self, n: int, taps, span_names, on_card: bool):
        self.n, self.taps, self.names = n, taps, set(span_names)
        self.on_card = on_card
        self.first: Optional[int] = None
        self.attempts = 0
        self.prof = None
        self.start_ns = 0
        self.trace: Optional[Trace] = None
        self.passes = 0

    def _start(self, i: int) -> None:
        self.first = i + 1
        self.attempts += 1
        self.taps.spans = []
        if self.on_card:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.taps.span_names = self.names
        self.start_ns = time.time_ns()

    def after_pass(self, i: int) -> bool:
        if self.first is None:
            self._start(i)
            return False
        if i + 1 - self.first < self.n:
            return False
        end_ns = time.time_ns()
        self.taps.span_names = set()
        self.passes = self.n
        if not self.on_card:
            return True
        self.prof.__exit__(None, None, None)
        kernels, runtime = [], []
        for ev in self.prof.profiler.kineto_results.events():
            name = ev.name()
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if str(ev.device_type()).endswith("CUDA"):
                kernels.append((name, s, e))
            elif name.startswith("cuda"):
                runtime.append((name, s, e))
        self.prof = None
        if kernels:
            self.trace = Trace(kernels, runtime, (self.start_ns, end_ns),
                               self.taps.spans,
                               time.time_ns() - time.perf_counter_ns())
            return True
        if self.attempts == ATTEMPTS:
            raise RuntimeError(f"{ATTEMPTS} profiler sessions recorded no "
                               "device events")
        self._start(i)
        return False


def _union(intervals) -> list:
    """Disjoint, sorted cover of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_intervals(trace: Trace) -> list:
    """The union of kernel intervals, clipped to the traced window."""
    lo, hi = trace.window_ns
    return _union((max(s, lo), min(e, hi)) for _, s, e in trace.kernels
                  if e > lo and s < hi)


def busy_ns(trace: Trace) -> int:
    """Nanoseconds of the window in which some kernel ran on the card."""
    return sum(e - s for s, e in busy_intervals(trace))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time of
    the window by the integrator call the host was in (its span), in
    seconds."""
    per_op = {}
    for name, s, e in trace.kernels:
        per_op[name] = per_op.get(name, 0) + (e - s)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = trace.window_ns
    gaps, prev = [], lo
    for s, e in busy_intervals(trace) + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    # spans are on the perf_counter clock: shift them onto the window's
    spans = sorted((s + trace.clock_shift_ns, e + trace.clock_shift_ns, n)
                   for n, s, e, _ in trace.spans)
    idle, j = {}, 0
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        while j < len(spans) and spans[j][1] < mid:
            j += 1
        name = ("in " + spans[j][2] if j < len(spans) and spans[j][0] <= mid
                else "between the integrator's calls")
        idle[name] = idle.get(name, 0) + (ge - gs)
    gaps_by = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, t / 1e9] for n, t in ops],
            "idle_gaps": [[n, t / 1e9] for n, t in gaps_by]}
