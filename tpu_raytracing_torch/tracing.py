"""The port's own tracing: spans at its layer boundaries and counters of
host syncs and lanes. Off unless a caller turns it on.

Spans are `torch.profiler.record_function` ranges: each lands, as a user
annotation, in whatever profiler session is open, stamped on the
profiler's clock beside the kernel and CUDA runtime events, and the span
that caused it is the one that encloses it on the thread. Every name
starts with "rt.":

    rt.pass       one pass (render_accumulated's chunk, render's beauty)
    rt.sample     camera rays and the bounce loop of one sample
    rt.bounce     one bounce of every lane
    rt.traverse.closest, rt.traverse.shadow   the integrator's walks
    rt.nee        light sampling, shadow rays and their BSDF evaluation
    rt.shade.eval, rt.shade.sample            the BSDF dispatch
    rt.coat.eval, rt.coat.sample              the coat's layered walk
    rt.accumulate a pass's host work after its samples
    rt.callback   the caller's on_chunk
    rt.aov        the first-hit AOV pass of `render`
    rt.aov.chunk  one pixel chunk of it (render_aov_chunk)
    rt.aov.to_host  its copies to the host and the Morton reorder

Counters are kept here until `snapshot()`; a device value is kept as its
0-d tensor and summed only there, so counting adds no sync to a pass:

    sync.<site>   host-blocking reads (a device value read on the host, a
                  `nonzero`, a copy between host and card) at each site
    lanes.alive   lanes alive at the top of each bounce
    lanes.run     lanes each bounce ran over
    coat.kernel_lanes   lanes the coat's kernel took (ops/layered.py)
    shade.kernel_lanes  lanes the shading kernel took (ops/bsdf_dispatch.py)
    aov.lanes     lanes the AOV pass handed the walk active
    host_ns.<span>  host nanoseconds inside a span opened with
                  `host_ns=True` (the rt.aov spans)

    from tpu_raytracing_torch import tracing
    tracing.reset(); tracing.enable()
    with torch.profiler.profile(...) as prof:
        render_accumulated(...)
    tracing.disable()
    counts = tracing.snapshot()   # {"sync.render.alive_any": 9, ...}

With tracing off, `span` returns one shared no-op context manager and
`sync` and `count` return at once: no kernel, no sync, no device memory.
"""
from __future__ import annotations

import contextlib
import time

import torch

_OFF = contextlib.nullcontext()


class _State:
    """What tracing keeps between `reset()` and `snapshot()`."""

    def __init__(self):
        self.on = False
        self.counts = {}   # name -> host int
        self.device = {}   # name -> list of 0-d device tensors
        self.open = []     # names of the spans open on the thread


_state = _State()


def enable() -> None:
    _state.on = True


def disable() -> None:
    _state.on = False


def enabled() -> bool:
    return _state.on


def reset() -> None:
    """Drop every counter."""
    _state.counts, _state.device = {}, {}


def snapshot() -> dict:
    """Every counter by name, as host ints (one read of the device's)."""
    out = dict(_state.counts)
    for name, values in _state.device.items():
        out[name] = out.get(name, 0) + int(torch.stack(values).sum())
    return out


class _Span:
    def __init__(self, name: str, args, host_ns: bool):
        self.name = name
        self.fn = torch.profiler.record_function(
            name, None if args is None else
            ", ".join(f"{k}={v}" for k, v in args.items()))
        self.host_ns = host_ns
        self.t0 = 0

    def __enter__(self):
        self.fn.__enter__()
        _state.open.append(self.name)
        if self.host_ns:
            self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        if self.host_ns:
            _add("host_ns." + self.name, time.perf_counter_ns() - self.t0)
        _state.open.pop()
        return self.fn.__exit__(*exc)


def span(name: str, args: dict | None = None, host_ns: bool = False):
    """A context manager around one unit of a layer's work, named
    "rt.<layer>[.<part>]"; `args` (a dict) is kept beside it in the
    profiler's event. With `host_ns`, the host's nanoseconds inside it
    add to the counter "host_ns.<name>", which a reader can take without
    a profiler session."""
    if not _state.on:
        return _OFF
    return _Span(name, args, host_ns)


def sync(site: str, n: int = 1) -> None:
    """Count `n` host-blocking reads at `site` ("<module>.<read>"). A read
    in a helper that several layers call names its site "*.<read>": it is
    counted under the layer of the innermost open span, as "coat.<read>"
    inside rt.coat.eval."""
    if not _state.on:
        return
    if site.startswith("*."):
        layer = _state.open[-1].split(".")[1] if _state.open else "untraced"
        site = layer + site[1:]
    _add("sync." + site, n)


def count(name: str, value):
    """Add `value` (a host int or a 0-d device tensor) to counter `name`;
    returns `value`, so a site counts what it computes in place."""
    if _state.on:
        if isinstance(value, torch.Tensor):
            _state.device.setdefault(name, []).append(value)
        else:
            _add(name, value)
    return value


def _add(name: str, n: int) -> None:
    _state.counts[name] = _state.counts.get(name, 0) + int(n)
