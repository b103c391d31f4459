"""Device time of the triangle walk's kernels a pass, in ms: the traced
slice's kernels whose name holds one of KERNELS, over its passes."""

KERNELS = ("bvh8t_walk",)


def walk_ns(trace) -> int:
    return sum(e - s for name, s, e in trace.kernels
               if any(k in name for k in KERNELS))


def read(run):
    tr = run.trace
    if tr is None or not run.traced_passes:
        return None
    ns = walk_ns(tr)
    if not ns:
        return None
    return ns / 1e6 / run.traced_passes
