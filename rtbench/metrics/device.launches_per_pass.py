"""Kernel launches a pass: the profiler's kernel events in the traced
slice (copies and fills left out) over its passes."""

NOT_KERNELS = ("Memcpy", "Memset")


def read(run):
    tr = run.trace
    if tr is None or not run.traced_passes:
        return None
    n = sum(1 for name, _, _ in tr.kernels if not name.startswith(NOT_KERNELS))
    return n / run.traced_passes
