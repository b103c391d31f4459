"""Share of the traced window with no kernel on the card: one minus the
union of the profiler's kernel intervals over the window's wall."""
from harness.trace import busy_ns


def read(run):
    tr = run.trace
    if tr is None:
        return None
    window = tr.window_ns[1] - tr.window_ns[0]
    return 100.0 * (1.0 - busy_ns(tr) / window)
