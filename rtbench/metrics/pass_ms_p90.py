"""The 90th percentile of all pass times of the window, in ms: how long
a viewer waits for its next refined image. p90 is the highest percentile
with ten passes or more beyond it at the window's pass count."""
from harness.window import percentile_ms


def read(run):
    if run.trace is not None or len(run.window.passes) < 2:
        return None
    return percentile_ms(run.window, 90)
