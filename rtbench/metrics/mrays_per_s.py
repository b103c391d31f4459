"""Rays traced (the program's `rays_traced`) over all passes of the
window, per second from the window's start to the end of its last pass,
in millions: the throughput of a render."""
from harness.window import rate


def read(run):
    if run.trace is not None or not run.window.passes:
        return None
    return rate(run.window)
