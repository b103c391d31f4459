"""Seconds from the process's start to the first timed pass: CUDA
context, the port's kernel and host-library builds (cached in the
checkout after the first run), scene load and compile, warm-up."""


def read(run):
    return run.setup_s
