"""What the probes' mains share: the device choice and the timing."""
from __future__ import annotations

import argparse
import time

import torch


def parse_args(argv, doc: str, iters: int) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the kernel, the default) or cpu (the plain "
                    "version)")
    ap.add_argument("--iters", type=int, default=iters,
                    help=f"iterations of the probe's loop (default {iters})")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probe times its kernel on the "
                           "card (pass --device cpu for the plain version)")
    return args


def best_ms(fn, device: str, reps: int = 5) -> float:
    """Least milliseconds of `reps` calls after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def device_name(device: str) -> str:
    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
