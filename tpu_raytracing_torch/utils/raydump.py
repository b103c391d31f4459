"""Env-gated ray-batch capture for offline traversal analysis.

Counterpart of tpu_raytracing/utils/raydump.py, with its format.
TPU_RT_DUMP_RAYS=1 makes every intersect_scene call record its ray batch
(origin, direction, t range, active mask, early_exit kind): the real
integrator's per-bounce workloads, which scripts/probe_reorg.py evaluates
offline. PyTorch runs eagerly, so `emit` copies the tensors to numpy in
call order; with the knob off it returns before any copy. A dump `save`d
here loads with either package's `load`.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

BATCHES: List[dict] = []


def enabled() -> bool:
    return os.environ.get("TPU_RT_DUMP_RAYS", "0") == "1"


def clear() -> None:
    BATCHES.clear()


def emit(early_exit: bool, o, d, t_min, t_max, act) -> None:
    """Record one traversal call's inputs (a no-op unless
    TPU_RT_DUMP_RAYS=1)."""
    if not enabled():
        return
    BATCHES.append(dict(
        kind=1 if early_exit else 0,
        o=o.cpu().numpy().copy(),
        d=d.cpu().numpy().copy(),
        t_min=t_min.cpu().numpy().copy(),
        t_max=t_max.cpu().numpy().copy(),
        act=act.cpu().numpy().copy(),
    ))


def save(path: str) -> None:
    arrs = {}
    for i, b in enumerate(BATCHES):
        for k, v in b.items():
            arrs[f"b{i}_{k}"] = v
    arrs["n"] = np.asarray(len(BATCHES))
    np.savez_compressed(path, **arrs)


def load(path: str) -> List[dict]:
    with np.load(path) as z:
        return [
            {k: z[f"b{i}_{k}"] for k in ("kind", "o", "d", "t_min", "t_max",
                                         "act")}
            for i in range(int(z["n"]))
        ]
