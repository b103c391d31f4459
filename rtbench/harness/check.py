"""What every traffic kind's comparison shares: the check's pixels drawn
from the seed, a traversal call held against the reference's brute
force, and the verdict. The numbers compared, and how, are the traffic
kind's (kinds/traffic/<kind>.py: NUMBERS, compare); their limits are the
cell's (cells/<cell>.json)."""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from reference.render import intersect

T_RTOL = 1e-4


def pick_pixels(seed: int, width: int, height: int, k: int) -> np.ndarray:
    """k distinct raster indices drawn from the seed."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x5EED])
    return np.sort(rng.choice(width * height, size=k, replace=False))


def traversal_mismatch(sc, rec: dict) -> tuple:
    """(mismatching lanes, active lanes) of one captured traversal call:
    another kind of hit, t off by more than T_RTOL of it, or another
    occlusion than the reference's on the same rays."""
    act = rec["active"]
    if rec["kind"] == "occluded":
        _, prim = intersect(sc, rec["origin"], rec["direction"], rec["t_min"],
                            rec["t_max"], act, any_hit=True)
        bad = act & ((prim >= 0) != rec["occluded"])
    else:
        t, prim = intersect(sc, rec["origin"], rec["direction"],
                            rec["t_min"], rec["t_max"], act)
        pt, pp = rec["t"], rec["prim"].to(torch.int64)
        kind_r = torch.where(prim < 0, 0, torch.where(prim < sc.n_tris, 1, 2))
        kind_p = torch.where(pp < 0, 0, torch.where(pp < sc.n_tris, 1, 2))
        t_off = (pt - t).abs() > T_RTOL * t.abs()
        bad = act & ((kind_r != kind_p) | ((kind_r > 0) & t_off))
    return int(bad.sum()), int(act.sum())


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            names: Iterable[str]) -> bool:
    return all(numbers[k] <= limits[k] for k in names)
