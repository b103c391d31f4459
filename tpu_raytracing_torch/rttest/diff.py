"""EXR image comparison: the port's copy of visual_testing/rttest/diff.py.

Loads the channel group present in both images (preference order RGB,
Normal.XYZ, Albedo.XYZ, UV) with the port's own EXR reader, and computes
the cross-backend statistics of the JAX harness with its thresholds:
MSE and max absolute difference, the Reinhard-tonemapped relative mean
(`rel_mean`) and the worst 8x8 tonemapped block-mean deviation
(`block_rel`). The statistical gate reads `rel_mean` and `block_rel` on
the RGB group and the MSE on AOV groups.

A reference may also be a digest record (digest.py): the reference's
tonemapped mean and its 8x8 tonemapped block means, kept as float64.
`compare_digest` computes `rel_mean` and `block_rel` from it exactly as
`compare_arrays` does from the full image, bit for bit; `mse` and
`max_diff` are then None, since the gate does not read them for RGB.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..utils.exr import read_exr

CHANNEL_GROUPS = [
    ("RGB", ["R", "G", "B"]),
    ("Normal", ["Normal.X", "Normal.Y", "Normal.Z"]),
    ("Albedo", ["Albedo.X", "Albedo.Y", "Albedo.Z"]),
    ("UV", ["U", "V"]),
]
BLOCK_GRID = 8


def load_exr_channels(path: Path) -> Tuple[str, np.ndarray]:
    """(group name, (H, W, C) array) for the first available channel group."""
    channels, width, height = read_exr(path)
    for group_name, names in CHANNEL_GROUPS:
        if all(n in channels for n in names):
            stacked = np.stack([channels[n] for n in names], axis=-1)
            return group_name, stacked
    raise ValueError(
        f"{path}: no known channel group (have {sorted(channels)})"
    )


@dataclass
class DiffResult:
    mse: Optional[float]  # None against a digest
    max_diff: Optional[float]
    channel_group: str
    rel_mean: float = 0.0  # |mean(t(out)) - mean(t(ref))| / mean(t(ref)),
    # t = Reinhard x/(1+x) on clamped-nonnegative values (bounded stat)
    block_rel: float = 0.0  # max over an 8x8 block grid of
    # |mean(t(out)_blk) - mean(t(ref)_blk)| / mean(t(ref)): catches
    # spatially-wrong but energy-preserving regressions (shifted/flipped
    # geometry, region channel swaps) that a global mean cannot see

    # The JAX harness's cross-backend statistical gate, thresholds as they
    # are there: per-pixel beauty differences are chaotic Monte-Carlo path
    # divergence seeded by FMA-contraction ULPs (unbiased, so the image
    # mean must still agree tightly), while first-hit AOV groups are
    # deterministic up to silhouette hit/miss flips (sphere normals MSE
    # 1.7e-3 measured across backends), so they get a small MSE bound.
    STAT_AOV_MSE = 5.0e-3
    STAT_REL_MEAN = 0.005
    STAT_BLOCK_REL = 0.002
    # a per-scene rel-mean override without a block override keeps the
    # factor-based block bound
    BLOCK_TOL_FACTOR = 3.0

    def stat_passes(
        self,
        rel_mean_tol: float | None = None,
        block_rel_tol: float | None = None,
    ) -> bool:
        if self.channel_group == "RGB":
            tol = (
                rel_mean_tol if rel_mean_tol is not None
                else self.STAT_REL_MEAN
            )
            if block_rel_tol is not None:
                btol = block_rel_tol
            elif rel_mean_tol is not None:
                btol = self.BLOCK_TOL_FACTOR * rel_mean_tol
            else:
                btol = self.STAT_BLOCK_REL
            return self.rel_mean <= tol and self.block_rel <= btol
        return self.mse is not None and self.mse <= self.STAT_AOV_MSE


def tonemap(x: np.ndarray) -> np.ndarray:
    """Reinhard x / (1 + x) on clamped-nonnegative float64 values: the
    statistic has finite variance although cross-backend HDR means are
    dominated by rare near-singular paths whose backend assignment is
    ULP-chaotic."""
    a = np.maximum(x.astype(np.float64), 0.0)
    return a / (1.0 + a)


def _blocks(t: np.ndarray, grid: int = BLOCK_GRID):
    """The grid x grid tiling of `t` by np.array_split, row-major."""
    for rows in np.array_split(t, grid, axis=0):
        yield from np.array_split(rows, grid, axis=1)


def block_means(t: np.ndarray) -> list:
    """The mean of each block of `t`'s tiling, None for an empty block."""
    return [float(np.mean(b)) if b.size else None for b in _blocks(t)]


def _block_rel(ta: np.ndarray, tb: np.ndarray, tb_mean: float) -> float:
    """Max tonemapped block-mean deviation over the tiling, normalized by
    the global reference mean (so dark blocks don't blow up the
    statistic)."""
    return _block_rel_means(ta, [np.mean(b) if b.size else None
                                 for b in _blocks(tb)], tb_mean)


def _block_rel_means(ta: np.ndarray, tb_blocks: list, tb_mean: float) -> float:
    denom = max(tb_mean, 1e-9)
    worst = 0.0
    for blk_a, mean_b in zip(_blocks(ta), tb_blocks):
        if blk_a.size == 0:
            continue
        worst = max(worst, abs(float(np.mean(blk_a) - mean_b)) / denom)
    return worst


def _rel_mean(ta: np.ndarray, tb_mean: float) -> float:
    return float(abs(np.mean(ta) - tb_mean) / max(tb_mean, 1e-9))


def _check_match(out_group, out_shape, ref_group, ref_shape) -> None:
    if out_group != ref_group:
        raise ValueError(
            f"channel group mismatch: output has {out_group}, "
            f"reference has {ref_group}"
        )
    if tuple(out_shape) != tuple(ref_shape):
        raise ValueError(f"shape mismatch: {tuple(out_shape)} vs "
                         f"{tuple(ref_shape)}")


def compare_arrays(group: str, out: np.ndarray, ref: np.ndarray) -> DiffResult:
    """The statistics of an output image against a full reference image of
    the same channel group."""
    _check_match(group, out.shape, group, ref.shape)
    d = out.astype(np.float64) - ref.astype(np.float64)
    ta, tb = tonemap(out), tonemap(ref)
    tb_mean = float(np.mean(tb))
    return DiffResult(
        mse=float(np.mean(d * d)),
        max_diff=float(np.max(np.abs(d))) if d.size else 0.0,
        channel_group=group,
        rel_mean=_rel_mean(ta, tb_mean),
        block_rel=_block_rel(ta, tb, tb_mean),
    )


def compare_digest(group: str, out: np.ndarray, record: dict) -> DiffResult:
    """The statistics of an output image against a digest record: the same
    rel_mean and block_rel as against the full reference; no MSE."""
    _check_match(group, out.shape, record["group"], record["shape"])
    ta = tonemap(out)
    tb_mean = record["tb_mean"]
    return DiffResult(
        mse=None, max_diff=None, channel_group=group,
        rel_mean=_rel_mean(ta, tb_mean),
        block_rel=_block_rel_means(ta, record["tb_blocks"], tb_mean),
    )


def compare_images(output_path: Path, reference_path: Path) -> DiffResult:
    out_group, out = load_exr_channels(output_path)
    ref_group, ref = load_exr_channels(reference_path)
    _check_match(out_group, out.shape, ref_group, ref.shape)
    return compare_arrays(out_group, out, ref)
