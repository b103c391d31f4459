"""The port's references: a digest of the JAX package's CPU renders.

The port is never its own reference. Its harness holds every run against
images the JAX package rendered on the CPU with its own harness
(`JAX_PLATFORMS=cpu python -m visual_testing.rttest cpu --bless-all
--no-perf`, which writes visual_testing/references/, ignored by git), as
the JAX harness holds its TPU runs against CPU-blessed references. The
JAX harness's `bless` (review and copy of the renderer's own outputs) is
deliberately not ported; this module takes its place:

    python -m tpu_raytracing_torch.rttest digest [--source DIR]
        [--commit HASH] [--wall NAME=SECONDS ...]

reads the JAX EXRs of every suite row whose scene asset exists, and of the
extra rows below, and writes references/digest.json: per row the CLI
arguments and the settings it was rendered at, the JAX commit, the sha256
of the source EXR, its channel group and shape, and its CPU wall seconds.
An RGB row keeps the tonemapped mean `tb_mean`, the 8x8 tonemapped block
means `tb_blocks` (float64, so diff.compare_digest gives rel_mean and
block_rel bit for bit as against the full image) and the plain mean. An
AOV row's gate is an MSE over pixels, so its EXR is committed beside the
digest as JAX wrote it (`exr`).
"""
from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .diff import block_means, load_exr_channels, tonemap
from .test_spec import TestSpec

DIGEST_NAME = "digest.json"
# references beyond the suite: chip_smoke.py's bench frame (the bunny at
# 8 spp, one light sample, depth 8), rendered with the JAX CLI
EXTRA_ROWS = {
    "coated_diffuse_bunny_8spp": [
        "--scene-name", "coated_diffuse_bunny", "-s", "8", "-l", "1", "-d",
        "8", "full"],
}


def row_args(spec: TestSpec, base_dir: Path) -> List[str]:
    """The CLI arguments a suite row renders with (the harness adds -o and
    --backend)."""
    return spec.scene_cli_args(base_dir) + spec.settings.to_cli_args()


def settings_of(args: List[str]) -> dict:
    """The settings the CLI renders `args` at (resolution, spp, light
    samples, depth, sampler, outputs)."""
    from .. import cli

    parsed = cli.build_parser().parse_args(args)
    builtin, scene = cli._load_scene(parsed)
    s = cli._apply_aov_flags(cli._merge_settings(builtin, parsed), parsed)
    sampler = type(s.sampler).__name__.lower()
    if sampler == "stratified":
        sampler += (f" {s.sampler.x_strata}x{s.sampler.y_strata}"
                    + (" jittered" if s.sampler.jitter else ""))
    return {
        "resolution": [scene.camera.raster_width, scene.camera.raster_height],
        "spp": s.samples_per_pixel,
        "light_samples": s.light_sample_count,
        "max_depth": s.max_ray_depth,
        "sampler": sampler,
        "seed": s.seed,
        "outputs": [f.name for f in type(s.outputs) if f & s.outputs],
    }


def sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def make_record(name: str, args: List[str], source: Path, jax_commit: str,
                wall_s: Optional[float]) -> dict:
    group, img = load_exr_channels(source)
    rec = {
        "name": name,
        "args": args,
        "settings": settings_of(args),
        "jax_commit": jax_commit,
        "source": source.name,
        "sha256": sha256(source),
        "group": group,
        "shape": list(img.shape),
        "cpu_wall_s": wall_s,
    }
    if group == "RGB":
        tb = tonemap(img)
        rec["tb_mean"] = float(np.mean(tb))
        rec["tb_blocks"] = block_means(tb)
        rec["mean"] = float(np.mean(img.astype(np.float64)))
    else:
        rec["exr"] = source.name
    return rec


def git_head(repo: Path) -> str:
    return subprocess.run(["git", "rev-parse", "HEAD"], cwd=repo,
                          capture_output=True, text=True,
                          check=True).stdout.strip()


def make_digest(rows: Dict[str, List[str]], source_dir: Path, out_dir: Path,
                jax_commit: str, wall: Dict[str, float]) -> dict:
    """Digest the JAX EXR `source_dir/<name>.exr` of each row into
    out_dir/digest.json, copying each AOV row's EXR beside it."""
    missing = [n for n in rows if not (source_dir / f"{n}.exr").is_file()]
    if missing:
        raise FileNotFoundError(f"no JAX reference in {source_dir} for "
                                f"{missing}")
    out_dir.mkdir(parents=True, exist_ok=True)
    records = {}
    for name, args in rows.items():
        src = source_dir / f"{name}.exr"
        rec = make_record(name, args, src, jax_commit, wall.get(name))
        if "exr" in rec:
            shutil.copyfile(src, out_dir / rec["exr"])
        records[name] = rec
        print(f"  {name:<28} {rec['group']:<7} {rec['shape']} "
              f"{rec['sha256'][:12]}", flush=True)
    (out_dir / DIGEST_NAME).write_text(json.dumps(records, indent=1) + "\n")
    return records


class References:
    """A reference directory: digest.json's records, else plain EXRs named
    after the rows (a reference rendered by hand, as the tests do)."""

    def __init__(self, path: Path):
        self.path = path
        f = path / DIGEST_NAME
        self.records = json.loads(f.read_text()) if f.is_file() else {}

    def lookup(self, name: str):
        """(record or None, EXR path or None) of a row; both None when the
        directory holds no reference for it."""
        rec = self.records.get(name)
        if rec is None:
            exr = self.path / f"{name}.exr"
            return None, (exr if exr.is_file() else None)
        if "exr" in rec:
            exr = self.path / rec["exr"]
            if sha256(exr) != rec["sha256"]:
                raise ValueError(f"{exr.name}: sha256 differs from the "
                                 f"digest's")
            return rec, exr
        return rec, None
