"""Checkpointed accumulation of the beauty pass in spp chunks.

Counterpart of tpu_raytracing/integrator/accumulate.py. The sample loop
runs in chunks of `spp_chunk` samples (the last one takes the remainder);
after each chunk the Morton-ordered sum can be written to an npz
checkpoint, from which an interrupted render resumes. Sample indices are
absolute, so the samples are those of a one-shot render; only the f32
summation order differs (one partial sum a chunk). A checkpoint whose
settings fingerprint or chunk size differs is ignored and the render
starts afresh. Where JAX runs a chunk as one `fori_loop`, the port loops
over the samples on the device (integrator/render.py::sample_sum).
"""
from __future__ import annotations

import hashlib
import json
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..device.scene_buffers import DeviceScene
from ..ops.rng import SamplerConfig
from .. import tracing
from ..settings import RaytracerSettings, RenderOutput
from .render import (
    StaticSettings, _pixel_grid, _run_chunked, default_chunk, device_scene,
    sample_sum,
)

log = logging.getLogger("tpu_raytracing_torch")


def _settings_fingerprint(settings: RaytracerSettings, ds: DeviceScene,
                          layout: str = "morton1") -> str:
    """The JAX package's fingerprint of what a checkpoint's sums depend on;
    `layout` names the accumulator's pixel order ("raster-dist1" for the
    distributed driver's)."""
    blob = json.dumps(
        {
            "spp": settings.samples_per_pixel,
            "depth": settings.max_ray_depth,
            "lights": settings.light_sample_count,
            "seed": settings.seed,
            "sampler": repr(settings.sampler),
            "accumulate": settings.accumulate_bounces,
            "wh": [ds.meta.width, ds.meta.height],
            "tris": ds.meta.n_tris,
            "layout": layout,
        },
        sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def read_checkpoint(path: Optional[Path], fingerprint: str, spp_chunk: int,
                    n: int) -> tuple:
    """(spp done, rays, accumulator (n, 3) f32) from the checkpoint at
    `path` where its fingerprint and chunk size match, else a fresh
    start."""
    fresh = 0, 0, np.zeros((n, 3), np.float32)
    if path is None or not path.exists():
        return fresh
    with np.load(path, allow_pickle=False) as ck:
        if (str(ck["fingerprint"]) == fingerprint
                and int(ck["spp_chunk"]) == spp_chunk):
            log.info("resuming from checkpoint: %d spp done",
                     int(ck["spp_done"]))
            return int(ck["spp_done"]), int(ck["rays"]), ck["accum"]
    log.warning("checkpoint does not match settings; starting fresh")
    return fresh


def write_checkpoint(path: Path, accum, spp_done: int, rays: int,
                     fingerprint: str, spp_chunk: int) -> None:
    """Write the checkpoint beside `path`, then move it over `path`, so an
    interrupted write leaves the previous one."""
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, accum=accum, spp_done=spp_done, rays=rays,
             fingerprint=fingerprint, spp_chunk=spp_chunk)
    tmp.replace(path)


def render_accumulated(
    scene_or_device,
    settings: RaytracerSettings,
    spp_chunk: int = 32,
    checkpoint_path: Optional[Path] = None,
    chunk_pixels: Optional[int] = None,
    on_chunk=None,
    device="cuda",
) -> RenderOutput:
    """Beauty render accumulated in spp chunks, with optional resume, on
    `device` (the card unless the caller asks for "cpu").

    on_chunk(image (H, W, 3), spp_done) is called after every chunk with
    the current partial average."""
    device = torch.device(device)
    ds = device_scene(scene_or_device, device, "render_accumulated")
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    st = StaticSettings.from_settings(settings)
    width, height = ds.meta.width, ds.meta.height
    total_spp = settings.samples_per_pixel
    spp_chunk = min(spp_chunk, total_spp)
    fingerprint = _settings_fingerprint(settings, ds)

    if checkpoint_path is not None:
        checkpoint_path = Path(checkpoint_path)
    spp_done, rays_total, accum = read_checkpoint(
        checkpoint_path, fingerprint, spp_chunk, height * width)

    px, py, unmorton = _pixel_grid(width, height)
    chunk = chunk_pixels or default_chunk(device)
    while spp_done < total_spp:
        this_chunk = min(spp_chunk, total_spp - spp_done)
        with tracing.span("rt.pass", {"first": spp_done, "count": this_chunk}):
            t0 = time.perf_counter()
            parts, rays = [], 0
            for size, (r, n) in _run_chunked(
                    lambda a, b, act: sample_sum(ds, cfg, st, a, b, spp_done,
                                                 this_chunk, act),
                    px, py, device, chunk):
                parts.append(r[:size])
                rays = rays + n
            with tracing.span("rt.accumulate"):
                tracing.sync("accumulate.to_host")
                accum = accum + torch.cat(parts).cpu().numpy()
                tracing.sync("accumulate.rays")
                rays_total += int(rays)
                spp_done += this_chunk
                log.info("accumulated %d/%d spp (%.2fs)", spp_done, total_spp,
                         time.perf_counter() - t0)
                if checkpoint_path is not None:
                    write_checkpoint(checkpoint_path, accum, spp_done,
                                     rays_total, fingerprint, spp_chunk)
                if on_chunk is not None:
                    image = (accum[unmorton] / np.float32(spp_done)).reshape(
                        height, width, 3)
            if on_chunk is not None:
                with tracing.span("rt.callback"):
                    on_chunk(image, spp_done)

    out = RenderOutput(width=width, height=height)
    out.beauty = (accum[unmorton] / np.float32(total_spp)).reshape(
        height, width, 3)
    out.rays_traced = rays_total
    return out
