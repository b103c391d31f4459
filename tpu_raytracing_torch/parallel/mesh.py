"""Multi-GPU rendering over a (tiles, spp) device mesh on torch.distributed.

Counterpart of tpu_raytracing/parallel/mesh.py. JAX drives every local
device from one controller; PyTorch runs one process per device (SPMD):
every rank calls the same function with the same arguments, compiles the
scene on its own device (the tables are byte-identical, so nothing is
broadcast), renders its share and returns the whole RenderOutput.

- The group is NCCL over cuda:{local rank} on the card and gloo on the CPU
  (`init_render_group`); the mesh is `init_device_mesh(device_type,
  (n_tiles, n_spp), mesh_dim_names=("tiles", "spp"))` over its ranks.
- The raster-order pixel grid is padded to a multiple of n_tiles with
  inactive lanes, which are traced dead and not counted. A rank renders the
  contiguous tile slice of its `tiles` coordinate and the contiguous block
  of samples of its `spp` coordinate through integrator/render.py's
  `sample_sum`, in `_run_chunked` chunks of `default_chunk(device)`.
- rays: an int64 all_reduce(SUM) over the mesh. Tiles: an all-gather over
  the `tiles` axis; the slices are equal in size because the grid is padded.
- The spp axis is folded in a fixed rank order: the n_spp partial sums of a
  tile are gathered and added one by one onto the running sum,
  ((acc + b0) + b1) + ..., never by an all_reduce, whose summation order
  NCCL does not fix.

Determinism contract. RNG streams are keyed by (pixel, sample), never by
rank, and a lane's result does not depend on the other lanes of its batch,
so with that fold:
- n_spp = 1: `render_distributed` is bit-exact with `integrator.render.
  render` on one device, for any tile count;
- n_spp = k: it is bit-exact with `integrator.accumulate.render_accumulated`
  at spp_chunk = spp / k on one device;
- `render_accumulated_distributed(spp_chunk=c)` over k spp shards is
  bit-exact with `render_accumulated(spp_chunk=c / k)` where c divides spp,
  checkpoints and resumes (across tile counts too) included.
JAX's `psum` reassociates the spp sums and gets within rtol 2e-5 only
(tests/test_parallel.py).

AOVs are not distributed: render them with `integrator.render.render`.
"""
from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device.scene_buffers import DeviceScene
from ..integrator.accumulate import (
    _settings_fingerprint, read_checkpoint, write_checkpoint,
)
from ..integrator.render import (
    StaticSettings, _run_chunked, default_chunk, device_scene, sample_sum,
)
from ..ops.rng import SamplerConfig
from ..settings import AovFlags, RaytracerSettings, RenderOutput

log = logging.getLogger("tpu_raytracing_torch")

TILE_AXIS = "tiles"
SPP_AXIS = "spp"

# torch renamed all_gather_into_tensor to all_gather_single (same arguments)
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def init_render_group(device="cuda", init_method: Optional[str] = None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None) -> torch.device:
    """Start this rank's default process group and return its device:
    NCCL on cuda:{local rank} (LOCAL_RANK, else `rank`), or gloo when the
    caller asks for the CPU. Without `init_method` the ranks come from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT). A
    cuda group without a card raises."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_render_group(device='cuda'): no CUDA "
                               "device")
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    if init_method is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    return dev


def make_render_mesh(n_tiles: Optional[int] = None,
                     n_spp: int = 1) -> DeviceMesh:
    """A (tiles, spp) mesh over the ranks of the default group, which
    `init_render_group` (or the caller) has started; rank r sits at
    (r // n_spp, r % n_spp)."""
    if not dist.is_initialized():
        raise RuntimeError("make_render_mesh: no process group; start one "
                           "with init_render_group")
    world = dist.get_world_size()
    if n_tiles is None:
        n_tiles = world // n_spp
    if n_tiles * n_spp != world:
        raise ValueError(f"mesh {n_tiles}x{n_spp} != world size {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_tiles, n_spp),
                            mesh_dim_names=(TILE_AXIS, SPP_AXIS))


def _axis(mesh: DeviceMesh, name: str) -> tuple:
    """(size, this rank's coordinate, process group) of a mesh axis."""
    return (mesh.size(mesh.mesh_dim_names.index(name)),
            mesh.get_local_rank(name), mesh.get_group(name))


def _rank_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _padded_grid(width: int, height: int, n_tiles: int) -> tuple:
    """Raster-order (px, py, active), padded with inactive lanes to a
    multiple of n_tiles."""
    gx, gy = np.meshgrid(np.arange(width, dtype=np.uint32),
                         np.arange(height, dtype=np.uint32))
    px, py = gx.reshape(-1), gy.reshape(-1)
    n = px.shape[0]
    pad = (-n) % n_tiles
    active = np.arange(n + pad) < n
    zeros = np.zeros(pad, np.uint32)
    return np.concatenate([px, zeros]), np.concatenate([py, zeros]), active


def shard_sum(ds: DeviceScene, cfg: SamplerConfig, st: StaticSettings, px,
              py, active, tile: int, n_tiles: int, first: int, count: int,
              chunk_pixels: Optional[int] = None) -> tuple:
    """One rank's work: radiance summed over samples first .. first +
    count - 1 of tile `tile` of `n_tiles` equal slices of the padded grid
    (px, py, active: numpy), lanes where `active` is false traced dead.
    Returns ((slice, 3) f32 on ds.device, rays (0-d int64))."""
    size = px.shape[0] // n_tiles
    sl = slice(tile * size, (tile + 1) * size)
    parts = []
    rays = torch.zeros((), dtype=torch.int64, device=ds.device)
    for n, (r, k) in _run_chunked(
            lambda a, b, act: sample_sum(ds, cfg, st, a, b, first, count,
                                         act),
            px[sl], py[sl], ds.device,
            chunk_pixels or default_chunk(ds.device), active[sl]):
        parts.append(r[:n])
        rays = rays + k
    return torch.cat(parts), rays


def _fold_spp(part: torch.Tensor, acc: torch.Tensor, group,
              n_spp: int) -> torch.Tensor:
    """acc plus the tile's n_spp partial sums, added one by one in spp rank
    order: ((acc + b0) + b1) + ..."""
    blocks = torch.empty((n_spp * part.shape[0], *part.shape[1:]),
                         dtype=part.dtype, device=part.device)
    _all_gather(blocks, part.contiguous(), group=group)
    for b in blocks.view(n_spp, *part.shape):
        acc = acc + b
    return acc


def _gather_tiles(x: torch.Tensor, group, n_tiles: int) -> np.ndarray:
    out = torch.empty((n_tiles * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _all_gather(out, x.contiguous(), group=group)
    return out.cpu().numpy()


def _total_rays(rays: torch.Tensor) -> int:
    """The int64 sum of every rank's rays (the mesh is the whole group)."""
    total = rays.reshape(1).clone()
    dist.all_reduce(total)
    return int(total)


def make_sharded_step(ds: DeviceScene, cfg: SamplerConfig,
                      st: StaticSettings, mesh: DeviceMesh,
                      chunk_pixels: Optional[int] = None):
    """The sharded render step: (px, py, active) of the padded grid (numpy,
    the same on every rank) -> (radiance of every lane (N, 3) numpy f32,
    rays int), on every rank.

    Each spp rank sums its contiguous block of sample indices. With one spp
    shard the sum is divided on the device as render_beauty_chunk divides
    it (so render_distributed is bit-exact with render); with k the folded
    sum is divided on the host as render_accumulated divides its
    accumulator (bit-exact with render_accumulated at spp / k)."""
    n_tiles, tile, tile_group = _axis(mesh, TILE_AXIS)
    n_spp, spp_rank, spp_group = _axis(mesh, SPP_AXIS)
    spp = st.samples_per_pixel
    if spp % n_spp != 0:
        raise ValueError(f"samples_per_pixel={spp} not divisible by spp "
                         f"mesh axis {n_spp}")
    per = spp // n_spp

    def step(px, py, active):
        part, rays = shard_sum(ds, cfg, st, px, py, active, tile, n_tiles,
                               spp_rank * per, per, chunk_pixels)
        rays = _total_rays(rays)
        if n_spp == 1:
            return _gather_tiles(part / spp, tile_group, n_tiles), rays
        total = _fold_spp(part, torch.zeros_like(part), spp_group, n_spp)
        return _gather_tiles(total, tile_group, n_tiles) / np.float32(spp), \
            rays

    return step


def render_distributed(scene_or_device, settings: RaytracerSettings,
                       mesh: Optional[DeviceMesh] = None,
                       n_spp_shards: int = 1,
                       chunk_pixels: Optional[int] = None) -> RenderOutput:
    """Full-frame beauty render sharded over a device mesh; every rank
    calls it and gets the whole frame. Without `mesh`, a (world / n_spp,
    n_spp) mesh over the default group."""
    if mesh is None:
        mesh = make_render_mesh(n_spp=n_spp_shards)
    ds = device_scene(scene_or_device, _rank_device(mesh),
                      "render_distributed")
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    st = StaticSettings.from_settings(settings)
    step = make_sharded_step(ds, cfg, st, mesh, chunk_pixels)
    width, height = ds.meta.width, ds.meta.height
    px, py, active = _padded_grid(width, height, _axis(mesh, TILE_AXIS)[0])
    radiance, rays = step(px, py, active)
    out = RenderOutput(width=width, height=height)
    if settings.outputs & AovFlags.BEAUTY:
        out.beauty = radiance[:width * height].reshape(height, width, 3)
    out.rays_traced = rays
    return out


def make_sharded_accum_step(ds: DeviceScene, cfg: SamplerConfig,
                            st: StaticSettings, mesh: DeviceMesh,
                            n_samples: int,
                            chunk_pixels: Optional[int] = None):
    """The sharded accumulation step: (s0, px, py, active, acc) -> (acc
    with samples [s0, s0 + n_samples) of every lane folded on, rays), on
    every rank; acc is the (N, 3) f32 numpy running sum of the padded grid.
    The mesh-parallel analogue of render_accumulated's chunk, with the spp
    blocks folded onto the running sum in rank order."""
    n_tiles, tile, tile_group = _axis(mesh, TILE_AXIS)
    n_spp, spp_rank, spp_group = _axis(mesh, SPP_AXIS)
    if n_samples % n_spp != 0:
        raise ValueError(f"chunk samples {n_samples} not divisible by spp "
                         f"axis {n_spp}")
    per = n_samples // n_spp

    def step(s0, px, py, active, acc):
        part, rays = shard_sum(ds, cfg, st, px, py, active, tile, n_tiles,
                               s0 + spp_rank * per, per, chunk_pixels)
        size = part.shape[0]
        mine = torch.tensor(acc[tile * size:(tile + 1) * size],
                            device=ds.device)
        folded = _fold_spp(part, mine, spp_group, n_spp)
        return _gather_tiles(folded, tile_group, n_tiles), _total_rays(rays)

    return step


def render_accumulated_distributed(
    scene_or_device,
    settings: RaytracerSettings,
    mesh: Optional[DeviceMesh] = None,
    n_spp_shards: int = 1,
    spp_chunk: int = 32,
    checkpoint_path=None,
    on_chunk=None,
    chunk_pixels: Optional[int] = None,
) -> RenderOutput:
    """A beauty render accumulated in checkpointable spp chunks, each chunk
    sharded over a (tiles, spp) mesh; every rank calls it.

    Sample indices are absolute, so the sample set is a one-shot render's.
    Only rank 0 reads and writes the checkpoint (JAX's fingerprint and
    layout, the raster-order accumulator); it broadcasts the samples done,
    the rays and the accumulator to every rank before the first chunk, so
    that the ranks agree on the chunks left. on_chunk(image (H, W, 3),
    spp_done) runs on every rank after each chunk."""
    if mesh is None:
        mesh = make_render_mesh(n_spp=n_spp_shards)
    device = _rank_device(mesh)
    ds = device_scene(scene_or_device, device,
                      "render_accumulated_distributed")
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    st = StaticSettings.from_settings(settings)
    width, height = ds.meta.width, ds.meta.height
    n = width * height
    total_spp = settings.samples_per_pixel
    spp_chunk = min(spp_chunk, total_spp)
    fingerprint = _settings_fingerprint(settings, ds, "raster-dist1")
    if checkpoint_path is not None:
        checkpoint_path = Path(checkpoint_path)

    first = dist.get_rank() == 0
    spp_done, rays_total, accum = (
        read_checkpoint(checkpoint_path, fingerprint, spp_chunk, n) if first
        else (0, 0, np.zeros((n, 3), np.float32)))
    state = torch.tensor([spp_done, rays_total], dtype=torch.int64,
                         device=device)
    acc = torch.tensor(accum, dtype=torch.float32, device=device)
    dist.broadcast(state, src=0)
    dist.broadcast(acc, src=0)
    spp_done, rays_total = (int(v) for v in state.cpu())

    n_tiles = _axis(mesh, TILE_AXIS)[0]
    px, py, active = _padded_grid(width, height, n_tiles)
    padded = np.zeros((px.shape[0], 3), np.float32)
    padded[:n] = acc.cpu().numpy()
    steps = {}
    while spp_done < total_spp:
        t0 = time.perf_counter()
        this_chunk = min(spp_chunk, total_spp - spp_done)
        if this_chunk not in steps:
            steps[this_chunk] = make_sharded_accum_step(
                ds, cfg, st, mesh, this_chunk, chunk_pixels)
        padded, rays = steps[this_chunk](spp_done, px, py, active, padded)
        rays_total += rays
        spp_done += this_chunk
        accum = padded[:n]
        log.info("accumulated %d/%d spp over %dx%d mesh (%.2fs)", spp_done,
                 total_spp, n_tiles, _axis(mesh, SPP_AXIS)[0],
                 time.perf_counter() - t0)
        if first and checkpoint_path is not None:
            write_checkpoint(checkpoint_path, accum, spp_done, rays_total,
                             fingerprint, spp_chunk)
        if on_chunk is not None:
            on_chunk((accum / np.float32(spp_done)).reshape(height, width, 3),
                     spp_done)

    out = RenderOutput(width=width, height=height)
    if settings.outputs & AovFlags.BEAUTY:
        out.beauty = (padded[:n] / np.float32(total_spp)).reshape(
            height, width, 3)
    out.rays_traced = rays_total
    return out


def dryrun_step(mesh: DeviceMesh, n_pixels: int = 256,
                spp: int = 8) -> np.ndarray:
    """Build checkered_plane on this rank's device and run one sharded
    render step over the mesh on random pixels (tiny shapes); returns the
    radiance of every lane."""
    from ..scene.test_scenes import get_test_scene

    ts = get_test_scene("checkered_plane")
    settings = ts.settings_func()
    settings.samples_per_pixel = spp
    settings.light_sample_count = 1
    settings.max_ray_depth = 2
    ds = device_scene(ts.scene_func(), _rank_device(mesh), "dryrun_step")
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    step = make_sharded_step(ds, cfg, StaticSettings.from_settings(settings),
                             mesh)
    n_tiles = _axis(mesh, TILE_AXIS)[0]
    n_pixels = max(n_pixels, n_tiles)
    n_pixels += (-n_pixels) % n_tiles
    rng = np.random.default_rng(0)
    px = rng.integers(0, ds.meta.width, n_pixels, dtype=np.uint32)
    py = rng.integers(0, ds.meta.height, n_pixels, dtype=np.uint32)
    return step(px, py, np.ones(n_pixels, bool))[0]
