"""The path-tracing integrator: batched bounce loop + render driver.

Counterpart of tpu_raytracing/integrator/render.py on its plain path (what
JAX runs on the CPU): the primary bounce is peeled, then every later bounce
runs until no lane is alive, with no bounce sort, alive-prefix ladder,
join permutation or NEE stacking (those TPU schedules give the plain
path's output, tests/test_trace_modes.py). Semantics:

- primary rays respect near/far clip, secondary rays use t_min = 1e-4;
- directly hit emitters contribute only after specular bounces;
- NEE over every light, shadow rays from the light toward the point, and
  zero-contribution samples (pdf <= 0 or back-facing) skip the walk;
- BSDF importance sampling continues the path.

`rays_traced` counts as JAX does: lanes alive at the top of each bounce
plus the shadow rays actually walked.

Rays that miss add the environment's radiance where the scene has one.

First-hit AOVs (normals, albedo, uv, mip level) come from one pass of
unjittered camera rays before the beauty pass, as in JAX.

`render_single_pixel` replays one pixel's sample streams (the CLI's `pixel`
command); the NaN scan at the end of `render` names it for a repro.
"""
from __future__ import annotations

import functools
import logging
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device.scene_buffers import (
    DeviceScene, LIGHT_DIRECTION, LIGHT_POINT, MAT_COATED_DIFFUSE, MAT_DIFFUSE,
    compile_scene,
)
from ..ops import bsdf as B
from ..ops.bsdf_dispatch import bsdf_eval, bsdf_sample
from ..ops.camera_rays import generate_rays
from ..ops.light_sampling import (
    environment_radiance, light_emitted_radiance, sample_light,
)
from ..ops.linalg import dot, make_orthonormal_basis
from ..ops.rng import SamplerConfig, make_stream
from ..ops.textures import (
    EvalCtx, eval_ctx_from_differentials, eval_texture, texture_mip_level,
)
from ..ops.traverse import hit_details, intersect_scene, occluded
from ..settings import (
    AovFlags, RaytracerSettings, RenderOutput, SinglePixelOutput,
)
from .. import tracing

log = logging.getLogger("tpu_raytracing_torch")

# f32 everywhere: no TF32 in any matmul or convolution the port reaches
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GPU_CHUNK = 1 << 18  # pixels per dispatch on the card (the whole bench frame)
CPU_CHUNK = 1 << 13


def default_chunk(device) -> int:
    return GPU_CHUNK if torch.device(device).type == "cuda" else CPU_CHUNK


class StaticSettings(NamedTuple):
    """The subset of RaytracerSettings the bounce loop reads."""

    max_ray_depth: int
    accumulate_bounces: bool
    light_sample_count: int
    samples_per_pixel: int
    antialias_primary_rays: bool

    @staticmethod
    def from_settings(s: RaytracerSettings) -> "StaticSettings":
        return StaticSettings(
            max_ray_depth=int(s.max_ray_depth),
            accumulate_bounces=bool(s.accumulate_bounces),
            light_sample_count=int(s.light_sample_count),
            samples_per_pixel=int(s.samples_per_pixel),
            antialias_primary_rays=bool(s.antialias_primary_rays),
        )


def _to_local(x, y, n, v):
    return torch.stack([dot(v, x), dot(v, y), dot(v, n)], dim=-1)


def _to_world(x, y, n, v):
    return v[..., 0:1] * x + v[..., 1:2] * y + v[..., 2:3] * n


class _PathState(NamedTuple):
    ray_o: torch.Tensor
    ray_d: torch.Tensor
    alive: torch.Tensor
    specular: torch.Tensor
    radiance: torch.Tensor
    path_weight: torch.Tensor
    stream: object
    rays: torch.Tensor  # () int64 on the device


def _bounce(ds: DeviceScene, cfg: SamplerConfig, st: StaticSettings,
            s: _PathState, depth: int, primary: bool, diff) -> _PathState:
    """One bounce of every lane (the JAX body with static_primary)."""
    alive, ray_o, ray_d = s.alive, s.ray_o, s.ray_d
    radiance, pw, specular, stream = (s.radiance, s.path_weight, s.specular,
                                      s.stream)
    Bb = ray_o.shape[0]
    dev = ray_o.device
    f32 = ray_o.dtype
    kinds = ds.meta.mat_kinds_present

    tracing.count("lanes.run", Bb)
    rays = s.rays + tracing.count("lanes.alive", alive.sum())
    if primary:
        t_min, t_max = ds.meta.near_clip, ds.meta.far_clip
    else:
        t_min, t_max = 1.0e-4, float("inf")
    with tracing.span("rt.traverse.closest"):
        t, prim = intersect_scene(
            ds, ray_o, ray_d,
            torch.full((Bb,), t_min, dtype=f32, device=dev),
            torch.full((Bb,), t_max, dtype=f32, device=dev),
            active=alive,
        )
    hit_mask = prim >= 0
    if ds.meta.has_env:
        miss = alive & ~hit_mask
        radiance = radiance + torch.where(
            miss[:, None], pw * environment_radiance(ds, ray_d), 0.0)
    alive = alive & hit_mask
    hit = hit_details(ds, ray_o, ray_d, t, prim)

    add_zero_bounce = st.accumulate_bounces or st.max_ray_depth == depth
    emit_mask = alive & specular & add_zero_bounce & (hit.light >= 0)
    radiance = radiance + torch.where(
        emit_mask[:, None], pw * light_emitted_radiance(ds, hit.light), 0.0)

    # material evaluation context (antialiased on primary hits)
    plain_ctx = EvalCtx.without_antialiasing(hit.uv)
    has_derivs = st.antialias_primary_rays and primary
    if has_derivs:
        aa_ctx = eval_ctx_from_differentials(hit, ray_o, ray_d, diff)

        def sel(a, b):
            return torch.where(alive, a, b)

        ctx = EvalCtx(
            uv=hit.uv,
            dudx=sel(aa_ctx.dudx, plain_ctx.dudx),
            dudy=sel(aa_ctx.dudy, plain_ctx.dudy),
            dvdx=sel(aa_ctx.dvdx, plain_ctx.dvdx),
            dvdy=sel(aa_ctx.dvdy, plain_ctx.dvdy),
        )
    else:
        ctx = plain_ctx

    params = B.get_bsdf_params(ds, hit.material, ctx, has_derivs=has_derivs)
    bx, by = make_orthonormal_basis(hit.normal)
    wo = _to_local(bx, by, hit.normal, -ray_d)

    depth = depth + 1
    alive = alive & (depth <= st.max_ray_depth)

    add_direct = st.accumulate_bounces or depth == st.max_ray_depth
    nee_mask = alive & ~B.is_delta_bsdf(params) & add_direct

    direct = torch.zeros((Bb, 3), dtype=f32, device=dev)
    with tracing.span("rt.nee"):
        for li, lk in enumerate(ds.meta.light_kinds):
            n_s = (1 if lk in (LIGHT_POINT, LIGHT_DIRECTION)
                   else st.light_sample_count)
            contrib = torch.zeros((Bb, 3), dtype=f32, device=dev)
            for _ in range(n_s):
                ls, stream = sample_light(ds, li, hit.point, cfg, stream)
                wi = _to_local(bx, by, hit.normal, -ls.direction)
                cos_theta = torch.clamp(wi[..., 2], min=0.0)
                shadow_act = nee_mask & (ls.pdf > 0.0) & (cos_theta > 0.0)
                rays = rays + shadow_act.sum()
                with tracing.span("rt.traverse.shadow"):
                    occ = occluded(
                        ds, ls.origin, ls.direction,
                        torch.full((Bb,), 1.0e-3, dtype=f32, device=dev),
                        ls.distance - 1.0e-3,
                        active=shadow_act,
                    )
                good = shadow_act & ~occ
                with tracing.span("rt.shade.eval"):
                    f = bsdf_eval(params, wo, wi, kinds, active=good)
                safe_pdf = torch.where(ls.pdf == 0.0, 1.0, ls.pdf)
                c = f * ls.radiance * (cos_theta / safe_pdf)[:, None]
                contrib = contrib + torch.where(good[:, None], c, 0.0)
            direct = direct + contrib / n_s
    radiance = radiance + pw * direct

    # continuation via BSDF importance sampling
    with tracing.span("rt.shade.sample"):
        samp, stream = bsdf_sample(
            params, wo, B.ALL_COMPONENTS, cfg, stream, kinds, active=alive)
    ok = samp.valid & (samp.pdf > 0.0) & torch.any(samp.f != 0.0, dim=-1)
    alive = alive & ok
    alive3 = alive[:, None]
    cos_theta = torch.abs(samp.wi[..., 2])
    safe_pdf = torch.where(samp.pdf == 0.0, 1.0, samp.pdf)
    pw = torch.where(alive3, pw * samp.f * (cos_theta / safe_pdf)[:, None], pw)
    specular = torch.where(alive, (samp.component & B.SPECULAR) != 0, specular)
    new_d = _to_world(bx, by, hit.normal, samp.wi)
    return _PathState(
        ray_o=torch.where(alive3, hit.point, ray_o),
        ray_d=torch.where(alive3, new_d, ray_d),
        alive=alive,
        specular=specular,
        radiance=radiance,
        path_weight=pw,
        stream=stream,
        rays=rays,
    )


def trace_radiance(ds: DeviceScene, cfg: SamplerConfig, st: StaticSettings,
                   px, py, sample_idx: int, active=None):
    """Radiance of one sample of each pixel; returns ((B, 3), rays (0-d))."""
    with tracing.span("rt.sample"):
        stream = make_stream(px, py, sample_idx)
        ray_o, ray_d, diff, stream = generate_rays(
            ds, px, py, cfg, stream, st.samples_per_pixel, jitter=True)
        Bb = px.shape[0]
        dev = ray_o.device
        alive0 = (torch.ones(Bb, dtype=torch.bool, device=dev)
                  if active is None else active)
        s = _PathState(
            ray_o=ray_o, ray_d=ray_d, alive=alive0,
            specular=torch.ones(Bb, dtype=torch.bool, device=dev),
            radiance=torch.zeros((Bb, 3), dtype=ray_o.dtype, device=dev),
            path_weight=torch.ones((Bb, 3), dtype=ray_o.dtype, device=dev),
            stream=stream,
            rays=torch.zeros((), dtype=torch.int64, device=dev),
        )
        with tracing.span("rt.bounce", {"depth": 0}):
            s = _bounce(ds, cfg, st, s, 0, True, diff)
        depth = 1
        while _any_alive(s.alive):
            with tracing.span("rt.bounce", {"depth": depth}):
                s = _bounce(ds, cfg, st, s, depth, False, None)
            depth += 1
        return s.radiance, s.rays


def _any_alive(alive) -> bool:
    """The bounce loop's test: a host read of the device's lanes."""
    tracing.sync("render.alive_any")
    return bool(alive.any())


def sample_sum(ds: DeviceScene, cfg: SamplerConfig, st: StaticSettings,
               px, py, first: int, count: int, active=None):
    """Radiance summed over samples first .. first + count - 1 (absolute
    sample indices) for one pixel chunk, in sample order; returns
    ((B, 3) f32, rays traced (0-d int64 tensor))."""
    total = torch.zeros((px.shape[0], 3), dtype=torch.float32,
                        device=px.device)
    rays = torch.zeros((), dtype=torch.int64, device=px.device)
    for s in range(first, first + count):
        r, n = trace_radiance(ds, cfg, st, px, py, s, active=active)
        total = total + r
        rays = rays + n
    return total, rays


def render_beauty_chunk(ds: DeviceScene, cfg: SamplerConfig,
                        st: StaticSettings, px, py, active=None):
    """Average radiance over spp for one pixel chunk; returns
    ((B, 3) f32, rays traced (0-d int64 tensor))."""
    total, rays = sample_sum(ds, cfg, st, px, py, 0, st.samples_per_pixel,
                             active)
    return total / st.samples_per_pixel, rays


def render_aov_chunk(ds: DeviceScene, cfg: SamplerConfig, st: StaticSettings,
                     px, py, albedo: bool = True, mip_level: bool = True,
                     active=None):
    """First-hit AOVs of one pixel chunk from unjittered camera rays:
    (normals (B, 3), albedo (B, 3), uv (B, 2), mip level (B,)), zero where
    nothing is hit. Albedo is the albedo texture of diffuse and coated
    materials and white for the others (materials.rs get_albedo); the mip
    level is that of a diffuse material's albedo texture where it is a
    trilinear image (materials.rs get_mip_level). An AOV whose flag is
    false is zero, and no texture work runs for it. Lanes where `active`
    (bool (B,)) is false are walked dead: every AOV is zero there."""
    with tracing.span("rt.aov.chunk", host_ns=True):
        stream = make_stream(px, py, 0)
        ray_o, ray_d, diff, stream = generate_rays(
            ds, px, py, cfg, stream, st.samples_per_pixel, jitter=False)
        B_ = px.shape[0]
        dev = ray_o.device
        f32 = dict(dtype=torch.float32, device=dev)
        t, prim = intersect_scene(
            ds, ray_o, ray_d, torch.full((B_,), ds.meta.near_clip, **f32),
            torch.full((B_,), ds.meta.far_clip, **f32), active=active)
        hit = hit_details(ds, ray_o, ray_d, t, prim)
        h1 = hit.hit[:, None]
        normals = torch.where(h1, hit.normal, 0.0)
        uv = torch.where(h1, hit.uv, 0.0)
        alb = torch.zeros_like(normals)
        mip = torch.zeros(B_, dtype=torch.float32, device=dev)
        if not (albedo or mip_level):
            return normals, alb, uv, mip
        ctx = eval_ctx_from_differentials(hit, ray_o, ray_d, diff)
        ctx = EvalCtx(uv=hit.uv, **{
            k: torch.where(hit.hit, getattr(ctx, k), 0.0)
            for k in ("dudx", "dudy", "dvdx", "dvdy")})
        mat = torch.clamp(hit.material, min=0).long()
        kind = ds.mat_kind[mat]
        albedo_tex = ds.mat_tex[mat, 0]
        if albedo:
            sk = ds.meta.slot_kinds
            sampled = eval_texture(ds, albedo_tex, ctx,
                                   kinds=sk[0] if sk else None)[:, :3]
            has_albedo = (kind == MAT_DIFFUSE) | (kind == MAT_COATED_DIFFUSE)
            alb = torch.where(
                h1, torch.where(has_albedo[:, None], sampled, 1.0), 0.0)
        if mip_level:
            diffuse = kind == MAT_DIFFUSE
            level, valid = texture_mip_level(
                ds, torch.where(diffuse, albedo_tex, -1), ctx)
            mip = torch.where(hit.hit & valid & diffuse, level, 0.0)
        return normals, alb, uv, mip


def _interleave_bits(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64)
    v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v << 2)) & np.uint64(0x3333333333333333)
    v = (v | (v << 1)) & np.uint64(0x5555555555555555)
    return v


@functools.lru_cache(maxsize=8)
def _pixel_grid(width: int, height: int):
    """Flat pixel lists in Morton order (+ the inverse permutation).
    Cached per resolution; callers treat the arrays as read-only."""
    xs = np.arange(width, dtype=np.uint32)
    ys = np.arange(height, dtype=np.uint32)
    px, py = np.meshgrid(xs, ys)
    px, py = px.reshape(-1), py.reshape(-1)
    morton = _interleave_bits(px) | (_interleave_bits(py) << np.uint64(1))
    order = np.argsort(morton, kind="stable")
    inverse = np.empty_like(order)
    inverse[order] = np.arange(order.shape[0])
    return px[order], py[order], inverse


def _run_chunked(fn, px, py, device, chunk, active=None):
    """Yield (size, fn(px, py, active)) over fixed-size pixel chunks; the
    tail chunk is padded with inactive lanes (traced dead, not counted), as
    are the lanes where `active` (a bool array like px) is false."""
    n = px.shape[0]
    chunk = min(chunk, n)
    for start in range(0, n, chunk):
        cpx = px[start:start + chunk].astype(np.int64)
        cpy = py[start:start + chunk].astype(np.int64)
        size = cpx.shape[0]
        act = np.arange(chunk) < size
        if active is not None:
            act[:size] &= active[start:start + chunk]
        pad = np.zeros(chunk - size, np.int64)
        cpx, cpy = np.concatenate([cpx, pad]), np.concatenate([cpy, pad])
        tracing.sync("render.chunk_to_device", 3)
        yield size, fn(torch.from_numpy(cpx).to(device),
                       torch.from_numpy(cpy).to(device),
                       torch.from_numpy(act).to(device))


def device_scene(scene_or_device, device: torch.device,
                 caller: str) -> DeviceScene:
    """The compiled scene on `device`: a DeviceScene as given (it must
    live there), or a Scene compiled there. A cuda device without a card
    raises."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}(device='cuda'): no CUDA device")
    if isinstance(scene_or_device, DeviceScene):
        if scene_or_device.device.type != device.type:
            raise ValueError(f"scene lives on {scene_or_device.device}, "
                             f"{caller} on {device}")
        return scene_or_device
    t0 = time.perf_counter()
    ds = compile_scene(scene_or_device, device)
    log.info("scene compile took %.3fs", time.perf_counter() - t0)
    return ds


def render(scene_or_device, settings: RaytracerSettings, device="cuda",
           chunk_pixels: int | None = None) -> RenderOutput:
    """Full-frame render on `device`: the card unless the caller asks for
    "cpu"; without a card, a cuda render raises. The first-hit AOVs that
    `settings.outputs` asks for come first, then the beauty pass."""
    device = torch.device(device)
    ds = device_scene(scene_or_device, device, "render")
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    st = StaticSettings.from_settings(settings)
    width, height = ds.meta.width, ds.meta.height
    out = RenderOutput(width=width, height=height)
    px, py, unmorton = _pixel_grid(width, height)
    chunk = chunk_pixels or default_chunk(device)
    if settings.outputs & AovFlags.FIRST_HIT_AOVS:
        t0 = time.perf_counter()
        want_albedo = bool(settings.outputs & AovFlags.ALBEDO)
        want_mip = bool(settings.outputs & AovFlags.MIP_LEVEL)
        with tracing.span("rt.aov", host_ns=True):
            sized = list(_run_chunked(
                lambda a, b, act: render_aov_chunk(
                    ds, cfg, st, a, b, want_albedo, want_mip, active=act),
                px, py, device, chunk))
            # a chunk hands the walk its `size` pixels active, its padding
            # dead: the rays are counted on the host
            out.aov_rays_traced = tracing.count(
                "aov.lanes", sum(size for size, _ in sized))
            with tracing.span("rt.aov.to_host", host_ns=True):
                tracing.sync("render.aov_to_host", 4)
                normals, albedo, uv, mip = (
                    torch.cat([res[k][:size] for size, res in sized])
                    .cpu().numpy()[unmorton] for k in range(4))
        log.info("aov pass took %.3fs", time.perf_counter() - t0)
        if settings.outputs & AovFlags.NORMALS:
            out.normals = normals.reshape(height, width, 3)
        if settings.outputs & AovFlags.ALBEDO:
            out.albedo = albedo.reshape(height, width, 3)
        if settings.outputs & AovFlags.UV_COORDS:
            out.uv = uv.reshape(height, width, 2)
        if want_mip:
            out.mip_level = mip.reshape(height, width)
    if not settings.outputs & AovFlags.BEAUTY:
        return out
    t0 = time.perf_counter()
    with tracing.span("rt.pass", {"first": 0, "count": st.samples_per_pixel}):
        parts, rays = [], 0
        for size, (r, n) in _run_chunked(
                lambda a, b, act: render_beauty_chunk(ds, cfg, st, a, b, act),
                px, py, device, chunk):
            parts.append(r[:size])
            rays = rays + n
        tracing.sync("render.to_host")
        beauty = torch.cat(parts).cpu().numpy()
        tracing.sync("render.rays")
        out.rays_traced = int(rays)
    dt = time.perf_counter() - t0
    log.info("beauty pass took %.3fs (%d rays, %.1f Mrays/s)",
             dt, out.rays_traced, out.rays_traced / dt / 1e6)
    beauty = beauty[unmorton].reshape(height, width, 3)
    _nan_scan(beauty)
    out.beauty = beauty
    return out


def _nan_scan(beauty: np.ndarray) -> None:
    """Log the non-finite pixels of a frame and how to replay the first."""
    bad = ~np.isfinite(beauty)
    if bad.any():
        ys, xs = np.nonzero(bad.any(axis=-1))
        log.warning(
            "%d non-finite radiance pixels (first at x=%d y=%d); repro "
            "with: python -m tpu_raytracing_torch.cli <scene> pixel %d %d",
            len(ys), xs[0], ys[0], xs[0], ys[0])


def render_single_pixel(scene, settings: RaytracerSettings, x: int, y: int,
                        sample_count: int = 1, sample_offset: int = 0,
                        device="cuda") -> list:
    """Replay the sample streams of pixel (x, y), clamped to the raster:
    per sample its radiance and its camera ray's first hit (hit, uv,
    normal). On the card unless the caller asks for "cpu"."""
    ds = compile_scene(scene, device)
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    st = StaticSettings.from_settings(settings)
    x = min(max(x, 0), ds.meta.width - 1)
    y = min(max(y, 0), ds.meta.height - 1)
    px = torch.tensor([x], dtype=torch.int64, device=ds.device)
    py = torch.tensor([y], dtype=torch.int64, device=ds.device)
    near = torch.full((1,), ds.meta.near_clip, device=ds.device)
    far = torch.full((1,), ds.meta.far_clip, device=ds.device)
    outputs = []
    for s in range(sample_offset, sample_offset + sample_count):
        radiance = trace_radiance(ds, cfg, st, px, py, s)[0][0]
        stream = make_stream(px, py, s)
        ray_o, ray_d, _, _ = generate_rays(
            ds, px, py, cfg, stream, st.samples_per_pixel, jitter=True)
        t, prim = intersect_scene(ds, ray_o, ray_d, near, far)
        hit = hit_details(ds, ray_o, ray_d, t, prim)
        outputs.append(SinglePixelOutput(
            sample_index=s, hit=bool(hit.hit[0]),
            uv=hit.uv[0].cpu().numpy(), normal=hit.normal[0].cpu().numpy(),
            radiance=radiance.cpu().numpy()))
    return outputs
