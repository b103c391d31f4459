"""The plain reference path tracer: brute-force intersection over every
triangle and sphere of the reference's own scene, then the renderer's
bounce loop (camera rays, closest hit, shading normal, next-event
estimation with one any-hit shadow ray a light sample, BSDF sampling)
lane by lane, on any list of (pixel, sample index) lanes. The lights are
the scene's light kinds (scene.py), sampled as the renderer samples them:
`samples(light_sample_count)` samples each, averaged.

The sampler, BSDFs and the coat's layered walk are frozen copies of the
port's plain arithmetic (this directory), so a lane whose geometry agrees
to the bit follows the same path; the coat hashes the bits of its
directions, so a lane whose hit point differs in the last bit takes
another walk there and agrees only in distribution.

`rays` counts per lane what the renderer's `rays_traced` counts: the lane
at the top of each bounce while it is alive, and each shadow ray walked.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import bsdf as B
from .bsdf_dispatch import bsdf_eval, bsdf_sample
from .intersect import ray_sphere, ray_triangle, ray_triangle_edges, \
    sphere_hit_geom
from .linalg import apply_point, apply_vector, apply_vector_transposed, \
    dot, make_orthonormal_basis, normalize
from .rng import M32, SamplerConfig, make_stream
from .scene import RefScene

INF = float("inf")
PAIRS_PER_BLOCK = 1 << 23  # ray-triangle pairs tested in one block


class Lanes(NamedTuple):
    """What the reference renders: one lane a (pixel, sample index), and
    where given, the lane's own render seed (uint32 in int64) in place of
    `trace`'s, so one call can follow lanes of many jobs."""

    px: torch.Tensor      # (B,) int64
    py: torch.Tensor      # (B,) int64
    sample: torch.Tensor  # (B,) int64
    seed: Optional[torch.Tensor] = None  # (B,) int64


class Hit(NamedTuple):
    point: torch.Tensor     # (B, 3)
    normal: torch.Tensor    # (B, 3)
    material: torch.Tensor  # (B,) int32


def _spheres(sc: RefScene, o, d, t_min, t_max):
    """(t, index) of the nearest sphere in [t_min, t_max], inf where none;
    the first index wins an equal t."""
    o_o = apply_point(sc.sph_w2o[None, :], o[:, None, :])
    d_o = apply_vector(sc.sph_w2o[None, :], d[:, None, :])
    valid, t = ray_sphere(o_o, d_o, sc.sph_center[None, :],
                          sc.sph_radius[None, :], t_min[:, None],
                          t_max[:, None])
    t = torch.where(valid, t, INF)
    t_best = t.amin(dim=1)
    first = torch.arange(t.shape[1], device=t.device).expand_as(t)
    idx = torch.where(t == t_best[:, None], first, t.shape[1]).amin(dim=1)
    return t_best, idx.clamp(max=t.shape[1] - 1)


def _triangles(sc: RefScene, o, d, t_min, t_max, any_hit: bool):
    """Brute force over every triangle, in blocks of rays: (t, index) of
    the nearest in [t_min, t_max] (the first index wins an equal t), or
    for `any_hit` whether any is hit."""
    n = o.shape[0]
    block = max(1, PAIRS_PER_BLOCK // max(sc.n_tris, 1))
    t_out = torch.full((n,), INF, device=o.device)
    i_out = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    first = torch.arange(sc.n_tris, device=o.device)
    for a in range(0, n, block):
        s = slice(a, a + block)
        valid, t, _, _ = ray_triangle_edges(
            o[s, None, :], d[s, None, :], sc.p0[None], sc.e1[None],
            sc.e2[None], t_min[s, None], t_max[s, None])
        if any_hit:
            i_out[s] = torch.where(valid.any(dim=1), 0, -1)
            continue
        t_best = t.amin(dim=1)
        idx = torch.where(t == t_best[:, None], first, sc.n_tris).amin(dim=1)
        hit = torch.isfinite(t_best)
        t_out[s] = torch.where(hit, t_best, INF)
        i_out[s] = torch.where(hit, idx, -1)
    return t_out, i_out


def intersect(sc: RefScene, o, d, t_min, t_max, active, any_hit=False):
    """The scene query of the renderer: spheres first, whose hit cuts the
    triangles' t_max, then the triangles. Returns (t, prim): prim < n_tris
    a triangle, n_tris + s sphere s, -1 a miss (and every inactive lane);
    for `any_hit` only prim >= 0 means anything."""
    n = o.shape[0]
    t_min = t_min.expand(n).contiguous()
    t_best = t_max.to(torch.float32).expand(n).contiguous().clone()
    best = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    if sc.n_spheres:
        st, sidx = _spheres(sc, o, d, t_min, t_best)
        sph = torch.isfinite(st) & active
        t_best = torch.where(sph, st, t_best)
        best = torch.where(sph, sc.n_tris + sidx, best)
    walk = active & (best < 0) if any_hit else active
    lanes = torch.nonzero(walk)[:, 0]
    if lanes.numel() and sc.n_tris:
        tt, ti = _triangles(sc, o[lanes], d[lanes], t_min[lanes],
                            t_best[lanes], any_hit)
        hit = ti >= 0
        t_best[lanes] = torch.where(hit, tt, t_best[lanes])
        best[lanes] = torch.where(hit, ti, best[lanes])
    t = torch.where(best >= 0, t_best, INF)
    return t, best


def hit_details(sc: RefScene, o, d, t, prim) -> Hit:
    """Hit point, unit shading normal (the vertex normals interpolated at
    the barycentrics recomputed from the ray, or the sphere's) and
    material; zero where nothing is hit."""
    hit = prim >= 0
    is_tri = hit & (prim < sc.n_tris)
    point = o + t[:, None] * d
    tid = torch.where(is_tri, prim, 0).clamp(0, max(sc.n_tris - 1, 0))
    p0, p1, p2 = sc.p0[tid], sc.p1[tid], sc.p2[tid]
    _, _, u, v = ray_triangle(o, d, p0, p1, p2, torch.full_like(t, -INF),
                              torch.full_like(t, INF))
    w = 1.0 - u - v
    sn = (w[:, None] * sc.n0[tid] + u[:, None] * sc.n1[tid]
          + v[:, None] * sc.n2[tid])
    normal = normalize(sn)
    material = sc.tri_mat[tid]
    if sc.n_spheres:
        sid = torch.where(is_tri, 0, prim - sc.n_tris).clamp(
            0, sc.n_spheres - 1)
        w2o, o2w = sc.sph_w2o[sid], sc.sph_o2w[sid]
        o_o = apply_point(w2o, o)
        d_o = apply_vector(w2o, d)
        p_o = o_o + t[:, None] * d_o
        ctr, rad = sc.sph_center[sid], sc.sph_radius[sid]
        rel = p_o - ctr
        rn = torch.sqrt(torch.sum(rel * rel, dim=-1, keepdim=True))
        safe_rn = torch.where(rn == 0.0, torch.ones_like(rn), rn)
        p_o = ctr + rel * (rad[:, None] / safe_rn) * (1.0 + 4.0e-7)
        _, n_o, _, _ = sphere_hit_geom(p_o, ctr, rad)
        sel = is_tri[:, None]
        point = torch.where(sel, point, apply_point(o2w, p_o))
        normal = torch.where(
            sel, normal, normalize(apply_vector_transposed(w2o, n_o)))
        material = torch.where(is_tri, material, sc.sph_mat[sid])
    h1 = hit[:, None]
    return Hit(point=torch.where(h1, point, 0.0),
               normal=torch.where(h1, normal, 0.0),
               material=torch.where(hit, material, 0))


def _to_local(x, y, n, v):
    return torch.stack([dot(v, x), dot(v, y), dot(v, n)], dim=-1)


def _to_world(x, y, n, v):
    return v[..., 0:1] * x + v[..., 1:2] * y + v[..., 2:3] * n


def camera_rays(sc: RefScene, cfg: SamplerConfig, lanes: Lanes):
    """(origin, direction, stream after the camera's draws) per lane."""
    stream = make_stream(lanes.px, lanes.py, lanes.sample)
    return sc.camera.rays(lanes.px, lanes.py, cfg, stream)


def trace(sc: RefScene, seed: int, lanes: Lanes, max_depth: int,
          light_sample_count: int, accumulate_bounces: bool = True,
          on_query=None):
    """Radiance (B, 3) and rays traced (B,) of each lane's path.
    `on_query(closest, origin, direction, t_min, t_max, active, answer)`,
    where given, sees every scene query (answer: (t, prim) of a closest
    hit, the occluded flags of a shadow query). A lane's `seed`, where
    `lanes` has them, keys its draws in place of `seed`: every draw hashes
    (seed, pixel, sample, dimension) lane by lane (rng.py)."""
    cfg = SamplerConfig.independent(seed)
    if lanes.seed is not None:
        cfg = cfg._replace(seed=lanes.seed.to(torch.int64) & M32)
    o, d, stream = camera_rays(sc, cfg, lanes)
    n = o.shape[0]
    dev = o.device
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    radiance = torch.zeros((n, 3), device=dev)
    pw = torch.ones((n, 3), device=dev)
    rays = torch.zeros(n, dtype=torch.int64, device=dev)
    depth = 0
    while bool(alive.any()):
        rays = rays + alive
        if depth == 0:
            t_min, t_max = sc.camera.near, sc.camera.far
        else:
            t_min, t_max = 1.0e-4, INF
        t_lo = torch.full((n,), t_min, device=dev)
        t_hi = torch.full((n,), t_max, device=dev)
        t, prim = intersect(sc, o, d, t_lo, t_hi, alive)
        if on_query is not None:
            on_query(True, o, d, t_lo, t_hi, alive, (t, prim))
        if sc.miss_lights:
            miss = alive & (prim < 0)
            for light in sc.miss_lights:
                radiance = radiance + torch.where(
                    miss[:, None], pw * light.miss(d), 0.0)
        alive = alive & (prim >= 0)
        hit = hit_details(sc, o, d, t, prim)
        params = B.get_bsdf_params(sc.mats, hit.material)
        bx, by = make_orthonormal_basis(hit.normal)
        wo = _to_local(bx, by, hit.normal, -d)
        depth += 1
        alive = alive & (depth <= max_depth)
        add_direct = accumulate_bounces or depth == max_depth
        nee = alive & ~B.is_delta_bsdf(params) & add_direct
        direct = torch.zeros((n, 3), device=dev)
        for light in sc.lights:
            n_s = light.samples(light_sample_count)
            if not n_s:
                continue
            contrib = torch.zeros((n, 3), device=dev)
            for _ in range(n_s):
                ls, stream = light.sample(hit.point, cfg, stream)
                wi = _to_local(bx, by, hit.normal, -ls.direction)
                cos_theta = torch.clamp(wi[..., 2], min=0.0)
                shadow = nee & (ls.pdf > 0.0) & (cos_theta > 0.0)
                rays = rays + shadow
                s_lo = torch.full((n,), 1.0e-3, device=dev)
                s_hi = ls.distance - 1.0e-3
                _, occ = intersect(sc, ls.origin, ls.direction, s_lo, s_hi,
                                   shadow, any_hit=True)
                if on_query is not None:
                    on_query(False, ls.origin, ls.direction, s_lo, s_hi,
                             shadow, occ >= 0)
                good = shadow & (occ < 0)
                f = bsdf_eval(params, wo, wi, sc.kinds, active=good)
                safe_pdf = torch.where(ls.pdf == 0.0, 1.0, ls.pdf)
                c = f * ls.radiance * (cos_theta / safe_pdf)[:, None]
                contrib = contrib + torch.where(good[:, None], c, 0.0)
            direct = direct + contrib / n_s
        radiance = radiance + pw * direct
        samp, stream = bsdf_sample(params, wo, B.ALL_COMPONENTS, cfg, stream,
                                   sc.kinds, active=alive)
        ok = samp.valid & (samp.pdf > 0.0) & torch.any(samp.f != 0.0, dim=-1)
        alive = alive & ok
        cos_t = torch.abs(samp.wi[..., 2])
        safe_pdf = torch.where(samp.pdf == 0.0, 1.0, samp.pdf)
        pw = torch.where(alive[:, None],
                         pw * samp.f * (cos_t / safe_pdf)[:, None], pw)
        new_d = _to_world(bx, by, hit.normal, samp.wi)
        o = torch.where(alive[:, None], hit.point, o)
        d = torch.where(alive[:, None], new_d, d)
    return radiance, rays
