"""Batched scene intersection: closest-hit, any-hit and hit shading data.

Counterpart of tpu_raytracing/ops/traverse.py without the bounce sort or
presorted lanes, in JAX's pass order: a brute-force pass over the analytic
spheres in object space, one pass over the main triangle accel, then one
pass per instance over its shared BLAS with the rays taken into object
space (w2o) and masked by the instance's world-box slab test. Each pass
takes the best t so far as its t_max. The triangle query goes through
ops/traverse_kernels.py, which picks the walk as the JAX kernel switch does
and runs its CUDA kernel on the card and its plain version on the CPU.

`hit_details` expands a winner into its shading geometry: on the card by
one kernel a call (csrc/hit_details.cu), on the CPU by its predicated
plain twin, `hit_details_plain`.

Winning primitive encoding: 0 <= prim < n_tris -> triangle index (BVH
order); n_tris <= prim < inst_vtri_base0 -> sphere prim - n_tris; then
one block of virtual triangle ids per instance (vtri_base + the BLAS's
triangle); prim < 0 -> miss.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import native_cuda, tracing
from ..device.scene_buffers import DeviceScene
from ..utils import raydump
from .intersect import ray_aabb, ray_sphere, ray_triangle, sphere_hit_geom
from .linalg import (
    apply_point, apply_vector, apply_vector_transposed, cross, normalize,
)
from .traverse_kernels import intersect_tris
from .walk_common import check_aligned

INF = float("inf")


class Hit(NamedTuple):
    """SoA hit records."""

    hit: torch.Tensor       # (B,) bool
    t: torch.Tensor         # (B,) f32
    prim: torch.Tensor      # (B,) i32 encoded winner
    uv: torch.Tensor        # (B, 2)
    point: torch.Tensor     # (B, 3) world
    normal: torch.Tensor    # (B, 3) world, unit
    dpdu: torch.Tensor      # (B, 3)
    dpdv: torch.Tensor      # (B, 3)
    material: torch.Tensor  # (B,) i32
    light: torch.Tensor     # (B,) i32 (-1 = not an emitter)


def _intersect_spheres(ds: DeviceScene, origin, direction, t_min, t_max):
    """Every sphere, brute force, in object space. Returns (t, sphere
    index); the first index wins an equal t, as jnp.argmin does."""
    S = ds.sph_center.shape[0]
    o_o = apply_point(ds.sph_w2o[None, :], origin[:, None, :])
    d_o = apply_vector(ds.sph_w2o[None, :], direction[:, None, :])
    valid, t = ray_sphere(o_o, d_o, ds.sph_center[None, :],
                          ds.sph_radius[None, :], t_min[:, None],
                          t_max[:, None])
    real = torch.arange(S, device=origin.device)[None, :] < ds.meta.n_spheres
    t = torch.where(valid & real, t, torch.full_like(t, INF))
    best = torch.argmin(t, dim=1)
    t_best = torch.gather(t, 1, best[:, None])[:, 0]
    return t_best, best.to(torch.int32)


def intersect_scene(ds: DeviceScene, origin, direction, t_min, t_max,
                    early_exit: bool = False, active=None):
    """Closest-hit (or any-hit) query. Returns (t, encoded prim or -1).

    A sphere hit cuts the lane's t_max for the triangle walks; a triangle
    at t <= that hit replaces it. The affine ray transform keeps t, so t
    chains through the instance passes. Any-hit lanes that an earlier pass
    occludes skip the later walks."""
    B = origin.shape[0]
    dev = origin.device
    t_min = t_min.expand(B).contiguous()
    t_best = t_max.to(torch.float32).expand(B).contiguous()
    best = torch.full((B,), -1, dtype=torch.int32, device=dev)
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=dev)
    raydump.emit(early_exit, origin, direction, t_min, t_best, active)
    n_tris = ds.meta.n_tris
    if ds.meta.n_spheres:
        st, sidx = _intersect_spheres(ds, origin, direction, t_min, t_best)
        sph_hit = torch.isfinite(st) & active
        t_best = torch.where(sph_hit, st, t_best)
        best = torch.where(sph_hit, n_tris + sidx, best)
    if n_tris:
        walk = active & (best < 0) if early_exit else active
        pt, pbest = intersect_tris(ds, origin, direction, t_min, t_best,
                                   walk, early_exit)
        tri_hit = pbest >= 0
        t_best = torch.where(tri_hit, pt, t_best)
        best = torch.where(tri_hit, pbest, best)
    inv_dir = 1.0 / direction if ds.meta.instances else None
    for i, (blas_id, vtri_base, _, _) in enumerate(ds.meta.instances):
        w2o = ds.inst_xf[i, 16:].reshape(4, 4)
        a0, a1 = ray_aabb(origin, inv_dir, ds.inst_aabb_min[i],
                          ds.inst_aabb_max[i])
        walk = active & (a0 <= a1) & (a1 >= t_min) & (a0 <= t_best)
        if early_exit:
            walk = walk & (best < 0)
        pt, pbest = intersect_tris(
            ds, apply_point(w2o, origin), apply_vector(w2o, direction),
            t_min, t_best, walk, early_exit, blas=blas_id)
        ihit = pbest >= 0
        t_best = torch.where(ihit, pt, t_best)
        best = torch.where(ihit, vtri_base + pbest, best)
    t = torch.where(best >= 0, t_best, torch.full_like(t_best, INF))
    return t, best


def occluded(ds: DeviceScene, origin, direction, t_min, t_max, active=None):
    """Any-hit query for shadow rays."""
    _, prim = intersect_scene(ds, origin, direction, t_min, t_max,
                              early_exit=True, active=active)
    return prim >= 0


def hit_details(ds: DeviceScene, origin, direction, t, prim) -> Hit:
    """Expand an encoded (t, prim) result into full shading geometry.

    CUDA tensors launch csrc/hit_details.cu, one thread a lane, bit for
    bit with the plain version (adding the lanes to the traced counter
    `hit.kernel_lanes`); CPU tensors run `hit_details_plain`."""
    if not native_cuda.on_card("hit_details", origin):
        return hit_details_plain(ds, origin, direction, t, prim)
    return _hit_kernel(ds, origin, direction, t, prim)


def hit_details_plain(ds: DeviceScene, origin, direction, t,
                      prim) -> Hit:
    """`hit_details` predicated over every lane. Triangles interpolate in
    world space; an instanced triangle is decoded to its BLAS's
    object-space shade row, recomputed with the object-space ray and
    transformed out (the normal by the inverse transpose); spheres are
    recomputed in object space and transformed out."""
    n_tris = ds.meta.n_tris
    instances = ds.meta.instances
    hit = prim >= 0
    is_tri = hit & (prim < n_tris)
    point = origin + t[:, None] * direction

    o_sel, d_sel = origin, direction
    if instances:
        is_inst = hit & (prim >= ds.meta.inst_vtri_base0)
        # the instances' id blocks are contiguous and ascending: the lane's
        # instance is the last whose vtri base is <= prim
        tracing.sync("traverse.instance_bases")
        vbase, shade_off = torch.tensor(
            [[vb for _, vb, _, _ in instances],
             [so for *_, so in instances]],
            dtype=prim.dtype, device=prim.device)
        xf_id = torch.where(
            is_inst, torch.searchsorted(vbase, prim, right=True) - 1, 0)
        row = torch.where(is_inst, prim - vbase[xf_id] + shade_off[xf_id],
                          torch.where(is_tri, prim, 0))
        tid = torch.clamp(row, 0, ds.tri_shade.shape[0] - 1)
        xf = ds.inst_xf[xf_id]
        o2w = xf[:, :16].reshape(-1, 4, 4)
        iw2o = xf[:, 16:].reshape(-1, 4, 4)
        sel_i = is_inst[:, None]
        o_sel = torch.where(sel_i, apply_point(iw2o, origin), origin)
        d_sel = torch.where(sel_i, apply_vector(iw2o, direction), direction)
    else:
        tid = torch.clamp(torch.where(is_tri, prim, torch.zeros_like(prim)),
                          0, max(n_tris - 1, 0))
    sh = ds.tri_shade[tid.long()]
    p0, p1, p2 = sh[:, 0:3], sh[:, 3:6], sh[:, 6:9]
    sh_ints = sh[:, 24:28].contiguous().view(torch.int32)
    _, _, u, v = ray_triangle(
        o_sel, d_sel, p0, p1, p2,
        torch.full_like(t, -INF), torch.full_like(t, INF),
    )
    w = 1.0 - u - v
    geo_n = normalize(cross(p2 - p0, p1 - p0))
    sn = (
        w[:, None] * sh[:, 9:12]
        + u[:, None] * sh[:, 12:15]
        + v[:, None] * sh[:, 15:18]
    )
    normal = torch.where((sh_ints[:, 2] != 0)[:, None], normalize(sn), geo_n)
    has_uv = (sh_ints[:, 3] != 0)[:, None]
    tracing.sync("traverse.default_uv")
    default_uv = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]],
                              device=origin.device)
    uv0 = torch.where(has_uv, sh[:, 18:20], default_uv[0])
    uv1 = torch.where(has_uv, sh[:, 20:22], default_uv[1])
    uv2 = torch.where(has_uv, sh[:, 22:24], default_uv[2])
    uv = w[:, None] * uv0 + u[:, None] * uv1 + v[:, None] * uv2
    # pbrt 4ed eq. 6.7
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    dp02 = p0 - p2
    dp12 = p1 - p2
    det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
    degenerate = torch.abs(det) < 1e-9
    inv_det = torch.where(
        degenerate, torch.zeros_like(det),
        1.0 / torch.where(degenerate, torch.ones_like(det), det))
    dpdu = inv_det[:, None] * (duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12)
    dpdv = inv_det[:, None] * (duv02[:, 0:1] * dp12 - duv12[:, 0:1] * dp02)
    material, light = sh_ints[:, 0], sh_ints[:, 1]
    if instances:
        normal = torch.where(
            sel_i, normalize(apply_vector_transposed(iw2o, normal)), normal)
        dpdu = torch.where(sel_i, apply_vector(o2w, dpdu), dpdu)
        dpdv = torch.where(sel_i, apply_vector(o2w, dpdv), dpdv)
        is_tri = is_tri | is_inst

    if ds.meta.n_spheres:
        sid = torch.clamp(
            torch.where(is_tri, torch.zeros_like(prim), prim - n_tris),
            0, ds.sph_center.shape[0] - 1).long()
        w2o, o2w = ds.sph_w2o[sid], ds.sph_o2w[sid]
        o_o = apply_point(w2o, origin)
        d_o = apply_vector(w2o, direction)
        p_o = o_o + t[:, None] * d_o
        # Reproject the hit onto the surface and inflate it a few ULPs
        # outward: o + t*d can round to a point inside the sphere, from
        # which a grazing reflection re-enters on a real chord and
        # self-shadows the silhouette (the JAX package's robustness fix
        # over geometry.rs:92-136; the metal scene lost 19% of its energy
        # without it). Transmitted rays re-enter at t ~ 1e-7 << t_min.
        ctr, rad = ds.sph_center[sid], ds.sph_radius[sid]
        rel = p_o - ctr
        rn = torch.sqrt(torch.sum(rel * rel, dim=-1, keepdim=True))
        safe_rn = torch.where(rn == 0.0, torch.ones_like(rn), rn)
        p_o = ctr + rel * (rad[:, None] / safe_rn) * (1.0 + 4.0e-7)
        sph_uv, n_o, dpdu_o, dpdv_o = sphere_hit_geom(p_o, ctr, rad)
        sel = is_tri[:, None]
        uv = torch.where(sel, uv, sph_uv)
        point = torch.where(sel, point, apply_point(o2w, p_o))
        normal = torch.where(
            sel, normal, normalize(apply_vector_transposed(w2o, n_o)))
        dpdu = torch.where(sel, dpdu, apply_vector(o2w, dpdu_o))
        dpdv = torch.where(sel, dpdv, apply_vector(o2w, dpdv_o))
        material = torch.where(is_tri, material, ds.sph_mat[sid])
        light = torch.where(is_tri, light, ds.sph_light[sid])

    h1 = hit[:, None]
    return Hit(
        hit=hit,
        t=torch.where(hit, t, torch.full_like(t, INF)),
        prim=prim,
        uv=torch.where(h1, uv, torch.zeros_like(uv)),
        point=torch.where(h1, point, torch.zeros_like(point)),
        normal=torch.where(h1, normal, torch.zeros_like(normal)),
        dpdu=torch.where(h1, dpdu, torch.zeros_like(dpdu)),
        dpdv=torch.where(h1, dpdv, torch.zeros_like(dpdv)),
        material=torch.where(hit, material, torch.zeros_like(prim)),
        light=torch.where(hit, light, torch.full_like(prim, -1)),
    )


# ------------------------------------------------------- the card's kernel

def _hit_kernel(ds: DeviceScene, origin, direction, t, prim) -> Hit:
    """`hit_details` by one launch of csrc/hit_details.cu: the scene
    tables and the lanes checked, the outputs allocated here."""
    n, dev = origin.shape[0], ds.device
    f32, i32 = torch.float32, torch.int32
    S, X = ds.sph_center.shape[0], ds.inst_xf.shape[0]
    check_aligned([("hit_details: tri_shade", ds.tri_shade, f32),
                   ("hit_details: sph_o2w", ds.sph_o2w, f32),
                   ("hit_details: sph_w2o", ds.sph_w2o, f32),
                   ("hit_details: inst_xf", ds.inst_xf, f32)])
    args = [native_cuda.check_tensor(f"hit_details: {name}", x, shape,
                                     dtype, dev)
            for name, x, dtype, shape in (
                ("tri_shade", ds.tri_shade, f32, (ds.tri_shade.shape[0], 32)),
                ("sph_center", ds.sph_center, f32, (S, 3)),
                ("sph_radius", ds.sph_radius, f32, (S,)),
                ("sph_o2w", ds.sph_o2w, f32, (S, 4, 4)),
                ("sph_w2o", ds.sph_w2o, f32, (S, 4, 4)),
                ("sph_mat", ds.sph_mat, i32, (S,)),
                ("sph_light", ds.sph_light, i32, (S,)),
                ("inst_xf", ds.inst_xf, f32, (X, 32)),
                ("inst_bases", ds.inst_bases, i32,
                 (2, len(ds.meta.instances))),
                ("origin", origin, f32, (n, 3)),
                ("direction", direction, f32, (n, 3)),
                ("t", t, f32, (n,)),
                ("prim", prim, i32, (n,)))]
    hit = Hit(
        hit=torch.empty(n, dtype=torch.bool, device=dev),
        t=torch.empty(n, dtype=f32, device=dev),
        prim=prim,
        uv=torch.empty((n, 2), dtype=f32, device=dev),
        point=torch.empty((n, 3), dtype=f32, device=dev),
        normal=torch.empty((n, 3), dtype=f32, device=dev),
        dpdu=torch.empty((n, 3), dtype=f32, device=dev),
        dpdv=torch.empty((n, 3), dtype=f32, device=dev),
        material=torch.empty(n, dtype=i32, device=dev),
        light=torch.empty(n, dtype=i32, device=dev),
    )
    if n:
        m = ds.meta
        native_cuda.launch(
            "tpu_rt_hit_details", dev,
            *(x.data_ptr() for x in (*args, *hit[:2], *hit[3:])),
            n, m.n_tris, ds.tri_shade.shape[0], m.n_spheres, S,
            len(m.instances), m.inst_vtri_base0)
        tracing.count("hit.kernel_lanes", n)
    return hit
