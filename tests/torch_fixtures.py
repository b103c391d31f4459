"""Scenes, rays and call recorders that the port's tests share with the
card check (chip_smoke.py).

- Rays at the walks' hard cases: `edge_rays` (the brute kernel's prefilter
  edges), `axis_rays` (zero direction components from node box planes),
  `at_t_limits` (t limits at each hit's t), and `path_rays`, the bunny
  frame's camera rays and their shadow rays.
- Holding a walk against its plain version: `EXACT` (the walks bit for bit
  with theirs), `axis_limits` and `compare_trees` (bvh8t, whose plain
  version walks another tree).
- Scenes: `repeated_triangles`, `emissive_box` and `textured_cubes` take
  either package's scene modules (they import neither package, so the
  tests build the JAX package's copy the same way); `write_glb` and
  `bunnies_glb` write glTF files; `tiny_frame` is
  tests/test_parallel.py's 37x27 checkered_plane.
- Shading: `bsdf_lanes` (seeded lanes for the BSDF dispatch), `coat_calls`
  and `shade_calls` (every coat or dispatch call of one render, its inputs
  cloned), at `COAT_SETTINGS`, the benchmark's pass; `hit_calls` (every
  hit_details call of one render, its inputs cloned).

Imports neither jax nor the JAX package (tests/test_torch_isolation.py).
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch

# closest-hit: equal-t ties between different leaves may pick different
# triangles (a kernel and its plain version may visit leaves in another
# order); the brute, quad, quadrow, pair and skip-link kernels repeat their
# plain versions' order bit for bit
EXACT = ("brute", "quad", "quadrow", "pair", "walk")
# the walks on the persistent grid redesigned after bvh8t: K4, K5 and K6
PERSISTENT = ("quad", "quadrow", "pair", "walk")
# axis rays from snapped box planes often run through a shared vertex or
# edge, where two walks that order leaves differently may pick different
# triangles at t within T_RTOL (tests/test_torch_walks.py's axis cases):
# a share of the live rays, which t limits at the hits do not change
AXIS_TIE_SHARE = 0.02
T_RTOL = 1e-5
# one 1-spp pass at the benchmark's settings (500x500 at the scene's
# camera, 4 light samples, depth 8): the lane counts of its coat and
# shading calls
COAT_SETTINGS = dict(samples_per_pixel=1, light_sample_count=4,
                     max_ray_depth=8)
# the BSDF dispatch's edge directions: the poles, grazing (z = 0 and
# +-1e-7), the axes and two diagonals
EDGE_DIRS = np.array(
    [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0], [0.6, 0.8, 0],
     [0.6, 0, 0.8], [1, 0, 1e-7], [0, -1, -1e-7], [0.8, 0, -0.6]],
    np.float32)
# bunnies_glb's four bunnies: (turn about z in degrees, scale, x, y)
BUNNY_NODES = ((0.0, 1.0, -0.55, -0.35), (90.0, 0.8, 0.55, -0.35),
               (200.0, 0.9, -0.5, 0.55), (300.0, 1.1, 0.5, 0.6))


def edge_rays(ds, n: int, seed: int) -> tuple:
    """Rays aimed at the edges of the brute kernel's prefilter on the
    triangle rows of ds's card layout, from either side at a random tilt: a
    quarter at vertices, a quarter on edges (u or v 0, u + v 1), a quarter
    just inside or outside an edge (by 1e-7, 1e-5, 1.2e-5, 2^-16 or 1.6e-5
    of the triangle), a quarter nearly parallel to the triangle (den near
    0, tilts of 0 to 1e-3). t_min 1e-4; half the lanes have a finite
    t_max; every 7th lane is inactive. Returns numpy (o, d, t_min, t_max,
    active)."""
    g = np.random.default_rng(seed)
    tris = ds.t8_card.tris.cpu().numpy().astype(np.float64)
    rows = g.integers(0, tris.shape[0], n)
    p0, e1, e2 = tris[rows, 0:3], tris[rows, 3:6], tris[rows, 6:9]

    def unit(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True),
                              1e-30)

    nrm = unit(np.cross(e1, e2))
    kind, side = g.integers(0, 4, n), g.integers(0, 3, n)
    w = g.uniform(0.0, 1.0, n)
    off = (np.array([1e-7, 1e-5, 1.2e-5, 2.0 ** -16, 1.6e-5])[
        g.integers(0, 5, n)] * g.choice([-1.0, 1.0], n))
    at = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])[side]  # vertices
    edge = np.stack([np.where(side == 0, w, 0.0),  # v = 0, u = 0, u + v = 1
                     np.where(side == 1, w, np.where(side == 2, 1 - w, 0.0))],
                    axis=1)
    edge[side == 2, 0] = w[side == 2]
    near = edge.copy()  # the edge moved out (off > 0) or in by `off`
    near[side == 0, 1] = -off[side == 0]
    near[side == 1, 0] = -off[side == 1]
    near[side == 2] *= (1.0 + off[side == 2])[:, None]
    uv = np.where((kind == 0)[:, None], at,
                  np.where((kind == 1)[:, None], edge,
                           np.where((kind == 2)[:, None], near,
                                    np.stack([w / 2, np.full(n, 0.25)], 1))))
    p = p0 + uv[:, :1] * e1 + uv[:, 1:] * e2
    size = np.linalg.norm(e1, axis=1) + np.linalg.norm(e2, axis=1)
    h = g.uniform(0.05, 2.0, n) * size * g.choice([-1.0, 1.0], n)
    o = p + nrm * h[:, None] + g.normal(0.0, 0.5, (n, 3)) * np.abs(h)[:, None]
    d = unit(p - o)
    flat = kind == 3  # nearly in the triangle's plane, through p
    tilt = np.array([0.0, 1e-7, 1e-5, 1e-3])[g.integers(0, 4, n)]
    d_flat = unit(unit(e1 - e2 * g.uniform(-1, 1, (n, 1)))
                  + nrm * (tilt * g.choice([-1.0, 1.0], n))[:, None])
    d = np.where(flat[:, None], d_flat, d)
    o = np.where(flat[:, None], p - d_flat * np.abs(h)[:, None], o)
    t_max = np.where(np.arange(n) % 2 == 0, np.inf,
                     g.uniform(0.5, 3.0, n) * np.abs(h))
    return (o.astype(np.float32), d.astype(np.float32),
            np.full(n, 1e-4, np.float32), t_max.astype(np.float32),
            np.arange(n) % 7 != 3)


def axis_rays(ds, n: int, seed: int) -> tuple:
    """Rays with zero direction components, from inside the scene's node
    boxes: each from a random point of a random box of bvh_nodes (the
    skip-link walk's; the BVH4 records keep a subset of them), along an axis
    (half the rays: one nonzero component) or a diagonal of two axes (the
    other half), its coordinate on each zero axis snapped to that box's
    min or max, so the slab test meets (box - o) * inf = 0 * inf = NaN
    there. t_min 1e-4, t_max inf; every 7th lane inactive. Returns numpy
    (o, d, t_min, t_max, active)."""
    g = np.random.default_rng(seed)
    nodes = ds.bvh_nodes_pk.cpu().numpy().reshape(-1, 8)[:int(
        ds.meta.n_bvh_nodes)]
    box = nodes[g.integers(0, nodes.shape[0], n)]
    lo, hi = box[:, 0:3], box[:, 3:6]
    o = (lo + g.uniform(0.0, 1.0, (n, 3)) * (hi - lo)).astype(np.float32)
    axis = g.integers(0, 3, n)
    two = np.arange(n) % 2 == 1  # a second nonzero axis
    other = (axis + g.integers(1, 3, n)) % 3
    nonzero = np.zeros((n, 3), bool)
    nonzero[np.arange(n), axis] = True
    nonzero[two, other[two]] = True
    sign = g.choice(np.float32([-1.0, 1.0]), (n, 3))
    size = np.where(two, np.float32(np.sqrt(0.5)), np.float32(1.0))
    d = np.where(nonzero, sign * size[:, None], np.float32(0.0))
    snap = np.where(g.integers(0, 2, (n, 3)) == 0, lo, hi)
    o = np.where(nonzero, o, snap).astype(np.float32)
    return (o, d.astype(np.float32), np.full(n, 1e-4, np.float32),
            np.full(n, np.inf, np.float32), np.arange(n) % 7 != 3)


def at_t_limits(args, t, best) -> list:
    """A ray batch with each hit lane's t limits at its hit: a third with
    t_min = t, a third with t_max = t, a third with t_max one float below
    t."""
    o, d, t_min, t_max, active = args
    hit = best >= 0
    k = torch.arange(t.shape[0], device=t.device) % 3
    below = torch.nextafter(t, torch.full_like(t, -float("inf")))
    return [o, d, torch.where(hit & (k == 0), t, t_min),
            torch.where(hit & (k == 1), t,
                        torch.where(hit & (k == 2), below, t_max)), active]


def path_rays(ds, settings) -> dict:
    """The frame's camera rays (sample 0) and their shadow rays toward the
    scene's first light from the primary hits: mode -> (origin,
    direction, t_min, t_max, active, early_exit), on ds's device."""
    from tpu_raytracing_torch.integrator.render import _pixel_grid
    from tpu_raytracing_torch.ops.camera_rays import generate_rays
    from tpu_raytracing_torch.ops.light_sampling import sample_light
    from tpu_raytracing_torch.ops.rng import SamplerConfig, make_stream
    from tpu_raytracing_torch.ops.traverse import intersect_scene

    dev = ds.device
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    px, py, _ = _pixel_grid(ds.meta.width, ds.meta.height)
    px = torch.from_numpy(px.astype(np.int64)).to(dev)
    py = torch.from_numpy(py.astype(np.int64)).to(dev)
    stream = make_stream(px, py, 0)
    o, d, _, _ = generate_rays(ds, px, py, cfg, stream,
                               settings.samples_per_pixel, True)
    n = o.shape[0]

    def full(v):
        return torch.full((n,), v, dtype=torch.float32, device=dev)

    t_min, far = full(ds.meta.near_clip), full(ds.meta.far_clip)
    t, prim = intersect_scene(ds, o, d, t_min, far)
    ls, _ = sample_light(ds, 0, torch.where((prim >= 0)[:, None],
                                            o + t[:, None] * d, 0.0),
                         cfg, stream)
    return {
        "closest_hit": (o, d, t_min, far,
                        torch.ones(n, dtype=torch.bool, device=dev), False),
        "any_hit": (ls.origin.contiguous(), ls.direction.contiguous(),
                    full(1e-3), ls.distance - 1e-3, prim >= 0, True),
    }


def axis_limits(ds, walk, kernel, plain, axis) -> tuple:
    """(t, best) to put an axis batch's t limits at (at_t_limits): the plain
    version's closest hits; for a walk not in EXACT only on the lanes where
    its kernel finds the same winner at the same t bits (best -1
    elsewhere), as tests/test_torch_walks.py::_hard_rays does."""
    tp, bp = plain(ds, *axis)
    if walk not in EXACT:
        tk, bk = kernel(ds, *axis)
        bp = torch.where((bk == bp) & (tk.view(torch.int32)
                                       == tp.view(torch.int32)), bp, -1)
    return tp, bp


def compare_trees(ds, mode, args, tk, bk, tp, bp, limit: int = 8) -> tuple:
    """Hold the bvh8t kernel against its plain version, which walks another
    tree (the XLA stack walk over the child-pair rows), on axis rays. Hit
    bits equal; winners equal but for ties (a different winner at t within
    T_RTOL, up to AXIS_TIE_SHARE of the live rays); t within T_RTOL. Except
    for fault F3 (ROADMAP section 3): a walk's box test can cull a box that
    holds a hit, (a) where the ray lies in the plane of a box face across
    which its direction is zero (0 * inf = NaN in the slab test), or (b)
    where the box's entry t rounds above the hit's t and t_best lies
    between them (t_max at a hit's t), so the hit is lost in the tree that
    has that box and found in the other. A lane outside the contract passes
    as F3 only where the brute force plain version, which culls nothing,
    finds a hit too: at the nearer of the two walks' t (within T_RTOL) in
    closest-hit. Prints the first `limit` lanes outside the contract (the
    ray, both answers, the brute force's). Returns (ok, report)."""
    from tpu_raytracing_torch.ops.traverse_kernels import (
        intersect_tris_brute_plain,
    )

    tk, bk, tp, bp = (x.cpu().numpy() for x in (tk, bk, tp, bp))
    hits = bk >= 0
    mismatch = hits != (bp >= 0)
    if mode == "any_hit":
        rest, ties = mismatch, np.zeros_like(mismatch)
    else:
        close = np.isclose(tk, tp, rtol=T_RTOL, atol=0.0)
        ties = (bk != bp) & hits & ~mismatch & close
        rest = (bk != bp) & ~ties
    lanes = np.nonzero(rest)[0]
    f3 = np.zeros(lanes.size, bool)
    if lanes.size:
        sub = torch.from_numpy(lanes).to(args[0].device)
        tb, bb = (x.cpu().numpy() for x in intersect_tris_brute_plain(
            ds, *[x[sub] for x in args]))
        near = np.minimum(np.where(bk[lanes] >= 0, tk[lanes], np.inf),
                          np.where(bp[lanes] >= 0, tp[lanes], np.inf))
        f3 = (bb >= 0) & (mode == "any_hit"
                          or np.isclose(near, tb, rtol=T_RTOL, atol=0.0))
        o, d, t_min, t_max, _ = (x.cpu().numpy() for x in args)
        for j, i in enumerate(lanes[:limit]):
            print(f"#   lane {i}{' (F3)' if f3[j] else ''}: o {o[i].tolist()} "
                  f"d {d[i].tolist()} t_min {t_min[i]!r} t_max {t_max[i]!r}: "
                  f"kernel ({tk[i]!r}, {bk[i]}), plain ({tp[i]!r}, {bp[i]}), "
                  f"brute force ({tb[j]!r}, {bb[j]})", flush=True)
        if lanes.size > limit:
            print(f"#   ... {lanes.size - limit} more lanes", flush=True)
    same = hits & (bk == bp)
    t_ok = bool(np.allclose(tk[same], tp[same], rtol=T_RTOL, atol=0.0))
    few = ties.sum() <= AXIS_TIE_SHARE * int(args[4].sum())
    ok = bool(f3.all()) and few and t_ok
    return ok, (
        f"{bk.shape[0]} rays, {int(hits.sum())} hits, {int(mismatch.sum())} "
        f"hit-bit mismatches, {int(ties.sum())} equal-t ties, {int(f3.sum())} "
        f"lanes of fault F3 (a hit the brute force finds, in a box one tree "
        f"culls), {int((~f3).sum())} other differences")


def _scene_modules(tmod, mmod, geom):
    """The port's scene, materials and geometry modules unless given."""
    if tmod is None:
        import tpu_raytracing_torch.geometry as geom
        import tpu_raytracing_torch.materials as mmod
        import tpu_raytracing_torch.scene.test_scenes as tmod
    return tmod, mmod, geom


def emissive_box(tmod=None, mmod=None, geom=None):
    """The Cornell box template (cornell_box(): five walls, a point light
    under the ceiling, a 500x500 camera) with a 0.5 x 0.5 quad just under
    the ceiling that emits (5, 5, 5) down into the box. Built from the
    port's modules, or from the ones given (tests build the JAX package's
    copy the same way)."""
    tmod, mmod, geom = _scene_modules(tmod, mmod, geom)
    sb = tmod.cornell_box()
    quad = tmod.make_plane(  # wound to face down
        tmod.v3(-0.25, -0.25, 1.49), tmod.v3(-0.25, 0.25, 1.49),
        tmod.v3(0.25, 0.25, 1.49), tmod.v3(0.25, -0.25, 1.49),
        tmod.v3(0, 0, -1))
    white = sb.add_constant_texture(tmod.v4(1, 1, 1, 1))
    mat = sb.add_material(mmod.Diffuse(albedo=white))
    sb.add_shape_with_transform(
        geom.TriangleMesh(quad), mat, geom.Transform.identity(),
        area_light_radiance=np.array([5.0, 5.0, 5.0], np.float32))
    return sb.build()


def repeated_triangles(tmod=None, mmod=None, geom=None):
    """A mesh of 12 seeded triangles that overlap in depth, each listed 20
    times, under a 32x32 camera at the origin looking down -z: the bvh8t
    layout splits the copies of a triangle over two groups of 10, so a ray
    meets equal-t ties inside a group and across groups. Modules as
    emissive_box's."""
    tmod, mmod, geom = _scene_modules(tmod, mmod, geom)
    g = np.random.default_rng(3)
    verts, tris = [], []
    for k in range(12):
        c = np.array([(k % 3) * 0.5 - 0.5, (k // 3 % 2) * 0.5 - 0.25,
                      -2.0 - 0.25 * k])
        verts.extend(c + g.uniform(-0.5, 0.5, (3, 3)) * [1.0, 1.0, 0.1])
        tris.extend([[3 * k, 3 * k + 1, 3 * k + 2]] * 20)
    sb = tmod.SceneBuilder()
    white = sb.add_constant_texture(tmod.v4(1, 1, 1, 1))
    mat = sb.add_material(mmod.Diffuse(albedo=white))
    mesh = tmod.make_mesh(np.array(verts, np.float32), tris,
                          np.tile([0.0, 0.0, 1.0], (len(verts), 1)))
    sb.add_shape_at_position(geom.TriangleMesh(mesh), mat, tmod.v3(0, 0, 0))
    sb.add_camera(tmod.Camera.lookat_camera_perspective(
        tmod.v3(0, 0, 0), tmod.v3(0, 0, -3), tmod.v3(0, 1, 0), False,
        np.deg2rad(60.0), 32, 32))
    return sb.build()


def textured_cubes(size: int, tmod=None, mmod=None, geom=None):
    """Three cubes in a row under a size x size camera, uv from -1.25 to
    2.5 on every face, whose albedos are: a seeded 48x40 image, TRILINEAR
    and MIRROR (its pyramid pads to 64x64); that image scaled by a
    checker; and a mix of the two by a constant. Modules as emissive_box's."""
    tmod, mmod, geom = _scene_modules(tmod, mmod, geom)
    sb = tmod.SceneBuilder()
    data = np.random.default_rng(7).uniform(0.05, 1.0, (40, 48, 3))
    img = sb.add_image(mmod.Image(data.astype(np.float32)))
    image = sb.add_texture(mmod.ImageTexture(
        image=img, sampler=mmod.TextureSampler(
            filter=mmod.FilterMode.TRILINEAR, wrap=mmod.WrapMode.MIRROR)))
    checker = sb.add_texture(mmod.CheckerTexture(
        color1=tmod.v4(0.9, 0.8, 0.2, 1), color2=tmod.v4(0.1, 0.3, 0.7, 1)))
    scale = sb.add_texture(mmod.ScaleTexture(a=image, b=checker))
    c = sb.add_constant_texture(tmod.v4(0.3, 0.3, 0.3, 1))
    mix = sb.add_texture(mmod.MixTexture(a=image, b=scale, c=c))
    face_uv = np.array([[-1.25, -1.25], [2.5, -1.25], [2.5, 2.5],
                        [-1.25, 2.5]], np.float32)
    for x, tex in ((-1.3, image), (0.0, scale), (1.3, mix)):
        mesh = tmod.make_cube(1.0)
        mesh.uvs = np.tile(face_uv, (6, 1))
        mat = sb.add_material(mmod.Diffuse(albedo=tex))
        sb.add_shape_at_position(geom.TriangleMesh(mesh), mat,
                                 tmod.v3(x, 0, -4))
    sb.add_camera(tmod.Camera.lookat_camera_perspective(
        tmod.v3(0, 1.5, 0), tmod.v3(0, 0, -4), tmod.v3(0, 1, 0), False,
        np.deg2rad(45.0), size, size))
    return sb.build()


def _lookat_matrix(eye, target, up) -> np.ndarray:
    """Row-major camera-to-world matrix of a glTF camera node (it looks
    down its local -z, +y up) at `eye` facing `target`."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    back = eye - target
    back /= np.linalg.norm(back)
    right = np.cross(up, back)
    right /= np.linalg.norm(right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2] = right, np.cross(back, right), back
    m[:3, 3] = eye
    return m


def write_glb(path, meshes, nodes, materials, camera, light) -> None:
    """Write a binary glTF 2.0 scene that both packages' loaders read.

    meshes: (vertices (V, 3), normals (V, 3), triangles (T, 3), material
    index) each; nodes: (mesh index, row-major 4x4 matrix) each, in scene
    order, the camera node and the light node after them; materials: the
    base colour (r, g, b) of a diffuse material each; camera: (eye, target,
    up, yfov in radians), aspect 1; light: a KHR_lights_punctual point light
    (position, colour, intensity). Two nodes that name one mesh make the
    loader emit one primitive under two transforms (an instance)."""
    blob = bytearray()
    views, accessors, gmeshes = [], [], []

    def add(arr, target_type, acc_type, comp):
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": arr.nbytes})
        blob.extend(arr.tobytes())
        acc = {"bufferView": len(views) - 1, "componentType": comp,
               "count": int(arr.shape[0]), "type": acc_type}
        if target_type == "POSITION":
            acc["min"] = arr.min(axis=0).tolist()
            acc["max"] = arr.max(axis=0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    for verts, norms, tris, mat in meshes:
        pos = add(np.ascontiguousarray(verts, np.float32), "POSITION",
                  "VEC3", 5126)
        nrm = add(np.ascontiguousarray(norms, np.float32), "NORMAL",
                  "VEC3", 5126)
        idx = add(np.ascontiguousarray(tris, np.uint32).reshape(-1, 1),
                  "", "SCALAR", 5125)
        gmeshes.append({"primitives": [{
            "attributes": {"POSITION": pos, "NORMAL": nrm},
            "indices": idx, "material": int(mat)}]})
    gnodes = [{"mesh": int(mi),
               "matrix": np.asarray(m, np.float64).T.reshape(-1).tolist()}
              for mi, m in nodes]
    eye, target, up, yfov = camera
    gnodes.append({"camera": 0, "matrix": _lookat_matrix(eye, target, up)
                   .T.reshape(-1).tolist()})
    pos, color, intensity = light
    gnodes.append({"translation": [float(v) for v in pos],
                   "extensions": {"KHR_lights_punctual": {"light": 0}}})
    tree = {
        "asset": {"version": "2.0"},
        "extensionsUsed": ["KHR_lights_punctual"],
        "extensions": {"KHR_lights_punctual": {"lights": [{
            "type": "point", "color": [float(c) for c in color],
            "intensity": float(intensity)}]}},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(gnodes)))}],
        "nodes": gnodes,
        "meshes": gmeshes,
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [float(c) for c in rgb] + [1.0],
            "metallicFactor": 0.0, "roughnessFactor": 1.0}}
            for rgb in materials],
        "cameras": [{"type": "perspective", "perspective": {
            "yfov": float(yfov), "aspectRatio": 1.0, "znear": 0.01,
            "zfar": 100.0}}],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    js = json.dumps(tree).encode()
    js += b" " * (-len(js) % 4)
    blob.extend(b"\0" * (-len(blob) % 4))
    chunks = (struct.pack("<II", len(js), 0x4E4F534A) + js
              + struct.pack("<II", len(blob), 0x004E4942) + bytes(blob))
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(chunks)))
        f.write(chunks)


def _z_turn(deg: float, scale: float, x: float, y: float) -> np.ndarray:
    """Row-major matrix: a turn about +z, a uniform scale, a shift in xy."""
    a = np.deg2rad(deg)
    m = np.eye(4)
    m[:2, :2] = scale * np.array([[np.cos(a), -np.sin(a)],
                                  [np.sin(a), np.cos(a)]])
    m[2, 2] = scale
    m[:2, 3] = x, y
    return m


def bunnies_glb(path, instanced: bool) -> None:
    """A glTF scene of the port's bunny mesh (28,576 triangles)
    under the four transforms of BUNNY_NODES on a 3 x 3 two-triangle floor,
    a camera above the front edge and one point light, diffuse materials.
    instanced: the four nodes name one mesh (four instances over one
    BLAS); else each names its own mesh entry, and all is baked
    world-space."""
    from tpu_raytracing_torch.scene.test_scenes import load_bunny

    b = load_bunny()
    bunny = (b.vertices, b.normals, b.tris, 0)
    floor = (np.array([[-1.5, -1.5, 0], [1.5, -1.5, 0], [1.5, 1.5, 0],
                       [-1.5, 1.5, 0]]), np.tile([[0.0, 0.0, 1.0]], (4, 1)),
             np.array([[0, 1, 2], [0, 2, 3]]), 1)
    n = len(BUNNY_NODES)
    meshes = [floor] + [bunny] * (1 if instanced else n)
    nodes = [(0, np.eye(4))] + [(1 if instanced else 1 + k, _z_turn(*xf))
                                for k, xf in enumerate(BUNNY_NODES)]
    write_glb(path, meshes, nodes, materials=[(0.8, 0.3, 0.2),
                                              (0.7, 0.7, 0.7)],
              camera=((0.0, -2.8, 1.6), (0.0, 0.1, 0.3), (0.0, 0.0, 1.0),
                      np.deg2rad(45.0)),
              light=((0.6, -1.0, 2.6), (1.0, 1.0, 1.0), 20.0))


def tiny_frame():
    """checkered_plane with tests/test_parallel.py's 37x27 camera and
    settings (the port's scene modules): (scene, settings)."""
    from tpu_raytracing_torch.scene.camera import create_perspective_transform
    from tpu_raytracing_torch.scene.test_scenes import get_test_scene

    ts = get_test_scene("checkered_plane")
    scene = ts.scene_func()
    cam = scene.camera
    w, h = 37, 27
    c2r = create_perspective_transform(
        cam.far_clip, cam.near_clip, cam.camera_type.yfov, w, h)
    cam.raster_width, cam.raster_height = w, h
    cam.world_to_raster = cam.camera_to_world.invert().compose(c2r)
    cam.raster_to_camera = c2r.invert()
    settings = ts.settings_func()
    settings.samples_per_pixel = 2
    settings.light_sample_count = 1
    settings.max_ray_depth = 2
    return scene, settings


def bsdf_lanes(n: int, seed: int, kinds=(0, 1, 2, 3, 4, 5), edge=0.05):
    """Seeded lanes for the BSDF dispatch, on the CPU: (params, wo, wi,
    stream). Kinds drawn from `kinds`; dielectric indices 1 to 2.5 and
    exactly 1; conductors' eta 0.1 to 3 and kappa 0 to 6 per channel
    (zero kappa on some); roughness 1e-3 to 0.8, anisotropic on half the
    rough lanes; coats as tests/test_torch_cuda.py's. wo and wi lie in
    either hemisphere, an `edge` share of each on EDGE_DIRS; wo from below
    a dielectric at grazing angles reflects totally. The stream starts at
    seeded dimensions."""
    from tpu_raytracing_torch.ops import bsdf as B
    from tpu_raytracing_torch.ops.rng import make_stream

    g = np.random.default_rng(seed)

    def unit(v):
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    kind = g.choice(np.asarray(kinds, np.int32), n)
    conductor = (kind == 2) | (kind == 4)
    eta_d = np.where(g.random(n) < 0.05, 1.0, 1.0 + 1.5 * g.random(n))
    eta = np.where(conductor[:, None], 0.1 + 2.9 * g.random((n, 3)),
                   np.repeat(eta_d[:, None], 3, 1))
    kappa = np.where((g.random(n) < 0.1)[:, None], 0.0,
                     6.0 * g.random((n, 3)))
    ax = np.where(g.random(n) < 0.1, 1e-3, 1e-3 + 0.8 * g.random(n))
    ay = np.where(g.random(n) < 0.5, ax, 1e-3 + 0.8 * g.random(n))
    wo = unit(g.normal(size=(n, 3)))
    wi = unit(g.normal(size=(n, 3)))
    for d in (wo, wi):
        pick = g.random(n) < edge
        d[pick] = unit(EDGE_DIRS[g.integers(0, len(EDGE_DIRS), pick.sum())])
    medium = np.where((g.random(n) < 0.3)[:, None], 0.0, g.random((n, 3)))
    params = B.BsdfParams(
        kind=kind, albedo=g.random((n, 3)), eta=eta, kappa=kappa,
        alpha_x=ax, alpha_y=ay,
        top_kind=np.where(np.maximum(ax, ay) <= 1e-3, 1, 3).astype(np.int32),
        thickness=0.01 + g.random(n), coat_albedo=medium)
    params = B.BsdfParams(*(
        torch.from_numpy(np.asarray(
            x, np.int32 if x.dtype == np.int32 else np.float32))
        for x in params))
    px = torch.from_numpy(g.integers(0, 500, n))
    py = torch.from_numpy(g.integers(0, 500, n))
    stream = make_stream(px, py, int(g.integers(0, 32)))
    stream = stream._replace(dim=torch.from_numpy(g.integers(0, 40, n)))
    return (params, torch.from_numpy(wo.astype(np.float32)),
            torch.from_numpy(wi.astype(np.float32)), stream)


def coat_calls(scene, settings) -> list:
    """Every coat call of one render of `scene` on cuda, its inputs cloned
    as the dispatch hands them over: (kind, params, wo, wi or draw_base),
    kind "eval" or "sample"."""
    from unittest import mock

    from tpu_raytracing_torch.integrator.render import render
    from tpu_raytracing_torch.ops import bsdf_dispatch as D
    from tpu_raytracing_torch.ops import layered as L

    calls = []

    def recorder(kind, fn):
        def run(params, wo, third):
            calls.append((kind, type(params)(*(x.clone() for x in params)),
                          wo.clone(), third.clone()))
            return fn(params, wo, third)
        return run

    with mock.patch.object(D, "layered_eval",
                           recorder("eval", L.layered_eval)), \
            mock.patch.object(D, "layered_sample",
                              recorder("sample", L.layered_sample)):
        render(scene, settings)
    return calls


def shade_calls(scene, settings) -> list:
    """Every BSDF dispatch call of one render of `scene` on cuda, its
    inputs cloned as the integrator hands them over: ("eval", params, wo,
    wi, kinds, active) or ("sample", params, wo, allowed, cfg, stream,
    kinds, active)."""
    from unittest import mock

    from tpu_raytracing_torch.integrator import render as R

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(clone(v) for v in x))
        return x

    calls = []

    def recorder(kind, fn):
        def run(*args, **kwargs):
            calls.append((kind, *(clone(a) for a in args),
                          clone(kwargs.get("active"))))
            return fn(*args, **kwargs)
        return run

    with mock.patch.object(R, "bsdf_eval", recorder("eval", R.bsdf_eval)), \
            mock.patch.object(R, "bsdf_sample",
                              recorder("sample", R.bsdf_sample)):
        R.render(scene, settings)
    return calls


def hit_calls(scene, settings, device="cuda") -> list:
    """Every hit_details call of one render of `scene` on `device`, its
    inputs cloned as the integrator hands them over: (ds, origin,
    direction, t, prim)."""
    from unittest import mock

    from tpu_raytracing_torch.integrator import render as R

    calls, fn = [], R.hit_details

    def run(ds, *args):
        calls.append((ds, *(x.clone() for x in args)))
        return fn(ds, *args)

    with mock.patch.object(R, "hit_details", run):
        R.render(scene, settings, device=device)
    return calls
