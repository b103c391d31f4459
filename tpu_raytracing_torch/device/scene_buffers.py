"""Scene -> torch tensors on one device ("compile" the scene for the port).

Counterpart of tpu_raytracing/device/scene_buffers.py, restricted to the
leaves the ported slice reads. The layout functions are the JAX package's
numpy code, ported line for line so that every table is byte-identical to
the JAX scene's leaf of the same name (tests/test_torch_scene.py): the
traversal tables of every walk the JAX kernel switch selects (bvh8t,
skip-link, child-pair, BVH4 and its row records), the shading rows, the
object-space sphere tables, the material and texture tables with the image
mip atlas, the light tables with the area-light emitter rows, the camera
tables, and the instance tables: one object-space BLAS (`BlasTables`) per
mesh that several transform chains share, with each instance's transforms
and world box.

The scene description it reads (scene, geometry, accel, materials,
lights) is the port's own copy of the JAX package's host modules; the port
imports nothing of tpu_raytracing and never imports jax.

Scene features outside the slice raise NotImplementedError and name the
ROADMAP.md item that brings them.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from ..accel import build_bvh
from ..geometry import Sphere, Transform, TriangleMesh
from ..geometry.matrix import apply_point as _np_apply_point
from ..lights import DiffuseAreaLight, DirectionLight, PointLight
from ..materials import (
    CheckerTexture, CoatedDiffuse, ConstantTexture, Diffuse, FilterMode,
    ImageTexture, MixTexture, RoughConductor, RoughDielectric, ScaleTexture,
    SmoothConductor, SmoothDielectric,
)
from ..scene import BasicPrimitive, Scene
from ..scene.camera import (
    Orthographic, PinholePerspective, ThinLensPerspective,
)

F = np.float32

# material kinds
MAT_DIFFUSE = 0
MAT_SMOOTH_DIELECTRIC = 1
MAT_SMOOTH_CONDUCTOR = 2
MAT_ROUGH_DIELECTRIC = 3
MAT_ROUGH_CONDUCTOR = 4
MAT_COATED_DIFFUSE = 5

# texture kinds
TEX_IMAGE = 0
TEX_CONSTANT = 1
TEX_CHECKER = 2
TEX_SCALE = 3
TEX_MIX = 4

# light kinds
LIGHT_POINT = 0
LIGHT_DIRECTION = 1
LIGHT_AREA = 2

# camera kinds
CAM_ORTHOGRAPHIC = 0
CAM_PINHOLE = 1
CAM_THIN_LENS = 2

# bvh8t layout at the JAX package's defaults (TPU_RT_T8_W / TPU_RT_T8_LG)
T8_WIDTH = 16
T8_LEAF = 16
N8_PER_BLOCK = 16  # nodes per node block (8 columns each)
G8_PER_BLOCK = 12  # tri groups per tri block (10 columns each)

# shared meshes below this size are baked world-space, as are emissive ones
# (the JAX package's INSTANCE_MIN_TRIS: same variable, same default, read
# at import)
INSTANCE_MIN_TRIS = int(os.environ.get("TPU_RT_INSTANCE_MIN_TRIS", "16"))

# f32 words of a triangle row of the bvh8t card layout (csrc/bvh8t_walk.cu)
T8_ROW_WORDS = 12


def _unsupported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is outside the ported slice (ROADMAP.md: {item})"
    )


@dataclass(frozen=True)
class SceneMeta:
    """Static scene facts the slice branches on (a subset of the JAX
    SceneMeta, same field names and values)."""

    n_tris: int
    n_spheres: int
    light_kinds: Tuple[int, ...]
    mat_kinds_present: Tuple[int, ...]
    tex_kinds_present: Tuple[int, ...]
    any_trilinear: bool
    any_nearest: bool
    has_env: bool
    env_tex: int
    cam_kind: int
    width: int
    height: int
    near_clip: float
    far_clip: float
    aperture_radius: float
    focal_distance: float
    root_meta: int
    bvh2_depth: int
    n_bvh_nodes: int   # unpadded BVH node count = skip-link walk sentinel
    root_meta4: int    # quad (BVH4) walk root meta
    bvh4_stack: int    # quad walk stack bound
    root_meta4r: int   # quadrow root meta (leaf numbering of tri_rows)
    t8_stack: int
    t8_width: int
    t8_leaf: int
    # texture kinds reachable from each material slot / the env texture
    slot_kinds: Tuple[Tuple[int, ...], ...] = ()
    env_kinds: Tuple[int, ...] = ()
    # per BLAS: (n_tris, root_meta, bvh2_depth, root_meta4, bvh4_stack,
    # n_nodes, root_meta4r, t8_stack)
    blas_meta: Tuple[Tuple[int, ...], ...] = ()
    # per instance: (blas_id, vtri_base, n_tris, shade_off)
    instances: Tuple[Tuple[int, int, int, int], ...] = ()
    # first virtual-triangle prim id (n_tris + padded sphere count)
    inst_vtri_base0: int = 0


@dataclass(frozen=True)
class Bvh8tCard:
    """The bvh8t walk's card layout (csrc/bvh8t_walk.cu), a pure function of
    the JAX-identical t8 tables (`bvh8t_card_layout`)."""

    nodes: torch.Tensor     # (N8, 4) i32: first child record, n_int,
                            # n_leaf, child_base
    children: torch.Tensor  # (C, 8) f32: box min3 max3, link, rows (bits)
    tris: torch.Tensor      # (R, 12) f32: p0 e1 e2, id bits, 2 zero words


class AccelMeta(NamedTuple):
    """The statics a triangle walk reads, under SceneMeta's names: the main
    tables' are fields of SceneMeta, a BLAS's its `blas_meta` row."""

    n_tris: int
    root_meta: int
    bvh2_depth: int
    root_meta4: int
    bvh4_stack: int
    n_bvh_nodes: int
    root_meta4r: int
    t8_stack: int
    t8_width: int
    t8_leaf: int


@dataclass(frozen=True)
class BlasTables:
    """One shared BLAS: a mesh's object-space traversal tables, built once
    however many instances use it (the JAX BlasTables, same leaf names),
    with its bvh8t card layout and its statics. It has the attributes the
    walks read from a DeviceScene, so every walk takes one in its place
    (ops/traverse_kernels.py::accel_of)."""

    bvh2_rows: torch.Tensor
    tri_pack: torch.Tensor
    bvh4_recs_pk: torch.Tensor
    bvh2_rows_pk: torch.Tensor
    bvh_nodes_pk: torch.Tensor
    tri_pack_pk: torch.Tensor
    bvh4_rows: torch.Tensor
    tri_rows: torch.Tensor
    t8_nodes: torch.Tensor
    t8_meta: torch.Tensor
    t8_tris: torch.Tensor
    t8_card: Bvh8tCard
    meta: AccelMeta


BLAS_LEAF_NAMES = tuple(f.name for f in dataclasses.fields(BlasTables)
                        if f.name not in ("meta", "t8_card"))


@dataclass
class DeviceScene:
    """The slice's scene tables as torch tensors on one device."""

    bvh2_rows: torch.Tensor      # (M, 16) f32 child-pair rows (plain walk)
    tri_pack: torch.Tensor       # (T, 9) f32 p0 p1 p2 (plain walk)
    bvh_nodes: torch.Tensor      # (N8, 8) f32 skip-link node records
    bvh_nodes_pk: torch.Tensor   # (ceil(N/16), 128) f32, 16 node records/row
    tri_pack_pk: torch.Tensor    # (ceil(T/8), 128) f32, 8 tri records/row
    bvh2_rows_pk: torch.Tensor   # (M/8, 128) f32, 8 child-pair records/row
    bvh4_recs_pk: torch.Tensor   # (K/4, 128) f32, 4 quad records/row
    bvh4_rows: torch.Tensor      # (K8, 128) f32, one quad record/row
    tri_rows: torch.Tensor       # (L, 128) f32, one leaf's tris/row + ids
    t8_nodes: torch.Tensor       # (Nb*W, 128) f32 bvh8t node blocks
    t8_meta: torch.Tensor        # (N8, 2) i32 child/leaf base + counts
    t8_tris: torch.Tensor        # (Gb*LG, 128) f32 bvh8t tri groups
    tri_shade: torch.Tensor      # (T, 32) f32 shading rows
    sph_center: torch.Tensor     # (S8, 3) f32 object-space centers
    sph_radius: torch.Tensor     # (S8,) f32, 0 on padding
    sph_o2w: torch.Tensor        # (S8, 4, 4) f32 object to world
    sph_w2o: torch.Tensor        # (S8, 4, 4) f32 world to object
    sph_mat: torch.Tensor        # (S8,) i32
    sph_light: torch.Tensor      # (S8,) i32, -1 = not an emitter
    mat_kind: torch.Tensor       # (M,) i32
    mat_tex: torch.Tensor        # (M, 5) i32 texture ids, -1 = unset
    mat_remap: torch.Tensor      # (M,) bool remap_roughness
    mat_pack: torch.Tensor       # (M, 8) i32 kind, tex0..4, remap
    mat_tex_rows: torch.Tensor   # (M, 80) f32 the 5 slot texture rows
    tex_pack: torch.Tensor       # (X, 16) f32 v0, v1, bits[ref0/first
                                 # level, ref1, ref2, kind, filter, wrap,
                                 # n_levels]
    img_texels: torch.Tensor     # (P, 4) f32 mip atlas, every level
    lvl_pack: torch.Tensor       # (LV, 4) i32 offset, w, h of each level
    light_kind: torch.Tensor     # (L,) i32
    light_va: torch.Tensor       # (L, 3) position / direction
    light_vb: torch.Tensor       # (L, 3) intensity / radiance
    light_emit_first: torch.Tensor  # (L,) i32 first em_shade row
    light_emit_count: torch.Tensor  # (L,) i32 emitter triangles
    em_shade: torch.Tensor       # (E, 24) f32 p0 p1 p2 n0 n1 n2 area
                                 # bits(has_n)
    cam_raster_to_camera: torch.Tensor  # (4, 4)
    cam_camera_to_world: torch.Tensor   # (4, 4)
    cam_min_diff: torch.Tensor          # (4, 3)
    bounds_center: torch.Tensor  # (3,)
    bounds_radius: torch.Tensor  # () f32
    inst_xf: torch.Tensor        # (max(1, I), 32) f32 o2w | w2o row-major
    inst_aabb_min: torch.Tensor  # (max(1, I), 3) f32 instance world box
    inst_aabb_max: torch.Tensor
    t8_card: Bvh8tCard           # the bvh8t kernel's layout of t8_*
    blas_tables: Tuple[BlasTables, ...]
    meta: SceneMeta

    @property
    def device(self) -> torch.device:
        return self.tri_shade.device


# what a triangle walk reads (ops/traverse_kernels.py::accel_of): the main
# tables of a scene or one of its BLASes
Accel = Union[DeviceScene, BlasTables]

# the tables that have a JAX leaf of the same name
LEAF_NAMES = tuple(
    f.name for f in dataclasses.fields(DeviceScene)
    if f.name not in ("meta", "t8_card", "blas_tables")
)


def _pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    if a.shape[0] >= n:
        return a
    pad = np.full((n - a.shape[0], *a.shape[1:]), fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def _flatten_primitives(scene: Scene):
    """(BasicPrimitive, prim_index, composed world Transform) per leaf."""
    out = []

    def walk(agg_idx: int, outer: Transform):
        for i in range(len(scene.get_aggregate(agg_idx).children)):
            idx, t = scene.get_descendant(agg_idx, i)
            composed = t.compose(outer)
            prim = scene.get_primitive(idx)
            if isinstance(prim, BasicPrimitive):
                out.append((prim, idx, composed))
            else:
                walk(idx, composed)

    walk(scene.root_index(), Transform.identity())
    return out


def _child_pair_layout(bvh):
    """Child-pair rows for the plain stack walk: (rows, root_meta, depth)."""
    count = bvh.count
    n_nodes = count.shape[0]
    is_int = count == 0
    if bvh.prim_order.shape[0] == 0:
        return np.zeros((8, 16), F), -1, 1
    row_of = np.full(n_nodes, -1, np.int64)
    row_of[np.nonzero(is_int)[0]] = np.arange(int(is_int.sum()))
    m = int(is_int.sum())
    if m == 0:
        root_meta = (int(bvh.left_first[0]) << 3) | int(count[0])
        return np.zeros((8, 16), F), root_meta, 1

    ints = np.nonzero(is_int)[0]
    left = ints + 1
    right = bvh.skip[left].astype(np.int64)

    def child_metas(c):
        leaf = count[c] > 0
        return np.where(
            leaf,
            (bvh.left_first[c].astype(np.int64) << 3) | count[c],
            row_of[c] << 3,
        ).astype(np.int32)

    rows = np.zeros((m, 16), F)
    rows[:, 0:3] = bvh.node_min[left]
    rows[:, 3:6] = bvh.node_max[left]
    rows[:, 6:9] = bvh.node_min[right]
    cl = (bvh.node_min[left] + bvh.node_max[left]) * 0.5
    cr = (bvh.node_min[right] + bvh.node_max[right]) * 0.5
    axis = np.argmax(np.abs(cr - cl), axis=1).astype(np.int32)
    rows[:, 14] = axis.view(F)
    rows[:, 9:12] = bvh.node_max[right]
    rows[:, 12] = child_metas(left).view(F)
    rows[:, 13] = child_metas(right).view(F)

    depth = np.zeros(n_nodes, np.int64)
    for i in ints:  # preorder: a parent precedes its children
        lc = i + 1
        rc = int(bvh.skip[lc])
        depth[lc] = depth[rc] = depth[i] + 1
    maxd = int(depth.max()) + 1
    rows = _pad_rows(rows, _round_up(m, 8))
    return rows, 0, maxd


def _bvh4_layout(bvh):
    """Collapse the BVH2 into 4-wide records for the Pallas quad walk.

    Each BVH4 record covers two BVH2 levels: its children are the 2-4
    grandchildren (or leaf children) of a BVH2 internal node. Record = 32
    f32: 4 child AABBs (24), 4 child metas (leaf -> (first<<3)|count,
    internal -> bvh4_row<<3, -1 -> absent), packed order axes, pad.
    Returns (records (K, 32) f32, root_meta4, stack_bound).
    """
    count = bvh.count
    if bvh.prim_order.shape[0] == 0:
        return np.zeros((4, 32), F), -1, 4
    if count[0] > 0:  # single-leaf tree
        root_meta = (int(bvh.left_first[0]) << 3) | int(count[0])
        return np.zeros((4, 32), F), root_meta, 4

    left_of = lambda i: i + 1  # noqa: E731
    right_of = lambda i: int(bvh.skip[i + 1])  # noqa: E731

    def split_axis(i):
        l, r = left_of(i), right_of(i)
        cl = (bvh.node_min[l] + bvh.node_max[l]) * 0.5
        cr = (bvh.node_min[r] + bvh.node_max[r]) * 0.5
        return int(np.argmax(np.abs(cr - cl)))

    # BFS over BVH2 internals that become BVH4 records
    row_of = {}
    order = []

    def visit(i):
        row_of[i] = len(order)
        order.append(i)

    visit(0)
    qi = 0
    children_of = {}
    while qi < len(order):
        n = order[qi]
        qi += 1
        kids = []  # (bvh2 node id, is_leaf)
        for c in (left_of(n), right_of(n)):
            if count[c] > 0:
                kids.append((c, True))
            else:
                kids.append((left_of(c), count[left_of(c)] > 0))
                kids.append((right_of(c), count[right_of(c)] > 0))
        children_of[n] = kids
        for c, is_leaf in kids:
            if not is_leaf and c not in row_of:
                visit(c)

    k = len(order)
    recs = np.zeros((k, 32), F)
    metas = np.full((k, 4), -1, np.int32)
    axes = np.zeros(k, np.int32)
    for r, n in enumerate(order):
        kids = children_of[n]
        # order axes: top split + per-half splits (identity when a half
        # was not collapsed)
        a_top = split_axis(n)
        l, rr = left_of(n), right_of(n)
        a_l = split_axis(l) if count[l] == 0 else a_top
        a_r = split_axis(rr) if count[rr] == 0 else a_top
        nleft = 2 if count[l] == 0 else 1
        axes[r] = (
            a_top | (a_l << 2) | (a_r << 4) | (len(kids) << 6) | (nleft << 9)
        )
        for j, (c, is_leaf) in enumerate(kids):
            recs[r, j * 6 : j * 6 + 3] = bvh.node_min[c]
            recs[r, j * 6 + 3 : j * 6 + 6] = bvh.node_max[c]
            if is_leaf:
                metas[r, j] = (int(bvh.left_first[c]) << 3) | int(count[c])
            else:
                metas[r, j] = row_of[c] << 3
        # when the left/right half was NOT collapsed (child was a leaf),
        # kids has fewer than 4 entries; j indexes stay compact and the
        # in-kernel order logic uses the child count
    recs[:, 24:28] = metas.view(F)
    recs[:, 28] = axes.view(F)

    # stack bound: ≤3 pushes per record level; record depth ≈ ceil(d2/2)
    d2 = 1
    depth = {0: 0}
    for n in order:
        for c, is_leaf in children_of[n]:
            if not is_leaf:
                depth[c] = depth[n] + 1
                d2 = max(d2, depth[c] + 1)
    bound = 3 * (d2 + 2)
    pad = -k % 4
    if pad:
        recs = np.concatenate([recs, np.zeros((pad, 32), F)])
    return recs, 0, bound


def _rowrec_layout(recs: np.ndarray, tri_pack: np.ndarray, root_meta4: int):
    """One quad record per 128-lane row + 8-aligned leaf triangle rows.

    A dynamic-sublane row read replaces the per-visit lax.switch record
    select (measured ~144 ns per switch by the round-2 in-situ probes —
    the dominant share of the kernel's per-visit cost), and each leaf
    phase reads ONE row and slices its tri slots statically instead of
    issuing 4 more switches. Slot field 9 carries the original tri index
    so winners keep global prim numbering.

    Returns (quad_rows (K, 128) f32, tri_rows (L, 128) f32, root_meta4r).
    """
    k = recs.shape[0]
    rows = np.zeros((k, 128), F)
    rows[:, :32] = recs
    metas = recs[:, 24:28].view(np.int32).copy()

    tri_rows = []

    def leaf_row(meta: int) -> int:
        first, count = meta >> 3, meta & 7
        row = np.zeros(128, F)
        for s in range(count):
            row[s * 16 : s * 16 + 9] = tri_pack[first + s, :9]
            row[s * 16 + 9] = np.int32(first + s).view(F)
        tri_rows.append(row)
        return ((len(tri_rows) - 1) << 3) | count

    if root_meta4 >= 0 and (root_meta4 & 7):
        root_meta4 = leaf_row(root_meta4)
    else:
        for r in range(k):
            for j in range(4):
                m = int(metas[r, j])
                if m >= 0 and (m & 7):
                    metas[r, j] = leaf_row(m)
        rows[:, 24:28] = metas.view(F)

    if not tri_rows:
        tri_rows.append(np.zeros(128, F))
    tri_rows = np.stack(tri_rows).astype(F)
    tri_rows = _pad_rows(tri_rows, _round_up(tri_rows.shape[0], 8))
    rows = _pad_rows(rows, _round_up(rows.shape[0], 8))
    return rows, tri_rows, int(root_meta4)

# the JAX package's 128-lane packed tables (ops/traverse_pallas.py)
NODE_F = 8       # f32 per skip-link node record: min3 max3 meta skip
NODES_PER_ROW = 16
TRI_F = 16       # f32 per packed triangle record (p0 p1 p2, 7 pad)
TRIS_PER_ROW = 8


def _pack_tables(bvh_nodes: np.ndarray, tri_pack: np.ndarray):
    """traverse_pallas.py::pack_tables: (nodes_pk, tris_pk), 128-lane rows
    of 16 node records / 8 triangle records."""
    n = bvh_nodes.shape[0]
    n_pad = -n % NODES_PER_ROW
    nodes = np.concatenate(
        [bvh_nodes.astype(F), np.zeros((n_pad, NODE_F), F)]
    ) if n_pad else bvh_nodes.astype(F)
    nodes_pk = nodes.reshape(-1, 128)

    t = tri_pack.shape[0]
    tris = np.zeros((t + (-t % TRIS_PER_ROW), TRI_F), F)
    tris[:t, :9] = tri_pack.astype(F)
    return nodes_pk, tris.reshape(-1, 128)


def _skiplink_nodes(bvh) -> np.ndarray:
    """(N8, 8) skip-link node records: min3, max3, bits((first<<3)|count),
    bits(skip), padded to a multiple of 8 with empty boxes that skip to
    the sentinel n_nodes."""
    n_nodes = bvh.n_nodes
    nd_pad = _round_up(n_nodes, 8)
    bvh_min = _pad_rows(bvh.node_min, nd_pad, fill=1.0)
    bvh_max = _pad_rows(bvh.node_max, nd_pad, fill=-1.0)
    bvh_first = _pad_rows(bvh.left_first, nd_pad)
    bvh_count = _pad_rows(bvh.count, nd_pad)
    bvh_skip = _pad_rows(bvh.skip, nd_pad, fill=n_nodes)
    meta1 = (bvh_first.astype(np.int64) << 3) | bvh_count.astype(np.int64)
    return np.concatenate(
        [
            bvh_min, bvh_max,
            meta1.astype(np.int32).view(F)[:, None],
            bvh_skip.view(F)[:, None],
        ],
        axis=1,
    ).astype(F)


def _t8_fld(w: int) -> int:
    """Meta bit-field width of the child counts (6 bits at W=32)."""
    return 6 if w == 32 else 5


def _bvh8t_layout(bvh, tri_pack, w: int = T8_WIDTH, lg: int = T8_LEAF):
    """The JAX package's bvh8t tables: W-wide nodes, LG-row tri groups.

    Node `nid` slot `s` box: node_blocks[(nid // 16) * w + s,
    (nid % 16) * 8 + 0..5]; meta = (child_base << fld | n_int,
    leaf_base << fld | n_leaf); internal children in slots 0..n_int-1,
    leaf groups in slots w-1-j; group `q` row `r`:
    tri_blocks[(q // 12) * lg + r, (q % 12) * 10 + 0..9] = p0, e1, e2, id
    bits. Empty slots hold NaN boxes.

    Returns (node_blocks, meta, tri_blocks, stack_bound).
    """
    count = bvh.count
    n2 = count.shape[0]
    if bvh.prim_order.shape[0] == 0:
        return (np.full((w, 128), np.nan, F), np.zeros((1, 2), np.int32),
                np.zeros((lg, 128), F), 4)

    leaf_idx = np.nonzero(count > 0)[0]
    lf = bvh.left_first.astype(np.int64)
    if not np.all(lf[leaf_idx][1:] == lf[leaf_idx][:-1] + count[leaf_idx][:-1]):
        raise ValueError("BVH prim ranges not contiguous in preorder")
    csum = np.concatenate([[0], np.cumsum(count)]).astype(np.int64)
    total = csum[bvh.skip] - csum[np.arange(n2)]
    pos = np.searchsorted(leaf_idx, np.arange(n2))
    first = lf[leaf_idx[np.minimum(pos, len(leaf_idx) - 1)]]

    ext = np.maximum(bvh.node_max - bvh.node_min, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    skip = bvh.skip

    def mergeable(i):
        return count[i] > 0 or total[i] <= lg

    # BFS collapse; node id = queue position; internal children contiguous
    queue = [0]
    qi = 0
    node_slots = []
    child_base = []
    depth = [0]
    maxd = 0
    while qi < len(queue):
        r = queue[qi]
        qi += 1
        maxd = max(maxd, depth[qi - 1])
        if mergeable(r):  # only possible for the root
            node_slots.append(([], [r]))
            child_base.append(0)
            continue
        cut = [r + 1, int(skip[r + 1])]
        while len(cut) < w:
            exp = [c for c in cut if not mergeable(c)]
            if not exp:
                break
            j = max(exp, key=lambda c: (area[c], -c))
            p = cut.index(j)
            cut[p:p + 1] = [j + 1, int(skip[j + 1])]
        ints = [c for c in cut if not mergeable(c)]
        lvs = [c for c in cut if mergeable(c)]
        child_base.append(len(queue))
        queue.extend(ints)
        depth.extend([depth[qi - 1] + 1] * len(ints))
        node_slots.append((ints, lvs))
    n8 = len(queue)

    nb = _round_up(n8, N8_PER_BLOCK) // N8_PER_BLOCK
    node_blocks = np.full((nb * w, 128), np.nan, F)
    meta = np.zeros((n8, 2), np.int32)
    groups = []
    fld = _t8_fld(w)
    for nid in range(n8):
        ints, lvs = node_slots[nid]
        meta[nid, 0] = (child_base[nid] << fld) | len(ints)
        meta[nid, 1] = (len(groups) << fld) | len(lvs)
        b, g = divmod(nid, N8_PER_BLOCK)
        for s, c in enumerate(ints):
            node_blocks[b * w + s, g * 8:g * 8 + 3] = bvh.node_min[c]
            node_blocks[b * w + s, g * 8 + 3:g * 8 + 6] = bvh.node_max[c]
        for j, c in enumerate(lvs):
            s = w - 1 - j
            node_blocks[b * w + s, g * 8:g * 8 + 3] = bvh.node_min[c]
            node_blocks[b * w + s, g * 8 + 3:g * 8 + 6] = bvh.node_max[c]
            groups.append((int(first[c]), int(total[c])))

    gb = _round_up(max(1, len(groups)), G8_PER_BLOCK) // G8_PER_BLOCK
    tri_blocks = np.zeros((gb * lg, 128), F)
    for q, (fst, cnt) in enumerate(groups):
        b, j = divmod(q, G8_PER_BLOCK)
        rows = slice(b * lg, b * lg + cnt)
        p0 = tri_pack[fst:fst + cnt, 0:3]
        tri_blocks[rows, j * 10:j * 10 + 3] = p0
        tri_blocks[rows, j * 10 + 3:j * 10 + 6] = tri_pack[fst:fst + cnt, 3:6] - p0
        tri_blocks[rows, j * 10 + 6:j * 10 + 9] = tri_pack[fst:fst + cnt, 6:9] - p0
        tri_blocks[rows, j * 10 + 9] = (
            np.arange(fst, fst + cnt, dtype=np.int32).view(F))

    return node_blocks, meta, tri_blocks, maxd + 3


def bvh8t_card_layout(node_blocks, meta, tri_blocks, w: int, lg: int):
    """The bvh8t card layout of `_bvh8t_layout`'s tables (numpy).

    - nodes (N8, 4) i32: per node, its first child record, n_int, n_leaf
      and child_base (meta's field: internal child s is node child_base+s);
    - children (C, 8) f32: the real children only, node by node in slot
      order (internal slots 0..n_int-1, then leaf slots w-n_leaf..w-1):
      box min3 max3, then as int32 bits the child's node id and 0 for an
      internal child, or the group's first triangle row and its row count
      for a leaf group;
    - tris (R, 12) f32: the rows of every group that hold a triangle (any
      of the nine vertex words nonzero), group by group in group order,
      contiguous: p0, e1, e2, the id bits, two zero words.

    Returns (nodes, children, tris)."""
    fld = _t8_fld(w)
    m = np.asarray(meta).astype(np.int64) & 0xFFFFFFFF
    child_base, n_int = m[:, 0] >> fld, m[:, 0] & ((1 << fld) - 1)
    leaf_base, n_leaf = m[:, 1] >> fld, m[:, 1] & ((1 << fld) - 1)
    n_child = n_int + n_leaf
    first = np.concatenate([[0], np.cumsum(n_child)[:-1]]).astype(np.int64)

    # groups (G, lg, 10) from the (blocks x lg, 128) blocks of 12 groups
    g_all = np.asarray(tri_blocks).reshape(-1, lg, 128)[:, :, :120]
    g_all = g_all.reshape(-1, lg, G8_PER_BLOCK, 10).transpose(0, 2, 1, 3)
    grp = g_all.reshape(-1, lg, 10)[:int(n_leaf.sum())]
    used = np.any(grp[:, :, :9] != 0, axis=2)
    rows = used.sum(axis=1)
    row0 = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int64)
    tris = np.zeros((int(rows.sum()), T8_ROW_WORDS), F)
    tris[:, :10] = grp[used]

    node = np.repeat(np.arange(m.shape[0]), n_child)
    k = np.arange(node.shape[0]) - first[node]
    internal = k < n_int[node]
    slot = np.where(internal, k, k + w - n_child[node])
    blocks = np.asarray(node_blocks)
    children = np.zeros((node.shape[0], 8), F)
    children[:, :6] = blocks[(node // N8_PER_BLOCK * w + slot)[:, None],
                             (node % N8_PER_BLOCK * 8)[:, None] + np.arange(6)]
    q = leaf_base[node] + (w - 1 - slot)
    link = np.where(internal, child_base[node] + slot,
                    row0[np.where(internal, 0, q)])
    count = np.where(internal, 0, rows[np.where(internal, 0, q)])
    children[:, 6] = link.astype(np.int32).view(F)
    children[:, 7] = count.astype(np.int32).view(F)
    nodes = np.stack([first, n_int, n_leaf, child_base], axis=1)
    return nodes.astype(np.int32), children, tris


def bvh8t_card(node_blocks, meta, tri_blocks, w: int, lg: int,
               device) -> Bvh8tCard:
    """`bvh8t_card_layout` as tensors on `device`."""
    return Bvh8tCard(*(torch.from_numpy(a).to(device) for a in
                       bvh8t_card_layout(node_blocks, meta, tri_blocks, w,
                                         lg)))


def _accel_tables(tri_arrays):
    """BVH build + the slice's traversal layouts over one triangle soup.

    tri_arrays: (p0, p1, p2, n0, n1, n2, uv0, uv1, uv2, mat, light, has_n,
    has_uv) in input order. Returns a dict of host arrays and statics."""
    (p0, p1, p2, n0, n1, n2, uv0, uv1, uv2,
     mat, light, has_n, has_uv) = tri_arrays
    n_tris = p0.shape[0]
    prim_min = np.minimum(np.minimum(p0, p1), p2)
    prim_max = np.maximum(np.maximum(p0, p1), p2)
    bvh = build_bvh(prim_min, prim_max)
    order = bvh.prim_order
    tri = [p0, p1, p2, n0, n1, n2, uv0, uv1, uv2, mat, light, has_n, has_uv]
    if n_tris:
        tri = [a[order] for a in tri]
    t_pad = _round_up(n_tris, 8)
    tri = [_pad_rows(a, t_pad, fill=-1 if k == 10 else 0)
           for k, a in enumerate(tri)]

    tri_pack = np.concatenate(tri[0:3], axis=1).astype(F)
    bvh_nodes = _skiplink_nodes(bvh)
    bvh_nodes_pk, tri_pack_pk = _pack_tables(bvh_nodes, tri_pack)
    bvh2_rows, root_meta, bvh2_depth = _child_pair_layout(bvh)
    bvh4_recs, root_meta4, bvh4_stack = _bvh4_layout(bvh)
    bvh4_rows, tri_rows, root_meta4r = _rowrec_layout(
        bvh4_recs, tri_pack, root_meta4)
    t8_nodes, t8_meta, t8_tris, t8_stack = _bvh8t_layout(bvh, tri_pack)
    if n_tris:
        root_min = prim_min.min(axis=0).astype(F)
        root_max = prim_max.max(axis=0).astype(F)
    else:
        root_min = np.full(3, np.inf, F)
        root_max = np.full(3, -np.inf, F)
    return dict(
        tri=tri, tri_pack=tri_pack, bvh2_rows=bvh2_rows,
        root_meta=int(root_meta), bvh2_depth=int(bvh2_depth),
        bvh_nodes=bvh_nodes, bvh_nodes_pk=bvh_nodes_pk,
        tri_pack_pk=tri_pack_pk, bvh2_rows_pk=bvh2_rows.reshape(-1, 8 * 16),
        bvh4_recs_pk=bvh4_recs.reshape(-1, 4 * 32), bvh4_rows=bvh4_rows,
        tri_rows=tri_rows, n_bvh_nodes=int(bvh.n_nodes),
        root_meta4=int(root_meta4), bvh4_stack=int(bvh4_stack),
        root_meta4r=int(root_meta4r),
        t8_nodes=t8_nodes, t8_meta=t8_meta, t8_tris=t8_tris,
        t8_stack=int(t8_stack), root_min=root_min, root_max=root_max,
        n_tris=int(n_tris),
    )


def _tri_shade_rows(tri) -> np.ndarray:
    """(T, 32) single-gather shading rows from accel-ordered tri arrays."""
    (p0, p1, p2, n0, n1, n2, uv0, uv1, uv2, mat, light, has_n, has_uv) = tri
    sh = np.zeros((p0.shape[0], 32), F)
    sh[:, 0:3] = p0
    sh[:, 3:6] = p1
    sh[:, 6:9] = p2
    sh[:, 9:12] = n0
    sh[:, 12:15] = n1
    sh[:, 15:18] = n2
    sh[:, 18:20] = uv0
    sh[:, 20:22] = uv1
    sh[:, 22:24] = uv2
    sh[:, 24] = mat.astype(np.int32).view(F)
    sh[:, 25] = light.astype(np.int32).view(F)
    sh[:, 26] = has_n.astype(np.int32).view(F)
    sh[:, 27] = has_uv.astype(np.int32).view(F)
    return sh


def _normal_matrix(t: Transform) -> np.ndarray:
    return t.inverse[:3, :3].T.copy()


def _instance_groups(prims):
    """prim index -> (prim, [world transforms]) of every mesh that JAX
    builds as a shared BLAS: reached through more than one transform
    chain, not emissive, at least INSTANCE_MIN_TRIS triangles. In the
    order of first use."""
    occ_count: dict = {}
    for _, prim_idx, _ in prims:
        occ_count[prim_idx] = occ_count.get(prim_idx, 0) + 1
    groups: dict = {}
    for prim, prim_idx, t in prims:
        shape = prim.shape
        if (isinstance(shape, TriangleMesh) and occ_count[prim_idx] > 1
                and prim.area_light is None
                and shape.mesh.tris.shape[0] >= INSTANCE_MIN_TRIS):
            groups.setdefault(prim_idx, (prim, []))[1].append(t)
    return groups


def _triangle_soup(prims, instanced):
    """World-space triangle arrays of every mesh of the flattened `prims`
    that is not in `instanced` (compile_scene's loop; spheres are left to
    `_sphere_tables`, shared meshes to `_instance_tables`)."""
    parts = [[] for _ in range(13)]
    for prim, prim_idx, t in prims:
        mat_id = prim.material if prim.material is not None else 0
        light_id = prim.area_light if prim.area_light is not None else -1
        shape = prim.shape
        if isinstance(shape, Sphere) or prim_idx in instanced:
            continue
        if not isinstance(shape, TriangleMesh):
            raise TypeError(f"unknown shape: {shape}")
        mesh = shape.mesh
        nt = mesh.tris.shape[0]
        if nt == 0:
            continue
        m = t.forward
        verts = mesh.vertices @ m[:3, :3].T + m[:3, 3]
        tri = mesh.tris.astype(np.int64)
        parts[0].append(verts[tri[:, 0]])
        parts[1].append(verts[tri[:, 1]])
        parts[2].append(verts[tri[:, 2]])
        if mesh.has_normals:
            norms = mesh.normals @ _normal_matrix(t).T
            for k in range(3):
                parts[3 + k].append(norms[tri[:, k]])
            parts[11].append(np.ones(nt, bool))
        else:
            z = np.zeros((nt, 3), F)
            for k in range(3):
                parts[3 + k].append(z)
            parts[11].append(np.zeros(nt, bool))
        if mesh.has_uvs:
            for k in range(3):
                parts[6 + k].append(mesh.uvs[tri[:, k]])
            parts[12].append(np.ones(nt, bool))
        else:
            z = np.zeros((nt, 2), F)
            for k in range(3):
                parts[6 + k].append(z)
            parts[12].append(np.zeros(nt, bool))
        parts[9].append(np.full(nt, mat_id, np.int32))
        parts[10].append(np.full(nt, light_id, np.int32))

    shapes = [(3,)] * 6 + [(2,)] * 3 + [()] * 4
    dtypes = [F] * 9 + [np.int32, np.int32, bool, bool]
    return tuple(
        np.concatenate(p, axis=0).astype(dt) if p else np.zeros((0, *sh), dt)
        for p, sh, dt in zip(parts, shapes, dtypes)
    )


def _mesh_tri_arrays(mesh, mat_id: int, light_id: int):
    """Object-space per-triangle arrays of one mesh (no transform)."""
    tri = mesh.tris.astype(np.int64)
    nt = tri.shape[0]
    v = mesh.vertices.astype(F)
    p0, p1, p2 = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    if mesh.has_normals:
        n = mesh.normals.astype(F)
        n0, n1, n2 = n[tri[:, 0]], n[tri[:, 1]], n[tri[:, 2]]
        has_n = np.ones(nt, bool)
    else:
        n0 = n1 = n2 = np.zeros((nt, 3), F)
        has_n = np.zeros(nt, bool)
    if mesh.has_uvs:
        uv = mesh.uvs.astype(F)
        uv0, uv1, uv2 = uv[tri[:, 0]], uv[tri[:, 1]], uv[tri[:, 2]]
        has_uv = np.ones(nt, bool)
    else:
        uv0 = uv1 = uv2 = np.zeros((nt, 2), F)
        has_uv = np.zeros(nt, bool)
    return (p0, p1, p2, n0, n1, n2, uv0, uv1, uv2,
            np.full(nt, mat_id, np.int32), np.full(nt, light_id, np.int32),
            has_n, has_uv)


def _instance_tables(groups, n_tris: int):
    """The shared BLASes and their instances (JAX compile_scene's instance
    block): (BLAS accel dicts, blas_meta, instances without their vtri
    base, [(o2w, w2o)], [(world min, world max)], BLAS shade rows). A
    BLAS's shade rows follow the main rows, padded to 8."""
    blas, blas_meta, instances, mats, aabbs, shade = [], [], [], [], [], []
    shade_off = _round_up(n_tris, 8)
    for prim, transforms in groups.values():
        mat_id = prim.material if prim.material is not None else 0
        b = _accel_tables(_mesh_tri_arrays(prim.shape.mesh, mat_id, -1))
        blas_id = len(blas)
        blas.append(b)
        blas_meta.append((b["n_tris"], b["root_meta"], b["bvh2_depth"],
                          b["root_meta4"], b["bvh4_stack"],
                          b["n_bvh_nodes"], b["root_meta4r"],
                          b["t8_stack"]))
        shade.append(_tri_shade_rows(b["tri"]))
        lo, hi = b["root_min"], b["root_max"]
        corners = np.array(
            [[lo[0] if sx < 0 else hi[0], lo[1] if sy < 0 else hi[1],
              lo[2] if sz < 0 else hi[2]]
             for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], F)
        for t in transforms:
            m = t.forward
            wc = corners @ m[:3, :3].T + m[:3, 3]
            aabbs.append((wc.min(axis=0), wc.max(axis=0)))
            mats.append((m.astype(F), t.inverse.astype(F)))
            instances.append((blas_id, 0, b["n_tris"], shade_off))
        shade_off += shade[-1].shape[0]
    return blas, blas_meta, instances, mats, aabbs, shade


def _sphere_tables(prims):
    """(tables, n_spheres): the object-space sphere tables of the flattened
    `prims`, padded to a
    multiple of 8 with radius 0, identity matrices, material 0 and light -1
    (JAX compile_scene's spheres). No sphere is an emitter: an area light
    on one raises."""
    sph = []
    for prim, _, t in prims:
        if not isinstance(prim.shape, Sphere):
            continue
        if prim.area_light is not None:
            raise _unsupported(
                "an area light on a sphere",
                "Not ported: the JAX package asserts against it too")
        mat_id = prim.material if prim.material is not None else 0
        sph.append((prim.shape, t, mat_id))
    n_spheres = len(sph)
    s_pad = _round_up(n_spheres, 8) if n_spheres else 0
    tab = dict(
        sph_center=np.zeros((s_pad, 3), F),
        sph_radius=np.zeros(s_pad, F),
        sph_o2w=np.tile(np.eye(4, dtype=F), (s_pad, 1, 1)),
        sph_w2o=np.tile(np.eye(4, dtype=F), (s_pad, 1, 1)),
        sph_mat=np.zeros(s_pad, np.int32),
        sph_light=np.full(s_pad, -1, np.int32),
    )
    for i, (shape, t, mat_id) in enumerate(sph):
        tab["sph_center"][i] = shape.center
        tab["sph_radius"][i] = shape.radius
        tab["sph_o2w"][i] = t.forward
        tab["sph_w2o"][i] = t.inverse
        tab["sph_mat"][i] = mat_id
    return tab, n_spheres


def _material_tables(scene: Scene):
    n_mats = max(1, len(scene.materials))
    mat_kind = np.zeros(n_mats, np.int32)
    mat_tex = np.full((n_mats, 5), -1, np.int32)
    mat_remap = np.zeros(n_mats, bool)
    kinds_present = set()
    for i, m in enumerate(scene.materials):
        if isinstance(m, Diffuse):
            mat_kind[i] = MAT_DIFFUSE
            mat_tex[i, 0] = m.albedo
        elif isinstance(m, SmoothDielectric):
            mat_kind[i] = MAT_SMOOTH_DIELECTRIC
            mat_tex[i, 0] = m.eta
        elif isinstance(m, SmoothConductor):
            mat_kind[i] = MAT_SMOOTH_CONDUCTOR
            mat_tex[i, 0] = m.eta
            mat_tex[i, 1] = m.kappa
        elif isinstance(m, RoughDielectric):
            mat_kind[i] = MAT_ROUGH_DIELECTRIC
            mat_tex[i, 0] = m.eta
            mat_tex[i, 2] = m.roughness
            mat_remap[i] = m.remap_roughness
        elif isinstance(m, RoughConductor):
            mat_kind[i] = MAT_ROUGH_CONDUCTOR
            mat_tex[i, 0] = m.eta
            mat_tex[i, 1] = m.kappa
            mat_tex[i, 2] = m.roughness
            mat_remap[i] = m.remap_roughness
        elif isinstance(m, CoatedDiffuse):
            mat_kind[i] = MAT_COATED_DIFFUSE
            mat_tex[i, 0] = m.diffuse_albedo
            mat_tex[i, 1] = m.dielectric_eta
            mat_tex[i, 2] = (
                m.dielectric_roughness if m.dielectric_roughness is not None
                else -1
            )
            mat_tex[i, 3] = m.thickness
            mat_tex[i, 4] = m.coat_albedo
            mat_remap[i] = m.dielectric_remap_roughness
        else:
            raise TypeError(f"unknown material: {m}")
        kinds_present.add(int(mat_kind[i]))
    if not scene.materials:
        kinds_present.add(MAT_DIFFUSE)
    return mat_kind, mat_tex, mat_remap, tuple(sorted(kinds_present))


def _build_mip_pyramid(data: np.ndarray):
    """Box-filter mip pyramid over a pow2-square padded copy (JAX
    compile_scene's pyramid; the reference's Lanczos3 pyramid has the same
    level structure)."""
    h, w = data.shape[:2]
    size = 1 << int(np.ceil(np.log2(max(h, w, 1))))
    levels = []
    if (h, w) != (size, size):
        ys = (np.arange(size) * h // size).clip(0, h - 1)
        xs = (np.arange(size) * w // size).clip(0, w - 1)
        cur = data[ys][:, xs]
    else:
        cur = data
    levels.append(cur.astype(F))
    while cur.shape[0] > 1:
        cur = (
            cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2]
        ) * 0.25
        levels.append(cur.astype(F))
    return levels


def _image_tables(scene: Scene):
    """The mip atlas: every level of every image, row-major texels, with
    one (offset, w, h) row a level. Only trilinear-filtered images get a
    pyramid; the others keep their one level."""
    trilinear_images = set()
    any_nearest = False
    for t in scene.textures:
        if isinstance(t, ImageTexture):
            if t.sampler.filter == FilterMode.TRILINEAR:
                trilinear_images.add(t.image)
            if t.sampler.filter == FilterMode.NEAREST:
                any_nearest = True

    texels, level_rows = [], []
    img_first_level = np.zeros(max(1, len(scene.images)), np.int32)
    img_n_levels = np.zeros(max(1, len(scene.images)), np.int32)
    offset = 0
    for i, img in enumerate(scene.images):
        if i in trilinear_images:
            levels = _build_mip_pyramid(img.data)
        else:
            levels = [img.data.astype(F)]
        img_first_level[i] = len(level_rows)
        img_n_levels[i] = len(levels)
        for lv in levels:
            h, w = lv.shape[:2]
            level_rows.append((offset, w, h))
            texels.append(lv.reshape(-1, 4))
            offset += h * w
    img_texels = (np.concatenate(texels, axis=0).astype(F) if texels
                  else np.zeros((1, 4), F))
    lvl_pack = np.zeros((max(1, len(level_rows)), 4), np.int32)
    lvl_pack[:, 1:3] = 1
    if level_rows:
        lvl_pack[:, 0:3] = np.asarray(level_rows, np.int32)
    return (img_texels, lvl_pack, img_first_level, img_n_levels,
            bool(trilinear_images), any_nearest)


def _texture_tables(scene: Scene, mat_tex: np.ndarray, img_first_level,
                    img_n_levels, env_tex: int):
    """(tex_pack, mat_tex_rows, kinds present, the kind sets each material
    slot reaches, the kind set the env texture reaches) of JAX
    compile_scene's textures block."""
    n_tex = max(1, len(scene.textures))
    tex_kind = np.full(n_tex, TEX_CONSTANT, np.int32)
    tex_v0 = np.zeros((n_tex, 4), F)
    tex_v1 = np.zeros((n_tex, 4), F)
    tex_ref = np.full((n_tex, 3), -1, np.int32)
    tex_filter = np.zeros(n_tex, np.int32)
    tex_wrap = np.zeros(n_tex, np.int32)
    for i, t in enumerate(scene.textures):
        if isinstance(t, ImageTexture):
            tex_kind[i] = TEX_IMAGE
            tex_ref[i, 0] = t.image
            tex_filter[i] = int(t.sampler.filter)
            tex_wrap[i] = int(t.sampler.wrap)
        elif isinstance(t, ConstantTexture):
            tex_v0[i] = t.value
        elif isinstance(t, CheckerTexture):
            tex_kind[i] = TEX_CHECKER
            tex_v0[i] = t.color1
            tex_v1[i] = t.color2
        elif isinstance(t, ScaleTexture):
            tex_kind[i] = TEX_SCALE
            tex_ref[i, 0:2] = (t.a, t.b)
        elif isinstance(t, MixTexture):
            tex_kind[i] = TEX_MIX
            tex_ref[i] = (t.a, t.b, t.c)
        else:
            raise TypeError(f"unknown texture: {t}")

    tex_pack = np.zeros((n_tex, 16), F)
    tex_pack[:, 0:4] = tex_v0
    tex_pack[:, 4:8] = tex_v1
    # int columns: ref0..2, kind, filter, wrap, n_levels; an image row holds
    # its image's first mip level in ref0 and its level count in n_levels
    ti = np.zeros((n_tex, 8), np.int32)
    is_img = tex_kind == TEX_IMAGE
    # non-image rows read image 0 here and keep their ref0 (JAX reads
    # image ref0, which faults where a scale or mix child id is past the
    # last image; the rows it does build are the same)
    img_id = np.where(is_img, tex_ref[:, 0], 0)
    ti[:, 0] = np.where(is_img, img_first_level[img_id], tex_ref[:, 0])
    ti[:, 1:3] = tex_ref[:, 1:3]
    ti[:, 3] = tex_kind
    ti[:, 4] = tex_filter
    ti[:, 5] = tex_wrap
    ti[:, 6] = np.where(is_img, img_n_levels[img_id], 0)
    tex_pack[:, 8:16] = ti.view(F)

    # material-major join of the slot rows; unset slots read a synthetic
    # constant-zero row (JAX compile_scene's mat_tex_rows)
    unset_row = np.zeros(16, F)
    ur_i = np.zeros(8, np.int32)
    ur_i[3] = TEX_CONSTANT
    unset_row[8:16] = ur_i.view(F)
    n_mats = mat_tex.shape[0]
    mat_tex_rows = np.zeros((n_mats, 5 * 16), F)
    for j in range(5):
        rows = tex_pack[np.maximum(mat_tex[:, j], 0)].copy()
        rows[mat_tex[:, j] < 0] = unset_row
        mat_tex_rows[:, 16 * j:16 * (j + 1)] = rows

    def reach_kinds(tid0: int) -> set:
        """Texture kinds reachable from texture `tid0` through scale and
        mix children."""
        out, stack, seen = set(), [int(tid0)], set()
        while stack:
            t = stack.pop()
            if t < 0 or t >= n_tex or t in seen:
                continue
            seen.add(t)
            k = int(tex_kind[t])
            out.add(k)
            if k in (TEX_SCALE, TEX_MIX):
                stack.extend(int(r) for r in tex_ref[t] if r >= 0)
        return out or {TEX_CONSTANT}

    slot_kinds = []
    for j in range(5):
        ks = set()
        for i in range(n_mats):
            t = int(mat_tex[i, j])
            if t < 0:
                ks.add(TEX_CONSTANT)  # the synthetic unset row
                if j == 0:
                    # the albedo AOV reads tex_pack[max(tid, 0)] directly
                    ks |= reach_kinds(0)
            else:
                ks |= reach_kinds(t)
        slot_kinds.append(tuple(sorted(ks)))
    kinds_present = tuple(sorted({int(k) for k in tex_kind}))
    env_kinds = (tuple(sorted(reach_kinds(env_tex))) if env_tex >= 0
                 else (TEX_CONSTANT,))
    return tex_pack, mat_tex_rows, kinds_present, tuple(slot_kinds), env_kinds


def _light_tables(scene: Scene):
    """Light rows and the area lights' world-space emitter rows (em_shade:
    p0 p1 p2 n0 n1 n2 area bits(has_n); one zero row of area 1 when no
    light is an area light)."""
    n_lights = len(scene.lights)
    l_pad = max(1, n_lights)
    light_kind = np.zeros(l_pad, np.int32)
    light_va = np.zeros((l_pad, 3), F)
    light_vb = np.zeros((l_pad, 3), F)
    emit_first = np.zeros(l_pad, np.int32)
    emit_count = np.zeros(l_pad, np.int32)
    em_rows = []
    em_offset = 0
    kinds = []
    for i, light in enumerate(scene.lights):
        if isinstance(light, PointLight):
            light_kind[i] = LIGHT_POINT
            light_va[i] = light.position
            light_vb[i] = light.intensity
        elif isinstance(light, DirectionLight):
            light_kind[i] = LIGHT_DIRECTION
            light_va[i] = light.direction
            light_vb[i] = light.radiance
        elif isinstance(light, DiffuseAreaLight):
            light_kind[i] = LIGHT_AREA
            light_vb[i] = light.radiance
            # _sphere_tables has refused an area light on a sphere
            mesh = scene.get_basic(light.prim_id).shape.mesh
            m = np.asarray(light.light_to_world, F)
            verts = mesh.vertices @ m[:3, :3].T + m[:3, 3]
            tri = mesh.tris.astype(np.int64)
            p0, p1, p2 = verts[tri[:, 0]], verts[tri[:, 1]], verts[tri[:, 2]]
            rows = np.zeros((len(tri), 24), F)
            rows[:, 0:3], rows[:, 3:6], rows[:, 6:9] = p0, p1, p2
            if mesh.has_normals:
                nm = np.linalg.inv(np.asarray(m, np.float64))[:3, :3].T.astype(F)
                norms = mesh.normals @ nm.T
                for k in range(3):
                    rows[:, 9 + 3 * k:12 + 3 * k] = norms[tri[:, k]]
            rows[:, 18] = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0),
                                               axis=-1)
            rows[:, 19] = np.full(len(tri), int(mesh.has_normals),
                                  np.int32).view(F)
            em_rows.append(rows)
            emit_first[i] = em_offset
            emit_count[i] = len(tri)
            em_offset += len(tri)
        else:
            raise TypeError(f"unknown light: {light}")
        kinds.append(int(light_kind[i]))
    if em_rows:
        em_shade = np.concatenate(em_rows, axis=0)
    else:
        em_shade = np.zeros((1, 24), F)
        em_shade[:, 18] = 1.0
    return dict(light_kind=light_kind, light_va=light_va, light_vb=light_vb,
                light_emit_first=emit_first, light_emit_count=emit_count,
                em_shade=em_shade), tuple(kinds)


def _minimum_differentials(cam) -> np.ndarray:
    """Minimum per-pixel ray differentials: rows x_o, y_o, x_d, y_d."""
    w2r_inv = cam.world_to_raster.inverse
    out = np.zeros((4, 3), F)
    if isinstance(cam.camera_type, Orthographic):
        origin = _np_apply_point(w2r_inv, [0.0, 0.0, 0.0])
        out[0] = _np_apply_point(w2r_inv, [1.0, 0.0, 0.0]) - origin
        out[1] = _np_apply_point(w2r_inv, [0.0, 1.0, 0.0]) - origin
    else:
        cx, cy = cam.raster_width / 2.0, cam.raster_height / 2.0
        center = _np_apply_point(w2r_inv, [cx, cy, 0.0])
        out[2] = _np_apply_point(w2r_inv, [cx + 1.0, cy, 0.0]) - center
        out[3] = _np_apply_point(w2r_inv, [cx, cy + 1.0, 0.0]) - center
    return out


def compile_scene(scene: Scene, device="cuda") -> DeviceScene:
    """Build the slice's tables for `scene` on `device` (the card unless
    the caller asks for "cpu"; without a card, cuda raises)."""
    prims = _flatten_primitives(scene)
    groups = _instance_groups(prims)
    acc = _accel_tables(_triangle_soup(prims, groups))
    blas, blas_meta, instances, inst_mats, inst_aabbs, blas_shade = (
        _instance_tables(groups, acc["n_tris"]))
    sph, n_spheres = _sphere_tables(prims)

    # virtual-triangle prim ids: [0, n_tris) main triangles, then the
    # padded spheres, then one contiguous block per instance
    inst_vtri_base0 = acc["n_tris"] + sph["sph_radius"].shape[0]
    base = inst_vtri_base0
    for i, (blas_id, _, nt_b, so) in enumerate(instances):
        instances[i] = (blas_id, base, nt_b, so)
        base += nt_b
    n_inst = len(instances)
    inst_xf = np.zeros((max(1, n_inst), 32), F)
    inst_aabb_min = np.zeros((max(1, n_inst), 3), F)
    inst_aabb_max = np.zeros((max(1, n_inst), 3), F)
    for i, (o2w, w2o) in enumerate(inst_mats):
        inst_xf[i, :16] = o2w.reshape(-1)
        inst_xf[i, 16:] = w2o.reshape(-1)
        inst_aabb_min[i], inst_aabb_max[i] = inst_aabbs[i]

    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    if acc["n_tris"]:
        lo = np.minimum(lo, acc["root_min"])
        hi = np.maximum(hi, acc["root_max"])
    for amin, amax in inst_aabbs:
        lo = np.minimum(lo, amin)
        hi = np.maximum(hi, amax)
    for i in range(n_spheres):
        c, r = sph["sph_center"][i], sph["sph_radius"][i]
        corners = c[None, :] + r * np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
             for sz in (-1, 1)], F)
        m = sph["sph_o2w"][i]
        wc = corners @ m[:3, :3].T + m[:3, 3]
        lo = np.minimum(lo, wc.min(axis=0))
        hi = np.maximum(hi, wc.max(axis=0))
    if not np.all(np.isfinite(lo)):
        lo, hi = np.zeros(3), np.zeros(3)
    bounds_center = ((lo + hi) * 0.5).astype(F)
    bounds_radius = F(np.linalg.norm(hi - lo) * 0.5)

    mat_kind, mat_tex, mat_remap, kinds_present = _material_tables(scene)
    (img_texels, lvl_pack, img_first_level, img_n_levels, any_trilinear,
     any_nearest) = _image_tables(scene)
    env = scene.environment_light
    env_tex = int(env.radiance) if env is not None else -1
    tex_pack, mat_tex_rows, tex_kinds, slot_kinds, env_kinds = (
        _texture_tables(scene, mat_tex, img_first_level, img_n_levels,
                        env_tex))
    mat_pack = np.zeros((mat_tex.shape[0], 8), np.int32)
    mat_pack[:, 0] = mat_kind
    mat_pack[:, 1:6] = mat_tex
    mat_pack[:, 6] = mat_remap.astype(np.int32)
    lights, light_kinds = _light_tables(scene)

    cam = scene.camera
    ct = cam.camera_type
    if isinstance(ct, Orthographic):
        cam_kind, aperture, focal = CAM_ORTHOGRAPHIC, 0.0, 0.0
    elif isinstance(ct, PinholePerspective):
        cam_kind, aperture, focal = CAM_PINHOLE, 0.0, 0.0
    elif isinstance(ct, ThinLensPerspective):
        cam_kind = CAM_THIN_LENS
        aperture, focal = ct.aperture_radius, ct.focal_distance
    else:
        raise TypeError(f"unknown camera: {ct}")

    meta = SceneMeta(
        n_tris=acc["n_tris"],
        n_spheres=n_spheres,
        light_kinds=light_kinds,
        mat_kinds_present=kinds_present,
        tex_kinds_present=tex_kinds,
        any_trilinear=any_trilinear,
        any_nearest=any_nearest,
        has_env=env is not None,
        env_tex=env_tex,
        cam_kind=cam_kind,
        width=cam.raster_width,
        height=cam.raster_height,
        near_clip=float(cam.near_clip),
        far_clip=float(cam.far_clip),
        aperture_radius=float(aperture),
        focal_distance=float(focal),
        root_meta=acc["root_meta"],
        bvh2_depth=acc["bvh2_depth"],
        n_bvh_nodes=acc["n_bvh_nodes"],
        root_meta4=acc["root_meta4"],
        bvh4_stack=acc["bvh4_stack"],
        root_meta4r=acc["root_meta4r"],
        t8_stack=acc["t8_stack"],
        t8_width=T8_WIDTH,
        t8_leaf=T8_LEAF,
        slot_kinds=slot_kinds,
        env_kinds=env_kinds,
        blas_meta=tuple(blas_meta),
        instances=tuple(instances),
        inst_vtri_base0=int(inst_vtri_base0),
    )
    leaves = dict(
        bvh2_rows=acc["bvh2_rows"], tri_pack=acc["tri_pack"],
        **{k: acc[k] for k in (
            "bvh_nodes", "bvh_nodes_pk", "tri_pack_pk", "bvh2_rows_pk",
            "bvh4_recs_pk", "bvh4_rows", "tri_rows")},
        t8_nodes=acc["t8_nodes"], t8_meta=acc["t8_meta"],
        t8_tris=acc["t8_tris"],
        tri_shade=np.concatenate([_tri_shade_rows(acc["tri"]), *blas_shade]),
        **sph, mat_kind=mat_kind, mat_tex=mat_tex, mat_remap=mat_remap,
        mat_pack=mat_pack, mat_tex_rows=mat_tex_rows, tex_pack=tex_pack,
        img_texels=img_texels, lvl_pack=lvl_pack, **lights,
        cam_raster_to_camera=cam.raster_to_camera.forward,
        cam_camera_to_world=cam.camera_to_world.forward,
        cam_min_diff=_minimum_differentials(cam),
        bounds_center=bounds_center, bounds_radius=bounds_radius,
        inst_xf=inst_xf, inst_aabb_min=inst_aabb_min,
        inst_aabb_max=inst_aabb_max,
    )
    return _to_device(leaves, blas, meta, device)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_device(leaves: dict, blas, meta: SceneMeta, device) -> DeviceScene:
    """leaves: LEAF_NAMES -> arrays; blas: per BLAS, BLAS_LEAF_NAMES ->
    arrays."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device")
    w, lg = meta.t8_width, meta.t8_leaf
    return DeviceScene(
        **{k: _tensor(leaves[k], device) for k in LEAF_NAMES},
        t8_card=bvh8t_card(leaves["t8_nodes"], leaves["t8_meta"],
                           leaves["t8_tris"], w, lg, device),
        blas_tables=tuple(
            BlasTables(
                **{k: _tensor(b[k], device) for k in BLAS_LEAF_NAMES},
                t8_card=bvh8t_card(b["t8_nodes"], b["t8_meta"],
                                   b["t8_tris"], w, lg, device),
                meta=AccelMeta(*bm, w, lg))
            for b, bm in zip(blas, meta.blas_meta)),
        meta=meta,
    )


def from_jax_leaves(leaves: dict, meta: dict, device) -> DeviceScene:
    """Build the port's DeviceScene from a JAX scene's leaves.

    leaves: JAX DeviceScene field name -> numpy array (np.asarray of the
    leaf), and "blas_tables" -> per BLAS, a mapping of its leaf names to
    arrays (the JAX BlasTables' `_asdict()`); meta: dataclasses.asdict of
    the JAX SceneMeta. A scene that JAX splits into bvh8t chunks keeps its
    unchunked tables, which the port walks."""
    fields = {f.name for f in dataclasses.fields(SceneMeta)}
    m = SceneMeta(**{k: _freeze(v) for k, v in meta.items() if k in fields})
    blas = leaves.get("blas_tables", ())
    if len(blas) != len(m.blas_meta):
        raise ValueError(
            f"leaves['blas_tables'] holds {len(blas)} BLAS tables but the "
            f"meta describes {len(m.blas_meta)}")
    return _to_device({k: leaves[k] for k in LEAF_NAMES}, blas, m, device)


def _freeze(v):
    """Lists from dataclasses.asdict back to the hashable tuples."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v
