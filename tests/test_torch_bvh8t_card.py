"""The bvh8t walk's card layout against the JAX package's bvh8t tables.

csrc/bvh8t_walk.cu reads `DeviceScene.t8_card`, which
device/scene_buffers.py::bvh8t_card_layout builds from the JAX-identical
t8 tables: node records, the real child records in slot order, and the
triangle rows that hold a triangle. These tests decode the card layout
back into the JAX package's `_bvh8t_layout` arrays bit for bit, at every
width the kernel is built for. The kernel itself is held against the plain
walk on the card (tests/test_torch_cuda.py). On the CPU every kernel
wrapper runs its plain version and native_cuda counts no launch.
"""
import dataclasses

import numpy as np
import pytest
import torch

import tpu_raytracing.device.scene_buffers as JSB
from tpu_raytracing.accel import build_bvh as jax_build_bvh
from tpu_raytracing.device import compile_scene as jax_compile_scene
from tpu_raytracing.scene.test_scenes import get_test_scene as jax_test_scene
from tpu_raytracing_torch.device import compile_scene, from_jax_leaves
from tpu_raytracing_torch.device import scene_buffers as SB
from tpu_raytracing_torch.native_cuda import launch_counts, reset_launch_counts
from tpu_raytracing_torch.ops.traverse_bvh8t import (
    intersect_tris_bvh8t, intersect_tris_plain,
)
from tpu_raytracing_torch.scene.test_scenes import get_test_scene

torch.set_num_threads(1)

LG = 16
BUNNY_NODES, BUNNY_CHILDREN, BUNNY_TRIS = 722, 3268, 28586


@pytest.fixture(scope="module")
def bunny():
    return compile_scene(get_test_scene("coated_diffuse_bunny").scene_func(),
                         "cpu")


@pytest.fixture(scope="module")
def bunny_bvh(bunny):
    """The JAX package's (native) BVH over the bunny's triangles, and the
    triangles in its order."""
    p = bunny.tri_pack.numpy()[:bunny.meta.n_tris]
    lo = np.minimum(np.minimum(p[:, 0:3], p[:, 3:6]), p[:, 6:9])
    hi = np.maximum(np.maximum(p[:, 0:3], p[:, 3:6]), p[:, 6:9])
    bvh = jax_build_bvh(lo, hi)
    return bvh, p[bvh.prim_order]


def _fld(w):
    return 6 if w == 32 else 5


def _decode(nodes, children, tris, w, lg):
    """The JAX tables (node blocks, meta, triangle blocks) rebuilt from a
    card layout: every real child box back in its slot, every row back in
    its group, NaN in empty slots and zero in unused rows. Also returns
    (group, first row, rows) of every leaf record."""
    n8 = nodes.shape[0]
    links = children.view(np.int32)
    node_blocks = np.full((max(1, -(-n8 // 16)) * w, 128), np.nan, np.float32)
    meta = np.zeros((n8, 2), np.int32)
    n_groups = int(nodes[:, 2].sum())
    tri_blocks = np.zeros((max(1, -(-n_groups // 12)) * lg, 128), np.float32)
    leaf_base, spans = 0, []
    for nid, (first, n_int, n_leaf, child_base) in enumerate(nodes.tolist()):
        meta[nid] = (child_base << _fld(w) | n_int,
                     leaf_base << _fld(w) | n_leaf)
        b, g = divmod(nid, 16)
        for k in range(n_int + n_leaf):
            rec = first + k
            s = k if k < n_int else k + w - n_int - n_leaf
            node_blocks[b * w + s, g * 8:g * 8 + 6] = children[rec, :6]
            link, rows = links[rec, 6], links[rec, 7]
            if k < n_int:
                assert (link, rows) == (child_base + s, 0)
                continue
            q = leaf_base + w - 1 - s
            spans.append((q, link, rows))
            bq, j = divmod(q, 12)
            tri_blocks[bq * lg:bq * lg + rows, j * 10:j * 10 + 10] = (
                tris[link:link + rows, :10])
        leaf_base += n_leaf
    return (node_blocks, meta, tri_blocks), sorted(spans)


def _same_bits(a, b):
    return (a.shape == b.shape
            and np.ascontiguousarray(a).tobytes()
            == np.ascontiguousarray(b).tobytes())


def _assert_card_of(tables, card, w):
    """card decodes back to tables bit for bit; one child record per real
    child, one row per triangle, rows of a group contiguous in group order."""
    nodes, children, tris = card
    node_blocks, meta, tri_blocks = tables
    fld = _fld(w)
    m = meta.astype(np.int64) & 0xFFFFFFFF
    n_child = (m[:, 0] & ((1 << fld) - 1)) + (m[:, 1] & ((1 << fld) - 1))
    assert nodes.shape == (meta.shape[0], 4) and nodes.dtype == np.int32
    assert children.shape == (n_child.sum(), 8)
    np.testing.assert_array_equal(nodes[:, 0],
                                  np.cumsum(n_child) - n_child)
    slots = tri_blocks.reshape(-1, 128)[:, :120].reshape(-1, 10)
    assert tris.shape == (int(np.any(slots[:, :9] != 0, axis=1).sum()), 12)
    assert not tris[:, 10:].any()
    decoded, spans = _decode(nodes, children, tris, w, LG)
    for got, want in zip(decoded, tables):
        assert _same_bits(got, want)
    q, row0, rows = (np.array(x, np.int64).reshape(-1) for x in zip(*spans))
    np.testing.assert_array_equal(q, np.arange(len(spans)))
    np.testing.assert_array_equal(row0, np.cumsum(rows) - rows)
    assert rows.sum() == tris.shape[0]


@pytest.mark.parametrize("width", [8, 16, 32])
def test_card_decodes_to_jax_layout(bunny_bvh, monkeypatch, width):
    """The JAX package's _bvh8t_layout over the bunny at each width the
    kernel is built for, through the card layout and back, bit for bit."""
    monkeypatch.setenv("TPU_RT_T8_W", str(width))
    monkeypatch.delenv("TPU_RT_T8_LG", raising=False)
    want = JSB._bvh8t_layout(*bunny_bvh)[:3]
    card = SB.bvh8t_card_layout(*want, width, LG)
    _assert_card_of(want, card, width)
    assert card[2].shape[0] == BUNNY_TRIS


@pytest.mark.parametrize("n_tris", [40, 300, 2000])
@pytest.mark.parametrize("width", [8, 16, 32])
def test_random_soup_card_decodes(monkeypatch, width, n_tris):
    """The JAX package's _bvh8t_layout over a seeded random triangle soup
    (trees of other depths and group fills than the bunny's), through the
    card layout and back, bit for bit."""
    g = np.random.default_rng(n_tris)
    c = g.random((n_tris, 1, 3)).astype(np.float32) * 10
    p = (c + g.normal(0, 0.3, (n_tris, 3, 3))).astype(np.float32)
    p = p.reshape(n_tris, 9)
    lo = np.minimum(np.minimum(p[:, 0:3], p[:, 3:6]), p[:, 6:9])
    hi = np.maximum(np.maximum(p[:, 0:3], p[:, 3:6]), p[:, 6:9])
    bvh = jax_build_bvh(lo, hi)
    monkeypatch.setenv("TPU_RT_T8_W", str(width))
    monkeypatch.delenv("TPU_RT_T8_LG", raising=False)
    want = JSB._bvh8t_layout(bvh, p[bvh.prim_order])[:3]
    card = SB.bvh8t_card_layout(*want, width, LG)
    _assert_card_of(want, card, width)
    assert card[2].shape[0] == n_tris


def test_bunny_card(bunny):
    """compile_scene's card layout of the bench scene: 722 node records,
    3,268 child records (721 internal children and 2,547 leaf groups), one
    row per triangle."""
    card = bunny.t8_card
    tables = [getattr(bunny, k).numpy()
              for k in ("t8_nodes", "t8_meta", "t8_tris")]
    got = [x.numpy() for x in (card.nodes, card.children, card.tris)]
    for a, b in zip(got, SB.bvh8t_card_layout(*tables, 16, LG)):
        assert _same_bits(a, b)
    _assert_card_of(tables, got, 16)
    nodes = got[0]
    assert nodes.shape[0] == BUNNY_NODES
    assert (int(nodes[:, 1].sum()), int(nodes[:, 2].sum())) == (721, 2547)
    assert got[1].shape[0] == BUNNY_CHILDREN
    assert got[2].shape[0] == BUNNY_TRIS == bunny.meta.n_tris
    ids = np.sort(got[2][:, 9].copy().view(np.int32))
    np.testing.assert_array_equal(ids, np.arange(BUNNY_TRIS))


def test_empty_and_single_leaf_tables():
    """The layouts of a scene with no triangles and of one whose root is a
    single leaf group (the JAX tables of those cases) decode back too."""
    empty = JSB._bvh8t_layout(jax_build_bvh(np.zeros((0, 3), np.float32),
                                            np.zeros((0, 3), np.float32)),
                              np.zeros((0, 9), np.float32))[:3]
    card = SB.bvh8t_card_layout(*empty, 16, LG)
    assert [x.shape for x in card] == [(1, 4), (0, 8), (0, 12)]
    for got, want in zip(_decode(*card, 16, LG)[0], empty):
        assert _same_bits(got, want)
    g = np.random.default_rng(3)
    p = g.random((5, 9)).astype(np.float32)
    lo = np.minimum(np.minimum(p[:, 0:3], p[:, 3:6]), p[:, 6:9])
    hi = np.maximum(np.maximum(p[:, 0:3], p[:, 3:6]), p[:, 6:9])
    bvh = jax_build_bvh(lo, hi)
    one = JSB._bvh8t_layout(bvh, p[bvh.prim_order])[:3]
    card = SB.bvh8t_card_layout(*one, 16, LG)
    assert card[1].shape == (1, 8) and card[2].shape == (5, 12)
    _assert_card_of(one, card, 16)


def test_from_jax_leaves_builds_the_card():
    """A DeviceScene made from a JAX scene's leaves carries the same card
    layout as the port's own compile."""
    jds = jax_compile_scene(jax_test_scene("cube").scene_func())
    leaves = {k: np.asarray(getattr(jds, k)) for k in SB.LEAF_NAMES}
    fj = from_jax_leaves(leaves, dataclasses.asdict(jds.meta), "cpu")
    tds = compile_scene(get_test_scene("cube").scene_func(), "cpu")
    for k in ("nodes", "children", "tris"):
        assert _same_bits(getattr(fj.t8_card, k).numpy(),
                          getattr(tds.t8_card, k).numpy()), k


def _cpu_rays(ds, n: int):
    """n rays from the scene's center, every fifth lane inactive."""
    g = np.random.default_rng(21)
    o = np.repeat(ds.bounds_center.numpy()[None], n, axis=0)
    d = g.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [torch.from_numpy(x) for x in (
        o, d, np.full(n, 1e-3, np.float32), np.full(n, np.inf, np.float32),
        np.arange(n) % 5 != 2)]


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
def test_cpu_tensors_take_the_plain_walk(bunny, early_exit):
    """On CPU tensors the wrapper runs the plain walk and launches
    nothing."""
    args = _cpu_rays(bunny, 128)
    reset_launch_counts()
    got = intersect_tris_bvh8t(bunny, *args, early_exit)
    want = intersect_tris_plain(bunny, *args, early_exit)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not launch_counts()


def _wrapper_calls(name: str, ds):
    """(the kernel wrapper's answer, its plain version's) on CPU tensors."""
    from tpu_raytracing_torch.ops import bsdf as B
    from tpu_raytracing_torch.ops import bsdf_dispatch as D
    from tpu_raytracing_torch.ops import layered as L
    from tpu_raytracing_torch.ops import traverse_kernels as TK
    from tpu_raytracing_torch.ops.rng import SamplerConfig
    from tpu_raytracing_torch.probes import bf16_vpu as P4
    from tpu_raytracing_torch.probes import iter_cost as P3
    from tpu_raytracing_torch.probes import slab_cost as P2
    from tpu_raytracing_torch.probes import walk_cost as P1

    from torch_fixtures import bsdf_lanes

    if name in TK.WALKS:
        plain = {"bvh8t": intersect_tris_plain,
                 "brute": TK.intersect_tris_brute_plain,
                 "quad": TK.intersect_tris_quad_plain,
                 "quadrow": lambda *a: TK.intersect_tris_quad_plain(
                     *a, rowrec=True),
                 "pair": TK.intersect_tris_pair_plain,
                 "walk": TK.intersect_tris_skiplink_plain}[name]
        args = _cpu_rays(ds, 64)
        return TK.WALKS[name](ds, *args), plain(ds, *args)
    if name.startswith("layered_"):
        params, wo, wi, _ = bsdf_lanes(64, 1, kinds=(5,))
        draw = torch.from_numpy(
            np.random.default_rng(1).integers(0, 1 << 32, 64))
        third = wi if name == "layered_eval" else draw
        return (getattr(L, name)(params, wo, third),
                getattr(L, name + "_plain")(params, wo, third))
    if name.startswith("bsdf_"):
        params, wo, wi, stream = bsdf_lanes(64, 2)
        kinds = (0, 1, 2, 3, 4, 5)
        if name == "bsdf_eval":
            return (D.bsdf_eval(params, wo, wi, kinds),
                    D.bsdf_eval_plain(params, wo, wi, kinds))
        cfg = SamplerConfig("independent", seed=3)
        return (D.bsdf_sample(params, wo, B.ALL_COMPONENTS, cfg, stream,
                              kinds),
                D.bsdf_sample_plain(params, wo, B.ALL_COMPONENTS, cfg, stream,
                                    kinds))
    if name == "iter_cost":
        ins, config = P3.script_inputs(), P3.CONFIGS[3]
        return (P3.iter_cost(*ins, *config, 8),
                P3.iter_cost_plain(*ins, *config, 8))
    if name == "bf16_vpu":
        box, ray = P4.script_inputs()["bfloat16"]
        return P4.bf16_vpu(box, ray, 8), P4.bf16_vpu_plain(box, ray, 8)
    if name == "slab_cost":
        ins = P2.varied_inputs()
        return (P2.slab_cost(*ins, "row0", 8),
                P2.slab_cost_plain(*ins, "row0", 8))
    ins = P1.varied_inputs()
    return (P1.walk_cost(*ins, "cond50", 8),
            P1.walk_cost_plain(*ins, "cond50", 8))


def _flat(x):
    """The tensors of a wrapper's answer, nested tuples flattened."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _flat(v)]


@pytest.mark.parametrize("name", [
    "bvh8t", "brute", "quad", "quadrow", "pair", "walk", "layered_eval",
    "layered_sample", "bsdf_eval", "bsdf_sample", "iter_cost", "bf16_vpu",
    "slab_cost", "walk_cost"])
def test_cpu_call_launches_nothing(bunny, monkeypatch, name):
    """Each of the 14 kernel wrappers on CPU tensors: its plain version's
    answer bit for bit, no launch counted, and the CUDA library never
    loaded."""
    from tpu_raytracing_torch import native_cuda

    def refuse():
        raise AssertionError("the CUDA library was loaded for CPU tensors")

    monkeypatch.setattr(native_cuda, "load", refuse)
    reset_launch_counts()
    got, want = _wrapper_calls(name, bunny)
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.device.type == "cpu" and torch.equal(a, b)
    assert not launch_counts()
