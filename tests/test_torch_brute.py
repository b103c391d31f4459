"""The brute kernel's pieces that run on the CPU (K3, csrc/t8_brute.cu).

- Equal-t ties: a mesh that lists each triangle 20 times
  (torch_fixtures.py::repeated_triangles), compiled by both packages,
  through the plain brute version and the JAX package's Pallas brute kernel in
  interpret mode (selected with TPU_RT_BRUTE_GROUPS, as
  tests/test_torch_walks.py selects it): the same winners, and the
  winners the tie rule names.
- The kernel's exact prefilter, whose plain twin is
  `ops/intersect.py::prefilter_rejects` (P3's prefilter too): it
  never rejects a row that ray_triangle_edges accepts, on hypothesis-drawn
  float32 numerators at the bounds of u and v, on a sweep of them around
  every bound, and on rays aimed at vertices and edges; and it rejects
  nearly every row a ray misses.
- The table the kernel reads beside the card's rows (`t8_card.groups`).

The kernel itself is held against the plain version bit for bit on the
card, in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import tpu_raytracing.geometry as jgeom
import tpu_raytracing.materials as jmat
import tpu_raytracing.scene.test_scenes as jscenes
from tpu_raytracing.device import compile_scene as jax_compile_scene
from tpu_raytracing.ops.traverse_pallas import intersect_tris_pallas
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.device import scene_buffers as SB
from tpu_raytracing_torch.ops import traverse_kernels as TK
from tpu_raytracing_torch.ops.intersect import (prefilter_rejects,
                                                ray_triangle_edges)
from tpu_raytracing_torch.ops.linalg import cross, dot
from tpu_raytracing_torch.scene.test_scenes import get_test_scene

from torch_fixtures import edge_rays, repeated_triangles

torch.set_num_threads(1)

BOUNDS = (0.0, -1e-5, 1.0, 1.0 + 1e-5, -2.0 ** -16, 1.0 + 2.0 ** -16, 0.5)
SPECIAL = np.array(
    [0.0, -0.0, 1.0, -1.0, 3.0, -7.5, 1e-3, -1e-20, 1e-38, 1e-45, -1e-42,
     2.0 ** -126, 2.0 ** -132, 2.0 ** 100, -2.0 ** 112, 2.0 ** 126,
     3.4e38, -3.4e38, np.inf, -np.inf, np.nan], np.float32)


@pytest.fixture(scope="module")
def scenes():
    """The port's bunny, metal and repeated-triangle scenes on the cpu."""
    return {
        "bunny": compile_scene(
            get_test_scene("coated_diffuse_bunny").scene_func(), "cpu"),
        "metal": compile_scene(get_test_scene("metal").scene_func(), "cpu"),
        "repeated": compile_scene(repeated_triangles(), "cpu"),
    }


def numerators(origin, direction, p0, e1, e2):
    """(den, nu, nv) of ray_triangle_edges, in its operation order: its
    u = nu / den and v = nv / den where den != 0."""
    pvec = cross(direction, e2)
    tvec = origin - p0
    return dot(pvec, e1), dot(pvec, tvec), dot(cross(tvec, e1), direction)


def _accepts_uv(den, nu, nv):
    """The u and v part of ray_triangle_edges' test on float32 (den, nu,
    nv), in its operations: a superset of the rows it accepts."""
    sden = torch.where(den == 0.0, torch.ones_like(den), den)
    u, v = nu / sden, nv / sden
    eps = 1e-5
    return ((den != 0.0) & (u >= -eps) & (u <= 1.0 + eps) & (v >= -eps)
            & (u + v <= 1.0 + eps))


def _nudge(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """float32 x moved by k steps of its bit pattern."""
    bits = np.asarray(x, np.float32).view(np.int32).astype(np.int64) + k
    return np.clip(bits, -2 ** 31, 2 ** 31 - 1).astype(np.int32).view(
        np.float32)


def _numerators_at_bounds(den: np.ndarray, ks) -> tuple:
    """(den, nu, nv) float32 with nu = den u and nv = den v, for u and v at
    every pair of BOUNDS (and v = 1 - u), each moved by each k of `ks`
    bit steps."""
    targets = [(u, v) for u in BOUNDS for v in (*BOUNDS, 1.0 - u)]
    d, nu, nv = [], [], []
    with np.errstate(all="ignore"):
        for u, v in targets:
            for ku in ks:
                for kv in ks:
                    d.append(den)
                    nu.append(_nudge(den * np.float32(u), ku))
                    nv.append(_nudge(den * np.float32(v), kv))
    return tuple(torch.from_numpy(np.concatenate(x).astype(np.float32))
                 for x in (d, nu, nv))


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
def test_repeated_triangles_plain_vs_pallas(monkeypatch, early_exit):
    """Equal-t ties inside a group and across groups: the plain brute
    version names the Pallas brute kernel's winner on every ray, t within
    rtol 1e-5 (XLA contracts multiply-adds), and that winner is the lowest
    id of the winning triangle's copies in the last group that holds one
    (traverse_pallas.py:1551-1568)."""
    for k in ("TPU_RT_PALLAS_KERNEL", "TPU_RT_BRUTE_GROUPS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TPU_RT_BRUTE_GROUPS", "4096")
    jds = jax_compile_scene(repeated_triangles(tmod=jscenes, mmod=jmat,
                                               geom=jgeom))
    tds = compile_scene(repeated_triangles(), "cpu")
    assert TK.select_walk(tds) == "brute" and TK.t8_groups(tds) == 24
    n = 1024
    g = np.random.default_rng(11)
    o = g.normal(0.0, 0.05, (n, 3)).astype(np.float32)
    tri = tds.tri_pack.numpy()[g.integers(0, tds.meta.n_tris, n)]
    w = g.dirichlet(np.ones(3), n)  # a point inside a random triangle
    target = (w[:, :1] * tri[:, 0:3] + w[:, 1:2] * tri[:, 3:6]
              + w[:, 2:] * tri[:, 6:9])
    d = (target - o) / np.linalg.norm(target - o, axis=1, keepdims=True)
    d = d.astype(np.float32)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.where(np.arange(n) % 2 == 0, np.inf,
                    g.uniform(2.0, 5.0, n)).astype(np.float32)
    act = np.arange(n) % 7 != 3
    t_k, p_k = intersect_tris_pallas(
        jds, *(jnp.asarray(x) for x in (o, d, tmin, tmax, act)),
        early_exit=early_exit)
    t_k, p_k = np.asarray(t_k), np.asarray(p_k)
    tp, bp = TK.intersect_tris_brute_plain(
        tds, *(torch.from_numpy(x) for x in (o, d, tmin, tmax, act)),
        early_exit)
    tp, bp = tp.numpy(), bp.numpy()
    hit = bp >= 0
    assert hit.sum() > n // 3
    np.testing.assert_array_equal(bp, p_k)
    np.testing.assert_allclose(tp[hit], t_k[hit], rtol=1e-5)
    assert np.all(bp[~act] == -1) and np.all(tp[~act] == tmax[~act])
    # the rule: every copy of the winning triangle has its t; the last
    # group holding one wins, with its lowest id there
    rows = tds.t8_card.tris.numpy()
    ids = rows[:, 9].copy().view(np.int32)
    groups = tds.t8_card.groups.numpy()[:rows.shape[0]]
    for i in np.nonzero(hit)[0]:
        same = np.all(rows[:, :9] == rows[ids == bp[i], :9], axis=1)
        last = same & (groups == groups[same].max())
        assert bp[i] == ids[last].min()
        assert same.sum() == 20 and len(set(groups[same])) == 2


def test_prefilter_sweep_at_the_bounds():
    """Around every bound of u, v and u + v, within 64 bit steps, for den
    from the subnormals to the infinities (and NaN): the prefilter rejects
    no row that the u, v test accepts, and rejects those with u, v or
    1 - u - v below -2^-15."""
    dens = np.concatenate([SPECIAL, -SPECIAL])
    den, nu, nv = _numerators_at_bounds(dens, np.array([-64, -3, 0, 1, 64]))
    rej = prefilter_rejects(den, nu, nv)
    assert not (rej & _accepts_uv(den, nu, nv)).any()
    a = den.abs().double()
    u, v = nu.double() / den.double(), nv.double() / den.double()
    far = (torch.isfinite(a) & (a > 2.0 ** -100) & (a < 2.0 ** 100)
           & ((u < -2.0 ** -15) | (v < -2.0 ** -15)
              | (u + v > 1 + 2.0 ** -15)))
    assert far.sum() > 1000 and bool(rej[far].all())


@settings(max_examples=300, deadline=None)
@given(den=st.floats(width=32, allow_nan=True, allow_infinity=True,
                     allow_subnormal=True),
       ks=st.lists(st.integers(-(2 ** 12), 2 ** 12), min_size=1,
                   max_size=4))
def test_prefilter_never_rejects_an_accepted_row(den, ks):
    """Hypothesis: any float32 den, nu and nv near den times a bound of u
    and v, bit steps apart: no row the u, v test accepts is rejected."""
    d, nu, nv = _numerators_at_bounds(np.array([den], np.float32),
                                      np.array(ks))
    assert not (prefilter_rejects(d, nu, nv)
                & _accepts_uv(d, nu, nv)).any()


@settings(max_examples=200, deadline=None)
@given(tri=st.lists(st.floats(-100.0, 100.0, width=32), min_size=9,
                    max_size=9),
       u=st.sampled_from([0.0, 1e-5, -1e-5, 2.0 ** -16, -1.2e-5, 1e-7, 0.3]),
       w=st.floats(0.0, 1.0, width=32),
       tilt=st.floats(-2.0, 2.0, width=32),
       side=st.integers(0, 2))
def test_prefilter_keeps_rays_at_edges(tri, u, w, tilt, side):
    """Hypothesis: a float32 triangle and a ray aimed at a point u outside
    (or inside) one of its edges, w along it: if Moller-Trumbore accepts
    the row, the prefilter keeps it."""
    p = np.array(tri, np.float64).reshape(3, 3)
    e1, e2 = p[1] - p[0], p[2] - p[0]
    n = np.cross(e1, e2)
    if np.linalg.norm(n) < 1e-6:
        return
    bary = [(w, -u), (-u, w), (w * (1 + u), (1 - w) * (1 + u))][side]
    hit = p[0] + bary[0] * e1 + bary[1] * e2
    o = hit + n / np.linalg.norm(n) + tilt * e1
    d = hit - o
    args = [torch.tensor(x, dtype=torch.float32)[None] for x in
            (o, d / np.linalg.norm(d), p[0], p[1] - p[0], p[2] - p[0])]
    p0, e1t, e2t = (x.to(torch.float32) for x in args[2:])
    valid, _, _, _ = ray_triangle_edges(
        args[0], args[1], p0, e1t, e2t, torch.tensor(-np.inf),
        torch.tensor(np.inf))
    rej = prefilter_rejects(*numerators(
        args[0], args[1], p0, e1t, e2t))
    assert not (rej & valid).any()


@pytest.mark.parametrize("name", ["bunny", "metal", "repeated"])
def test_prefilter_on_edge_rays(scenes, name):
    """torch_fixtures.py::edge_rays (vertices, edges, either side of them,
    nearly parallel) against every row of the scene: the prefilter keeps
    every row that Moller-Trumbore accepts at any t, keeps no more than a
    few rows a ray past those, and rejects nearly all the rest."""
    ds = scenes[name]
    o, d, _, _, _ = edge_rays(ds, 256, 7)
    rows = ds.t8_card.tris
    p0, e1, e2 = rows[None, :, 0:3], rows[None, :, 3:6], rows[None, :, 6:9]
    o, d = torch.from_numpy(o)[:, None], torch.from_numpy(d)[:, None]
    valid, _, _, _ = ray_triangle_edges(o, d, p0, e1, e2,
                                        torch.tensor(-np.inf),
                                        torch.tensor(np.inf))
    rej = prefilter_rejects(*numerators(o, d, p0, e1, e2))
    assert not (rej & valid).any()
    assert valid.sum() >= 256 // 2
    kept = (~rej).sum(dim=1) - valid.sum(dim=1)
    assert float(kept.float().mean()) < 0.5 + 0.01 * rows.shape[0]


@pytest.mark.parametrize("name", ["bunny", "metal", "repeated"])
def test_card_groups(scenes, name):
    """t8_card.groups: the group of each card row, -1 only as padding to a
    multiple of 4; groups in order; each row found in its group of the
    JAX-identical t8_tris blocks."""
    ds = scenes[name]
    rows = ds.t8_card.tris.numpy()
    groups = ds.t8_card.groups.numpy()
    n = rows.shape[0]
    assert groups.dtype == np.int32 and groups.shape == (-(-n // 4) * 4,)
    assert np.all(groups[n:] == -1) and np.all(np.diff(groups[:n]) >= 0)
    lg = int(ds.meta.t8_leaf)
    blocks = ds.t8_tris.numpy().reshape(-1, lg, 128)
    for k in range(0, n, max(1, n // 500)):
        b, j = divmod(int(groups[k]), TK.G8_PER_BLOCK)
        grp = blocks[b, :, j * 10:j * 10 + 10]
        assert np.any(np.all(grp.view(np.int32) == rows[k, :10].view(
            np.int32), axis=1)), k
    assert np.array_equal(groups,
                          SB.bvh8t_card_groups(ds.t8_tris.numpy(), lg))
