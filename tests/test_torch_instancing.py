"""Instances: the shared-BLAS tables, the per-instance passes and the
virtual-triangle decode of the port against the JAX package.

Two scenes, each built by both packages: the two-grid scene of
tests/test_instancing.py (one 32-triangle mesh under two transforms, as
TransformPrimitives over one BasicPrimitive), and a glTF file written with
chip_smoke.py::write_glb (the same mesh named by two nodes, beside a
two-triangle floor named by two nodes too, which stays baked world-space
since it is under INSTANCE_MIN_TRIS), loaded by each package's loader.

- The tables (every leaf, every BLAS leaf) are byte-identical to JAX's and
  the meta equal.
- intersect_scene: exact winners, virtual ids included, and t within rtol
  1e-5, against JAX's XLA stack walk (TPU_RT_PALLAS=0) and against its
  Pallas walks in interpret mode, one for each walk of the kernel switch;
  occluded: equal bits.
- hit_details on JAX's (t, prim) within rtol 1e-5, atol 1e-6.
- A 16x16 diffuse render of the glTF scene equals JAX's at rtol 1e-5 on
  every pixel, and the instanced render equals the baked one (each node
  with its own copy of the mesh) within an MSE of 1e-6, the rule of
  tests/test_instancing.py.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracing.device import compile_scene as jax_compile_scene
from tpu_raytracing.integrator.render import render as jax_render
from tpu_raytracing.ops.traverse import hit_details as jax_hit_details
from tpu_raytracing.ops.traverse import intersect_scene as jax_intersect
from tpu_raytracing.scene.loaders import scene_from_file as jax_load
from tpu_raytracing.settings import RaytracerSettings as JSettings
from tpu_raytracing_torch.device import compile_scene, from_jax_leaves
from tpu_raytracing_torch.device import scene_buffers as SB
from tpu_raytracing_torch.integrator.render import render
from tpu_raytracing_torch.ops.traverse import (
    hit_details, intersect_scene, occluded,
)
from tpu_raytracing_torch.scene.loaders import scene_from_file
from tpu_raytracing_torch.settings import AovFlags, RaytracerSettings

from chip_smoke import write_glb

torch.set_num_threads(1)

PKGS = ("tpu_raytracing", "tpu_raytracing_torch")
# the walks of the kernel switch and the variables that select them
SWITCH = {
    "bvh8t": {"TPU_RT_PALLAS_KERNEL": "bvh8t"},
    "brute": {"TPU_RT_PALLAS_KERNEL": "bvh8t", "TPU_RT_BRUTE_GROUPS": "64"},
    "quad": {"TPU_RT_PALLAS_KERNEL": "quad"},
    "quadrow": {"TPU_RT_PALLAS_KERNEL": "quadrow"},
    "pair": {"TPU_RT_PALLAS_KERNEL": "pair"},
    "walk": {"TPU_RT_PALLAS_KERNEL": "walk"},
}
XFORMS = (((-0.8, 0.0, -3.0), 0.0), ((0.9, 0.2, -3.5), 0.7))


def _grid_mesh(n=4, size=1.0):
    """tests/test_instancing.py::_grid_mesh: (vertices, normals, uvs,
    triangles) of a square on z=0, 2 n^2 triangles."""
    xs = np.linspace(-size / 2, size / 2, n + 1)
    vx, vy = np.meshgrid(xs, xs)
    verts = np.stack([vx.ravel(), vy.ravel(), np.zeros(vx.size)], axis=1)
    tris = []
    for j in range(n):
        for i in range(n):
            a = j * (n + 1) + i
            tris += [[a, a + 1, a + n + 2], [a, a + n + 2, a + n + 1]]
    normals = np.tile(np.array([[0.0, 0.0, 1.0]]), (verts.shape[0], 1))
    return verts, normals, (verts[:, :2] / size) + 0.5, np.asarray(tris)


def _xform_matrix(shift, turn):
    """Row-major rotate(turn about +y), then translate(shift)."""
    c, s = np.cos(turn), np.sin(turn)
    m = np.eye(4)
    m[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    m[:3, 3] = shift
    return m


def _grid_scene(pkg: str, shared: bool):
    """tests/test_instancing.py::_build from package `pkg`'s modules."""
    G = importlib.import_module(pkg + ".geometry")
    S = importlib.import_module(pkg + ".scene")
    M = importlib.import_module(pkg + ".materials")
    L = importlib.import_module(pkg + ".lights")
    C = importlib.import_module(pkg + ".scene.camera")
    sb = S.SceneBuilder()
    mat = sb.add_material(M.Diffuse(albedo=sb.add_constant_texture(
        G.v4(1, 1, 1, 1))))
    v, n, uv, tris = _grid_mesh()
    mesh = G.Mesh(vertices=v, tris=tris, normals=n, uvs=uv)
    xforms = [G.Transform.rotate(turn, np.array([0.0, 1.0, 0.0])).compose(
        G.Transform.translate(np.array(shift))) for shift, turn in XFORMS]
    if shared:
        basic = sb.add_primitive(S.BasicPrimitive(
            shape=G.TriangleMesh(mesh), material=mat, area_light=None))
        for t in xforms:
            sb.add_root_child(sb.add_primitive(
                S.TransformPrimitive(primitive=basic, transform=t)))
    else:
        for t in xforms:
            sb.add_shape_with_transform(G.TriangleMesh(mesh), mat, t)
    sb.add_light(L.PointLight(position=G.v3(0, 2, 0),
                              intensity=G.v3(20, 20, 20)))
    sb.add_camera(C.Camera.lookat_camera_perspective(
        G.v3(0, 0, 0), G.v3(0, 0, -3), G.v3(0, 1, 0), False,
        np.deg2rad(50.0), 160, 120))
    return sb.build()


def _write_gltf(path, shared: bool):
    """The grid under XFORMS' two transforms beside a two-triangle floor at
    y = -0.5 named by two nodes; one mesh entry per use unless shared."""
    v, n, _, tris = _grid_mesh()
    floor = (np.array([[-2, -0.5, -1], [2, -0.5, -1], [2, -0.5, -6],
                       [-2, -0.5, -6]]), np.tile([[0.0, 1.0, 0.0]], (4, 1)),
             np.array([[0, 1, 2], [0, 2, 3]]), 1)
    grid = (v, n, tris, 0)
    meshes = [floor, grid] if shared else [floor, floor, grid, grid]
    mats = [_xform_matrix(*x) for x in XFORMS]
    nodes = [(0, np.eye(4)), (0 if shared else 1, _xform_matrix(
        (0.3, 0.0, 0.2), 0.0))]
    nodes += [(1 if shared else 2 + k, m) for k, m in enumerate(mats)]
    write_glb(path, meshes, nodes, materials=[(0.9, 0.9, 0.9),
                                              (0.6, 0.4, 0.3)],
              camera=((0.0, 0.3, 0.5), (0.0, -0.2, -3.0), (0.0, 1.0, 0.0),
                      np.deg2rad(50.0)),
              light=((0.0, 2.0, 0.0), (1.0, 1.0, 1.0), 20.0))


@pytest.fixture(scope="module")
def gltf_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gltf")
    for shared in (True, False):
        _write_gltf(d / f"{'inst' if shared else 'baked'}.glb", shared)
    return d


def _scenes(case, gltf_files, shared=True):
    """(JAX scene, port scene) of a case."""
    if case == "grid":
        return _grid_scene(PKGS[0], shared), _grid_scene(PKGS[1], shared)
    path = gltf_files / f"{'inst' if shared else 'baked'}.glb"
    return jax_load(path), scene_from_file(path)


@pytest.fixture(scope="module")
def compiled(gltf_files):
    out = {}
    for case in ("grid", "gltf"):
        js, ts = _scenes(case, gltf_files)
        out[case] = (jax_compile_scene(js), compile_scene(ts, "cpu"))
    return out


def _same_bytes(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and (
        a.tobytes() == b.tobytes())


def _jax_leaves(jds) -> dict:
    leaves = {k: np.asarray(getattr(jds, k)) for k in SB.LEAF_NAMES}
    leaves["blas_tables"] = [{k: np.asarray(v) for k, v in b._asdict().items()}
                             for b in jds.blas_tables]
    return leaves


def _freeze(v):
    return tuple(_freeze(x) for x in v) if isinstance(v, (list, tuple)) else v


@pytest.mark.parametrize("case", ["grid", "gltf"])
def test_tables_byte_identical(compiled, case):
    """Every leaf, every BLAS leaf and the meta of the port's compile and
    of from_jax_leaves equal JAX's compile."""
    jds, tds = compiled[case]
    jm = dataclasses.asdict(jds.meta)
    fj = from_jax_leaves(_jax_leaves(jds), jm, "cpu")
    assert len(jds.meta.instances) == 2 and len(jds.blas_tables) == 1
    assert jds.meta.blas_meta[0][0] == 32
    assert jds.meta.n_tris == (0 if case == "grid" else 4)
    for ds in (tds, fj):
        for k in SB.LEAF_NAMES:
            assert _same_bytes(np.asarray(getattr(jds, k)),
                               getattr(ds, k).numpy()), k
        assert len(ds.blas_tables) == 1
        for k in SB.BLAS_LEAF_NAMES:
            assert _same_bytes(np.asarray(getattr(jds.blas_tables[0], k)),
                               getattr(ds.blas_tables[0], k).numpy()), k
        for f in dataclasses.fields(SB.SceneMeta):
            assert getattr(ds.meta, f.name) == _freeze(jm[f.name]), f.name
    assert fj.meta == tds.meta
    card = SB.bvh8t_card_layout(
        np.asarray(jds.blas_tables[0].t8_nodes),
        np.asarray(jds.blas_tables[0].t8_meta),
        np.asarray(jds.blas_tables[0].t8_tris), tds.meta.t8_width,
        tds.meta.t8_leaf)
    for a, k in zip(card, ("nodes", "children", "tris")):
        assert _same_bytes(a, getattr(tds.blas_tables[0].t8_card, k).numpy())


def test_from_jax_leaves_needs_the_blas_tables(compiled):
    """A meta with instances and leaves without their BLAS tables raise
    and name the missing leaf, rather than build a scene with none."""
    jds, _ = compiled["gltf"]
    leaves = _jax_leaves(jds)
    del leaves["blas_tables"]
    with pytest.raises(ValueError, match="blas_tables"):
        from_jax_leaves(leaves, dataclasses.asdict(jds.meta), "cpu")


def test_instance_min_tris_reads_the_jax_default():
    assert SB.INSTANCE_MIN_TRIS == 16


def _query(n: int, seed: int, early_exit: bool):
    """tests/test_instancing.py's rays: from near the camera, biased toward
    the grids, with some inactive lanes."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d[:, 2] -= 2.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 3.2 if early_exit else np.inf, np.float32)
    act = np.arange(n) % 7 != 3
    return o, d, tmin, tmax, act


def _set_switch(monkeypatch, pallas: str, env: dict):
    for k in ("TPU_RT_PALLAS_KERNEL", "TPU_RT_BRUTE_GROUPS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TPU_RT_PALLAS", pallas)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _both(jds, tds, q, early_exit):
    tj, pj = jax_intersect(jds, *(jnp.asarray(x) for x in q[:4]),
                           early_exit=early_exit, active=jnp.asarray(q[4]))
    tt, pt = intersect_scene(tds, *(torch.from_numpy(x) for x in q[:4]),
                             early_exit=early_exit,
                             active=torch.from_numpy(q[4]))
    return np.asarray(tj), np.asarray(pj), tt.numpy(), pt.numpy()


def _assert_same(tj, pj, tt, pt, early_exit, vtri_base0):
    if early_exit:  # any hit may end a walk: the bits must agree
        np.testing.assert_array_equal(pt >= 0, pj >= 0)
    else:
        np.testing.assert_array_equal(pt, pj)
        hit = pj >= 0
        np.testing.assert_allclose(tt[hit], tj[hit], rtol=1e-5)
    assert (pj >= vtri_base0).sum() > 50  # instance hits


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
@pytest.mark.parametrize("case", ["grid", "gltf"])
def test_intersect_vs_jax_xla_walk(compiled, monkeypatch, case, early_exit):
    jds, tds = compiled[case]
    _set_switch(monkeypatch, "0", {})
    q = _query(2048, 9, early_exit)
    _assert_same(*_both(jds, tds, q, early_exit), early_exit,
                 jds.meta.inst_vtri_base0)
    if early_exit:
        occ = occluded(tds, *(torch.from_numpy(x) for x in q[:4]),
                       active=torch.from_numpy(q[4]))
        np.testing.assert_array_equal(occ.numpy(),
                                      _both(jds, tds, q, True)[1] >= 0)


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["closest_hit", "any_hit"])
@pytest.mark.parametrize("walk", list(SWITCH))
def test_intersect_vs_jax_pallas_walk(compiled, monkeypatch, walk,
                                      early_exit):
    """Each walk of the switch over the main tables and the BLAS, held
    against the JAX Pallas kernel it stands for (interpret mode)."""
    jds, tds = compiled["gltf"]
    _set_switch(monkeypatch, "1", SWITCH[walk])
    q = _query(1024, 11, early_exit)
    _assert_same(*_both(jds, tds, q, early_exit), early_exit,
                 jds.meta.inst_vtri_base0)


@pytest.mark.parametrize("case", ["grid", "gltf"])
def test_hit_details_vs_jax(compiled, monkeypatch, case):
    """The virtual-triangle decode: shade rows of the BLAS, barycentrics
    from object-space rays, the normal by the inverse transpose, dpdu and
    dpdv by o2w; on JAX's own (t, prim)."""
    jds, tds = compiled[case]
    _set_switch(monkeypatch, "0", {})
    o, d, tmin, tmax, act = _query(2048, 13, False)
    tj, pj = jax_intersect(jds, *(jnp.asarray(x) for x in (o, d, tmin, tmax)))
    hj = jax_hit_details(jds, jnp.asarray(o), jnp.asarray(d), tj, pj)
    ht = hit_details(tds, torch.from_numpy(o), torch.from_numpy(d),
                     torch.from_numpy(np.asarray(tj)),
                     torch.from_numpy(np.asarray(pj)))
    assert (np.asarray(pj) >= jds.meta.inst_vtri_base0).sum() > 100
    for f in ("hit", "prim", "material", "light"):
        np.testing.assert_array_equal(getattr(ht, f).numpy(),
                                      np.asarray(getattr(hj, f)), err_msg=f)
    for f in ("t", "uv", "point", "normal", "dpdu", "dpdv"):
        np.testing.assert_allclose(getattr(ht, f).numpy(),
                                   np.asarray(getattr(hj, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)


def test_render_vs_jax(gltf_files, monkeypatch):
    """A 16x16 diffuse frame (2 spp, depth 3) of the glTF scene, every pixel
    within rtol 1e-5 of JAX's, rays_traced equal."""
    monkeypatch.setenv("TPU_RT_PALLAS", "0")
    js, ts = _scenes("gltf", gltf_files)
    js.camera = js.camera.with_resolution(16, 16)
    ts.camera = ts.camera.with_resolution(16, 16)
    kw = dict(samples_per_pixel=2, light_sample_count=1, max_ray_depth=3)
    want = jax_render(js, JSettings(**kw))
    got = render(ts, RaytracerSettings(**kw), "cpu")
    assert got.rays_traced == want.rays_traced
    assert (want.beauty.sum(-1) > 0).mean() > 0.5
    np.testing.assert_allclose(got.beauty, want.beauty, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", ["grid", "gltf"])
def test_instanced_render_matches_baked(gltf_files, case):
    """The port's frame of the instanced scene against the frame of the
    same scene with every mesh baked world-space (MSE < 1e-6)."""
    s = RaytracerSettings(samples_per_pixel=1, light_sample_count=1,
                          max_ray_depth=2, outputs=AovFlags.BEAUTY)
    imgs = []
    for shared in (True, False):
        scene = _scenes(case, gltf_files, shared)[1]
        if case == "gltf":
            scene.camera = scene.camera.with_resolution(96, 96)
        ds = compile_scene(scene, "cpu")
        assert bool(ds.meta.instances) == shared
        imgs.append(render(ds, s, "cpu").beauty)
    assert imgs[0].mean() > 0
    mse = float(np.mean((imgs[0] - imgs[1]) ** 2))
    assert mse < 1e-6, mse
