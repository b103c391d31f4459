"""The port's scene tables against the JAX package's, leaf by leaf.

Each package compiles its own copy of the scene (the port has its own
scene, geometry and BVH builder modules). Every table the port builds must
be byte-identical to the JAX leaf of the same name, the traversal layouts
of every walk the kernel switch selects included (the bvh8t node blocks
hold NaN in empty slots, so all tables are compared as raw bytes).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from tpu_raytracing.device import compile_scene as jax_compile_scene
from tpu_raytracing.scene.test_scenes import get_test_scene as jax_test_scene
from tpu_raytracing_torch.device import compile_scene, from_jax_leaves
from tpu_raytracing_torch.device.scene_buffers import LEAF_NAMES, SceneMeta
from tpu_raytracing_torch.scene.test_scenes import get_test_scene

from chip_smoke import emissive_box, textured_cubes

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[
    "coated_diffuse_bunny", "cube", "dielectric", "rough_metal",
    "out_of_focus_sphere"])
def both(request):
    return (jax_compile_scene(jax_test_scene(request.param).scene_func()),
            compile_scene(get_test_scene(request.param).scene_func(), "cpu"))


def _jax_leaves(jds):
    return {k: np.asarray(getattr(jds, k)) for k in LEAF_NAMES}


def _same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.ascontiguousarray(a).tobytes()
            == np.ascontiguousarray(b).tobytes())


@pytest.mark.parametrize("leaf", LEAF_NAMES)
def test_leaf_byte_identical(both, leaf):
    jds, tds = both
    want = np.asarray(getattr(jds, leaf))
    got = getattr(tds, leaf).numpy()
    assert _same_bytes(want, got), leaf


def test_meta_matches_jax(both):
    jds, tds = both
    jm = dataclasses.asdict(jds.meta)
    for f in dataclasses.fields(SceneMeta):
        want = jm[f.name]
        want = tuple(tuple(x) if isinstance(x, (list, tuple)) else x
                     for x in want) if isinstance(want, (list, tuple)) else want
        assert getattr(tds.meta, f.name) == want, f.name


def test_from_jax_leaves_same_scene(both):
    jds, tds = both
    fj = from_jax_leaves(_jax_leaves(jds), dataclasses.asdict(jds.meta), "cpu")
    assert fj.meta == tds.meta
    for k in LEAF_NAMES:
        assert _same_bytes(getattr(fj, k).numpy(), getattr(tds, k).numpy()), k


def test_bunny_shapes():
    """The bench scene's traversal tables: bvh8t at W=16, LG=16, and the
    layouts of the other walks."""
    tds = compile_scene(get_test_scene("coated_diffuse_bunny").scene_func(),
                        "cpu")
    assert tuple(tds.t8_nodes.shape) == (736, 128)
    assert tuple(tds.t8_meta.shape) == (722, 2)
    assert tuple(tds.t8_tris.shape) == (3408, 128)
    assert tds.meta.n_tris == 28586 and tds.meta.t8_stack == 6
    assert tds.meta.mat_kinds_present == (0, 5)
    assert tuple(tds.bvh_nodes_pk.shape) == (1150, 128)
    assert tuple(tds.tri_pack_pk.shape) == (3574, 128)
    assert tuple(tds.bvh2_rows_pk.shape) == (1149, 128)
    assert tuple(tds.bvh4_recs_pk.shape) == (1171, 128)
    assert tuple(tds.bvh4_rows.shape) == (4688, 128)
    assert tuple(tds.tri_rows.shape) == (9200, 128)
    assert tds.meta.n_bvh_nodes == 18385 and tds.meta.bvh2_depth == 19
    assert tds.meta.bvh4_stack == 33


@pytest.mark.parametrize("table", ["t8_tris", "tri_rows"])
def test_triangle_rows_pad_with_zeros(both, table):
    """Every triangle stands in exactly one slot (p0, e1 or p1, e2 or p2,
    id) of the bvh8t groups and of the quadrow leaf rows, and the slots
    that pad them are zero in every word. The kernels' counters and
    chip_smoke.py's bound count a slot as work iff its nine vertex words
    are not all zero."""
    _, tds = both
    tab = getattr(tds, table).numpy()
    if table == "t8_tris":  # (blocks x LG rows, 128): 12 groups of 10 lanes
        slots = tab.reshape(-1, 128)[:, :120].reshape(-1, 10)
    else:                   # (rows, 128): 8 slots of 16 lanes
        slots = tab.reshape(-1, 16)
    used = np.any(slots[:, :9] != 0, axis=1)
    assert np.all(slots[~used] == 0)
    ids = np.ascontiguousarray(slots[used, 9]).view(np.int32)
    np.testing.assert_array_equal(np.sort(ids), np.arange(tds.meta.n_tris))


def _outside_scene(case, tmod, mmod, geom):
    """A scene beyond the builtin set, built from one package's own modules
    (scene.test_scenes, materials, geometry): the cube with an image or a
    mix texture for albedo; chip_smoke.py's emissive Cornell box (an area
    light beside the point light) and textured cubes, at 64x64; or the
    Cornell box with an emissive sphere (`sphere_emitter`: outside the
    port) or an instanced mesh (`instanced_mesh`)."""
    if case == "emissive_quad":
        scene = emissive_box(tmod, mmod, geom)
        scene.camera = scene.camera.with_resolution(64, 64)
        return scene
    if case == "textured_cube":
        return textured_cubes(64, tmod, mmod, geom)
    if case in ("sphere_emitter", "instanced_mesh"):
        sb = tmod.cornell_box()
        white = sb.add_constant_texture(tmod.v4(1, 1, 1, 1))
        mat = sb.add_material(mmod.Diffuse(albedo=white))
        if case == "sphere_emitter":
            sb.add_shape_with_transform(
                geom.Sphere(tmod.v3(0, 0, 0), 0.25), mat,
                geom.Transform.translate(tmod.v3(0, 0, 0.75)),
                area_light_radiance=np.array([5.0, 5.0, 5.0], np.float32))
        else:  # one 18-triangle grid placed twice
            prims = importlib.import_module(tmod.__name__.rsplit(".", 1)[0])
            g = np.linspace(-0.2, 0.2, 4)
            verts = [(x, y, 0.0) for y in g for x in g]
            tris = [t for j in range(3) for i in range(3) for t in (
                [4 * j + i, 4 * j + i + 1, 4 * j + i + 5],
                [4 * j + i + 5, 4 * j + i + 4, 4 * j + i])]
            grid = sb.add_primitive(prims.BasicPrimitive(
                shape=geom.TriangleMesh(tmod.make_mesh(
                    verts, tris, [(0.0, 0.0, 1.0)] * 16)), material=mat))
            for x in (-0.4, 0.4):
                t = geom.Transform.translate(tmod.v3(x, 0, 0.3))
                sb.add_root_child(sb.add_primitive(
                    prims.TransformPrimitive(primitive=grid, transform=t)))
        return sb.build()
    sb = tmod.SceneBuilder()
    a = sb.add_constant_texture(tmod.v4(1, 0, 0, 1))
    if case == "image_texture":
        img = sb.add_image(mmod.Image(np.full((4, 4, 3), 0.5, np.float32)))
        tex = sb.add_texture(mmod.ImageTexture(image=img))
    else:
        b = sb.add_constant_texture(tmod.v4(0, 1, 0, 1))
        c = sb.add_constant_texture(tmod.v4(0.5, 0.5, 0.5, 1))
        tex = sb.add_texture(mmod.MixTexture(a=a, b=b, c=c))
    mat = sb.add_material(mmod.Diffuse(albedo=tex))
    sb.add_shape_at_position(geom.TriangleMesh(tmod.make_cube(1.0)), mat,
                             tmod.v3(0, 0, -3))
    sb.add_camera(tmod.Camera.lookat_camera_perspective(
        tmod.v3(1, 0.75, -1), tmod.v3(0, 0, -3), tmod.v3(0, 1, 0), False,
        np.deg2rad(45.0), 64, 64))
    return sb.build()


def _builtin(name):
    return (get_test_scene(name).scene_func(),
            jax_test_scene(name).scene_func())


def _built(case):
    import tpu_raytracing.geometry as JG
    import tpu_raytracing.materials as JM
    import tpu_raytracing.scene.test_scenes as JS
    import tpu_raytracing_torch.geometry as TG
    import tpu_raytracing_torch.materials as TM
    import tpu_raytracing_torch.scene.test_scenes as TS

    return _outside_scene(case, TS, TM, TG), _outside_scene(case, JS, JM, JG)


BEYOND_BUILTINS = ("image_texture", "mix_texture", "emissive_quad",
                   "textured_cube")


def _pair(name):
    """(port scene, JAX scene) of a builtin or an `_outside_scene` case."""
    return _built(name) if name in BEYOND_BUILTINS + (
        "sphere_emitter", "instanced_mesh") else _builtin(name)


@pytest.mark.parametrize("name", [
    "image_texture",          # image texture
    "mix_texture",            # mix texture
    "checkered_plane",        # checker texture
    "environment_light",      # environment light, NEAREST image
    "emissive_quad",          # area light
    "textured_cube",          # trilinear pyramid, scale, mix
    "instanced_mesh",         # a shared BLAS and its instance tables
])
def test_textures_and_lights_byte_identical(name):
    """compile_scene and from_jax_leaves give JAX's leaves, byte for byte
    (the mip atlas, texture rows, emitter rows and instance tables
    included; tests/test_torch_instancing.py holds the BLAS leaves), and
    JAX's meta."""
    port_scene, jax_scene = _pair(name)
    tds = compile_scene(port_scene, "cpu")
    jds = jax_compile_scene(jax_scene)
    jm = dataclasses.asdict(jds.meta)
    leaves = _jax_leaves(jds)
    leaves["blas_tables"] = [{k: np.asarray(v) for k, v in b._asdict().items()}
                             for b in jds.blas_tables]
    fj = from_jax_leaves(leaves, jm, "cpu")
    assert fj.meta == tds.meta
    for k in LEAF_NAMES:
        want = np.asarray(getattr(jds, k))
        assert _same_bytes(want, getattr(tds, k).numpy()), k
        assert _same_bytes(want, getattr(fj, k).numpy()), k
    for f in dataclasses.fields(SceneMeta):
        want = jm[f.name]
        want = tuple(tuple(x) if isinstance(x, (list, tuple)) else x
                     for x in want) if isinstance(want, (list, tuple)) else want
        assert getattr(tds.meta, f.name) == want, f.name


@pytest.mark.parametrize("name", ["sphere_emitter"])
def test_outside_slice_raises(name):
    """An area light on a sphere (JAX asserts against it) raises on the
    port."""
    port_scene, _ = _pair(name)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        compile_scene(port_scene, "cpu")


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        compile_scene(get_test_scene("cube").scene_func(), "cuda")
