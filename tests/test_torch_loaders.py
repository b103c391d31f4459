"""The port's glTF and PBRT loaders against the JAX package's: the same
Scene, field for field (arrays byte for byte), and the same compiled
tables.

The PBRT files are those of tests/test_loaders.py's tmp_path tests (named
materials and textures, a distant light, an area light applied to the next
shape) and one with a triangle mesh, a plymesh-free PBRT scene both
compilers take; the glTF file is tests/test_torch_instancing.py's (a
32-triangle mesh named by two nodes, a floor, a camera node and a
KHR_lights_punctual point light). Tests that need /root/reference/scenes
are left out: the directory is absent.
"""
import dataclasses
import enum

import numpy as np
import pytest

from tpu_raytracing.device import compile_scene as jax_compile_scene
from tpu_raytracing.scene.loaders import scene_from_file as jax_load
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.device.scene_buffers import (
    BLAS_LEAF_NAMES, LEAF_NAMES,
)
from tpu_raytracing_torch.lights import (
    DiffuseAreaLight, DirectionLight, PointLight,
)
from tpu_raytracing_torch.materials import ConstantTexture, Diffuse
from tpu_raytracing_torch.scene import (
    BasicPrimitive, PinholePerspective, TransformPrimitive,
)
from tpu_raytracing_torch.scene.loaders import (
    scene_from_file, scene_from_pbrt_file,
)

from test_torch_instancing import _write_gltf

NAMED = """
Film "rgb" "integer xresolution" [32] "integer yresolution" [32]
LookAt 0 0 4 0 0 0 0 1 0
Camera "perspective" "float fov" [45]
WorldBegin
LightSource "distant" "rgb L" [1 2 3] "point3 from" [0 0 1] "point3 to" [0 0 0]
Texture "red" "spectrum" "constant" "rgb value" [1 0 0]
MakeNamedMaterial "mymat" "string type" "diffuse" "texture reflectance" "red"
NamedMaterial "mymat"
Shape "sphere" "float radius" [2]
AttributeBegin
Material "conductor" "float roughness" [0.2]
Shape "sphere" "float radius" [1]
AttributeEnd
"""
AREA = """
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
LookAt 0 0 4 0 0 0 0 1 0
Camera "perspective" "float fov" [45]
WorldBegin
AttributeBegin
AreaLightSource "diffuse" "rgb L" [5 5 5] "float scale" [2]
Shape "sphere" "float radius" [1]
AttributeEnd
Shape "sphere" "float radius" [0.5]
"""
MESH = """
Film "rgb" "integer xresolution" [24] "integer yresolution" [16]
LookAt 0 1 5 0 0 0 0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "point" "rgb I" [10 10 10] "point3 from" [1 3 2]
AttributeBegin
Translate 0 -0.5 0
Rotate 30 0 1 0
Material "diffuse" "rgb reflectance" [0.2 0.6 0.3]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [-1 0 -1 1 0 -1 1 0 1 -1 0 1]
  "normal N" [0 1 0 0 1 0 0 1 0 0 1 0]
  "point2 uv" [0 0 1 0 1 1 0 1]
AttributeEnd
Shape "sphere" "float radius" [0.4]
"""
PBRT = {"named": NAMED, "area": AREA, "mesh": MESH}


def _same(a, b, path="scene"):
    """Field for field: the same class name, equal scalars, arrays of the
    same dtype, shape and bytes."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.ascontiguousarray(a).tobytes() == (
            np.ascontiguousarray(b).tobytes()), path
    elif isinstance(a, enum.Enum):
        assert type(a).__name__ == type(b).__name__, path
        assert a.value == b.value, path
    elif dataclasses.is_dataclass(a) or hasattr(a, "__dict__"):
        assert type(a).__name__ == type(b).__name__, path
        assert vars(a).keys() == vars(b).keys(), path
        for k in vars(a):
            _same(getattr(a, k), getattr(b, k), f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b, (path, a, b)


def _same_tables(jds, tds):
    for k in LEAF_NAMES:
        want = np.ascontiguousarray(np.asarray(getattr(jds, k)))
        got = getattr(tds, k).numpy()
        assert want.dtype == got.dtype and want.tobytes() == got.tobytes(), k
    for jb, tb in zip(jds.blas_tables, tds.blas_tables, strict=True):
        for k in BLAS_LEAF_NAMES:
            assert np.asarray(getattr(jb, k)).tobytes() == (
                getattr(tb, k).numpy().tobytes()), k
    for f in dataclasses.fields(tds.meta):
        want = getattr(jds.meta, f.name)
        assert getattr(tds.meta, f.name) == want, f.name


@pytest.mark.parametrize("name", list(PBRT))
def test_pbrt_same_scene_and_tables(tmp_path, name):
    path = tmp_path / f"{name}.pbrt"
    path.write_text(PBRT[name])
    got, want = scene_from_pbrt_file(path), jax_load(path)
    _same(got, want)
    if name == "area":  # an area light on a sphere: both compilers refuse
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            compile_scene(got, "cpu")
        return
    _same_tables(jax_compile_scene(want), compile_scene(got, "cpu"))


def test_pbrt_named_materials_and_textures(tmp_path):
    """tests/test_loaders.py's first tmp_path test on the port."""
    (tmp_path / "s.pbrt").write_text(NAMED)
    sc = scene_from_pbrt_file(tmp_path / "s.pbrt")
    assert len(sc.materials) == 2
    assert isinstance(sc.materials[0], Diffuse)
    tex = sc.textures[sc.materials[0].albedo]
    assert isinstance(tex, ConstantTexture)
    np.testing.assert_allclose(tex.value[:3], [1, 0, 0])
    assert isinstance(sc.lights[0], DirectionLight)
    np.testing.assert_allclose(sc.lights[0].direction, [0, 0, -1], atol=1e-6)


def test_pbrt_area_light_applies_to_next_shape(tmp_path):
    """tests/test_loaders.py's second tmp_path test on the port."""
    (tmp_path / "a.pbrt").write_text(AREA)
    sc = scene_from_pbrt_file(tmp_path / "a.pbrt")
    area = [x for x in sc.lights if isinstance(x, DiffuseAreaLight)]
    assert len(area) == 1
    np.testing.assert_allclose(area[0].radiance, [10, 10, 10])
    basics = [p for p in sc.primitives if isinstance(p, BasicPrimitive)]
    assert len([p for p in basics if p.area_light is not None]) == 1


@pytest.mark.parametrize("shared", [True, False], ids=["instanced", "baked"])
def test_gltf_same_scene_and_tables(tmp_path, shared):
    path = tmp_path / "s.glb"
    _write_gltf(path, shared)
    got, want = scene_from_file(path), jax_load(path)
    _same(got, want)
    assert got.camera.raster_height == 600
    assert isinstance(got.camera.camera_type, PinholePerspective)
    assert [type(x) for x in got.lights] == [PointLight]
    n_tp = sum(isinstance(p, TransformPrimitive) for p in got.primitives)
    n_basic = sum(isinstance(p, BasicPrimitive) for p in got.primitives)
    assert (n_tp, n_basic) == (4, 2 if shared else 4)
    _same_tables(jax_compile_scene(want), compile_scene(got, "cpu"))
