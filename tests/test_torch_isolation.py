"""The port stands alone: it imports nothing of jax or of the JAX package,
its copies of the host modules build what the JAX package builds, and its
entry points run on the card unless the caller asks for the CPU.
"""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_raytracing.accel import build_bvh as jax_build_bvh
from tpu_raytracing.scene.test_scenes import get_test_scene as jax_test_scene
from tpu_raytracing_torch.accel import build_bvh
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.integrator.render import render
from tpu_raytracing_torch.scene.test_scenes import get_test_scene
from tpu_raytracing_torch.settings import RaytracerSettings

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tpu_raytracing_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_fixtures.py"]
FORBIDDEN = ("jax", "tpu_raytracing", "scripts", "visual_testing")
CUDA_SOURCES = sorted((ROOT / "tpu_raytracing_torch" / "csrc").glob("*.cu*"))


def _imported_modules(path: Path):
    """Absolute module names a file imports (relative imports stay inside
    the port)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _relative_imports(path: Path):
    """(package directory the import resolves in, module path or None,
    imported names) of each relative import of a file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            base = path.parent
            for _ in range(node.level - 1):
                base = base.parent
            yield base, node.module, [a.name for a in node.names]


def _module_exists(base: Path, dotted: str) -> bool:
    target = base.joinpath(*dotted.split("."))
    return (target.with_suffix(".py").is_file()
            or (target / "__init__.py").is_file())


PORT_PACKAGE = sorted((ROOT / "tpu_raytracing_torch").rglob("*.py"))


@pytest.mark.parametrize(
    "path", PORT_PACKAGE,
    ids=[str(p.relative_to(ROOT)) for p in PORT_PACKAGE])
def test_relative_imports_resolve_in_the_port(path):
    """Every relative import names a module of the port itself (a module
    that only the JAX package has would raise ModuleNotFoundError where the
    import runs, which may be deep in a rarely taken branch)."""
    for base, module, names in _relative_imports(path):
        if module is not None:
            assert _module_exists(base, module), (
                f"{path.relative_to(ROOT)}: from {module} ... resolves to "
                f"no module of the port")
            continue
        init = (base / "__init__.py").read_text()
        for name in names:  # from . import x: a submodule or a package name
            assert _module_exists(base, name) or re.search(
                rf"\b{name}\b", init), (
                f"{path.relative_to(ROOT)}: from . import {name} resolves "
                f"to nothing in the port")


@pytest.mark.parametrize(
    "path", CUDA_SOURCES, ids=[p.name for p in CUDA_SOURCES])
def test_cuda_source_includes_only_the_toolkit_and_csrc(path):
    """A kernel source includes the C++ and CUDA headers (<...>) and the
    port's own csrc headers ("..."), nothing of the JAX package's C++
    sources: no include names a directory, and a quoted one is a file of
    csrc."""
    incs = re.findall(r'^\s*#\s*include\s*([<"][^>"]+[>"])', path.read_text(),
                      re.M)
    assert incs, f"{path.name} includes nothing"
    for inc in incs:
        name = inc[1:-1]
        assert "/" not in name and "\\" not in name and ".." not in name, inc
        if inc.startswith('"'):
            assert (path.parent / name).is_file(), inc


def _prim_boxes(tri_arrays):
    p0, p1, p2 = tri_arrays
    return (np.minimum(np.minimum(p0, p1), p2),
            np.maximum(np.maximum(p0, p1), p2))


def _scene_tris(scene):
    """World-space vertex triples of every mesh of a builtin scene (both
    packages' scenes hold the same meshes and transforms)."""
    from tpu_raytracing_torch.device.scene_buffers import (
        _flatten_primitives, _instance_groups, _triangle_soup,
    )

    prims = _flatten_primitives(scene)
    return _triangle_soup(prims, _instance_groups(prims))[0:3]


@pytest.mark.parametrize("name", ["coated_diffuse_bunny", "cube"])
def test_numpy_builder_equals_native(name):
    """The port's numpy BVH builder against the JAX package's builder
    (native C++ where it is built), array for array."""
    lo, hi = _prim_boxes(_scene_tris(get_test_scene(name).scene_func()))
    want = jax_build_bvh(lo, hi)
    got = build_bvh(lo, hi)
    for f in ("node_min", "node_max", "left_first", "count", "skip",
              "prim_order"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("name", ["coated_diffuse_bunny", "cube", "sphere",
                                  "checkered_plane", "environment_light"])
def test_scene_copies_match(name):
    """The port's builtin scenes hold the JAX package's meshes, materials,
    textures, images (byte for byte) and lights."""
    a = get_test_scene(name).scene_func()
    b = jax_test_scene(name).scene_func()
    assert [type(p).__name__ for p in a.primitives] == [
        type(p).__name__ for p in b.primitives]
    assert [type(t).__name__ for t in a.textures] == [
        type(t).__name__ for t in b.textures]
    assert len(a.images) == len(b.images)
    for x, y in zip(a.images, b.images):
        assert x.data.dtype == y.data.dtype and x.data.shape == y.data.shape
        assert x.data.tobytes() == y.data.tobytes()
    assert (a.environment_light is None) == (b.environment_light is None)
    assert [type(m).__name__ for m in a.materials] == [
        type(m).__name__ for m in b.materials]
    assert [type(x).__name__ for x in a.lights] == [
        type(x).__name__ for x in b.lights]
    assert (a.camera.raster_width, a.camera.raster_height) == (
        b.camera.raster_width, b.camera.raster_height)


def test_entry_points_default_to_the_card():
    """compile_scene and render without `device` run on cuda, so without a
    card they raise; the CPU is used only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene = get_test_scene("cube").scene_func()
    with pytest.raises(RuntimeError, match="CUDA"):
        compile_scene(scene)
    settings = RaytracerSettings(samples_per_pixel=1, max_ray_depth=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        render(scene, settings)
    assert compile_scene(scene, "cpu").device.type == "cpu"


def test_harness_and_native_library_stand_alone():
    """With jax, the JAX package and the JAX harness made unimportable, the
    port's rttest harness reads the suite and the committed references and
    gates a reference against itself, and the native host library builds
    the bunny's BVH."""
    code = (
        "import sys\n"
        "for m in ('jax', 'tpu_raytracing', 'visual_testing'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from tpu_raytracing_torch import native\n"
        "from tpu_raytracing_torch.rttest import diff, digest, main, runner\n"
        "from tpu_raytracing_torch.rttest.test_spec import load_test_suite\n"
        "specs = load_test_suite(main.SUITE)\n"
        "refs = digest.References(main.REFERENCES)\n"
        "rec, exr = refs.lookup('cube')\n"
        "assert diff.compare_images(exr, exr).mse == 0.0\n"
        "spec = next(s for s in specs if s.name == 'cube')\n"
        "assert runner.gate(spec, exr, refs, main.SCENE_BASE)[0] == 'PASS'\n"
        "assert native.get_lib() is not None\n"
        "from tpu_raytracing_torch.device import compile_scene\n"
        "from tpu_raytracing_torch.scene.test_scenes import get_test_scene\n"
        "sc = get_test_scene('coated_diffuse_bunny').scene_func()\n"
        "assert compile_scene(sc, 'cpu').meta.n_tris == 28586\n"
        "assert not any(m.split('.')[0] in ('jax', 'tpu_raytracing', "
        "'visual_testing') for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "TPU_RAYTRACING_NO_NATIVE")}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
