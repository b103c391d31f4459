"""The port's native host library (tpu_raytracing_torch/native.py): the
C++ BVH builder against the port's numpy builder and the JAX package's
native builder, array for array, and the C++ PIZ Huffman decode against the
Python one. Mirrors tests/test_native.py and the Huffman cases of
tests/test_exr_piz.py.
"""
import gzip
import os
from pathlib import Path

import numpy as np
import pytest

from tpu_raytracing.accel.bvh import build_bvh as jax_build_bvh
from tpu_raytracing_torch import native
from tpu_raytracing_torch.accel.bvh import build_bvh
from tpu_raytracing_torch.geometry import load_ply
from tpu_raytracing_torch.utils import exr_piz

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("node_min", "node_max", "left_first", "count", "skip", "prim_order")


def _bunny_boxes():
    asset = ROOT / "tpu_raytracing_torch/scene/assets/bunny.ply.gz"
    mesh = load_ply(gzip.decompress(asset.read_bytes()))
    p = mesh.vertices[mesh.tris]
    return p.min(axis=1), p.max(axis=1)


def _random_boxes():
    rng = np.random.default_rng(0)
    c = rng.random((2000, 3)).astype(np.float32) * 50
    h = rng.random((2000, 3)).astype(np.float32)
    return c - h, c + h


BOXES = {
    "random": _random_boxes,
    "bunny": _bunny_boxes,
    "same_centroid": lambda: (np.zeros((20, 3), np.float32),
                              np.ones((20, 3), np.float32)),
    "single": lambda: (np.zeros((1, 3), np.float32),
                       np.ones((1, 3), np.float32)),
}


@pytest.fixture
def native_on(monkeypatch):
    monkeypatch.delenv("TPU_RAYTRACING_NO_NATIVE", raising=False)
    assert native.get_lib() is not None


def _same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("boxes", BOXES)
@pytest.mark.parametrize("against", ["port_numpy", "jax_native"])
def test_native_builder_array_for_array(native_on, monkeypatch, boxes,
                                        against):
    pmin, pmax = BOXES[boxes]()
    got = build_bvh(pmin, pmax)
    if against == "port_numpy":
        monkeypatch.setenv("TPU_RAYTRACING_NO_NATIVE", "1")
        want = build_bvh(pmin, pmax)
    else:
        want = jax_build_bvh(pmin, pmax, use_native=True)
    _same(got, want)


def test_switch_selects_the_numpy_builder(monkeypatch):
    """TPU_RAYTRACING_NO_NATIVE set: no library, the numpy builder runs
    (read at each call, as in the JAX package's meaning)."""
    monkeypatch.setenv("TPU_RAYTRACING_NO_NATIVE", "1")
    assert native.get_lib() is None
    calls = []
    monkeypatch.setattr(native, "build_bvh_native",
                        lambda *a: calls.append(a))
    pmin, pmax = BOXES["random"]()
    _same(build_bvh(pmin, pmax), jax_build_bvh(pmin, pmax))
    assert not calls


_rng = np.random.default_rng(42)
HUF_DATA = {
    "single": np.array([7], np.uint16),
    "zeros": np.zeros(300, np.uint16),
    "small-alphabet": _rng.integers(0, 50, 1000).astype(np.uint16),
    "runs": np.repeat(_rng.integers(0, 65536, 16), 256).astype(np.uint16),
    "dense": _rng.integers(0, 65536, 65537).astype(np.uint16),
    "max-sym": np.full(1000, 65535, np.uint16),
}


@pytest.mark.parametrize("name", HUF_DATA)
def test_huffman_native_equals_python(native_on, name):
    data = HUF_DATA[name]
    comp = exr_piz.huf_compress(data)
    out_py = exr_piz._huf_uncompress_py(comp, len(data))
    np.testing.assert_array_equal(out_py, data)
    out = native.huf_uncompress_native(native.get_lib(), comp, len(data))
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, data)
    np.testing.assert_array_equal(exr_piz.huf_uncompress(comp, len(data)),
                                  data)


@pytest.mark.parametrize("switch", ["native", "python"])
def test_huffman_rejects_malformed(monkeypatch, switch):
    if switch == "python":
        monkeypatch.setenv("TPU_RAYTRACING_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("TPU_RAYTRACING_NO_NATIVE", raising=False)
    data = np.random.default_rng(42).integers(0, 1000, 512).astype(np.uint16)
    comp = bytearray(exr_piz.huf_compress(data))
    with pytest.raises(ValueError):
        exr_piz.huf_uncompress(bytes(comp[:10]), 512)
    with pytest.raises(ValueError):
        exr_piz.huf_uncompress(bytes(comp), 513)  # wrong expected count


def test_build_failure_raises(monkeypatch, tmp_path):
    """Unlike the JAX package, a failed build raises; nothing falls back."""
    bad = tmp_path / "bin"
    bad.mkdir()
    gxx = bad / "g++"
    gxx.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 1\n")
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bad}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.delenv("TPU_RAYTRACING_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.get_lib()
    pmin, pmax = BOXES["single"]()
    with pytest.raises(RuntimeError, match="build failed"):
        build_bvh(pmin, pmax)
    assert not list((tmp_path / "build").glob("*"))


def test_library_is_built_from_the_port_sources():
    """The library builds from the port's own copies under csrc/host, which
    the CUDA build's globs (*.cu, *.cuh) do not pick up."""
    from tpu_raytracing_torch import native_cuda

    names = [p.name for p in native._sources()]
    assert names == ["bvh_builder.cpp", "exr_huf.cpp"]
    assert all(p.parent == ROOT / "tpu_raytracing_torch/csrc/host"
               for p in native._sources())
    assert not any(p.suffix == ".cpp" for p in native_cuda._sources())
