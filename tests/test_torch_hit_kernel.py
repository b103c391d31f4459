"""The hit_details kernel's contract on the CPU (csrc/hit_details.cu, whose
bit-for-bit tests run on the card in tests/test_torch_cuda.py).

On CPU tensors `hit_details` runs its plain twin, `hit_details_plain`,
and never builds or loads the CUDA library. On CUDA tensors the wrapper
checks every table and lane before it launches: those checks raise here
on CPU tensors of the wrong shape, type or device, before any launch. The
per-scene instance base table the kernel reads is the one the plain code
builds each call; the kernel's constants are read from its source and
held against the plain code's, and its ctypes signature against the C
entry's parameter list.
"""
import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from torch_fixtures import bunnies_glb, hit_calls
from tpu_raytracing_torch import native_cuda, tracing
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.ops import traverse as T
from tpu_raytracing_torch.scene import scene_from_file
from tpu_raytracing_torch.scene.test_scenes import get_test_scene
from tpu_raytracing_torch.settings import RaytracerSettings

torch.set_num_threads(1)

SOURCE = "hit_details.cu"
TEXT = (native_cuda.CSRC / SOURCE).read_text()
SETTINGS = dict(samples_per_pixel=1, light_sample_count=1, max_ray_depth=3)


def _scene(name, tmp_path_factory):
    if name == "bunnies":
        path = tmp_path_factory.mktemp("glb") / "bunnies.glb"
        bunnies_glb(path, instanced=True)
        scene = scene_from_file(str(path))
    else:
        scene = get_test_scene(name).scene_func()
    scene.camera = scene.camera.with_resolution(12, 12)
    return scene


@pytest.fixture(scope="module")
def calls(tmp_path_factory):
    """name -> every hit_details call of a 12x12 CPU render: a sphere and
    triangles (rough_dielectric), four instances over one BLAS."""
    s = RaytracerSettings(**SETTINGS)
    return {name: hit_calls(_scene(name, tmp_path_factory), s, "cpu")
            for name in ("rough_dielectric", "bunnies")}


def _same_bits(got, want) -> bool:
    return all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        if a.dtype == torch.float32 else torch.equal(a, b)
        for a, b in zip(got, want, strict=True))


@pytest.mark.parametrize("name", ["rough_dielectric", "bunnies"])
def test_cpu_tensors_run_the_plain_twin(calls, name, monkeypatch):
    def refuse():
        raise AssertionError("the CUDA library was loaded for CPU tensors")

    monkeypatch.setattr(native_cuda, "load", refuse)
    launched = native_cuda.launch_counts()
    tracing.reset()
    tracing.enable()
    try:
        for ds, *lanes in calls[name]:
            assert _same_bits(T.hit_details(ds, *lanes),
                              T.hit_details_plain(ds, *lanes))
    finally:
        tracing.disable()
    assert native_cuda.launch_counts() == launched
    assert "hit.kernel_lanes" not in tracing.snapshot()


def _broken(lanes, what):
    """The lanes (origin, direction, t, prim) with one made wrong."""
    o, d, t, prim = lanes
    return {
        "origin_shape": (o[:, :2], d, t, prim),
        "direction_rows": (o, d[1:], t, prim),
        "t_dtype": (o, d, t.double(), prim),
        "t_shape": (o, d, t[:, None], prim),
        "prim_dtype": (o, d, t, prim.long()),
        "origin_device": (o.to("meta"), d, t, prim),
    }[what]


@pytest.mark.parametrize("what", ["origin_shape", "direction_rows",
                                  "t_dtype", "t_shape", "prim_dtype",
                                  "origin_device"])
def test_kernel_path_rejects_wrong_lanes(calls, what, monkeypatch):
    """The card's path checks every lane tensor before it launches (run
    here on a CPU scene, where any launch would fail to build)."""
    monkeypatch.setattr(native_cuda, "launch", None)
    ds, *lanes = calls["rough_dielectric"][0]
    with pytest.raises(ValueError, match="hit_details: .* expected"):
        T._hit_kernel(ds, *_broken(lanes, what))


def test_kernel_path_rejects_a_misaligned_table(calls, monkeypatch):
    monkeypatch.setattr(native_cuda, "launch", None)
    ds, *lanes = calls["rough_dielectric"][0]
    rows = ds.tri_shade.shape[0]
    bad = torch.empty(rows * 32 + 1)[1:].view(rows, 32)  # 4 bytes off
    bad.copy_(ds.tri_shade)
    with pytest.raises(ValueError, match="tri_shade: the kernel reads"):
        T._hit_kernel(dataclasses.replace(ds, tri_shade=bad), *lanes)


def test_unsupported_device_raises(calls):
    ds, *lanes = calls["rough_dielectric"][0]
    with pytest.raises(ValueError, match="unsupported device"):
        T.hit_details(ds, *(x.to("meta") for x in lanes))


def _plain_table(ds) -> torch.Tensor:
    """The instance base table as hit_details_plain builds it each call."""
    instances = ds.meta.instances
    return torch.tensor(
        [[vb for _, vb, _, _ in instances], [so for *_, so in instances]],
        dtype=torch.int32, device=ds.device)


@pytest.mark.parametrize("name", ["rough_dielectric", "bunnies"])
def test_instance_bases_match_the_plain_table(calls, name):
    ds = calls[name][0][0]
    assert ds.inst_bases.dtype == torch.int32
    assert ds.inst_bases.device == ds.device
    assert torch.equal(ds.inst_bases, _plain_table(ds))
    if name == "bunnies":
        vbase = ds.inst_bases[0]
        assert ds.inst_bases.shape == (2, 4)
        assert int(vbase[0]) == ds.meta.inst_vtri_base0
        assert bool((vbase[1:] > vbase[:-1]).all())
    else:
        assert ds.inst_bases.shape == (2, 0)


def test_instance_bases_built_once_per_scene():
    """compile_scene builds the table beside the JAX-identical leaves; it
    is no leaf of its own."""
    from tpu_raytracing_torch.device import scene_buffers as SB

    assert "inst_bases" not in SB.LEAF_NAMES
    scene = get_test_scene("rough_dielectric").scene_func()
    ds = compile_scene(scene, "cpu")
    assert torch.equal(ds.inst_bases, _plain_table(ds))


def _f32(x: float) -> float:
    return float(np.float32(x))


def _literal(name: str) -> float:
    m = re.search(rf"constexpr float {name} = (\S+)f;", TEXT)
    assert m is not None, name
    return float.fromhex(m.group(1))


@pytest.mark.parametrize("name, value", [
    # u = phi / (2.0 * math.pi): phi * (1 / f32(2 pi)) in f32
    ("kInvTwoPi", float(np.float32(1.0) / np.float32(2.0 * math.pi))),
    ("kInflate", _f32(1.0 + 4.0e-7)),
    ("kDegenerateDet", _f32(1e-9)),
])
def test_kernel_float_constants(name, value):
    assert _literal(name) == value


def test_signature_matches_the_c_entry():
    m = re.search(r'extern "C" int tpu_rt_hit_details\(([^)]*)\)', TEXT)
    assert m is not None
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    want = [native_cuda._P if "*" in p else native_cuda._I for p in params]
    assert native_cuda.SIGNATURES["tpu_rt_hit_details"] == want
    assert params[-8:] == ["int n", "int n_tris", "int n_rows",
                           "int n_spheres", "int n_sph_rows", "int n_inst",
                           "int inst_vtri_base0", "void* stream"]
