"""The coat kernel's contract on the CPU (csrc/layered_walk.cu with the
pieces it shares in csrc/bsdf_common.cuh, whose own tests run on the card
in tests/test_torch_cuda.py).

On CPU tensors `layered_eval` and `layered_sample` run their plain twins
and never build or load the CUDA library. The kernel's constants are read
from its source, as probes/common.py::source_int reads a kernel's layout,
and held against the plain twins: the loop counts, the draws' dimensions
(recorded from the plain twins' hash calls), the material and component
codes, and each f32 constant against the Python float it rounds; the
ctypes signatures against the C entries' parameter lists.
"""
import inspect
import math
import re

import numpy as np
import pytest
import torch

from tpu_raytracing_torch import native_cuda, tracing
from tpu_raytracing_torch.device import scene_buffers as SB
from tpu_raytracing_torch.ops import bsdf as B
from tpu_raytracing_torch.ops import layered as L
from tpu_raytracing_torch.ops import linalg
from tpu_raytracing_torch.probes.common import source_int

SOURCE = "layered_walk.cu"
HEADER = "bsdf_common.cuh"  # the BSDF pieces it shares with bsdf_kinds.cu
TEXT = "\n".join((native_cuda.CSRC / name).read_text()
                 for name in (SOURCE, HEADER))


def _int(name: str) -> int:
    try:
        return source_int(SOURCE, f"constexpr int {name}")
    except LookupError:
        return source_int(HEADER, f"constexpr int {name}")


def _lanes(n: int, seed: int):
    """Seeded rough and smooth coats, most with a medium (white on a
    third, as the bunny's), so that some walks run every depth."""
    g = np.random.default_rng(seed)
    ax = np.where(g.random(n) < 0.3, 1e-3, 0.05 + 0.45 * g.random(n))
    medium = np.where((g.random(n) < 0.2)[:, None], 0.0, g.random((n, 3)))
    medium[g.random(n) < 0.3] = 1.0
    wo = g.normal(size=(n, 3))
    wi = g.normal(size=(n, 3))
    wi[:, 2] = np.abs(wi[:, 2]) * np.sign(wo[:, 2])
    f32 = [torch.from_numpy(np.asarray(x, np.float32)) for x in (
        g.random((n, 3)), np.repeat(1.2 + 0.8 * g.random((n, 1)), 3, 1),
        np.zeros((n, 3)), ax, ax, 0.01 + g.random(n), medium,
        wo / np.linalg.norm(wo, axis=1, keepdims=True),
        wi / np.linalg.norm(wi, axis=1, keepdims=True))]
    albedo, eta, kappa, ax_, ay_, thickness, coat_albedo, wo_t, wi_t = f32
    top = torch.from_numpy(np.where(ax <= 1e-3, 1, 3).astype(np.int32))
    params = B.BsdfParams(torch.full((n,), 5, dtype=torch.int32), albedo,
                          eta, kappa, ax_, ay_, top, thickness, coat_albedo)
    draw_base = torch.from_numpy(g.integers(0, 1 << 32, n, dtype=np.int64))
    return params, wo_t, wi_t, draw_base


@pytest.mark.parametrize("kind", ["eval", "sample"])
def test_cpu_tensors_run_the_plain_twin(kind, monkeypatch):
    def refuse():
        raise AssertionError("the CUDA library was loaded for CPU tensors")

    monkeypatch.setattr(native_cuda, "load", refuse)
    params, wo, wi, draw_base = _lanes(64, 0)
    launched = native_cuda.launch_counts()
    tracing.reset()
    tracing.enable()
    try:
        if kind == "eval":
            got = (L.layered_eval(params, wo, wi),)
            want = (L.layered_eval_plain(params, wo, wi),)
        else:
            got = tuple(L.layered_sample(params, wo, draw_base))
            want = tuple(L.layered_sample_plain(params, wo, draw_base))
    finally:
        tracing.disable()
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    assert native_cuda.launch_counts() == launched
    assert "coat.kernel_lanes" not in tracing.snapshot()


@pytest.mark.parametrize("name, value", [
    ("N_SAMPLES", L.N_SAMPLES),
    ("MAX_DEPTH", L.MAX_DEPTH),
    ("MAT_SMOOTH_DIELECTRIC", SB.MAT_SMOOTH_DIELECTRIC),
    ("NONSPECULAR_REFLECTION", B.NONSPECULAR_REFLECTION),
    ("SPECULAR_REFLECTION", B.SPECULAR_REFLECTION),
    ("NONSPECULAR_TRANSMISSION", B.NONSPECULAR_TRANSMISSION),
    ("SPECULAR_TRANSMISSION", B.SPECULAR_TRANSMISSION),
])
def test_kernel_int_constants(name, value):
    assert _int(name) == value


def _recorded_dims(kind: str, monkeypatch) -> set:
    """The (sample, dimension) (eval) or dimension (sample) of every draw
    the plain twin makes on lanes whose walks reach every depth."""
    seen = set()
    hash_u32 = L.hash_u32

    def record(*words):
        ints = tuple(w for w in words if isinstance(w, int))
        if ints:
            seen.add(ints if kind == "eval" else ints[0])
        return hash_u32(*words)

    monkeypatch.setattr(L, "hash_u32", record)
    params, wo, wi, draw_base = _lanes(256, 1)
    if kind == "eval":
        L.layered_eval_plain(params, wo, wi)
    else:
        L.layered_sample_plain(params, wo, draw_base)
    return seen


def _kernel_depth_dims() -> set:
    """Every dimension of a depth step, from the kernel's constants. The
    plain twins draw the roulette's at every depth; the kernel only from
    RR_FROM_DEPTH on, where it can end a walk (test_roulette_from_depth)."""
    base, stride = _int("DIM_BASE"), _int("DIM_STRIDE")
    phase, iface = _int("D_PHASE"), _int("D_IFACE")
    offsets = (_int("D_RR"), _int("D_DZ"), phase, phase + 1, iface,
               iface + 1, iface + 2)
    return {base + depth * stride + k for depth in range(_int("MAX_DEPTH"))
            for k in offsets}


@pytest.mark.parametrize("fn", [L.layered_eval_plain,
                                L.layered_sample_plain])
def test_roulette_from_depth(fn):
    assert "rr_on = (depth > 3)" in inspect.getsource(fn)
    assert _int("RR_FROM_DEPTH") == 4


def test_kernel_draw_dims_eval(monkeypatch):
    enter, exit_ = _int("DIM_ENTER"), _int("DIM_EXIT")
    dims = ({enter, enter + 1, enter + 2, exit_, exit_ + 1, exit_ + 2}
            | _kernel_depth_dims())
    want = {(s, d) for s in range(_int("N_SAMPLES")) for d in dims}
    assert _recorded_dims("eval", monkeypatch) == want


def test_kernel_draw_dims_sample(monkeypatch):
    enter = _int("DIM_SAMPLE_ENTER")
    want = {enter, enter + 1, enter + 2} | _kernel_depth_dims()
    assert _recorded_dims("sample", monkeypatch) == want


def _f32(x) -> float:
    return float(np.float32(x))


# the kernel's f32 constant, the Python float it rounds, and the literal
# and the function that holds it where the plain twins write one
FLOATS = [
    ("kPi", _f32(B._PI), None, None),
    ("kInvPi", float(np.float32(1.0) / np.float32(B._PI)), None, None),
    ("kInv2Pi", _f32(1.0 / (2.0 * B._PI)), "1.0 / (2.0 * _PI)",
     B.diffuse_pdf),
    ("kTwoPi", _f32(2.0 * math.pi), "2.0 * math.pi", L.hg_sample),
    ("kHgNorm", _f32((0.25 / math.pi) * (1.0 - L.G_HG * L.G_HG)),
     "(0.25 / math.pi) * (1.0 - g * g)", L.hg_p_cos),
    ("kTwoG", _f32(2.0 * L.G_HG), "2.0 * g", L.hg_p_cos),
    ("kUMax", _f32(0.9999995), "max=0.9999995", L.layered_eval_plain),
    ("kNearPole", _f32(0.8), "< 0.8", linalg.make_orthonormal_basis),
    ("kWhPole", _f32(0.9999), "< 0.9999", B.tr_sample_wm),
    ("kMinNz", _f32(1.0e-6), "min=1.0e-6", B.tr_sample_wm),
    ("kMinDot", _f32(1e-20), "min=1e-20", B._ts_pdf_from),
    ("kLambdaGrazing", _f32(1e8), "1e8", B.tr_lambda),
    ("kRR", _f32(0.25), "< 0.25", L.layered_sample_plain),
]


@pytest.mark.parametrize("name, value, literal, fn", FLOATS,
                         ids=[f[0] for f in FLOATS])
def test_kernel_float_constants(name, value, literal, fn):
    m = re.search(rf"constexpr float {name} = ([^;]+?)f;", TEXT)
    assert m is not None, name
    text = m.group(1)
    got = float.fromhex(text) if text.startswith("0x") else float(text)
    assert got == value
    if literal is not None:
        assert literal in inspect.getsource(fn)


def _c_params(entry: str) -> list:
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', TEXT)
    assert m is not None, entry
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("entry", ["tpu_rt_layered_eval",
                                   "tpu_rt_layered_sample"])
def test_signature_matches_the_c_entry(entry):
    params = _c_params(entry)
    want = [native_cuda._P if "*" in p else native_cuda._I for p in params]
    assert native_cuda.SIGNATURES[entry] == want
    assert params[-2] == "int n" and params[-1] == "void* stream"
