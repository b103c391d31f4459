"""The shading kernel's contract on the CPU (csrc/bsdf_kinds.cu with the
pieces it shares in csrc/bsdf_common.cuh, whose own tests run on the card
in tests/test_torch_cuda.py).

On CPU tensors `bsdf_sample` and `bsdf_eval` run their plain twins and
never build or load the CUDA library. The plain twins are the predicated
dispatch: each lane gets its own kind's result from ops/bsdf.py (the
component flags tested against `allowed`), the coated lanes the caller
consumes the layered walk's, every other lane the null sample or zero f,
which is what the kernel computes lane by lane. The kernel's constants
are read from its sources and held against the plain code, and its
ctypes signatures against the C entries' parameter lists.
"""
import inspect
import math
import re

import numpy as np
import pytest
import torch

from torch_fixtures import bsdf_lanes
from tpu_raytracing_torch import native_cuda, tracing
from tpu_raytracing_torch.device import scene_buffers as SB
from tpu_raytracing_torch.ops import bsdf as B
from tpu_raytracing_torch.ops import bsdf_dispatch as D
from tpu_raytracing_torch.ops import complexmath
from tpu_raytracing_torch.ops import layered as L
from tpu_raytracing_torch.ops.rng import (
    SamplerConfig, hash_u32, sample_uniform, sample_uniform2,
)
from tpu_raytracing_torch.probes.common import source_int

torch.set_num_threads(1)

SOURCE = "bsdf_kinds.cu"
HEADER = "bsdf_common.cuh"
TEXT = (native_cuda.CSRC / SOURCE).read_text()
HEADER_TEXT = (native_cuda.CSRC / HEADER).read_text()
ALL_KINDS = (0, 1, 2, 3, 4, 5)
CFG = SamplerConfig("independent", seed=11)


def _active(n, seed, how):
    if how == "none":
        return None
    g = np.random.default_rng(seed + 100)
    return torch.from_numpy(g.random(n) < (0.0 if how == "empty" else 0.6))


def _flag(allowed, flag) -> bool:
    return (allowed & flag) != 0


def _lane_kinds_sample(params, wo, allowed, stream, kinds, active):
    """The sample each lane's own kind gives (ops/bsdf.py), the coated
    lanes' from the layered walk, and the null sample elsewhere."""
    u2, s = sample_uniform2(CFG, stream)
    u1, s = sample_uniform(CFG, s)
    n, k = wo.shape[0], params.kind
    eta = params.eta[..., 0]
    per_kind = {
        SB.MAT_DIFFUSE: lambda: B.diffuse_sample(params.albedo, wo, u2),
        SB.MAT_SMOOTH_DIELECTRIC: lambda: B.smooth_dielectric_sample(
            eta, wo, u1, allowed),
        SB.MAT_SMOOTH_CONDUCTOR: lambda: B.smooth_conductor_sample(
            params.eta, params.kappa, wo),
        SB.MAT_ROUGH_CONDUCTOR: lambda: B.ts_refl_sample(
            wo, params.eta, params.kappa, params.alpha_x, params.alpha_y,
            u2),
        SB.MAT_ROUGH_DIELECTRIC: lambda: B.ts_sample(
            wo, eta, params.alpha_x, params.alpha_y, allowed, u2, u1),
    }
    flags = {SB.MAT_DIFFUSE: B.NONSPECULAR_REFLECTION,
             SB.MAT_SMOOTH_CONDUCTOR: B.SPECULAR_REFLECTION,
             SB.MAT_ROUGH_CONDUCTOR: B.REFLECTION}
    want = [torch.zeros(n, 3), torch.zeros(n, 3), torch.zeros(n),
            torch.zeros(n, dtype=torch.int32),
            torch.zeros(n, dtype=torch.bool)]
    kinds = D._rough_kinds(kinds)
    for kind, fn in per_kind.items():
        lanes = k == kind
        if kind not in kinds or not bool(lanes.any()):
            continue
        got = fn()
        if kind in flags:
            got = got._replace(valid=got.valid & _flag(allowed, flags[kind]))
        for dst, src in zip(want, got):
            dst[lanes] = src[lanes]
    coated = k == SB.MAT_COATED_DIFFUSE
    if active is not None:
        coated = coated & active
    if SB.MAT_COATED_DIFFUSE in kinds and bool(coated.any()):
        lanes = torch.nonzero(coated)[:, 0]
        base = hash_u32(s.px[lanes], s.py[lanes], s.sample[lanes],
                        s.dim[lanes], 0xC0A7ED)
        got = L.layered_sample_plain(
            B.BsdfParams(*(x[lanes] for x in params)), wo[lanes], base)
        for dst, src in zip(want, got):
            dst[lanes] = src
    return want, s


def _lane_kinds_eval(params, wo, wi, kinds, active):
    k, f = params.kind, torch.zeros_like(wo)
    per_kind = {
        SB.MAT_DIFFUSE: lambda: B.diffuse_eval(params.albedo, wo, wi),
        SB.MAT_ROUGH_CONDUCTOR: lambda: B.ts_refl_eval(
            wo, wi, params.eta, params.kappa, params.alpha_x,
            params.alpha_y),
        SB.MAT_ROUGH_DIELECTRIC: lambda: B.ts_eval(
            wo, wi, params.eta[..., 0], params.alpha_x, params.alpha_y),
    }
    kinds = D._rough_kinds(kinds)
    for kind, fn in per_kind.items():
        lanes = k == kind
        if kind in kinds and bool(lanes.any()):
            f[lanes] = fn()[lanes]
    coated = k == SB.MAT_COATED_DIFFUSE
    if active is not None:
        coated = coated & active
    if SB.MAT_COATED_DIFFUSE in kinds and bool(coated.any()):
        lanes = torch.nonzero(coated)[:, 0]
        f[lanes] = L.layered_eval_plain(
            B.BsdfParams(*(x[lanes] for x in params)), wo[lanes], wi[lanes])
    return f


def _same_bits(got, want) -> bool:
    return all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        if a.dtype == torch.float32 else torch.equal(a, b)
        for a, b in zip(got, want, strict=True))


@pytest.mark.parametrize("kind", ["eval", "sample"])
def test_cpu_tensors_run_the_plain_twin(kind, monkeypatch):
    def refuse():
        raise AssertionError("the CUDA library was loaded for CPU tensors")

    monkeypatch.setattr(native_cuda, "load", refuse)
    params, wo, wi, stream = bsdf_lanes(96, 0)
    active = _active(96, 0, "mixed")
    launched = native_cuda.launch_counts()
    tracing.reset()
    tracing.enable()
    try:
        if kind == "eval":
            got = (D.bsdf_eval(params, wo, wi, ALL_KINDS, active),)
            want = (D.bsdf_eval_plain(params, wo, wi, ALL_KINDS, active),)
        else:
            s, st = D.bsdf_sample(params, wo, B.ALL_COMPONENTS, CFG, stream,
                                  ALL_KINDS, active)
            w, wst = D.bsdf_sample_plain(params, wo, B.ALL_COMPONENTS, CFG,
                                         stream, ALL_KINDS, active)
            got, want = (*s, *st), (*w, *wst)
    finally:
        tracing.disable()
    assert _same_bits(got, want)
    assert native_cuda.launch_counts() == launched
    assert "shade.kernel_lanes" not in tracing.snapshot()


SAMPLE_CASES = [
    # (seed, allowed, the kinds the caller names, active)
    (0, B.ALL_COMPONENTS, ALL_KINDS, "mixed"),
    (1, B.ALL_COMPONENTS, ALL_KINDS, "none"),
    (2, B.REFLECTION, ALL_KINDS, "mixed"),
    (3, B.NONSPECULAR, ALL_KINDS, "none"),
    (4, B.SPECULAR_TRANSMISSION | B.NONSPECULAR_REFLECTION, ALL_KINDS,
     "mixed"),
    (5, 0, ALL_KINDS, "none"),
    # rough kinds name their smooth ones; lanes of unnamed kinds stay null
    (6, B.ALL_COMPONENTS, (0, 3, 4), "none"),
    (7, B.ALL_COMPONENTS, (0, 5), "empty"),
]


@pytest.mark.parametrize("seed, allowed, kinds, active", SAMPLE_CASES)
def test_plain_sample_is_each_lanes_kind(seed, allowed, kinds, active):
    params, wo, _, stream = bsdf_lanes(512, seed, edge=0.1)
    act = _active(512, seed, active)
    got, got_stream = D.bsdf_sample_plain(params, wo, allowed, CFG, stream,
                                          kinds, act)
    want, want_stream = _lane_kinds_sample(params, wo, allowed, stream,
                                           kinds, act)
    assert _same_bits(got, want)
    assert _same_bits(got_stream, want_stream)
    assert torch.equal(got_stream.dim, stream.dim + 3)  # three draws a lane
    # allowed 0 leaves only the coat's samples (its walk takes them all)
    uncoated = params.kind != SB.MAT_COATED_DIFFUSE
    assert bool(got.valid[uncoated].any()) == (allowed != 0)


@pytest.mark.parametrize("seed, kinds, active", [
    (0, ALL_KINDS, "mixed"), (1, ALL_KINDS, "none"), (2, (0, 3, 4), "none"),
    (3, (0, 5), "empty"), (4, (1, 2), "mixed")])
def test_plain_eval_is_each_lanes_kind(seed, kinds, active):
    params, wo, wi, _ = bsdf_lanes(512, seed, edge=0.1)
    act = _active(512, seed, active)
    got = D.bsdf_eval_plain(params, wo, wi, kinds, act)
    assert _same_bits((got,), (_lane_kinds_eval(params, wo, wi, kinds, act),))
    if 1 in kinds and 3 not in kinds:  # delta BSDFs evaluate to zero
        smooth = (params.kind == 1) | (params.kind == 2)
        assert bool((got[smooth] == 0).all())


def _int(name: str) -> int:
    try:
        return source_int(SOURCE, f"constexpr int {name}")
    except LookupError:
        return source_int(HEADER, f"constexpr int {name}")


@pytest.mark.parametrize("name, value", [
    ("MAT_DIFFUSE", SB.MAT_DIFFUSE),
    ("MAT_SMOOTH_DIELECTRIC", SB.MAT_SMOOTH_DIELECTRIC),
    ("MAT_SMOOTH_CONDUCTOR", SB.MAT_SMOOTH_CONDUCTOR),
    ("MAT_ROUGH_DIELECTRIC", SB.MAT_ROUGH_DIELECTRIC),
    ("MAT_ROUGH_CONDUCTOR", SB.MAT_ROUGH_CONDUCTOR),
    ("MAT_COATED_DIFFUSE", SB.MAT_COATED_DIFFUSE),
    ("NONSPECULAR_REFLECTION", B.NONSPECULAR_REFLECTION),
    ("SPECULAR_REFLECTION", B.SPECULAR_REFLECTION),
    ("NONSPECULAR_TRANSMISSION", B.NONSPECULAR_TRANSMISSION),
    ("SPECULAR_TRANSMISSION", B.SPECULAR_TRANSMISSION),
])
def test_kernel_int_constants(name, value):
    assert _int(name) == value


def test_kernel_takes_every_kind_but_the_coat():
    """sample_lane and eval_lane have a case for each kind the plain twins
    compute, and none for the coat's, whose kernel runs after."""
    def cases(fn: str) -> set:
        body = TEXT[TEXT.index(fn):]
        body = body[:body.index("\n}\n")]
        return set(re.findall(r"case (MAT_\w+):", body))

    assert cases("__device__ Sample sample_lane(") == {
        "MAT_DIFFUSE", "MAT_SMOOTH_DIELECTRIC", "MAT_SMOOTH_CONDUCTOR",
        "MAT_ROUGH_CONDUCTOR", "MAT_ROUGH_DIELECTRIC"}
    # the smooth kinds are delta BSDFs: bsdf_eval leaves them zero
    assert cases("__device__ V3 eval_lane(") == {
        "MAT_DIFFUSE", "MAT_ROUGH_CONDUCTOR", "MAT_ROUGH_DIELECTRIC"}
    src = inspect.getsource(D.bsdf_eval_plain)
    assert "MAT_SMOOTH" not in src and "MAT_DIFFUSE" in src


def test_kernel_samples_every_component():
    """The kernel samples at allowed = ALL_COMPONENTS, the integrator's one
    value: the dielectrics' templates are instantiated there alone, and no
    component flag is an argument."""
    from tpu_raytracing_torch.integrator import render as R

    assert re.findall(r"ts_sample<(\w+)>", TEXT) == ["ALL_COMPONENTS"]
    assert re.findall(r"smooth_dielectric_sample<(\w+)>", TEXT) == [
        "SPECULAR"]
    assert "int allowed" not in TEXT
    assert re.search(r"bsdf_sample\(\s*params, wo, B\.ALL_COMPONENTS,",
                     inspect.getsource(R))


@pytest.mark.parametrize("allowed", [
    B.REFLECTION, B.TRANSMISSION, B.NONSPECULAR, B.SPECULAR, 0,
    torch.tensor(B.ALL_COMPONENTS)])
def test_sample_kernel_refuses_other_allowed(allowed):
    """Any other `allowed` is refused before anything is checked or
    launched, so on CPU tensors too."""
    params, wo, _, _ = bsdf_lanes(8, 0)
    with pytest.raises(ValueError, match="allowed"):
        D._sample_kernel(params, wo, torch.zeros(8, 2), torch.zeros(8),
                         allowed, ALL_KINDS)


def _f32(x) -> float:
    return float(np.float32(x))


# the f32 constants the kernel's code takes from the shared header and the
# Python float each rounds, with the literal and the function that holds it
FLOATS = [
    ("kPi", _f32(B._PI), None, None),
    ("kInvPi", float(np.float32(1.0) / np.float32(B._PI)), "albedo / _PI",
     B.diffuse_eval),
    ("kTwoPi", _f32(2.0 * math.pi), None, None),
    ("kWhPole", _f32(0.9999), "< 0.9999", B.tr_sample_wm),
    ("kMinNz", _f32(1.0e-6), "min=1.0e-6", B.tr_sample_wm),
    ("kMinDot", _f32(1e-20), "min=1e-20", B.ts_refl_pdf),
    ("kLambdaGrazing", _f32(1e8), "1e8", B.tr_lambda),
]


@pytest.mark.parametrize("name, value, literal, fn", FLOATS,
                         ids=[f[0] for f in FLOATS])
def test_kernel_float_constants(name, value, literal, fn):
    m = re.search(rf"constexpr float {name} = ([^;]+?)f;", HEADER_TEXT)
    assert m is not None, name
    text = m.group(1)
    assert float.fromhex(text) == value
    if literal is not None:
        assert literal in inspect.getsource(fn)


@pytest.mark.parametrize("literal, fn", [
    ("* 0.5", complexmath.c_sqrt),
    ("(c_abs2(r_parl) + c_abs2(r_perp)) * 0.5", complexmath.fresnel_complex),
    ("4.0 * wo[..., 2] * wi[..., 2]", B.ts_refl_eval),
    ("(4.0 * safe_dot)", B.ts_refl_pdf),
    ("1 + torch.square(", complexmath._hypot),
])
def test_kernel_literals_are_the_plain_codes(literal, fn):
    """The complex Fresnel term's and the rough conductor's scalars: the
    plain code's literals, which the kernel writes as the same f32."""
    assert literal in inspect.getsource(fn)


def _c_params(entry: str) -> list:
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', TEXT)
    assert m is not None, entry
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("entry, ints", [
    ("tpu_rt_bsdf_eval", ["int kinds", "int n"]),
    ("tpu_rt_bsdf_sample", ["int kinds", "int n"]),
])
def test_signature_matches_the_c_entry(entry, ints):
    params = _c_params(entry)
    want = [native_cuda._P if "*" in p else native_cuda._I for p in params]
    assert native_cuda.SIGNATURES[entry] == want
    assert params[-len(ints) - 1:] == [*ints, "void* stream"]


def test_kinds_mask():
    assert D._kinds_mask(D._rough_kinds((0, 3))) == 0b1011
    assert D._kinds_mask((np.int32(5),)) == 1 << 5
