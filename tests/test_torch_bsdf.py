"""BSDFs of the slice, lane by lane against the JAX package.

Inputs are per-lane random materials (diffuse and coated diffuse with
smooth and rough coats, with and without a scattering medium; in the
all-kinds tests also smooth and rough dielectrics and conductors) and
random directions, made with numpy. The conductor and dielectric kinds are
short f32 chains and agree per lane within rtol 1e-5, except where a
last-bit difference meets a grazing direction (stated at each test).
Tolerances of the coated kind: the layered walk is a chain of
f32 operations whose random decisions are hashed from bit-identical
inputs, so lanes follow the same branches and agree to a few ULPs of each
step, except where a last-bit difference (XLA contracts multiply-adds,
PyTorch does not) is amplified by a near-grazing direction. Evaluation:
every lane within rtol 1e-4 (measured max 1.4e-5). Sampling: components,
validity and stream dimensions exact; wi, f and pdf within rtol 1e-4 on
at least 99.8% of lanes (measured: all but 2 of 4,096) and within 1e-2
on all.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_raytracing.ops.bsdf as JB
import tpu_raytracing.ops.rng as JR
from tpu_raytracing.device import compile_scene as jax_compile_scene
from tpu_raytracing.ops.bsdf_dispatch import bsdf_eval as jax_bsdf_eval
from tpu_raytracing.ops.bsdf_dispatch import bsdf_pdf as jax_bsdf_pdf
from tpu_raytracing.ops.bsdf_dispatch import bsdf_sample as jax_bsdf_sample
from tpu_raytracing.ops.textures import EvalCtx as JEvalCtx
from tpu_raytracing.scene.test_scenes import get_test_scene as jax_test_scene
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.ops import bsdf as TB
from tpu_raytracing_torch.ops import rng as TR
from tpu_raytracing_torch.ops.bsdf_dispatch import (
    bsdf_eval, bsdf_pdf, bsdf_sample,
)
from tpu_raytracing_torch.ops.textures import EvalCtx
from tpu_raytracing_torch.scene.test_scenes import get_test_scene

torch.set_num_threads(1)

N = 4096
KINDS = (0, 5)


def _dirs(g, n):
    v = g.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def lanes():
    g = np.random.default_rng(0)
    ax = np.where(g.random(N) < 0.3, 1e-3,
                  0.05 + 0.45 * g.random(N)).astype(np.float32)
    arrays = [
        np.where(g.random(N) < 0.5, 0, 5).astype(np.int32),      # kind
        g.random((N, 3), dtype=np.float32),                      # albedo
        np.repeat((1.2 + 0.8 * g.random(N, dtype=np.float32))[:, None], 3, 1),
        np.zeros((N, 3), np.float32),                             # kappa
        ax, ax.copy(),
        np.where(ax <= 1e-3, 1, 3).astype(np.int32),              # top kind
        (0.01 + g.random(N)).astype(np.float32),                  # thickness
        np.where((g.random(N) < 0.3)[:, None], 0.0,
                 g.random((N, 3))).astype(np.float32),            # coat albedo
    ]
    wo = _dirs(g, N)
    wi = _dirs(g, N)
    wi[:, 2] = np.abs(wi[:, 2]) * np.sign(wo[:, 2])
    px = g.integers(0, 500, N).astype(np.uint32)
    py = g.integers(0, 500, N).astype(np.uint32)
    jp = JB.BsdfParams(*[jnp.asarray(a) for a in arrays])
    tp = TB.BsdfParams(*[torch.from_numpy(a) for a in arrays])
    return jp, tp, wo, wi, px, py


def _close_frac(a, b, rtol, atol):
    err = np.abs(a - b) - (atol + rtol * np.abs(b))
    return (err.reshape(a.shape[0], -1) <= 0).all(axis=1).mean()


@pytest.fixture(scope="module")
def evals(lanes):
    jp, tp, wo, wi, _, _ = lanes
    want = np.asarray(jax_bsdf_eval(jp, jnp.asarray(wo), jnp.asarray(wi),
                                    KINDS))
    got = bsdf_eval(tp, torch.from_numpy(wo), torch.from_numpy(wi), KINDS)
    return want, got.numpy()


@pytest.mark.parametrize("subset", ["diffuse", "coated", "mixed"])
def test_bsdf_eval_per_lane(lanes, evals, subset):
    k = np.asarray(lanes[0].kind)
    sel = {"diffuse": k == 0, "coated": k == 5,
           "mixed": np.ones(N, bool)}[subset]
    want, got = evals
    np.testing.assert_allclose(got[sel], want[sel], rtol=1e-4, atol=1e-7)


def test_bsdf_eval_active_mask(lanes, evals):
    """Coated lanes outside `active` are skipped; active lanes unchanged."""
    _, tp, wo, wi, _, _ = lanes
    act = torch.from_numpy(np.arange(N) % 3 == 0)
    part = bsdf_eval(tp, torch.from_numpy(wo), torch.from_numpy(wi), KINDS,
                     active=act)
    np.testing.assert_array_equal(part[act].numpy(), evals[1][act.numpy()])
    coated_off = (np.asarray(lanes[0].kind) == 5) & ~act.numpy()
    assert not part.numpy()[coated_off].any()


@pytest.mark.parametrize("kind", ["independent", "stratified"])
def test_bsdf_sample_per_lane(lanes, kind):
    jp, tp, wo, _, px, py = lanes
    cfg = (TR.SamplerConfig("independent", seed=42) if kind == "independent"
           else TR.SamplerConfig("stratified", True, 4, 4, 9))
    js = JR.make_stream(jnp.asarray(px), jnp.asarray(py), 3)._replace(
        dim=jnp.full(N, 5, jnp.uint32))
    ts = TR.make_stream(torch.from_numpy(px.astype(np.int64)),
                        torch.from_numpy(py.astype(np.int64)), 3)._replace(
        dim=torch.full((N,), 5, dtype=torch.int64))
    sj, js = jax_bsdf_sample(jp, jnp.asarray(wo),
                             jnp.full(N, JB.ALL_COMPONENTS, jnp.int32),
                             JR.SamplerConfig(*cfg), js, KINDS)
    st, ts = bsdf_sample(tp, torch.from_numpy(wo), TB.ALL_COMPONENTS, cfg, ts,
                         KINDS)
    # every bsdf_sample consumes exactly 3 sampler dimensions
    np.testing.assert_array_equal(ts.dim.numpy(), np.asarray(js.dim))
    assert int(ts.dim[0]) == 8
    np.testing.assert_array_equal(st.component.numpy(),
                                  np.asarray(sj.component))
    np.testing.assert_array_equal(st.valid.numpy(), np.asarray(sj.valid))
    for name in ("wi", "f", "pdf"):
        a, b = getattr(st, name).numpy(), np.asarray(getattr(sj, name))
        assert _close_frac(a, b, 1e-4, 1e-6) >= 0.998, name
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("name", ["coated_diffuse_bunny", "cube", "metal",
                                  "rough_metal", "dielectric",
                                  "rough_dielectric"])
def test_get_bsdf_params(name):
    scene = get_test_scene(name).scene_func()
    jds = jax_compile_scene(jax_test_scene(name).scene_func())
    tds = compile_scene(scene, "cpu")
    mats = np.arange(-1, max(1, len(scene.materials)) + 1, dtype=np.int32)
    mats = np.clip(mats, -1, max(0, len(scene.materials) - 1))
    uv = np.random.default_rng(5).random((mats.shape[0], 2), dtype=np.float32)
    want = JB.get_bsdf_params(jds, jnp.asarray(mats),
                              JEvalCtx.without_antialiasing(jnp.asarray(uv)))
    got = TB.get_bsdf_params(tds, torch.from_numpy(mats),
                             EvalCtx.without_antialiasing(torch.from_numpy(uv)))
    for f in TB.BsdfParams._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_dielectric_pieces():
    """Fresnel, refraction and the rough-dielectric functions the coat
    uses, on random lanes (rtol 1e-5: short f32 chains)."""
    g = np.random.default_rng(7)
    wo, wi = _dirs(g, N), _dirs(g, N)
    eta = (1.1 + g.random(N)).astype(np.float32)
    a = (0.05 + 0.5 * g.random(N)).astype(np.float32)
    jw, jv, je, ja = map(jnp.asarray, (wo, wi, eta, a))
    tw, tv, te, ta = map(torch.from_numpy, (wo, wi, eta, a))
    pairs = [
        (JB.fresnel_dielectric(jw[:, 2], je), TB.fresnel_dielectric(tw[:, 2], te)),
        (JB.refract(je, jw, jv)[0], TB.refract(te, tw, tv)[0]),
        (JB.tr_distribution(jw, ja, ja), TB.tr_distribution(tw, ta, ta)),
        (JB.tr_g(jw, jv, ja, ja), TB.tr_g(tw, tv, ta, ta)),
        (JB.ts_eval(jw, jv, je, ja, ja), TB.ts_eval(tw, tv, te, ta, ta)),
        (JB.ts_pdf(jw, jv, je, ja, ja, JB.ALL_COMPONENTS),
         TB.ts_pdf(tw, tv, te, ta, ta, TB.ALL_COMPONENTS)),
    ]
    for k, (want, got) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=str(k))


# ------------------------------------------------ all six kinds, conductors

ALL_KINDS = (0, 1, 2, 3, 4, 5)


@pytest.fixture(scope="module")
def kind_lanes():
    """Random lanes of every kind: 0 diffuse, 1 smooth dielectric, 2
    smooth conductor, 3 rough dielectric, 4 rough conductor, 5 coated."""
    g = np.random.default_rng(3)
    kind = g.integers(0, 6, N).astype(np.int32)
    ax = (0.05 + 0.45 * g.random(N)).astype(np.float32)
    ay = np.where(g.random(N) < 0.5, ax,
                  0.05 + 0.45 * g.random(N)).astype(np.float32)
    ior = (1.2 + 0.8 * g.random(N)).astype(np.float32)
    conductor = (kind == 2) | (kind == 4)
    eta = np.where(conductor[:, None], 0.1 + 1.4 * g.random((N, 3)),
                   ior[:, None]).astype(np.float32)
    kappa = np.where(conductor[:, None], 1.0 + 4.0 * g.random((N, 3)),
                     0.0).astype(np.float32)
    arrays = [
        kind, g.random((N, 3), dtype=np.float32), eta, kappa, ax, ay,
        np.where(g.random(N) < 0.3, 1, 3).astype(np.int32),       # top kind
        (0.01 + g.random(N)).astype(np.float32),                  # thickness
        g.random((N, 3)).astype(np.float32),                      # coat albedo
    ]
    wo = _dirs(g, N)
    wi = _dirs(g, N)
    # half the pairs in one hemisphere, half across (transmission)
    wi[: N // 2, 2] = np.abs(wi[: N // 2, 2]) * np.sign(wo[: N // 2, 2])
    px = g.integers(0, 500, N).astype(np.uint32)
    py = g.integers(0, 500, N).astype(np.uint32)
    jp = JB.BsdfParams(*[jnp.asarray(a) for a in arrays])
    tp = TB.BsdfParams(*[torch.from_numpy(a) for a in arrays])
    return jp, tp, wo, wi, px, py


def test_fresnel_complex_rgb():
    """Conductor Fresnel per lane and channel, cos in [-1, 1] (rtol 1e-5)."""
    g = np.random.default_rng(8)
    cos = np.concatenate([g.uniform(-1, 1, N - 3),
                          [0.0, 1.0, -1.0]]).astype(np.float32)
    eta = (0.05 + 2.0 * g.random((N, 3))).astype(np.float32)
    kappa = (5.0 * g.random((N, 3))).astype(np.float32)
    want = JB.fresnel_complex_rgb(*map(jnp.asarray, (cos, eta, kappa)))
    got = TB.fresnel_complex_rgb(*map(torch.from_numpy, (cos, eta, kappa)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def test_smooth_conductor_sample():
    """Mirror direction, F / cos and the inside-hit guard: a lane with
    wo.z <= 0 is invalid (PARITY.md 2.2), as in JAX."""
    g = np.random.default_rng(9)
    wo = _dirs(g, N)
    wo[:8, 2] = 0.0
    eta = (0.1 + 1.4 * g.random((N, 3))).astype(np.float32)
    kappa = (1.0 + 4.0 * g.random((N, 3))).astype(np.float32)
    want = JB.smooth_conductor_sample(*map(jnp.asarray, (eta, kappa, wo)))
    got = TB.smooth_conductor_sample(*map(torch.from_numpy, (eta, kappa, wo)))
    np.testing.assert_array_equal(got.valid.numpy(), wo[:, 2] > 0)
    for f in ("valid", "component", "wi", "pdf"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(want.f), rtol=1e-5)


def test_rough_conductor_pieces():
    """ts_refl_pdf, ts_refl_eval (zero across hemispheres, the guard of
    PARITY.md 2.2) and ts_refl_sample per lane (rtol 1e-5)."""
    g = np.random.default_rng(10)
    wo, wi = _dirs(g, N), _dirs(g, N)
    ax = (0.05 + 0.45 * g.random(N)).astype(np.float32)
    ay = (0.05 + 0.45 * g.random(N)).astype(np.float32)
    eta = (0.1 + 1.4 * g.random((N, 3))).astype(np.float32)
    kappa = (1.0 + 4.0 * g.random((N, 3))).astype(np.float32)
    u2 = g.random((N, 2), dtype=np.float32)
    j = [jnp.asarray(a) for a in (wo, wi, eta, kappa, ax, ay, u2)]
    t = [torch.from_numpy(a) for a in (wo, wi, eta, kappa, ax, ay, u2)]
    f_got = TB.ts_refl_eval(*t[:6]).numpy()
    np.testing.assert_allclose(f_got, np.asarray(JB.ts_refl_eval(*j[:6])),
                               rtol=1e-5, atol=1e-7)
    assert not f_got[wo[:, 2] * wi[:, 2] < 0].any()
    np.testing.assert_allclose(
        TB.ts_refl_pdf(t[0], t[1], t[4], t[5]).numpy(),
        np.asarray(JB.ts_refl_pdf(j[0], j[1], j[4], j[5])), rtol=1e-5,
        atol=1e-7)
    want = JB.ts_refl_sample(j[0], *j[2:])
    got = TB.ts_refl_sample(t[0], *t[2:])
    for f in ("valid", "component"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    # wi is a unit vector from sin and cos of the sampled disk point, whose
    # last bits differ (9% of lanes): its components within 1e-5 absolute.
    # A grazing wi (wi.z ~ 0.01) turns such a bit into 1.5e-5 of f, so f
    # and pdf are held against JAX's eval and pdf at the port's own wi
    wi_got = got.wi.numpy()
    np.testing.assert_allclose(wi_got, np.asarray(want.wi), rtol=1e-5,
                               atol=1e-5)
    jw = jnp.asarray(wi_got)
    np.testing.assert_allclose(
        got.f.numpy(), np.asarray(JB.ts_refl_eval(j[0], jw, *j[2:6])),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got.pdf.numpy(), np.asarray(JB.ts_refl_pdf(j[0], jw, j[4], j[5])),
        rtol=1e-5, atol=1e-6)


def test_bsdf_eval_all_kinds(kind_lanes):
    jp, tp, wo, wi, _, _ = kind_lanes
    want = np.asarray(jax_bsdf_eval(jp, jnp.asarray(wo), jnp.asarray(wi),
                                    ALL_KINDS))
    got = bsdf_eval(tp, torch.from_numpy(wo), torch.from_numpy(wi),
                    ALL_KINDS).numpy()
    k = np.asarray(jp.kind)
    assert not got[(k == 1) | (k == 2)].any()  # delta BSDFs evaluate to 0
    np.testing.assert_allclose(got[k != 5], want[k != 5], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got[k == 5], want[k == 5], rtol=1e-4,
                               atol=1e-7)


def test_bsdf_pdf_all_kinds(kind_lanes):
    """Zero on delta and coated lanes; rtol 1e-5 elsewhere."""
    jp, tp, wo, wi, _, _ = kind_lanes
    for allowed in (TB.ALL_COMPONENTS, TB.REFLECTION):
        want = np.asarray(jax_bsdf_pdf(jp, jnp.asarray(wo), jnp.asarray(wi),
                                       allowed, ALL_KINDS))
        got = bsdf_pdf(tp, torch.from_numpy(wo), torch.from_numpy(wi),
                       allowed, ALL_KINDS).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        k = np.asarray(jp.kind)
        assert not got[(k == 1) | (k == 2) | (k == 5)].any()
        assert (got[(k == 0) | (k == 3) | (k == 4)] > 0).mean() > 0.3


@pytest.mark.parametrize("kind", ["independent", "stratified"])
def test_bsdf_sample_all_kinds(kind_lanes, kind):
    """Every kind's sample; each call consumes exactly 3 sampler
    dimensions, and both dielectric samplers read u1. Components and
    validity exact; wi, f and pdf within rtol 1e-5 on the conductor and
    dielectric lanes, the coated lanes as in test_bsdf_sample_per_lane."""
    jp, tp, wo, _, px, py = kind_lanes
    cfg = (TR.SamplerConfig("independent", seed=7) if kind == "independent"
           else TR.SamplerConfig("stratified", True, 4, 4, 9))
    js = JR.make_stream(jnp.asarray(px), jnp.asarray(py), 1)._replace(
        dim=jnp.full(N, 2, jnp.uint32))
    ts = TR.make_stream(torch.from_numpy(px.astype(np.int64)),
                        torch.from_numpy(py.astype(np.int64)), 1)._replace(
        dim=torch.full((N,), 2, dtype=torch.int64))
    sj, js = jax_bsdf_sample(jp, jnp.asarray(wo),
                             jnp.full(N, JB.ALL_COMPONENTS, jnp.int32),
                             JR.SamplerConfig(*cfg), js, ALL_KINDS)
    st, ts = bsdf_sample(tp, torch.from_numpy(wo), TB.ALL_COMPONENTS, cfg, ts,
                         ALL_KINDS)
    np.testing.assert_array_equal(ts.dim.numpy(), np.asarray(js.dim))
    assert np.all(ts.dim.numpy() == 5)
    k = np.asarray(jp.kind)
    comp = st.component.numpy()
    np.testing.assert_array_equal(comp, np.asarray(sj.component))
    np.testing.assert_array_equal(st.valid.numpy(), np.asarray(sj.valid))
    # u1 chooses between reflection and transmission on dielectric lanes
    for dk, refl in ((1, TB.SPECULAR_REFLECTION),
                     (3, TB.NONSPECULAR_REFLECTION)):
        assert 0.02 < (comp[k == dk] == refl).mean() < 0.98
    plain = k != 5
    for name in ("wi", "f", "pdf"):
        a, b = getattr(st, name).numpy(), np.asarray(getattr(sj, name))
        np.testing.assert_allclose(a[plain], b[plain], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        assert _close_frac(a[~plain], b[~plain], 1e-4, 1e-6) >= 0.99, name
