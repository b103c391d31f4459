"""BSDFs of the slice, lane by lane against the JAX package.

Inputs are per-lane random materials (diffuse and coated diffuse with
smooth and rough coats, with and without a scattering medium) and random
directions, made with numpy. Tolerances: the layered walk is a chain of
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
from tpu_raytracing.ops.bsdf_dispatch import bsdf_sample as jax_bsdf_sample
from tpu_raytracing.ops.textures import EvalCtx as JEvalCtx
from tpu_raytracing.scene.test_scenes import get_test_scene as jax_test_scene
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.ops import bsdf as TB
from tpu_raytracing_torch.ops import rng as TR
from tpu_raytracing_torch.ops.bsdf_dispatch import bsdf_eval, bsdf_sample
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


@pytest.mark.parametrize("name", ["coated_diffuse_bunny", "cube"])
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
