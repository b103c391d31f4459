"""Texture evaluation, per lane, against the JAX package's ops/textures.py.

Both sides read the same tables: the JAX scene's leaves carried across by
from_jax_leaves. The scene holds a seeded 48x40 image (a TRILINEAR texture
of it gets the padded 64x64 pyramid) and a seeded 5x7 image, an image
texture for each filter and wrap mode, a checker, a constant, and scale and
mix textures over image and checker children.

Inputs are seeded: uv from -3 to 3, from -500 to 500 (the checkered plane's
range), and on texel centres and edges, where rounding ties; derivatives
zero on a third of the lanes.

Tolerance. Wrapping, point sampling, the plain checker and constants are
integer and select work, and are bit-equal. The bilinear blend, the mip
level (log2) and the checker's erf antialiasing are held within rtol 1e-6
(atol 1e-7): XLA contracts multiply-adds into FMAs where PyTorch rounds
each step, and XLA's f32 erf is its own rational approximation. Measured on
the CPU: every lane bit-equal without derivatives; with them, 12% of the
lanes (trilinear, antialiased checker, scale) differ, by at most 1.5e-6
relative.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_raytracing.geometry as JG
import tpu_raytracing.materials as JM
import tpu_raytracing.ops.textures as JT
import tpu_raytracing.scene.test_scenes as JS
from tpu_raytracing.device import compile_scene as jax_compile_scene
from tpu_raytracing_torch.device import from_jax_leaves
from tpu_raytracing_torch.device.scene_buffers import (
    TEX_CHECKER, TEX_CONSTANT, TEX_IMAGE, TEX_MIX, TEX_SCALE,
)
from tpu_raytracing_torch.ops import textures as TT

from test_torch_scene import _jax_leaves

torch.set_num_threads(1)

N = 4096
RTOL, ATOL = 1e-6, 1e-7
FILTERS = ("NEAREST", "BILINEAR", "TRILINEAR")
WRAPS = ("REPEAT", "MIRROR", "CLAMP")


def _scene():
    """The JAX scene; texture ids: (filter, wrap) -> id, plus 'checker',
    'constant', 'scale' (image x checker) and 'mix' (image, checker by the
    constant)."""
    g = np.random.default_rng(11)
    sb = JS.SceneBuilder()
    big = sb.add_image(JM.Image(g.uniform(0, 1, (40, 48, 4)).astype(np.float32)))
    small = sb.add_image(JM.Image(g.uniform(0, 1, (5, 7, 3)).astype(np.float32)))
    ids = {}
    # the scale and mix rows' first children come first: JAX's compile
    # reads image ref0 of every row, so a first child's id must also be an
    # image's (test_child_ids_past_the_images)
    order = [("TRILINEAR", "MIRROR"), ("BILINEAR", "REPEAT")] + [
        (f, w) for f in FILTERS for w in WRAPS]
    for f, w in order:
        if (f, w) not in ids:
            ids[f, w] = sb.add_texture(JM.ImageTexture(
                image=big if f == "TRILINEAR" else small,
                sampler=JM.TextureSampler(filter=JM.FilterMode[f],
                                          wrap=JM.WrapMode[w])))
    assert ids["TRILINEAR", "MIRROR"] < 2 and ids["BILINEAR", "REPEAT"] < 2
    ids["checker"] = sb.add_texture(JM.CheckerTexture(
        color1=JS.v4(0.9, 0.1, 0.2, 1), color2=JS.v4(0.1, 0.7, 0.4, 0.5)))
    ids["constant"] = sb.add_constant_texture(JS.v4(0.25, 0.5, 0.75, 1))
    ids["scale"] = sb.add_texture(JM.ScaleTexture(
        a=ids["TRILINEAR", "MIRROR"], b=ids["checker"]))
    ids["mix"] = sb.add_texture(JM.MixTexture(
        a=ids["BILINEAR", "REPEAT"], b=ids["checker"], c=ids["constant"]))
    mat = sb.add_material(JM.Diffuse(albedo=ids["mix"]))
    sb.add_shape_at_position(JG.TriangleMesh(JS.make_cube(1.0)), mat,
                             JS.v3(0, 0, -3))
    sb.add_camera(JS.Camera.lookat_camera_perspective(
        JS.v3(1, 0.75, -1), JS.v3(0, 0, -3), JS.v3(0, 1, 0), False,
        np.deg2rad(45.0), 8, 8))
    return sb.build(), ids


@pytest.fixture(scope="module")
def tables():
    scene, ids = _scene()
    jds = jax_compile_scene(scene)
    tds = from_jax_leaves(_jax_leaves(jds), dataclasses.asdict(jds.meta), "cpu")
    assert jds.meta.any_trilinear and jds.meta.any_nearest
    return jds, tds, ids


def _inputs(seed, derivs):
    """(uv, dudx, dudy, dvdx, dvdy) as f32 numpy arrays."""
    g = np.random.default_rng(seed)
    uv = g.uniform(-3, 3, (N, 2))
    uv[N // 4:N // 2] = g.uniform(-500, 500, (N // 4, 2))
    # texel centres and edges of the 7-, 48- and 64-wide levels
    k = g.integers(-20, 20, (N // 8, 2))
    den = g.choice([7, 14, 48, 96, 64, 128], (N // 8, 2))
    uv[N // 2:N // 2 + N // 8] = k / den
    d = np.zeros((4, N))
    if derivs:
        d = g.choice([-1, 1], (4, N)) * 10.0 ** g.uniform(-4, -0.5, (4, N))
        d[:, : N // 3] = 0.0
        d[0, N // 3:N // 2] = 0.0  # one axis without a footprint
    return (uv.astype(np.float32), *d.astype(np.float32))


def _ctxs(inp):
    uv, dudx, dudy, dvdx, dvdy = inp
    return (JT.EvalCtx(*(jnp.asarray(a) for a in inp)),
            TT.EvalCtx(*(torch.from_numpy(a) for a in inp)))


def _eval_both(jds, tds, tid, inp, has_derivs, kinds=None):
    jc, tc = _ctxs(inp)
    want = np.asarray(JT.eval_texture(jds, jnp.asarray(tid), jc, has_derivs,
                                      kinds))
    got = TT.eval_texture(tds, torch.from_numpy(tid), tc, has_derivs,
                          kinds).numpy()
    return got, want


@pytest.mark.parametrize("wrap", WRAPS)
def test_wrap_matches_jax(wrap):
    """Negative and large uv, floored like jnp.mod: bit-equal."""
    x = _inputs(1, False)[0].reshape(-1)
    kind = torch.full(x.shape, int(JM.WrapMode[wrap]), dtype=torch.int32)
    want = np.asarray(JT._apply_wrap(jnp.asarray(kind.numpy()),
                                     jnp.asarray(x)))
    got = TT._apply_wrap(kind, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    if wrap != "CLAMP":
        assert np.all((got >= 0) & (got <= 1))


@pytest.mark.parametrize("derivs", [False, True], ids=["no_derivs", "derivs"])
@pytest.mark.parametrize("filt", FILTERS)
def test_image_filter_matches_jax(tables, filt, derivs):
    """Each filter over the three wrap modes, lane by lane."""
    jds, tds, ids = tables
    tid = np.array([ids[filt, w] for w in WRAPS], np.int32)[
        np.arange(N) % 3]
    inp = _inputs(2, derivs)
    got, want = _eval_both(jds, tds, tid, inp, has_derivs=derivs)
    assert got.shape == (N, 4) and np.isfinite(got).all()
    if filt == "NEAREST":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if filt == "TRILINEAR" and derivs:
        # the footprint reached coarser levels on some lanes
        jc, tc = _ctxs(inp)
        lvl, ok = TT.texture_mip_level(tds, torch.from_numpy(tid), tc)
        assert ok.any() and lvl[ok].max() > 1.0


@pytest.mark.parametrize("derivs", [False, True], ids=["no_derivs", "derivs"])
def test_checker_matches_jax(tables, derivs):
    """The plain checker is bit-equal; the erf antialiasing within rtol."""
    jds, tds, ids = tables
    tid = np.full(N, ids["checker"], np.int32)
    inp = _inputs(3, derivs)
    for has_derivs in (False, True):
        got, want = _eval_both(jds, tds, tid, inp, has_derivs)
        if has_derivs and derivs:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            # the antialiased lanes blend the two colours
            assert np.any((got[:, 0] > 0.11) & (got[:, 0] < 0.89))
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["scale", "mix"])
def test_scale_mix_match_jax(tables, kind):
    """Scale and mix rows over image and checker children, with and
    without derivatives."""
    jds, tds, ids = tables
    tid = np.full(N, ids[kind], np.int32)
    for has_derivs in (False, True):
        inp = _inputs(4, has_derivs)
        got, want = _eval_both(jds, tds, tid, inp, has_derivs)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kinds", [
    None, (TEX_CONSTANT,), (TEX_CHECKER, TEX_CONSTANT),
    (TEX_IMAGE, TEX_CONSTANT, TEX_MIX), (TEX_IMAGE, TEX_CHECKER, TEX_SCALE),
], ids=["all", "constant", "checker", "image_mix", "image_scale"])
def test_every_kind_per_lane(tables, kinds):
    """Every texture id (and -1, which reads row 0) on every lane, under
    the call site's kind set: JAX skips the kinds outside it, and so does
    the port, so the two agree on every lane whatever the set."""
    jds, tds, ids = tables
    n_tex = tds.tex_pack.shape[0]
    tid = np.random.default_rng(5).integers(-1, n_tex, N).astype(np.int32)
    inp = _inputs(5, True)
    for has_derivs in (False, True):
        got, want = _eval_both(jds, tds, tid, inp, has_derivs, kinds)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_texture_mip_level_matches_jax(tables):
    """The mip level of every texture id: valid only on the trilinear
    image's lanes with a footprint."""
    jds, tds, ids = tables
    n_tex = tds.tex_pack.shape[0]
    tid = np.random.default_rng(6).integers(-1, n_tex, N).astype(np.int32)
    jc, tc = _ctxs(_inputs(6, True))
    lw, vw = (np.asarray(a) for a in JT.texture_mip_level(
        jds, jnp.asarray(tid), jc))
    lg, vg = (a.numpy() for a in TT.texture_mip_level(
        tds, torch.from_numpy(tid), tc))
    np.testing.assert_array_equal(vg, vw)
    np.testing.assert_allclose(lg, lw, rtol=RTOL, atol=ATOL)
    # id -1 reads row 0, the trilinear image
    tri = np.isin(np.maximum(tid, 0), [ids["TRILINEAR", w] for w in WRAPS])
    assert vg.any() and not vg[~tri].any()
    assert np.all(lg[~vg] == 0.0)


def test_child_ids_past_the_images():
    """A scale whose first child's id is past the last image compiles on
    the port (JAX's compile faults on it: it reads that id as an image),
    and evaluates to the product of its children."""
    import tpu_raytracing_torch.geometry as TG
    import tpu_raytracing_torch.materials as TM
    import tpu_raytracing_torch.scene.test_scenes as TS
    from tpu_raytracing_torch.device import compile_scene

    sb = TS.SceneBuilder()
    sb.add_constant_texture(TS.v4(1, 1, 1, 1))
    a = sb.add_constant_texture(TS.v4(0.5, 0.25, 1, 1))
    b = sb.add_texture(TM.CheckerTexture(color1=TS.v4(0.5, 0.5, 0.5, 1),
                                         color2=TS.v4(1, 1, 1, 1)))
    scale = sb.add_texture(TM.ScaleTexture(a=b, b=a))
    mat = sb.add_material(TM.Diffuse(albedo=scale))
    sb.add_shape_at_position(TG.TriangleMesh(TS.make_cube(1.0)), mat,
                             TS.v3(0, 0, -3))
    sb.add_camera(TS.Camera.lookat_camera_perspective(
        TS.v3(1, 0.75, -1), TS.v3(0, 0, -3), TS.v3(0, 1, 0), False,
        np.deg2rad(45.0), 8, 8))
    tds = compile_scene(sb.build(), "cpu")
    assert tds.meta.slot_kinds[0] == (TEX_CONSTANT, TEX_CHECKER, TEX_SCALE)
    uv = torch.tensor([[0.25, 0.25], [0.75, 0.25]])
    got = TT.eval_texture(tds, torch.tensor([scale, scale]),
                          TT.EvalCtx.without_antialiasing(uv)).numpy()
    np.testing.assert_array_equal(got[:, :3], [[0.5, 0.25, 1.0],
                                               [0.25, 0.125, 0.5]])
