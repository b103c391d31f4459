"""Area-light sampling and the environment lookup against the JAX package's
ops/light_sampling.py, per lane.

Area lights: the Cornell box with its point light and an emissive quad
under the ceiling (the emitter has shading normals), and the same box with
a tilted hexagonal emitter of six triangles and no normals (the geometric
normal, and a choice among triangles). Each sample draws three stream
dimensions, so both sides draw the same numbers; four samples are drawn in
a row, as a bounce draws light_sample_count of them. Shading points are
seeded inside the box, some behind the emitter (zero radiance).

Tolerance: radiance, origin, direction and distance within rtol 1e-6 (a
few f32 multiply-adds that XLA contracts into FMAs), and the pdf, d^2 /
cos(theta) over the area, within rtol 1e-4: at grazing angles 1 / cos
amplifies a last-bit difference in the direction (measured worst 5.4e-5,
on a pdf of 1,875).

The environment: the builtin environment_light sky (a NEAREST, REPEAT
image) and a mix of that image and a checker by a BILINEAR, CLAMP image,
looked up along seeded directions and the six axes. The lookup's acos and
atan2 may differ from XLA's in the last bit, which can move a NEAREST tap
to the next texel: at least 99.9% of the sky's lanes are bit-equal
(measured: all). The mix's bilinear weights blend colours 20 times apart,
which amplifies the FMA differences: within rtol 1e-4 (measured worst
5.8e-5; 94.5% of the lanes bit-equal).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_raytracing.ops.light_sampling as JL
import tpu_raytracing.ops.rng as JR
from tpu_raytracing.device import compile_scene as jax_compile_scene
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.device.scene_buffers import LIGHT_AREA
from tpu_raytracing_torch.ops import light_sampling as TL
from tpu_raytracing_torch.ops import rng as TR

from test_torch_scene import _built, _builtin

torch.set_num_threads(1)

N = 4096
N_SAMPLES = 4


def _hexagon_emitter(tmod, mmod, geom):
    """The Cornell box with a tilted six-triangle emitter without normals."""
    sb = tmod.cornell_box()
    ang = np.arange(6) * np.pi / 3
    verts = np.concatenate([[[0.0, 0.0, 0.0]], np.stack(
        [0.3 * np.cos(ang), 0.3 * np.sin(ang), np.zeros(6)], axis=1)])
    tris = [[0, 1 + i, 1 + (i + 1) % 6] for i in range(6)]
    mesh = geom.Mesh(vertices=verts.astype(np.float32),
                     tris=np.asarray(tris, np.uint32))
    white = sb.add_constant_texture(tmod.v4(1, 1, 1, 1))
    mat = sb.add_material(mmod.Diffuse(albedo=white))
    t = geom.Transform.rotate(0.4, tmod.v3(1, 0, 0)).compose(
        geom.Transform.translate(tmod.v3(0.2, -0.1, 1.3)))
    sb.add_shape_with_transform(
        geom.TriangleMesh(mesh), mat, t,
        area_light_radiance=np.array([4.0, 3.0, 2.0], np.float32))
    return sb.build()


def _pair(case):
    if case == "emissive_quad":
        return _built(case)
    import tpu_raytracing.geometry as JG
    import tpu_raytracing.materials as JM
    import tpu_raytracing.scene.test_scenes as JS
    import tpu_raytracing_torch.geometry as TG
    import tpu_raytracing_torch.materials as TM
    import tpu_raytracing_torch.scene.test_scenes as TS

    return _hexagon_emitter(TS, TM, TG), _hexagon_emitter(JS, JM, JG)


def _streams(seed):
    g = np.random.default_rng(seed)
    px = g.integers(0, 500, N).astype(np.uint32)
    py = g.integers(0, 500, N).astype(np.uint32)
    return (JR.make_stream(jnp.asarray(px), jnp.asarray(py), 3),
            TR.make_stream(torch.from_numpy(px.astype(np.int64)),
                           torch.from_numpy(py.astype(np.int64)), 3))


@pytest.mark.parametrize("case", ["emissive_quad", "hexagon_no_normals"])
def test_area_light_sample_matches_jax(case):
    port_scene, jax_scene = _pair(case)
    tds = compile_scene(port_scene, "cpu")
    jds = jax_compile_scene(jax_scene)
    li = tds.meta.light_kinds.index(LIGHT_AREA)
    assert int(tds.light_emit_count[li]) == (2 if case == "emissive_quad"
                                             else 6)
    g = np.random.default_rng(21)
    pts = np.stack([g.uniform(-0.95, 0.95, N), g.uniform(-0.95, 0.95, N),
                    g.uniform(0.02, 1.499, N)], axis=1).astype(np.float32)
    cfg = TR.SamplerConfig("independent", seed=42)
    js, ts = _streams(22)
    chosen = set()
    for k in range(N_SAMPLES):
        want, js = JL.sample_light(jds, li, jnp.asarray(pts),
                                   JR.SamplerConfig(*cfg), js)
        got, ts = TL.sample_light(tds, li, torch.from_numpy(pts), cfg, ts)
        np.testing.assert_array_equal(ts.dim.numpy(), np.asarray(js.dim))
        for f in want._fields:
            np.testing.assert_allclose(
                getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                rtol=1e-4 if f == "pdf" else 1e-6, atol=1e-7,
                err_msg=f"{case} sample {k} {f}")
        lit = (got.radiance.numpy() > 0).any(-1)
        assert 0.05 < lit.mean() < 1.0  # some points lie behind the emitter
        assert np.all(got.pdf.numpy() > 0)
        # the origins lie on the emitter: which triangle each came from
        o = got.origin.numpy()
        chosen |= set(np.round(np.arctan2(o[:, 1] + 0.1, o[:, 0] - 0.2)
                               * 3 / np.pi).astype(int).tolist())
    if case != "emissive_quad":
        assert len(chosen) >= 6  # every triangle of the fan was drawn


def _env_mix(tmod, mmod, lmod):
    """environment_light with a mix environment: the sky image (NEAREST,
    REPEAT) and a checker, blended by the sky as a BILINEAR, CLAMP
    texture."""
    scene = tmod.get_test_scene("environment_light").scene_func()
    n = len(scene.textures)
    scene.textures.append(mmod.ImageTexture(
        image=0, sampler=mmod.TextureSampler(
            filter=mmod.FilterMode.BILINEAR, wrap=mmod.WrapMode.CLAMP)))
    scene.textures.append(mmod.CheckerTexture(
        color1=tmod.v4(2, 1, 0.5, 1), color2=tmod.v4(0.1, 0.2, 0.4, 1)))
    scene.textures.append(mmod.MixTexture(a=0, b=n + 1, c=n))
    scene.environment_light = lmod.EnvironmentLight(radiance=n + 2)
    return scene


def _env_pair(case):
    if case == "builtin":
        return _builtin("environment_light")
    import tpu_raytracing.lights as JLi
    import tpu_raytracing.materials as JM
    import tpu_raytracing.scene.test_scenes as JS
    import tpu_raytracing_torch.lights as TLi
    import tpu_raytracing_torch.materials as TM
    import tpu_raytracing_torch.scene.test_scenes as TS

    return _env_mix(TS, TM, TLi), _env_mix(JS, JM, JLi)


@pytest.mark.parametrize("case", ["builtin", "mix"])
def test_environment_radiance_matches_jax(case):
    port_scene, jax_scene = _env_pair(case)
    tds = compile_scene(port_scene, "cpu")
    jds = jax_compile_scene(jax_scene)
    assert tds.meta.has_env and tds.meta.env_kinds == jds.meta.env_kinds
    g = np.random.default_rng(31)
    d = g.normal(0, 1, (N, 3)) * g.uniform(0.5, 3.0, (N, 1))  # unnormalized
    d[:6] = np.concatenate([np.eye(3), -np.eye(3)])
    d = d.astype(np.float32)
    want = np.asarray(JL.environment_radiance(jds, jnp.asarray(d)))
    got = TL.environment_radiance(tds, torch.from_numpy(d)).numpy()
    assert got.shape == (N, 3) and np.isfinite(got).all()
    if case == "builtin":  # NEAREST taps: a texel read as it is
        same = np.all(got == want, axis=-1)
        assert same.mean() >= 0.999, same.mean()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(np.unique(got, axis=0)) > 100  # many texels were read
