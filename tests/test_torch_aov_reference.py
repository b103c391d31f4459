"""The AOV-only feature-buffer render of the benchmark's configuration
`coated_diffuse_bunny_aov` (rtbench/configs/): the port's `render` with
normals and albedo and no beauty, against the benchmark's plain
reference (rtbench/reference/aov.py: pixel-centre camera rays, brute-force
closest hit, the interpolated shading normal, the material's albedo), on
the CPU; and the port's tracing of that pass (the `rt.aov*` spans, the
`aov.lanes` counter and the spans' host-nanosecond counters).

Each case is a seeded tiny version of the configuration: its scene, the
bunny and all, under a camera moved by a few tenths from the source's,
at 16, 24 or 32 pixels square. Tolerances, each with its reason:

- hit mask: equal on every pixel but MAX_MASK_DIFF of them, where a ray
  grazing the bunny's silhouette may fall either side of it (the tree
  walk and the brute force test the same triangles with the same
  arithmetic, so this has read 0);
- normals: within N_ATOL (the benchmark's `aov` traffic kind's) in every
  component on every pixel both hit, but MAX_MASK_DIFF of them: float32
  rounding of the shading chain is ~1e-6, and a tie on an edge of the
  mesh resolved to the neighbouring triangle interpolates the same vertex
  normals there;
- albedo: bit for bit wherever both hit (a constant texture read against
  the material's row), and zero wherever the port misses;
- `aov_rays_traced`: the active lanes the pass handed the walk, exactly,
  which are the frame's pixels whatever the chunking.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
BENCH = REPO / "rtbench"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))  # after the repo: it shadows nothing

from harness.program import build_scene  # noqa: E402
from reference.aov import first_hit  # noqa: E402
from reference.scene import RefScene  # noqa: E402
from tpu_raytracing_torch import tracing  # noqa: E402
from tpu_raytracing_torch.device.scene_buffers import compile_scene  # noqa: E402
from tpu_raytracing_torch.integrator import render as render_mod  # noqa: E402
from tpu_raytracing_torch.settings import (  # noqa: E402
    AovFlags, RaytracerSettings,
)

torch.set_num_threads(1)

CONFIG = json.loads(
    (BENCH / "configs" / "coated_diffuse_bunny_aov.json").read_text())
N_ATOL = 1e-5
MAX_MASK_DIFF = 0.005
OUTPUTS = AovFlags.NORMALS | AovFlags.ALBEDO


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _scene(seed: int) -> dict:
    """The configuration's scene with its camera moved by the seed."""
    rng = np.random.default_rng(seed)
    scene = json.loads(json.dumps(CONFIG["scene"]))
    cam = scene["camera"]
    cam["position"] = (np.asarray(cam["position"])
                       + rng.uniform(-0.3, 0.3, 3)).tolist()
    cam["target"] = (np.asarray(cam["target"])
                     + rng.uniform(-0.1, 0.1, 3)).tolist()
    return scene


def _settings(seed: int) -> RaytracerSettings:
    return RaytracerSettings(
        samples_per_pixel=CONFIG["settings"]["samples_per_pixel"],
        seed=seed, outputs=OUTPUTS)


def _reference(scene: dict, width: int):
    sc = RefScene(scene, width, width, BENCH, "cpu")
    ys, xs = np.mgrid[0:width, 0:width]
    fh = first_hit(sc, torch.as_tensor(xs.reshape(-1)),
                   torch.as_tensor(ys.reshape(-1)))
    return fh.prim.numpy() >= 0, fh.normal.numpy(), fh.albedo.numpy()


@pytest.mark.parametrize("width", [16, 24, 32])
@pytest.mark.parametrize("seed", [1, 2, 3, 2**31 + 7])
def test_port_matches_the_reference(seed, width):
    scene = _scene(seed)
    ds = compile_scene(build_scene(scene, width, width, BENCH), "cpu")
    out = render_mod.render(ds, _settings(seed), "cpu")
    assert out.beauty is None and out.rays_traced == 0
    assert out.uv is None and out.mip_level is None
    normals = out.normals.reshape(-1, 3)
    albedo = out.albedo.reshape(-1, 3)
    assert np.isfinite(normals).all() and np.isfinite(albedo).all()
    ref_hit, ref_normals, ref_albedo = _reference(scene, width)
    hit = np.any(normals != 0, axis=-1)
    assert 0.05 < ref_hit.mean() < 1.0
    assert (hit != ref_hit).mean() <= MAX_MASK_DIFF
    both = hit & ref_hit
    close = np.all(np.abs(normals - ref_normals) <= N_ATOL, axis=-1)
    assert (~close[both]).mean() <= MAX_MASK_DIFF
    np.testing.assert_array_equal(albedo[both], ref_albedo[both])
    np.testing.assert_array_equal(albedo[~hit], 0.0)
    np.testing.assert_array_equal(normals[~hit], 0.0)
    np.testing.assert_allclose(np.linalg.norm(normals[hit], axis=-1), 1.0,
                               rtol=1e-5)
    assert out.aov_rays_traced == width * width


@pytest.fixture(scope="module")
def bunny16():
    return compile_scene(build_scene(_scene(5), 16, 16, BENCH), "cpu")


def _active_walked(monkeypatch) -> list:
    """Records the `active` lanes each call of the walk was handed."""
    real = render_mod.intersect_scene
    seen = []

    def recorded(*args, active=None, **kw):
        seen.append(active.clone())
        return real(*args, active=active, **kw)
    monkeypatch.setattr(render_mod, "intersect_scene", recorded)
    return seen


@pytest.mark.parametrize("chunk", [100, 256, 1 << 13])
def test_rays_are_the_active_lanes_handed_the_walk(bunny16, chunk,
                                                   monkeypatch):
    """A frame of 256 pixels in chunks of 100 (the tail padded by 44
    dead lanes), 256 or 8,192 (one chunk): the walk sees every pixel
    active once and every padded lane dead, and the count is those
    lanes."""
    seen = _active_walked(monkeypatch)
    out = render_mod.render(bunny16, _settings(5), "cpu", chunk_pixels=chunk)
    assert len(seen) == -(-256 // min(chunk, 256))
    assert sum(int(a.sum()) for a in seen) == out.aov_rays_traced == 256
    assert sum(a.numel() for a in seen) == len(seen) * min(chunk, 256)


def test_tracing_counts_and_spans_the_aov_pass(bunny16):
    off = render_mod.render(bunny16, _settings(5), "cpu", chunk_pixels=100)
    assert tracing.snapshot() == {}
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = render_mod.render(bunny16, _settings(5), "cpu",
                               chunk_pixels=100)
    tracing.disable()
    counts = tracing.snapshot()
    for f in ("normals", "albedo"):
        np.testing.assert_array_equal(getattr(on, f), getattr(off, f))
    assert on.aov_rays_traced == off.aov_rays_traced == 256
    assert counts["aov.lanes"] == 256
    assert counts["sync.render.aov_to_host"] == 4
    assert counts["sync.render.chunk_to_device"] == 3 * 3
    frame, chunks, to_host = (counts[f"host_ns.rt.aov{s}"]
                              for s in ("", ".chunk", ".to_host"))
    assert 0 < chunks and 0 < to_host and chunks + to_host <= frame
    events = [e for e in prof.events() if e.name.startswith("rt.aov")]
    names = [e.name for e in events]
    assert names.count("rt.aov") == 1 and names.count("rt.aov.to_host") == 1
    assert names.count("rt.aov.chunk") == 3
    for e in events:
        if e.name != "rt.aov":
            assert e.cpu_parent is not None and e.cpu_parent.name == "rt.aov"
