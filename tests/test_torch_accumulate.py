"""Checkpointed accumulation (integrator/accumulate.py) on the CPU: the five
cases of tests/test_accumulate.py, on the same scene and settings, the
camera cut to 96x54 (the builtin 480x270 view) to keep the plain versions
quick."""
import numpy as np
import pytest
import torch

from tpu_raytracing_torch.integrator.accumulate import render_accumulated
from tpu_raytracing_torch.integrator.render import render
from tpu_raytracing_torch.scene.test_scenes import get_test_scene
from tpu_raytracing_torch.settings import AovFlags

torch.set_num_threads(1)
CHUNK = 1 << 12


@pytest.fixture(scope="module")
def scene_settings():
    ts = get_test_scene("checkered_plane")
    s = ts.settings_func()
    s.samples_per_pixel = 4
    s.light_sample_count = 1
    s.max_ray_depth = 2
    s.outputs = AovFlags.BEAUTY
    # ray-differential scale depends on total spp; disable antialiasing so a
    # 2-spp run reproduces the 4-spp run's first chunk bit-exactly
    s.antialias_primary_rays = False
    scene = ts.scene_func()
    scene.camera = scene.camera.with_resolution(96, 54)
    return scene, s


def _acc(scene, s, **kw):
    return render_accumulated(scene, s, chunk_pixels=CHUNK, device="cpu", **kw)


def test_chunked_matches_oneshot_samples(scene_settings):
    """Chunked accumulation covers the same absolute sample set; the
    result matches the one-shot render within f32 reassociation noise."""
    scene, s = scene_settings
    full = render(scene, s, "cpu", chunk_pixels=CHUNK)
    acc = _acc(scene, s, spp_chunk=2)
    np.testing.assert_allclose(acc.beauty, full.beauty, rtol=1e-5, atol=1e-6)
    assert acc.rays_traced == full.rays_traced > 0


def test_ragged_final_chunk(scene_settings):
    """total_spp % spp_chunk != 0 renders exactly total_spp samples."""
    scene, s = scene_settings
    s3 = type(s)(**{**s.__dict__})
    s3.samples_per_pixel = 3
    full = render(scene, s3, "cpu", chunk_pixels=CHUNK)
    acc = _acc(scene, s3, spp_chunk=2)
    np.testing.assert_allclose(acc.beauty, full.beauty, rtol=1e-5, atol=1e-6)
    assert acc.rays_traced == full.rays_traced


def test_resume_from_partial_checkpoint(scene_settings, tmp_path):
    """A checkpoint holding only the first chunk resumes to the same final
    image as an uninterrupted run (sample indices are absolute)."""
    scene, s = scene_settings
    ck = tmp_path / "ck.npz"
    ref = _acc(scene, s, spp_chunk=2, checkpoint_path=ck)
    with np.load(ck, allow_pickle=False) as f:
        full = dict(f)
    s2 = type(s)(**{**s.__dict__})
    s2.samples_per_pixel = 2
    ck2 = tmp_path / "ck2.npz"
    _acc(scene, s2, spp_chunk=2, checkpoint_path=ck2)
    with np.load(ck2, allow_pickle=False) as f:
        partial = dict(f)
    # graft the partial accumulator into the 4-spp fingerprint's context
    np.savez(ck, accum=partial["accum"], spp_done=2, rays=partial["rays"],
             fingerprint=full["fingerprint"], spp_chunk=2)
    resumed = _acc(scene, s, spp_chunk=2, checkpoint_path=ck)
    np.testing.assert_array_equal(resumed.beauty, ref.beauty)
    assert resumed.rays_traced == ref.rays_traced


def test_mismatched_checkpoint_restarts(scene_settings, tmp_path, caplog):
    scene, s = scene_settings
    ck = tmp_path / "ck.npz"
    _acc(scene, s, spp_chunk=2, checkpoint_path=ck)
    s2 = type(s)(**{**s.__dict__})
    s2.seed = 123  # different settings -> fingerprint mismatch
    out = _acc(scene, s2, spp_chunk=2, checkpoint_path=ck)
    assert "does not match" in caplog.text
    assert np.isfinite(out.beauty).all()
    np.testing.assert_array_equal(out.beauty,
                                  _acc(scene, s2, spp_chunk=2).beauty)


def test_on_chunk_progressive_hook(scene_settings):
    """on_chunk gets a live partial average after every spp chunk."""
    scene, s = scene_settings
    seen = []
    out = _acc(scene, s, spp_chunk=2,
               on_chunk=lambda img, done: seen.append((img.copy(), done)))
    assert [d for _, d in seen] == [2, 4]
    np.testing.assert_array_equal(seen[-1][0], out.beauty)
