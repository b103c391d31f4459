"""The ray dump (tpu_raytracing_torch/utils/raydump.py) against the JAX
package's (tpu_raytracing/utils/raydump.py), on a 64-pixel Morton block of
checkered_plane at 1 spp: its builtin depth and light.

What is bit for bit: every batch's kind, t_min, t_max and active mask (the
Morton order, the clip planes and the bounce loop are integer or table
work), the sequence of kinds, and the first batch's origins (the pinhole's
position). The first batch's directions are f32 arithmetic that XLA
contracts into multiply-adds where PyTorch does not: they agree within
tests/test_torch_rng.py's camera-ray tolerance, rtol 1e-6 and atol 1e-6
(measured: at most 2 ulps apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracing.device import compile_scene as jax_compile_scene
from tpu_raytracing.integrator.render import StaticSettings as JStatic
from tpu_raytracing.integrator.render import _pixel_grid as jax_pixel_grid
from tpu_raytracing.integrator.render import render_beauty_chunk as jax_chunk
from tpu_raytracing.ops.rng import SamplerConfig as JSamplerConfig
from tpu_raytracing.scene.test_scenes import get_test_scene as jax_test_scene
from tpu_raytracing.utils import raydump as jax_raydump
from tpu_raytracing_torch.device import compile_scene
from tpu_raytracing_torch.integrator.render import (
    StaticSettings, render_beauty_chunk,
)
from tpu_raytracing_torch.ops.rng import SamplerConfig
from tpu_raytracing_torch.scene.test_scenes import get_test_scene
from tpu_raytracing_torch.utils import raydump

torch.set_num_threads(1)

SCENE, START, N_PIX = "checkered_plane", 40000, 64
KEYS = ("kind", "o", "d", "t_min", "t_max", "act")


def _settings():
    s = get_test_scene(SCENE).settings_func()
    s.samples_per_pixel = 1
    return s


def _block():
    ds = compile_scene(get_test_scene(SCENE).scene_func(), "cpu")
    px, py, _ = jax_pixel_grid(ds.meta.width, ds.meta.height)
    sel = slice(START, START + N_PIX)
    return ds, px[sel], py[sel]


def _port_batches() -> list:
    ds, px, py = _block()
    s = _settings()
    raydump.clear()
    try:
        render_beauty_chunk(
            ds, SamplerConfig.from_settings(s.sampler, s.seed),
            StaticSettings.from_settings(s),
            torch.from_numpy(px.astype(np.int64)),
            torch.from_numpy(py.astype(np.int64)),
            torch.ones(N_PIX, dtype=torch.bool))
        return list(raydump.BATCHES)
    finally:
        raydump.clear()


def test_off_records_nothing(monkeypatch):
    monkeypatch.delenv("TPU_RT_DUMP_RAYS", raising=False)
    assert not raydump.enabled()
    assert _port_batches() == []
    monkeypatch.setenv("TPU_RT_DUMP_RAYS", "0")
    assert _port_batches() == []


def test_first_batch_matches_jax(monkeypatch):
    monkeypatch.setenv("TPU_RT_DUMP_RAYS", "1")
    got = _port_batches()
    _, px, py = _block()
    s = _settings()
    cfg = SamplerConfig.from_settings(s.sampler, s.seed)
    jds = jax_compile_scene(jax_test_scene(SCENE).scene_func())
    # the callback is staged only while tracing: trace afresh, and leave no
    # traced callback behind for later tests
    jax.clear_caches()
    jax_raydump.clear()
    try:
        r, _ = jax_chunk(jds, JSamplerConfig(*cfg),
                         JStatic(*StaticSettings.from_settings(s)),
                         jnp.asarray(px), jnp.asarray(py),
                         jnp.ones(N_PIX, bool))
        jax.block_until_ready(r)
        want = list(jax_raydump.BATCHES)
    finally:
        jax_raydump.clear()
        jax.clear_caches()
    assert [b["kind"] for b in got] == [int(b["kind"]) for b in want]
    assert got[0]["kind"] == 0 and 1 in [b["kind"] for b in got]
    for g, w in zip(got, want):
        for k in ("t_min", "t_max", "act"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k
    g, w = got[0], want[0]
    assert g["act"].all() and g["o"].shape == w["o"].shape == (N_PIX, 3)
    assert g["o"].dtype == w["o"].dtype == np.float32
    assert g["o"].tobytes() == w["o"].tobytes()
    np.testing.assert_allclose(g["d"], w["d"], rtol=1e-6, atol=1e-6)


def test_save_loads_with_jax(monkeypatch, tmp_path):
    """A dump the port saves loads with JAX's raydump.load (the format
    scripts/probe_reorg.py reads) and with the port's, array for array."""
    monkeypatch.setenv("TPU_RT_DUMP_RAYS", "1")
    got = _port_batches()
    assert len(got) >= 2
    raydump.BATCHES.extend(got)
    try:
        raydump.save(str(tmp_path / "rays.npz"))
    finally:
        raydump.clear()
    for loaded in (jax_raydump.load(str(tmp_path / "rays.npz")),
                   raydump.load(str(tmp_path / "rays.npz"))):
        assert len(loaded) == len(got)
        for a, b in zip(loaded, got):
            assert set(a) == set(KEYS)
            for k in KEYS:
                np.testing.assert_array_equal(a[k], b[k])
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("early_exit", [False, True])
def test_emit_copies_in_call_order(monkeypatch, early_exit):
    """emit copies the tensors when it is called: later writes to them do
    not reach the dump."""
    monkeypatch.setenv("TPU_RT_DUMP_RAYS", "1")
    o = torch.zeros(4, 3)
    raydump.clear()
    try:
        raydump.emit(early_exit, o, o + 1, o[:, 0], o[:, 0] + 2,
                     torch.ones(4, dtype=torch.bool))
        o += 5
        (b,) = raydump.BATCHES
        assert b["kind"] == int(early_exit)
        assert b["o"].max() == 0 and b["d"].min() == 1 and b["t_max"][0] == 2
    finally:
        raydump.clear()
