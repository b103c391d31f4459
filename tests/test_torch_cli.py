"""The port's CLI (tpu_raytracing_torch/cli.py), on the CPU: the surface of
tests/test_cli.py with --backend cpu, run in this process from a temporary
working directory (outputs go under its scenes/output/)."""
import json
import re

import numpy as np
import pytest
import torch

from tpu_raytracing.integrator.render import (
    render_single_pixel as jax_single_pixel,
)
from tpu_raytracing.scene.test_scenes import get_test_scene as jax_test_scene
from tpu_raytracing_torch import cli, tracing
from tpu_raytracing_torch.utils.exr import read_exr

torch.set_num_threads(1)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_list_scenes(in_tmp, capsys):
    assert cli.main(["list-scenes"]) == 0
    names = json.loads(capsys.readouterr().out)
    assert "sphere" in names and "coated_diffuse_bunny" in names
    assert len(names) == 11


def test_missing_scene_is_error(in_tmp, capsys):
    assert cli.main(["full"]) == 1
    assert "scene-path or --scene-name" in capsys.readouterr().err


def test_full_render_exr_channels(in_tmp):
    code, out = cli.run(["--scene-name", "sphere", "-s", "1", "-o", "out.exr",
                         "--backend", "cpu", "full", "--aov", "n,u"])
    assert code == 0
    channels, w, h = read_exr(in_tmp / "scenes/output/out.exr")
    # sphere's builtin settings are NORMALS only; --aov adds UV
    assert set(channels) == {"Normal.X", "Normal.Y", "Normal.Z", "U", "V"}
    assert (w, h) == (400, 400)
    for k, c in enumerate("XYZ"):
        np.testing.assert_array_equal(channels[f"Normal.{c}"],
                                      out.normals[..., k])
    np.testing.assert_array_equal(channels["U"], out.uv[..., 0])
    assert np.any(out.normals != 0)


def test_png_outputs_one_file_per_aov(in_tmp):
    code, _ = cli.run(["--scene-name", "sphere", "-o", "out.png",
                       "--backend", "cpu", "full", "--aov", "n,u"])
    assert code == 0
    names = sorted(p.name for p in (in_tmp / "scenes/output").iterdir())
    assert names == ["out_NORMALS.png", "out_UV_COORDS.png"]


def test_profile_writes_a_chrome_trace(in_tmp):
    code, _ = cli.run(["--scene-name", "sphere", "--profile", "prof",
                       "--backend", "cpu", "full"])
    assert code == 0
    trace = json.loads((in_tmp / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_profile_traces_the_ports_spans(in_tmp, caplog):
    """--profile turns the port's tracing on for the render: the trace
    holds its rt. spans, and the host syncs are logged by site."""
    with caplog.at_level("INFO", logger="tpu_raytracing_torch"):
        code, _ = cli.run(["--scene-name", "checkered_plane", "-s", "1",
                           "-d", "1", "--profile", "prof", "--backend",
                           "cpu", "full"])
    assert code == 0
    trace = json.loads((in_tmp / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"rt.pass", "rt.sample", "rt.bounce"} <= names
    assert "host syncs at render.alive_any: 2" in caplog.text
    assert not tracing.enabled()


def _radiances(text: str) -> list:
    return [np.array([float(v) for v in m.split(", ")], np.float32)
            for m in re.findall(r"radiance: \(([^)]*)\)", text)]


def test_pixel_subcommand_matches_jax(in_tmp, capsys):
    """pixel prints each sample's first hit and radiance; the radiance
    equals JAX's render_single_pixel within rtol 1e-5 per sample (a
    diffuse-only scene: out_of_focus_sphere at 4 spp, samples 1 and 2)."""
    assert cli.main(["--scene-name", "out_of_focus_sphere", "-s", "4",
                     "--backend", "cpu", "pixel", "200", "200", "2", "1"]) == 0
    text = capsys.readouterr().out
    assert "sample 1" in text and "sample 2" in text
    assert text.count("hit: True") == 2
    ts = jax_test_scene("out_of_focus_sphere")
    s = ts.settings_func()
    s.samples_per_pixel = 4
    want = jax_single_pixel(ts.scene_func(), s, 200, 200, 2, 1)
    got = _radiances(text)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert np.any(w.radiance > 0)
        np.testing.assert_allclose(g, w.radiance, rtol=1e-5)


def test_checkpointed_cli_matches_oneshot(in_tmp):
    """--checkpoint with --spp-chunk renders the one-shot frame's samples
    (rtol 1e-5, atol 1e-6) and leaves a resumable checkpoint."""
    common = ["--scene-name", "checkered_plane", "-s", "3", "-d", "1",
              "--backend", "cpu"]
    _, one = cli.run([*common, "-o", "one.exr", "full"])
    _, acc = cli.run([*common, "-o", "acc.exr", "--checkpoint", "ck.npz",
                      "--spp-chunk", "2", "full"])
    np.testing.assert_allclose(acc.beauty, one.beauty, rtol=1e-5, atol=1e-6)
    with np.load(in_tmp / "ck.npz") as ck:
        assert int(ck["spp_done"]) == 3 and int(ck["spp_chunk"]) == 2
    channels, _, _ = read_exr(in_tmp / "scenes/output/acc.exr")
    np.testing.assert_array_equal(channels["R"], acc.beauty[..., 0])


@pytest.mark.parametrize("flags,item", [
    (["--multichip"], ("render_distributed", 1)),
    (["--multichip", "--spp-shards", "2"], ("render_distributed", 2)),
    (["-i"], ("tui.run", None)),
])
def test_unported_flags_raise(in_tmp, monkeypatch, flags, item):
    """The flags that raised NotImplementedError until the port had
    parallel/ and tui.py now reach them: --multichip the distributed render
    (with --spp-shards as its spp axis), -i the settings form."""
    import tpu_raytracing_torch.parallel as parallel
    import tpu_raytracing_torch.tui as tui
    from tpu_raytracing_torch.settings import RenderOutput

    reached = []

    def fake_render(scene, settings, n_spp_shards=1, chunk_pixels=None):
        reached.append(("render_distributed", n_spp_shards))
        return RenderOutput(width=400, height=400)

    def fake_form(args):
        reached.append(("tui.run", None))

    monkeypatch.setattr(parallel, "render_distributed", fake_render)
    monkeypatch.setattr(tui, "run", fake_form)
    assert cli.main(["--scene-name", "sphere", "--backend", "cpu", *flags,
                     "full", "--aov", "n"]) == 0
    assert reached == [item]


def test_cuda_backend_is_the_default(in_tmp):
    """Without a card the default backend raises; it never falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--scene-name", "sphere", "full"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--scene-name", "sphere", "pixel", "1", "1"])
    assert not (in_tmp / "scenes").exists()
