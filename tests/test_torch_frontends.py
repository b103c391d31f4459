"""The port's frontends (bundle.py, viewer.py, tui.py and the CLI's -i), the
surface of tests/test_frontends.py: the bundler's launchers run from dist/,
the headless viewer writes its PNGs on the CPU (the wireframe byte for byte
with the JAX viewer's: both read byte-identical scene tables through the
same numpy projection), and the TUI's form logic."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_raytracing.scene.test_scenes import get_test_scene as jax_test_scene
from tpu_raytracing.utils.png import save_png as jax_save_png
from tpu_raytracing.viewer import (
    _rasterize_wireframe as jax_rasterize, _wireframe_segments as jax_segments,
)
from tpu_raytracing_torch import cli, tui, viewer
from tpu_raytracing_torch.scene.test_scenes import get_test_scene

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _env(pythonpath=True):
    env = {k: v for k, v in os.environ.items()
           if k not in ("DISPLAY", "WAYLAND_DISPLAY", "PYTHONPATH")}
    if pythonpath:
        env["PYTHONPATH"] = str(REPO)
    return env


def test_bundle_creates_launchers(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "tpu_raytracing_torch.bundle", "--output-dir",
         str(tmp_path / "dist")],
        capture_output=True, text=True, timeout=120, env=_env(), cwd=REPO,
    )
    assert r.returncode == 0, r.stderr
    dist = tmp_path / "dist"
    for launcher in ("tpu-raytracing-torch", "tpu-raytracing-torch-viewer",
                     "rttest-torch"):
        assert (dist / launcher).exists()
        assert os.access(dist / launcher, os.X_OK)
    pkg = dist / "tpu_raytracing_torch"
    assert (pkg / "cli.py").exists() and (pkg / "parallel/mesh.py").exists()
    assert (pkg / "csrc/bvh8t_walk.cu").exists()
    assert (pkg / "csrc/host/bvh_builder.cpp").exists()
    assert (dist / "visual_testing/tests/tests.toml").read_bytes() == (
        REPO / "visual_testing/tests/tests.toml").read_bytes()
    # what the package builds or writes is built anew at first use
    assert not list(dist.rglob("_build")) and not list(dist.rglob("*.pyc"))
    assert not (pkg / "rttest/out").exists()
    # the launchers run from the bundle alone (no repository on the path)
    r = subprocess.run([str(dist / "tpu-raytracing-torch"), "list-scenes"],
                       capture_output=True, text=True, timeout=120,
                       env=_env(pythonpath=False), cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "sphere" in json.loads(r.stdout)
    r = subprocess.run([str(dist / "rttest-torch"), "--help"],
                       capture_output=True, text=True, timeout=120,
                       env=_env(pythonpath=False), cwd=tmp_path)
    assert r.returncode == 0, r.stderr


def test_viewer_headless_writes_pngs(tmp_path):
    """The headless viewer on the CPU writes the beauty and the wireframe;
    the wireframe PNG is the JAX viewer's, byte for byte."""
    r = subprocess.run(
        [sys.executable, "-m", "tpu_raytracing_torch.viewer", "--scene-name",
         "checkered_plane", "-s", "1", "-d", "2", "--backend", "cpu"],
        capture_output=True, text=True, timeout=300, env=_env(),
        cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "checkered_plane_view.png").stat().st_size > 0
    assert "triangles: 2" in r.stdout
    scene = jax_test_scene("checkered_plane").scene_func()
    cam = scene.camera
    edges = jax_segments(scene)
    assert edges.shape[0] > 0
    want = tmp_path / "jax_wire.png"
    jax_save_png(want, jax_rasterize(edges, cam.raster_width,
                                     cam.raster_height) * 255.0, exposure=1.0)
    got = (tmp_path / "checkered_plane_wire.png").read_bytes()
    assert got == want.read_bytes()


def test_wireframe_segments_match_jax():
    """The segments themselves, on an instanced-free mesh scene (cube)."""
    port = viewer._wireframe_segments(get_test_scene("cube").scene_func(),
                                      "cpu")
    want = jax_segments(jax_test_scene("cube").scene_func())
    assert port.dtype == want.dtype and port.shape == want.shape
    assert port.tobytes() == want.tobytes()


def test_viewer_cuda_without_card_raises(tmp_path, monkeypatch):
    """The viewer's default backend is the card; without one it raises and
    does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        viewer.main(["--scene-name", "cube", "-s", "1", "-d", "1"])
    assert not list(tmp_path.iterdir())


def test_tui_cycle_logic():
    assert tui._cycle_list(["a", "b", "c"], "a", 1) == "b"
    assert tui._cycle_list(["a", "b", "c"], "a", -1) == "c"
    assert tui._cycle_list(["a", "b"], "zz", 1) == "a"
    assert tui._cycle_list(tui.BACKENDS, "cuda", 1) == "cpu"
    assert set(tui.BACKENDS) == set(
        cli.build_parser()._option_string_actions["--backend"].choices)


def test_tui_form_state_roundtrip():
    """build_form_state/apply_form_state map CLI args <-> form fields."""
    args = cli.build_parser().parse_args(["-i", "full", "--aov", "n,u"])
    st = tui.build_form_state(args, ["sphere", "cube"])
    assert st["scene"] == "sphere" and st["aov"] == ["n", "u"]
    assert st["backend"] == "cuda"
    tui._toggle_aov(st, "a")
    tui._toggle_aov(st, "n")
    st["spp"] = "16"
    st["backend"] = "cpu"
    st["command"] = "pixel"
    st["px"], st["py"], st["count"] = "3", "7", "2"
    out = tui.apply_form_state(args, st)
    assert out.command == "pixel" and out.spp == 16 and out.backend == "cpu"
    assert (out.x, out.y, out.sample_count) == (3, 7, 2)
    assert out.interactive is False
    st["command"] = "full"
    out = tui.apply_form_state(args, st)
    assert out.aov == ["u,a"] and out.no_beauty is False


def test_cli_interactive_runs_the_form(tmp_path, monkeypatch, capsys):
    """`-i` opens the form (tui.run, here a stand-in): a cancelled form
    renders nothing, an accepted one renders what it set."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tui, "run", lambda args: None)
    assert cli.run(["-i"]) == (0, None)
    assert "Render cancelled." in capsys.readouterr().out

    def accept(args):
        st = tui.build_form_state(args, ["sphere"])
        st.update(backend="cpu", spp="1", aov=["n"], beauty=False)
        return tui.apply_form_state(args, st)

    monkeypatch.setattr(tui, "run", accept)
    code, out = cli.run(["-i", "full"])
    assert code == 0 and out.normals.shape == (400, 400, 3)
    assert (tmp_path / "scenes/output/output.exr").exists()
