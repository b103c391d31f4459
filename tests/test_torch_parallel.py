"""Multi-rank rendering (tpu_raytracing_torch/parallel) on the CPU: the
surface of tests/test_parallel.py with gloo ranks.

Each multi-rank case starts its ranks by running this file as a script,
one process a rank, on a file:// store in tmp_path (no TCP port, so xdist
workers cannot collide), with a 120 s timeout; each rank writes what it
got to an .npz. The frame is JAX's 37x27 checkered_plane of
tests/test_parallel.py::_tiny_frame_scene (999 pixels, so 2, 4 and 8 tiles
pad dead lanes), 2 spp, depth 2, one light sample: torch_fixtures.py's
`tiny_frame`, which chip_smoke.py's multi-gpu phase renders on the card.

Tolerances. Against the port on one device everything is bit for bit
(np.array_equal) and rays_traced equal: the spp axis is folded in a fixed
rank order. Against JAX's render_distributed the limits are
tests/test_torch_render_textures.py's for checkered_plane: the mean within
1% per channel, at least 92% of pixels within rtol 1e-3 (atol 1e-4), and
the port's rays plus its black primary lanes equal to JAX's rays.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_fixtures import tiny_frame

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 120
ACCUM_SPP, ACCUM_CHUNK = 8, 4  # the checkpoint cases: 2 chunks of 4 spp


def _rank(case, rank, world, out_dir, *extra):
    """One gloo rank of `case` (run as this file's __main__)."""
    import torch.distributed as dist

    from tpu_raytracing_torch.parallel import (
        dryrun_step, init_render_group, make_render_mesh, make_sharded_step,
        render_accumulated_distributed, render_distributed,
    )

    torch.set_num_threads(1)
    rank, world, out_dir = int(rank), int(world), Path(out_dir)
    init_render_group("cpu", f"file://{out_dir}/store", rank, world)
    scene, s = tiny_frame()
    got = {}
    try:
        if case == "tiles":
            out = render_distributed(scene, s, mesh=make_render_mesh(world))
            got = dict(beauty=out.beauty, rays=out.rays_traced,
                       dryrun=dryrun_step(make_render_mesh(world), 64, 2))
        elif case == "spp":
            s.samples_per_pixel = 4
            mesh = make_render_mesh(n_spp=2)
            out = render_distributed(scene, s, mesh=mesh)
            got = dict(beauty=out.beauty, rays=out.rays_traced)
            from tpu_raytracing_torch.device import compile_scene
            from tpu_raytracing_torch.integrator.render import StaticSettings
            from tpu_raytracing_torch.ops.rng import SamplerConfig

            s.samples_per_pixel = 3
            try:
                make_sharded_step(
                    compile_scene(scene, "cpu"),
                    SamplerConfig.from_settings(s.sampler, s.seed),
                    StaticSettings.from_settings(s), mesh)
            except ValueError as e:
                got["error"] = str(e)
        elif case == "accum":
            n_spp, interrupt = int(extra[0]), extra[1] == "interrupt"
            s.samples_per_pixel = ACCUM_SPP
            seen = []

            def on_chunk(img, spp_done):
                seen.append(spp_done)
                if interrupt:
                    raise KeyboardInterrupt  # a failure after one chunk

            try:
                out = render_accumulated_distributed(
                    scene, s, mesh=make_render_mesh(n_spp=n_spp),
                    spp_chunk=ACCUM_CHUNK, checkpoint_path=extra[2],
                    on_chunk=on_chunk)
                got = dict(beauty=out.beauty, rays=out.rays_traced)
            except KeyboardInterrupt:
                pass
            got["seen"] = np.asarray(seen)
        else:
            raise ValueError(case)
        np.savez(out_dir / f"{rank}.npz", **got)
    finally:
        dist.destroy_process_group()


def _launch(out_dir: Path, case: str, world: int, *extra) -> list:
    """Start `world` ranks of `case`, wait for all (a rank that fails makes
    the others' collectives fail or time out) and return each rank's npz."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "PYTHONPATH")}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(r), str(world), str(out_dir),
         *map(str, extra)],
        env=env, cwd=out_dir, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-2000:])
           for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad
    res = []
    for r in range(world):
        with np.load(out_dir / f"{r}.npz") as z:
            res.append(dict(z))
    return res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Launch a case once per module: (case, world, *extra) -> rank npz's."""
    cache = {}

    def run(case, world, *extra):
        key = (case, world, *extra)
        if key not in cache:
            cache[key] = _launch(tmp_path_factory.mktemp(case), case, world,
                                 *extra)
        return cache[key]

    return run


@pytest.fixture(scope="module")
def reference():
    """The port on one device: render, and render_accumulated at a chunk."""
    from tpu_raytracing_torch.integrator.accumulate import render_accumulated
    from tpu_raytracing_torch.integrator.render import render

    cache = {}

    def run(spp, spp_chunk=None):
        if (spp, spp_chunk) not in cache:
            scene, s = tiny_frame()
            s.samples_per_pixel = spp
            cache[spp, spp_chunk] = (
                render(scene, s, "cpu") if spp_chunk is None else
                render_accumulated(scene, s, spp_chunk=spp_chunk,
                                   device="cpu"))
        return cache[spp, spp_chunk]

    return run


@pytest.mark.parametrize("n_tiles", [2, 4, 8])
def test_tile_sharding_bit_exact(ranks, reference, n_tiles):
    """Every rank's frame equals the one-device render bit for bit, and
    rays_traced is equal: padded lanes are traced dead and not counted."""
    ref = reference(2)
    for got in ranks("tiles", n_tiles):
        np.testing.assert_array_equal(got["beauty"], ref.beauty)
        assert int(got["rays"]) == ref.rays_traced > 0


def test_dryrun_step(ranks):
    """dryrun_step runs one sharded step on 64 random pixels on every
    rank, each returning every lane."""
    for got in ranks("tiles", 2):
        assert got["dryrun"].shape == (64, 3)
        assert np.isfinite(got["dryrun"]).all() and got["dryrun"].max() > 0
    np.testing.assert_array_equal(*(g["dryrun"] for g in ranks("tiles", 2)))


def test_spp_sharding_bit_exact(ranks, reference):
    """A (2, 2) mesh at 4 spp: the spp fold in rank order gives
    render_accumulated's frame at spp_chunk 4 / 2 bit for bit."""
    ref = reference(4, 2)
    for got in ranks("spp", 4):
        np.testing.assert_array_equal(got["beauty"], ref.beauty)
        assert int(got["rays"]) == ref.rays_traced


def test_spp_not_divisible_raises(ranks):
    for got in ranks("spp", 4):
        assert "not divisible" in str(got["error"])


def test_checkpoint_resume_across_tile_counts(ranks, reference, tmp_path):
    """8 spp in chunks of 4 over a (2, 2) mesh, interrupted after the first
    chunk, then resumed over (1, 2): bit for bit with render_accumulated at
    spp_chunk 4 / 2, rays equal. Only rank 0 writes the checkpoint."""
    ck = tmp_path / "ck.npz"
    first = ranks("accum", 4, 2, "interrupt", ck)
    assert all(list(g["seen"]) == [ACCUM_CHUNK] for g in first)
    assert ck.exists() and not any(
        p.name.endswith(".tmp.npz") for p in tmp_path.iterdir())
    with np.load(ck) as z:
        assert int(z["spp_done"]) == ACCUM_CHUNK
    ref = reference(ACCUM_SPP, ACCUM_CHUNK // 2)
    for got in ranks("accum", 2, 2, "resume", ck):
        assert list(got["seen"]) == [ACCUM_SPP]
        np.testing.assert_array_equal(got["beauty"], ref.beauty)
        assert int(got["rays"]) == ref.rays_traced


def test_checkpoint_fingerprint_matches_jax(tmp_path):
    """The port's checkpoint fingerprint is JAX's: JAX's
    render_accumulated_distributed resumes a finished checkpoint the port
    wrote (so it renders nothing) and returns its frame and rays."""
    from test_parallel import _tiny_frame_scene
    from tpu_raytracing.parallel import make_render_mesh as jax_mesh
    from tpu_raytracing.parallel import (
        render_accumulated_distributed as jax_accumulated,
    )
    from tpu_raytracing_torch.device import compile_scene
    from tpu_raytracing_torch.integrator.accumulate import (
        _settings_fingerprint, render_accumulated,
    )

    scene, s = tiny_frame()
    ds = compile_scene(scene, "cpu")
    out = render_accumulated(ds, s, spp_chunk=2, device="cpu")
    accum = out.beauty.reshape(-1, 3) * np.float32(s.samples_per_pixel)
    ck = tmp_path / "ck.npz"
    np.savez(ck, accum=accum, spp_done=s.samples_per_pixel,
             rays=out.rays_traced,
             fingerprint=_settings_fingerprint(s, ds, "raster-dist1"),
             spp_chunk=2)
    jscene, js = _tiny_frame_scene()
    got = jax_accumulated(jscene, js, mesh=jax_mesh(n_spp=1), spp_chunk=2,
                          checkpoint_path=ck)
    assert got.rays_traced == out.rays_traced
    np.testing.assert_array_equal(
        got.beauty, (accum / np.float32(s.samples_per_pixel)).reshape(
            out.beauty.shape))


def test_render_distributed_matches_jax(ranks):
    """The port's 4-rank frame against JAX's render_distributed on its
    8-device CPU mesh, same frame and settings, at checkered_plane's
    floors (module docstring)."""
    from test_parallel import _tiny_frame_scene
    from test_torch_render_textures import _black_primary_lanes
    from tpu_raytracing.parallel import make_render_mesh as jax_mesh
    from tpu_raytracing.parallel import render_distributed as jax_distributed
    from tpu_raytracing_torch.device import compile_scene
    from tpu_raytracing_torch.integrator.render import StaticSettings
    from tpu_raytracing_torch.ops.rng import SamplerConfig

    jscene, js = _tiny_frame_scene()
    want = jax_distributed(jscene, js, mesh=jax_mesh(n_tiles=8, n_spp=1))
    got = ranks("tiles", 4)[0]
    g, w = got["beauty"], want.beauty
    assert g.shape == w.shape == (27, 37, 3) and np.isfinite(g).all()
    assert w.mean() > 0
    np.testing.assert_allclose(g.reshape(-1, 3).mean(axis=0),
                               w.reshape(-1, 3).mean(axis=0), rtol=0.01)
    close = np.all(np.abs(g - w) <= 1e-3 * np.abs(w) + 1e-4, axis=-1)
    assert close.mean() >= 0.92, close.mean()
    scene, s = tiny_frame()
    tds = compile_scene(scene, "cpu")
    cfg = SamplerConfig.from_settings(s.sampler, s.seed)
    st = StaticSettings.from_settings(s)
    gx, gy = np.meshgrid(np.arange(37), np.arange(27))
    px = torch.from_numpy(gx.reshape(-1))
    py = torch.from_numpy(gy.reshape(-1))
    black = sum(_black_primary_lanes(tds, cfg, st, px, py, sample)
                for sample in range(s.samples_per_pixel))
    assert black > 0
    assert int(got["rays"]) + black == want.rays_traced


def test_cli_multichip_cpu_renders(tmp_path, monkeypatch):
    """`full --multichip --backend cpu` started alone runs one gloo rank
    in this process and writes the one-device frame, bit for bit; the
    group it started is gone afterwards."""
    import torch.distributed as dist

    from tpu_raytracing_torch import cli
    from tpu_raytracing_torch.utils.exr import read_exr

    monkeypatch.chdir(tmp_path)
    common = ["--scene-name", "checkered_plane", "-s", "1", "-d", "1",
              "--backend", "cpu"]
    code, one = cli.run([*common, "-o", "one.exr", "full"])
    assert code == 0
    code, out = cli.run([*common, "--multichip", "-o", "multi.exr", "full"])
    assert code == 0 and not dist.is_initialized()
    np.testing.assert_array_equal(out.beauty, one.beauty)
    assert out.rays_traced == one.rays_traced > 0
    channels, _, _ = read_exr(tmp_path / "scenes/output/multi.exr")
    np.testing.assert_array_equal(channels["R"], one.beauty[..., 0])


def test_mesh_needs_a_group_of_its_size(tmp_path):
    """make_render_mesh refuses to run without a process group and checks
    its shape against the world size (a gloo world of one here)."""
    import torch.distributed as dist

    from tpu_raytracing_torch.parallel import (
        init_render_group, make_render_mesh,
    )

    with pytest.raises(RuntimeError, match="no process group"):
        make_render_mesh()
    assert init_render_group("cpu", f"file://{tmp_path}/store", 0, 1) == \
        torch.device("cpu")
    try:
        for shape in ((2, 1), (None, 2)):
            with pytest.raises(ValueError, match="!= world size 1"):
                make_render_mesh(*shape)
        mesh = make_render_mesh()
        assert mesh.mesh_dim_names == ("tiles", "spp")
        assert tuple(mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()


def test_multichip_without_card_raises(tmp_path, monkeypatch):
    """The distributed path's default device is the card: without one it
    raises and starts no group on the CPU."""
    import torch.distributed as dist

    from tpu_raytracing_torch import cli
    from tpu_raytracing_torch.parallel import init_render_group

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_render_group()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--scene-name", "sphere", "--multichip", "full"])
    assert not dist.is_initialized()
    assert not (tmp_path / "scenes").exists()


if __name__ == "__main__":
    _rank(*sys.argv[1:])
