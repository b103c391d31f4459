"""The port's rttest harness (tpu_raytracing_torch/rttest) against the JAX
harness (visual_testing/rttest): the same suite, the same statistics, a
digest that gives the full image's gate numbers bit for bit, the committed
references, and the harness end to end on the CPU against a reference the
JAX CLI renders here. Mirrors tests/test_rttest_gate.py and
tests/test_rttest_harness.py.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpu_raytracing.scene.test_scenes import get_test_scene as jax_test_scene
from tpu_raytracing_torch.rttest import diff, digest, main, perf, runner
from tpu_raytracing_torch.rttest.test_spec import load_test_suite
from tpu_raytracing_torch.utils.exr import read_exr, write_exr
from visual_testing.rttest import diff as jax_diff
from visual_testing.rttest import runner as jax_runner
from visual_testing.rttest import test_spec as jax_spec

ROOT = Path(__file__).resolve().parent.parent
SMALL_SUITE = """
[defaults]
samples_per_pixel = 4

[[test]]
name = "a"
builtin_scene = "sphere"

[[test]]
name = "b"
scene_path = "x/y.pbrt"
skip_visual = true
[test.settings]
samples_per_pixel = 16
aov = ["normal", "uv"]
no_beauty = true
stat_rel_mean = 0.01
"""


@pytest.fixture(params=["tests.toml", "small"])
def suite_file(request, tmp_path):
    if request.param == "tests.toml":
        return main.SUITE
    path = tmp_path / "t.toml"
    path.write_text(SMALL_SUITE)
    return path


def test_suite_parses_as_the_jax_harness_does(suite_file):
    ours = load_test_suite(suite_file)
    theirs = jax_spec.load_test_suite(suite_file)
    assert [s.name for s in ours] == [s.name for s in theirs]
    base = main.SCENE_BASE
    for a, b in zip(ours, theirs):
        assert a.scene_cli_args(base) == b.scene_cli_args(base)
        assert a.settings.to_cli_args() == b.settings.to_cli_args()
        assert vars(a.settings) == vars(b.settings)
        assert (a.skip_visual, a.tags) == (b.skip_visual, b.tags)
        out = Path("/o/x.exr")
        got = runner.build_command(a, out, ["-d", "3"], "cpu", base)
        want = jax_runner.build_command(b, out, ["-d", "3"], "cpu", base)
        assert got[:3] == [sys.executable, "-m", "tpu_raytracing_torch.cli"]
        assert got[3:] == want[3:]


def test_suite_rejects_ambiguous_scene(tmp_path):
    (tmp_path / "t.toml").write_text(
        '[[test]]\nname = "x"\nbuiltin_scene = "a"\nscene_path = "b"\n')
    with pytest.raises(ValueError, match="exactly one"):
        load_test_suite(tmp_path / "t.toml")


def _structured(h, w):
    y, x = np.mgrid[0:h, 0:w]
    return (np.stack([x / w, y / h, (x + y) / (w + h)], -1) * 2.0
            + 0.05).astype(np.float32)


def _channels(group, img):
    names = dict(diff.CHANNEL_GROUPS)[group]
    return {n: img[..., k] for k, n in enumerate(names)}


def _pair(group, h, w, seed):
    """A seeded (output, reference) image pair of a channel group: noise
    around a structured image, HDR outliers in the beauty."""
    rng = np.random.default_rng(seed)
    c = len(dict(diff.CHANNEL_GROUPS)[group])
    ref = _structured(h, w)[..., :c]
    if group == "RGB":
        ref = ref * rng.exponential(1.0, ref.shape).astype(np.float32)
        ref[rng.random((h, w)) < 0.01] = 500.0
    out = ref + rng.normal(0, 0.05, ref.shape).astype(np.float32)
    if group != "RGB":
        out[rng.random((h, w)) < 0.01] = 0.0  # silhouette flips
    return out.astype(np.float32), ref


PAIRS = [("RGB", 64, 80), ("RGB", 13, 21), ("RGB", 5, 6), ("Normal", 40, 40),
         ("Albedo", 24, 17), ("UV", 9, 33)]


@pytest.mark.parametrize("group,h,w", PAIRS,
                         ids=[f"{g}-{h}x{w}" for g, h, w in PAIRS])
def test_compare_images_equals_jax(tmp_path, group, h, w):
    out, ref = _pair(group, h, w, seed=h * w)
    write_exr(tmp_path / "o.exr", _channels(group, out))
    write_exr(tmp_path / "r.exr", _channels(group, ref))
    a = diff.compare_images(tmp_path / "o.exr", tmp_path / "r.exr")
    b = jax_diff.compare_images(tmp_path / "o.exr", tmp_path / "r.exr")
    assert a.channel_group == b.channel_group == group
    for f in ("mse", "max_diff", "rel_mean", "block_rel"):
        assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-12,
                                              abs=1e-12), f
    assert a.stat_passes() == b.stat_passes()


@pytest.mark.parametrize("group,h,w", PAIRS,
                         ids=[f"{g}-{h}x{w}" for g, h, w in PAIRS])
def test_digest_gives_the_full_images_gate_bit_for_bit(tmp_path, group, h, w):
    out, ref = _pair(group, h, w, seed=h + w)
    write_exr(tmp_path / f"{group}.exr", _channels(group, ref))
    rec = digest.make_record(group, ["--scene-name", "cube", "full"],
                             tmp_path / f"{group}.exr", "c0ffee", 1.5)
    rec = json.loads(json.dumps(rec))  # as committed
    if group != "RGB":
        assert rec["exr"] == f"{group}.exr" and "tb_mean" not in rec
        return
    full = diff.compare_arrays("RGB", out, ref)
    dig = diff.compare_digest("RGB", out, rec)
    assert dig.rel_mean == full.rel_mean
    assert dig.block_rel == full.block_rel
    assert dig.mse is None and dig.max_diff is None
    assert len(rec["tb_blocks"]) == 64
    assert rec["sha256"] == digest.sha256(tmp_path / f"{group}.exr")
    with pytest.raises(ValueError, match="shape"):
        diff.compare_digest("RGB", out[1:], rec)


def test_quadrant_swap_fails_the_block_gate():
    ref = _structured(600, 800).astype(np.float64)
    out = ref.copy()
    out[:300, :400], out[300:, 400:] = (
        ref[300:, 400:].copy(), ref[:300, :400].copy())
    a = diff.compare_arrays("RGB", out, ref)
    rec = {"group": "RGB", "shape": list(ref.shape),
           "tb_mean": float(np.mean(diff.tonemap(ref))),
           "tb_blocks": diff.block_means(diff.tonemap(ref))}
    b = diff.compare_digest("RGB", out, rec)
    ta, tb = diff.tonemap(out), diff.tonemap(ref)
    assert a.block_rel == jax_diff._block_rel(ta, tb, float(tb.mean()))
    for d in (a, b):
        assert d.rel_mean < 1e-9  # the global mean is blind to the swap
        assert d.block_rel > 0.1  # the spatial statistic is not
        assert not d.stat_passes()
        assert not d.stat_passes(0.02)
    assert diff._block_rel(tb, tb, float(tb.mean())) == 0.0


@pytest.mark.parametrize("rel_mean,block_rel,tols", [
    (0.05, 0.2, (0.10, None)), (0.05, 0.2, (0.10, 0.15)),
    (0.05, 0.2, (0.02, None)), (0.004, 0.0019, (None, None)),
    (0.004, 0.0021, (None, None)), (0.01, 0.04, (0.02, None)),
])
def test_stat_gate_and_per_scene_override_as_jax(rel_mean, block_rel, tols):
    """The gate's thresholds and the tests.toml overrides (stat_rel_mean,
    stat_block_rel) decide as in the JAX harness."""
    a = diff.DiffResult(mse=None, max_diff=None, channel_group="RGB",
                        rel_mean=rel_mean, block_rel=block_rel)
    b = jax_diff.DiffResult(mse=1.0, max_diff=1.0, channel_group="RGB",
                            rel_mean=rel_mean, block_rel=block_rel)
    assert a.stat_passes(*tols) == b.stat_passes(*tols)
    for mse in (4.9e-3, 5.1e-3):
        assert (diff.DiffResult(mse, 1.0, "Normal").stat_passes()
                == jax_diff.DiffResult(mse, 1.0, "Normal").stat_passes())
    for k in ("STAT_AOV_MSE", "STAT_REL_MEAN", "STAT_BLOCK_REL",
              "BLOCK_TOL_FACTOR"):
        assert getattr(diff.DiffResult, k) == getattr(jax_diff.DiffResult, k)


def _committed():
    return json.loads((main.REFERENCES / digest.DIGEST_NAME).read_text())


def _jax_settings(args):
    """What the JAX CLI renders a row's arguments at, from the JAX
    package's builtin settings and the row's flags."""
    name = args[args.index("--scene-name") + 1]
    ts = jax_test_scene(name)
    s, cam = ts.settings_func(), ts.scene_func().camera
    flags = dict(zip(args[:-1], args[1:]))
    return {
        "resolution": [cam.raster_width, cam.raster_height],
        "spp": int(flags.get("-s", s.samples_per_pixel)),
        "light_samples": int(flags.get("-l", s.light_sample_count)),
        "max_depth": int(flags.get("-d", s.max_ray_depth)),
        "seed": s.seed,
        "outputs": [f.name for f in type(s.outputs) if f & s.outputs],
        "sampler": type(s.sampler).__name__.lower() + (
            f" {s.sampler.x_strata}x{s.sampler.y_strata}"
            + (" jittered" if s.sampler.jitter else "")
            if type(s.sampler).__name__ == "Stratified" else ""),
    }


def test_committed_digest_covers_the_suite():
    recs = _committed()
    specs = load_test_suite(main.SUITE)
    want = {s.name for s in specs if s.scene_path is None
            or (main.SCENE_BASE / s.scene_path).exists()}
    want |= set(digest.EXTRA_ROWS)
    assert set(recs) == want
    assert "bathroom_albedo" not in recs  # its asset is absent
    for s in specs:
        if s.name in recs:
            assert recs[s.name]["args"] == digest.row_args(s, main.SCENE_BASE)
    for name, args in digest.EXTRA_ROWS.items():
        assert recs[name]["args"] == args


@pytest.mark.parametrize("name", sorted(_committed()))
def test_committed_record(name):
    rec = _committed()[name]
    assert rec["name"] == name
    assert len(rec["jax_commit"]) == 40 and len(rec["sha256"]) == 64
    assert rec["settings"] == _jax_settings(rec["args"])
    w, h = rec["settings"]["resolution"]
    assert rec["shape"][:2] == [h, w]
    assert rec["cpu_wall_s"] > 0
    if rec["group"] == "RGB":
        assert rec["settings"]["outputs"] == ["BEAUTY"]
        assert len(rec["tb_blocks"]) == 64
        assert 0 < rec["tb_mean"] < 1 and rec["mean"] > 0
    else:
        exr = main.REFERENCES / rec["exr"]
        assert digest.sha256(exr) == rec["sha256"]
        group, img = diff.load_exr_channels(exr)
        assert group == rec["group"] and list(img.shape) == rec["shape"]


def test_harness_reports_missing_assets_and_unknown_scenes(tmp_path, capsys):
    assert main.main(["cpu", "--scenes", "nope", "--out", str(tmp_path)]) == 2
    assert main.main(["cpu", "--scenes", "bathroom_albedo", "--json",
                      "--out", str(tmp_path)]) == 2
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["summary"] == {"pass": 0, "fail": 0, "new": 0, "error": 1}
    assert "missing scene asset" in res["results"][0]["message"]


def test_cube_end_to_end_on_the_cpu(tmp_path, capsys):
    """The harness renders `cube` through the port's CLI on the CPU and
    holds it against the JAX CLI's render of it here (PASS) and against the
    committed reference (PASS); a flipped copy of the output FAILs both; a
    reference rendered at other settings is refused."""
    ref_dir = tmp_path / "ref"
    subprocess.run(
        [sys.executable, "-m", "tpu_raytracing.cli", "--scene-name", "cube",
         "-o", str(ref_dir / "cube.exr"), "--backend", "cpu", "full"],
        check=True, capture_output=True, cwd=tmp_path, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": str(ROOT)})
    out_dir = tmp_path / "run"
    rc = main.main(["cpu", "--scenes", "cube", "--json", "--references",
                    str(ref_dir), "--out", str(out_dir)])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, res
    row = res["results"][0]
    assert row["status"] == "PASS" and row["group"] == "Normal"
    assert row["mse"] <= diff.DiffResult.STAT_AOV_MSE
    assert (out_dir / "perf_history.jsonl").is_file()

    spec = next(s for s in load_test_suite(main.SUITE) if s.name == "cube")
    output = Path(row["output"])
    committed = digest.References(main.REFERENCES)
    status, d, _, _ = runner.gate(spec, output, committed, main.SCENE_BASE)
    assert status == "PASS", d

    chans, _, _ = read_exr(output)
    flipped = tmp_path / "flipped.exr"
    write_exr(flipped, {k: v[::-1, ::-1] for k, v in chans.items()})
    for refs in (digest.References(ref_dir), committed):
        status, d, _, _ = runner.gate(spec, flipped, refs, main.SCENE_BASE)
        assert status == "FAIL" and d.mse > diff.DiffResult.STAT_AOV_MSE

    stale = digest.References(main.REFERENCES)
    stale.records["cube"] = dict(stale.records["cube"],
                                 args=["--scene-name", "cube", "-s", "2",
                                       "full"])
    status, _, msg, _ = runner.gate(spec, output, stale, main.SCENE_BASE)
    assert status == "ERROR" and "rendered with" in msg


def test_perf_regression_gate(tmp_path):
    baseline = perf.PerfBaseline(tmp_path / "b.json")
    baseline.set(perf.make_record("s", 1.0, ["-s", "2"], "cuda", 2, 1))
    baseline.save()
    b2 = perf.PerfBaseline(tmp_path / "b.json")
    reg = b2.check_regression(
        perf.make_record("s", 1.2, ["-s", "2"], "cuda", 2, 1), 10.0)
    assert reg is not None and reg["delta_pct"] == pytest.approx(20.0)
    assert b2.check_regression(
        perf.make_record("s", 1.2, ["-s", "4"], "cuda", 4, 1), 10.0) is None
    assert b2.check_regression(
        perf.make_record("s", 1.05, ["-s", "2"], "cuda", 2, 1), 10.0) is None
    h = perf.PerfHistory(tmp_path / "h.jsonl")
    for name, t in (("a", 1.0), ("b", 2.0), ("a", 3.0)):
        h.append(perf.make_record(name, t, [], "cpu", 1, 1))
    assert [r.render_time_seconds for r in h.records_for("a")] == [1.0, 3.0]
