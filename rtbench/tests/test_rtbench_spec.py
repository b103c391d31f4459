"""A cell, a traffic mix, a metric and a scene kind are found by name
from data alone: a new cell brings only files and BENCHMARK.json
entries."""
import json
import shutil

from rtbench_helpers import BENCH, REPO, run_cell, tiny_cell

NEW_METRIC = '''"""Passes of the window (a metric a later change could add)."""


def read(run):
    return float(len(run.window.passes))
'''


def test_new_cell_traffic_and_metric_from_files(tmp_path, capsys):
    root = tmp_path / "rtbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [dict(c, file=c["file"].replace(
        "rtbench/", f"{root.name}/")) for c in spec["configs"]]
    (root / "traffic" / "short_job.json").write_text(json.dumps(
        dict(json.loads((BENCH / "traffic" / "beauty.json").read_text()),
             job_spp=2)))
    shutil.copy(BENCH / "cells" / "rough_dielectric-beauty.json",
                root / "cells" / "rough_dielectric-short_job.json")
    (root / "metrics" / "window.passes.py").write_text(NEW_METRIC)
    spec["workloads"].append({
        "name": "rough_dielectric-short_job", "config": "rough_dielectric",
        "traffic": "short_job", "chips": 1, "why": "two-sample jobs"})
    spec["end_to_end"].append({
        "name": "window.passes", "unit": "passes", "better": "higher",
        "bound": 0.01, "source": "host_clock",
        "workloads": ["rough_dielectric-short_job"]})
    bench = tmp_path / "BENCHMARK.json"
    bench.write_text(json.dumps(spec))

    cell = tiny_cell("rough_dielectric-short_job", 8, benchmark=bench,
                     root=root)
    assert cell.traffic["job_spp"] == 2
    names = [m.name for m in cell.end_to_end]
    assert "window.passes" in names and "pass_ms_p90" not in names
    res = run_cell(cell, capsys, seconds=0.3)
    assert res["correct"] is True
    assert res["metrics"]["window.passes"]["value"] == res["attempted"]
    # the old cells do not see the new metric
    old = tiny_cell("bunny-beauty", 8, benchmark=bench, root=root)
    assert "window.passes" not in [m.name for m in old.end_to_end]


TRIANGLE_KIND = '''"""One triangle: three `points` and one `normal` (a kind a later
configuration could add)."""
import numpy as np


def port(shape, root):
    from tpu_raytracing_torch.geometry import Mesh, TriangleMesh
    return TriangleMesh(Mesh(
        vertices=np.asarray(shape["points"], np.float32),
        tris=np.array([[0, 1, 2]], np.uint32),
        normals=np.tile(np.asarray(shape["normal"], np.float32), (3, 1))))


def reference(shape, root):
    return dict(vertices=np.asarray(shape["points"], np.float32),
                normals=np.tile(np.asarray(shape["normal"], np.float32),
                                (3, 1)),
                tris=np.array([[0, 1, 2]], np.int64))
'''


def test_metal_cell_and_a_new_shape_kind_from_files(tmp_path, capsys):
    """The suite's `metal` scene (PERF.md's next cells), brought in as a
    configuration, a cell file and BENCHMARK.json entries, with a shape
    kind of its own added as one more file."""
    root = tmp_path / "rtbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [dict(c, file=c["file"].replace(
        "rtbench/", f"{root.name}/")) for c in spec["configs"]]
    cfg = json.loads((BENCH / "configs" / "rough_dielectric.json")
                     .read_text())
    cfg["name"] = "metal"
    cfg["scene"]["materials"][3] = {
        "kind": "conductor", "eta": [0.13, 0.43, 1.38],
        "kappa": [4.10, 2.46, 1.91]}
    cfg["scene"]["shapes"].append({
        "kind": "triangle", "name": "shelf", "material": 1,
        "points": [[-0.9, -0.9, 0.3], [0.9, -0.9, 0.3], [0.0, 0.5, 0.3]],
        "normal": [0, 0, 1], "position": [0, 0, 0]})
    (root / "configs" / "metal.json").write_text(json.dumps(cfg))
    (root / "kinds" / "shape" / "triangle.py").write_text(TRIANGLE_KIND)
    shutil.copy(BENCH / "cells" / "rough_dielectric-beauty.json",
                root / "cells" / "metal-beauty.json")
    spec["configs"].append({
        "name": "metal", "source": "tests.toml (test metal)",
        "file": f"{root.name}/configs/metal.json", "reduced": [],
        "why": "a smooth conductor sphere"})
    spec["workloads"].append({
        "name": "metal-beauty", "config": "metal", "traffic": "beauty",
        "chips": 1, "why": "the conductor's delta BSDF on the shared path"})
    bench = tmp_path / "BENCHMARK.json"
    bench.write_text(json.dumps(spec))

    cell = tiny_cell("metal-beauty", 12, benchmark=bench, root=root)
    res = run_cell(cell, capsys, seconds=0.3)
    assert res["correct"] is True
    assert res["check"]["radiance_mismatch"]["value"] == 0.0
    from reference.scene import RefScene
    sc = RefScene(cell.config["scene"], 4, 4, root, "cpu")
    assert sc.n_tris == 11 and sc.kinds == (0, 2)


def test_unknown_kind_names_its_missing_file(tmp_path):
    from reference.kinds import load_kind
    import pytest
    with pytest.raises(FileNotFoundError, match="kinds/light/area.py"):
        load_kind(BENCH, "light", "area")
    with pytest.raises(ValueError, match="not a name"):
        load_kind(BENCH, "light", "../point")


def test_every_listed_metric_has_a_reader():
    from harness import spec
    for name in ("bunny-beauty", "rough_dielectric-beauty"):
        cell = spec.load_cell(name, REPO / "BENCHMARK.json")
        assert {m.name for m in cell.per_layer} == {
            "device.idle_pct", "device.launches_per_pass",
            "integrator.syncs_per_pass", "shading.host_pct",
            "traversal.device_ms_per_pass", "traversal.bvh8t_walk_roofline"}
        assert ("pass_ms_p90" in {m.name for m in cell.end_to_end}) == (
            name == "rough_dielectric-beauty")
