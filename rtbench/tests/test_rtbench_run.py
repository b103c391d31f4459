"""A run of each cell at a tiny size on the CPU, through the window and
the reference comparison; and the card path on the card."""
import json
import subprocess
import sys

import pytest

from rtbench_helpers import BENCH, REPO, SEED, run_cell, tiny_cell


@pytest.mark.parametrize("cell,width", [("rough_dielectric-beauty", 16),
                                        ("bunny-beauty", 10)])
def test_tiny_run_is_correct(cell, width, capsys):
    res = run_cell(tiny_cell(cell, width), capsys)
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) >= {"mrays_per_s", "setup_s"}
    check = res["check"]
    assert list(check)[-1] == "rays_lane_mismatch" and list(res)[-1] == "check"
    assert check["camera_ray_err"]["value"] == 0.0
    assert check["radiance_mismatch"]["value"] <= \
        check["radiance_mismatch"]["limit"]


def test_tiny_traced_run_checks_every_pass(capsys):
    res = run_cell(tiny_cell("rough_dielectric-beauty", 12), capsys, trace=1)
    assert res["correct"] is True
    assert res["attempted"] == 3  # the captured pass and the two traced
    assert res["metrics"] == {}  # no device trace on the CPU


def test_no_card_means_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "rough_dielectric-beauty", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_card_traced_run_reports_every_layer(card, capsys):
    res = run_cell_on_card(tiny_cell("rough_dielectric-beauty", 32), capsys)
    assert res["correct"] is True
    assert set(res["metrics"]) == {
        "device.idle_pct", "device.launches_per_pass",
        "integrator.syncs_per_pass", "shading.host_pct",
        "traversal.device_ms_per_pass", "traversal.bvh8t_walk_roofline"}
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["metrics"]["traversal.bvh8t_walk_roofline"]["value"] <= 100


def run_cell_on_card(cell, capsys):
    import run as bench_run
    import torch
    from rtbench_helpers import Args
    assert bench_run.measure(cell, Args(trace=1), torch, on_card=True) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
