"""The check fails what it has to: the control (the reference in the
program's place, in TF32) and a run with the timed path broken
underneath, once for each fault a render cell can have (a pass that
returns the state unchanged, half of the frame left out, an answer
altered where it is produced: a BSDF value, a traversal answer, the ray
counter, the accumulated image). Each of them fails in each regime of
the check's budget of (pass, pixel) pairs too: under it, every pass at
fewer pixels, and whole jobs. Cells are cut to a few pixels so the CPU
holds them."""
import importlib

import numpy as np
import pytest
import torch

from harness import check
from rtbench_helpers import SEED, program_window, regimes, run_cell, \
    short_jobs, tiny_cell

CELLS = [("rough_dielectric-beauty", 12), ("bunny-beauty", 8)]
# K > K_MIN pixels; the rough cell's five passes over three jobs of two
# reach every regime, the bunny's three passes of one job all but whole jobs
WIDER = [("rough_dielectric-beauty", 12, 2, 5, ("under", "pixels", "jobs")),
         ("bunny-beauty", 10, 32, 3, ("under", "pixels"))]


@pytest.mark.parametrize("name,width", CELLS)
def test_control_fails_the_check(name, width):
    import control
    cell = tiny_cell(name, width)
    numbers = control.control_numbers(cell, SEED, 2, "cpu")
    failed = [k for k in cell.job.NUMBERS if numbers[k] > cell.limits[k]]
    assert "camera_ray_err" in failed and "radiance_mismatch" in failed


def _render():
    return importlib.import_module("tpu_raytracing_torch.integrator.render")


def _accumulate():
    """The module whose `sample_sum` the timed path calls."""
    return importlib.import_module(
        "tpu_raytracing_torch.integrator.accumulate")


def fault_unchanged(monkeypatch):
    """Each pass leaves the image as it found it: it traces and counts its
    rays but adds no radiance."""
    mod = _accumulate()
    real = mod.sample_sum

    def stale(*args, **kw):
        radiance, rays = real(*args, **kw)
        return torch.zeros_like(radiance), rays
    monkeypatch.setattr(mod, "sample_sum", stale)


def fault_half(monkeypatch):
    """Half of the frame is left out of every pass."""
    mod = _accumulate()
    real = mod.sample_sum

    def half(ds, cfg, st, px, py, first, count, active=None):
        keep = active.clone()
        keep[keep.shape[0] // 2:] = False
        return real(ds, cfg, st, px, py, first, count, keep)
    monkeypatch.setattr(mod, "sample_sum", half)


def fault_altered(monkeypatch):
    """The BSDF's value is off by 1% where it is produced."""
    mod = _render()
    real = mod.bsdf_eval
    monkeypatch.setattr(mod, "bsdf_eval",
                        lambda *a, **kw: real(*a, **kw) * 1.01)


def fault_walk(monkeypatch):
    """Traversal reports a miss on every eighth lane."""
    mod = _render()
    real = mod.intersect_scene

    def blind(*args, **kw):
        t, prim = real(*args, **kw)
        prim = prim.clone()
        prim[::8] = -1
        return torch.where(prim >= 0, t, float("inf")), prim
    monkeypatch.setattr(mod, "intersect_scene", blind)


def fault_counter(monkeypatch):
    """rays_traced counts each ray twice."""
    mod = _accumulate()
    real = mod.sample_sum

    def double(*args, **kw):
        radiance, rays = real(*args, **kw)
        return radiance, rays * 2
    monkeypatch.setattr(mod, "sample_sum", double)


def fault_accumulated(monkeypatch):
    """The accumulated image the render hands back is off by 10%."""
    mod = _accumulate()
    real = mod.render_accumulated

    def off(*args, on_chunk=None, **kw):
        def scaled(image, spp):
            return on_chunk(image * np.float32(0.9), spp)
        return real(*args, on_chunk=on_chunk and scaled, **kw)
    monkeypatch.setattr(mod, "render_accumulated", off)


FAULTS = [fault_unchanged, fault_half, fault_altered, fault_walk,
          fault_counter, fault_accumulated]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name,width", CELLS)
def test_broken_program_is_not_correct(fault, name, width, monkeypatch,
                                       capsys):
    fault(monkeypatch)
    res = run_cell(tiny_cell(name, width), capsys, seconds=0.5)
    assert res["correct"] is False


def _fails_in_every_regime(cell, window, pixels, sc, names) -> None:
    n, K = len(window.passes), pixels.shape[0]
    for regime, budget in regimes(cell, n, K).items():
        if regime not in names:
            continue
        numbers = cell.job.compare(sc, cell.config, window, pixels, budget,
                                   SEED)
        assert not check.verdict(numbers, cell.limits, cell.job.NUMBERS), \
            (regime, numbers)


@pytest.mark.parametrize("name,width,job_spp,n,names", WIDER)
def test_control_fails_in_every_regime(name, width, job_spp, n, names):
    from reference.scene import RefScene
    cell = short_jobs(name, width, job_spp)
    s = cell.config["settings"]
    sc = RefScene(cell.config["scene"], width, width, cell.root, "cpu")
    pixels = check.pick_pixels(SEED, width, width, width * width)
    window = cell.job.control_window(sc, cell.config, cell.traffic, SEED, n,
                                     pixels)
    assert s["width"] == width
    _fails_in_every_regime(cell, window, pixels, sc, names)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name,width,job_spp,n,names", WIDER)
def test_broken_program_fails_in_every_regime(fault, name, width, job_spp,
                                              n, names, monkeypatch):
    fault(monkeypatch)
    cell = short_jobs(name, width, job_spp)
    window, pixels, sc = program_window(cell, n)
    _fails_in_every_regime(cell, window, pixels, sc, names)
