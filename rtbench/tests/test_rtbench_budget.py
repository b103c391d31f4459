"""The check's budget of (pass, pixel) pairs: the reference follows lanes
of many jobs in one call, each with its job's seed; a window over the
budget makes at most the calls the budget holds; a window under it gives
the numbers the per-job check gave; and what the check has to fail it
fails in each regime of the budget (under it, every pass at fewer
pixels, whole jobs)."""
import json
import math
from typing import Dict, List

import numpy as np
import pytest
import torch

from harness import check
from harness.window import Pass, PassRecord, Window
from reference.render import Lanes, camera_rays, trace
from reference.rng import SamplerConfig
from reference.scene import RefScene
from rtbench_helpers import BENCH, SEED, program_window, regimes, \
    short_jobs, tiny_cell

M32 = 0xFFFFFFFF
CELLS = [("rough_dielectric-beauty", 12), ("bunny-beauty", 10)]


def _scene(config: str, width: int):
    c = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    return RefScene(c["scene"], width, width, BENCH, "cpu")


@pytest.mark.parametrize("config", ["rough_dielectric",
                                    "coated_diffuse_bunny"])
def test_per_lane_seeds_are_each_jobs_scalar_seed(config):
    sc = _scene(config, 16)
    g = torch.Generator().manual_seed(7)
    n = 16
    px, py = (torch.randint(0, 16, (n,), generator=g) for _ in range(2))
    sample = torch.randint(0, 32, (n,), generator=g)
    seeds = [SEED & M32, M32]
    which = torch.arange(n) % 2
    mixed = trace(sc, 0, Lanes(px, py, sample, torch.tensor(seeds)[which]),
                  8, 4)
    m = which == 0
    same = trace(sc, 0, Lanes(px[m], py[m], sample[m],
                              torch.full((int(m.sum()),), seeds[0])), 8, 4)
    for j, seed in enumerate(seeds):
        m = which == j
        alone = trace(sc, seed, Lanes(px[m], py[m], sample[m]), 8, 4)
        assert all(torch.equal(a[m], b) for a, b in zip(mixed, alone))
        if j == 0:  # one seed for every lane: the scalar call, to the bit
            assert all(torch.equal(a, b) for a, b in zip(same, alone))


def _control(cell, n_passes: int, seed: int = SEED):
    """The TF32 control's window of `n_passes` passes, its pixels and
    scene."""
    s = cell.config["settings"]
    sc = RefScene(cell.config["scene"], s["width"], s["height"], cell.root,
                  "cpu")
    pixels = check.pick_pixels(seed, s["width"], s["height"],
                               int(cell.settings["check_pixels"]))
    return cell.job.control_window(sc, cell.config, cell.traffic, seed,
                                   n_passes, pixels), pixels, sc


def _compare(cell, window, pixels, sc, budget, stats=None):
    return cell.job.compare(sc, cell.config, window, pixels, budget, SEED,
                            stats)


def _fake_window(cell, n_passes: int):
    """The control's two captured passes, then passes of zeros up to
    `n_passes`: as many passes and jobs as a fast program's window."""
    window, pixels, sc = _control(cell, 2)
    K = pixels.shape[0]
    job_spp = int(cell.traffic["job_spp"])
    recs = list(window.passes)
    for i in range(2, n_passes):
        job, sample = divmod(i, job_spp)
        recs.append(PassRecord(Pass(i, job, (SEED + job) & M32, sample),
                               float(i), float(i + 1), 0,
                               np.zeros((K, 3), np.float32), None, None))
    acc = {r.p.job: np.zeros((K, 3)) for r in recs}
    return Window(recs, float(n_passes), acc, True), pixels, sc


@pytest.mark.parametrize("budget,regime", [(256_000, "under"),
                                           (200_000, "pixels"),
                                           (20_000, "jobs")])
def test_the_budget_bounds_the_reference_calls(budget, regime, monkeypatch):
    """2,000 passes over 63 jobs: at most ceil(B / LANES_PER_BLOCK)
    calls of the reference, following at most B pairs."""
    cell = tiny_cell("rough_dielectric-beauty", 12, pixels=128)
    window, pixels, sc = _fake_window(cell, 2000)
    job = cell.job
    calls: List[int] = []

    def counting(sc, seed, lanes, *args, **kw):
        calls.append(lanes.px.shape[0])
        n = lanes.px.shape[0]
        return torch.zeros((n, 3)), torch.zeros(n, dtype=torch.int64)
    monkeypatch.setattr(job, "trace", counting)
    stats = {}
    _compare(cell, window, pixels, sc, budget, stats)
    assert len(calls) <= math.ceil(budget / job.LANES_PER_BLOCK)
    assert sum(calls) == stats["pairs"] <= budget
    assert stats["passes"] == 2000 and stats["all_jobs"] == 63
    if regime == "under":
        assert stats["k"] == 128 and stats["jobs"] == 63
        assert sum(calls) == 2000 * 128
    elif regime == "pixels":
        assert job.K_MIN <= stats["k"] < 128 and stats["jobs"] == 63
        assert sum(calls) == 2 * 128 + 1998 * stats["k"]
    else:
        assert stats["k"] == job.K_MIN and 2 <= stats["jobs"] < 63
        pl = job.plan(window, 128, budget, SEED)
        assert {0, 62} <= set(pl.jobs)
        assert pl.passes == [i for i, r in enumerate(window.passes)
                             if r.p.job in pl.jobs]


def test_the_pixels_are_a_seeded_subset_not_a_prefix():
    cell = tiny_cell("rough_dielectric-beauty", 12, pixels=128)
    window, _, _ = _fake_window(cell, 400)
    beauty = cell.job
    one = beauty.plan(window, 128, 20_000, SEED).cols
    assert one.max() >= 64  # not the first rows of the frame
    assert np.array_equal(one, beauty.plan(window, 128, 20_000, SEED).cols)
    assert not np.array_equal(one,
                              beauty.plan(window, 128, 20_000, SEED + 1).cols)


def compare_per_job(sc, config: dict, window: Window, pixels: np.ndarray
                    ) -> Dict[str, float]:
    """The check before the budget, frozen: every pass at every check
    pixel, the reference called job by job."""
    dev = sc.device
    s = config["settings"]
    width, depth, n_l = (s["width"], s["max_ray_depth"],
                         s["light_sample_count"])
    px = torch.as_tensor(pixels % width, device=dev)
    py = torch.as_tensor(pixels // width, device=dev)
    K = pixels.shape[0]
    out = dict(camera_ray_err=0.0, rays_counter_diff=0.0)
    bad = act = 0
    for rec in window.passes:
        if rec.captured is None:
            continue
        out["rays_counter_diff"] = max(
            out["rays_counter_diff"], abs(rec.rays - int(rec.active_total)))
        cam = next(c for c in rec.captured if c["kind"] == "intersect_scene")
        lanes = Lanes(px, py, torch.full_like(px, rec.p.sample))
        o, d, _ = camera_rays(sc, SamplerConfig.independent(rec.p.seed),
                              lanes)
        err = torch.maximum((cam["origin"] - o).abs().amax(),
                            (cam["direction"] - d).abs().amax())
        out["camera_ray_err"] = max(out["camera_ray_err"], float(err))
        for c in rec.captured:
            b, a = check.traversal_mismatch(sc, c)
            bad, act = bad + b, act + a
    out["traversal_mismatch"] = bad / max(act, 1)
    ref = np.zeros((len(window.passes), K, 3), np.float32)
    ref_rays = np.zeros((len(window.passes), K), np.int64)
    by_job: Dict[int, List[int]] = {}
    for i, rec in enumerate(window.passes):
        by_job.setdefault(rec.p.job, []).append(i)
    for job, idx in by_job.items():
        seed = window.passes[idx[0]].p.seed
        samples = torch.as_tensor([window.passes[i].p.sample for i in idx],
                                  device=dev)
        r, n = trace(sc, seed, Lanes(px.repeat(len(idx)), py.repeat(len(idx)),
                                     samples.repeat_interleave(K)), depth, n_l)
        ref[idx] = r.cpu().numpy().reshape(len(idx), K, 3)
        ref_rays[idx] = n.cpu().numpy().reshape(len(idx), K)
    prog = np.stack([r.values for r in window.passes])
    ok = np.abs(prog - ref) <= 1e-3 * np.abs(ref) + 1e-6
    out["radiance_mismatch"] = float((~ok.all(axis=-1)).mean())
    ref_sum = float(ref.astype(np.float64).sum())
    out["radiance_mean_gap"] = abs(
        float(prog.astype(np.float64).sum()) - ref_sum) / max(ref_sum, 1e-30)
    gaps = []
    for job, idx in by_job.items():
        want = float(ref[idx].astype(np.float64).sum())
        got = float(np.asarray(window.accumulated[job], np.float64).sum())
        gaps.append(abs(got - want) / max(want, 1e-30))
    out["accum_gap"] = max(gaps)
    lanes = [(sum(c["active"].to(torch.int64) for c in rec.captured)
              .cpu().numpy(), ref_rays[i])
             for i, rec in enumerate(window.passes) if rec.captured]
    out["rays_lane_mismatch"] = float(np.mean(
        [got != want for got, want in lanes])) if lanes else 0.0
    if not window.all_finite:
        out["radiance_mismatch"] = float("inf")
    return out


def test_under_the_budget_the_controls_numbers_are_the_per_job_checks():
    """The control's five passes over three jobs: the same numbers, to the
    bit, as the check gave job by job."""
    cell = short_jobs("rough_dielectric-beauty", 12)
    window, pixels, sc = _control(cell, 5)
    want = compare_per_job(sc, cell.config, window, pixels)
    assert _compare(cell, window, pixels, sc, 5 * 144) == want
    assert want["camera_ray_err"] > 0 and want["radiance_mismatch"] > 0


@pytest.mark.parametrize("name,width", CELLS)
def test_sound_program_under_and_over_the_budget(name, width):
    """The program's five passes over three jobs: under the budget the
    numbers of the check job by job, to the bit; correct in each regime,
    and each regime follows other pairs."""
    cell = short_jobs(name, width)
    window, pixels, sc = program_window(cell, 5)
    want = compare_per_job(sc, cell.config, window, pixels)
    seen = set()
    for regime, budget in regimes(cell, 5, pixels.shape[0]).items():
        stats = {}
        numbers = _compare(cell, window, pixels, sc, budget, stats)
        if regime == "under":
            assert numbers == want
        seen.add((stats["k"], stats["jobs"]))
        assert stats["pairs"] <= budget
        assert check.verdict(numbers, cell.limits, cell.job.NUMBERS), \
            (regime, numbers)
    assert len(seen) == 3


def _one_job_off(window: Window, job: int) -> Window:
    """The window with one job's radiance and image 1% too bright."""
    recs = [r._replace(values=r.values * np.float32(1.01))
            if r.p.job == job else r for r in window.passes]
    acc = dict(window.accumulated)
    acc[job] = acc[job] * 1.01
    return window._replace(passes=recs, accumulated=acc)


@pytest.fixture(scope="module")
def ten_jobs():
    cell = short_jobs("rough_dielectric-beauty", 12)
    return (cell, *program_window(cell, 20))


@pytest.mark.parametrize("regime,job", [("under", 4), ("pixels", 4),
                                        ("jobs", 9)])
def test_a_fault_in_one_job_of_ten_fails(ten_jobs, regime, job):
    """Ten jobs of two passes, one of them 1% too bright: the check fails
    it whether every pass is followed at every pixel or at K_MIN, and with
    whole jobs where the job is the last, which is always compared."""
    cell, window, pixels, sc = ten_jobs
    budget = regimes(cell, 20, pixels.shape[0])[regime]
    good = _compare(cell, window, pixels, sc, budget)
    assert check.verdict(good, cell.limits, cell.job.NUMBERS), good
    numbers = _compare(cell, _one_job_off(window, job), pixels, sc, budget)
    assert not check.verdict(numbers, cell.limits, cell.job.NUMBERS), \
        numbers
