"""The `beauty` traffic kind: one user's progressive render, a closed
loop of 1-spp passes of the whole frame's radiance, as the port's viewer
and the CLI's accumulate path run it.

A traffic file of this kind holds `spp_per_pass` (1) and `job_spp`, the
samples of one render: the program's `render_accumulated(spp_chunk=1)`
renders the job, whose settings.seed is the run's seed plus the job's
index, and the next job starts when it ends. A pass ends when its image
is on the host (`on_chunk`), and the next starts then. At the window's
close the pass in flight completes and counts, and the job is cut there.

The comparison (`compare`): what the window's passes produced, against
the plain reference (reference/), at the check's pixels of every pass
and on the traversal calls of the captured passes. The reference follows
at most the cell's `check_pairs` (pass, pixel) pairs a run (`plan`), in
calls of LANES_PER_BLOCK lanes across jobs: all of them while the window
is short enough, else every pass at fewer pixels, and past K_MIN pixels
a pass whole jobs; the captured passes always at every check pixel.
Numbers compared, each against its limit in the cell's file:

- camera_ray_err: the largest gap, over origin and direction components,
  between the camera rays the timed path handed its first closest-hit
  call and the reference's rays of the same pixels and sample;
- traversal_mismatch: the share of active lanes of the captured traversal
  calls whose answer differs from the reference's brute force on the same
  rays (harness/check.py);
- radiance_mismatch: the share of compared (pass, pixel) whose radiance, as
  `sample_sum` returned it, differs from the reference's by more than
  L_RTOL of it plus L_ATOL;
- radiance_mean_gap: the gap between the sums of all compared radiance,
  over the reference's;
- accum_gap: the largest gap, over the compared jobs, between the image
  `render_accumulated` accumulated (its last mean times its samples) and
  the sum of the reference's passes at the pixels an uncaptured pass is
  compared at, over the latter;
- rays_counter_diff: the largest gap, over the captured passes, between
  `rays_traced` and the active lanes the pass handed traversal (exact);
- rays_lane_mismatch: the share of the captured passes' compared pixels
  whose rays (the calls that had the lane active) differ from the
  reference's count for that lane.

A non-finite pixel in a job's accumulated image fails the run.
"""
from __future__ import annotations

import itertools
import math
import time
from typing import Dict, Iterator, List, NamedTuple

import numpy as np
import torch

from harness.check import traversal_mismatch
from harness.window import Pass, PassRecord, Window
from reference.lowp import tf32
from reference.render import Lanes, camera_rays, trace
from reference.rng import SamplerConfig

M32 = 0xFFFFFFFF
L_RTOL = 1e-3
L_ATOL = 1e-6
LANES_PER_BLOCK = 1 << 16
K_MIN = 64  # the fewest check pixels an uncaptured pass is followed at
NUMBERS = ("camera_ray_err", "traversal_mismatch", "radiance_mismatch",
           "radiance_mean_gap", "accum_gap", "rays_counter_diff",
           "rays_lane_mismatch")


def validate(traffic: dict) -> dict:
    if traffic.get("spp_per_pass") != 1:
        raise ValueError("the beauty traffic renders 1-spp passes")
    if int(traffic["job_spp"]) < 1:
        raise ValueError("job_spp >= 1")
    return traffic


def passes(traffic: dict, seed: int) -> Iterator[Pass]:
    """The run's passes in order."""
    job_spp = int(traffic["job_spp"])
    for i in itertools.count():
        job, sample = divmod(i, job_spp)
        yield Pass(i, job, (seed + job) & M32, sample)


def warm_up(prog, traffic: dict, seed: int, n: int) -> None:
    """`n` 1-spp renders on seeds no job of the run takes."""
    for w in range(n):
        prog.accumulate((seed - 1 - w) & M32, 1)


class _Closed(Exception):
    """The window closes at the end of the pass just done."""


def drive(prog, traffic: dict, seed: int, taps, pixels: np.ndarray,
          seconds: float = math.inf, capture=(0, 1),
          after_pass=None) -> Window:
    """Render jobs until `seconds` have passed, or `after_pass(i)`, called
    at the end of each pass, returns true. Passes whose place is in
    `capture` run with the taps' capture on."""
    job_spp = int(traffic["job_spp"])
    records: List[PassRecord] = []
    last = {}
    t0 = time.perf_counter()
    mark = [t0]
    taps.capture = 0 in capture
    for job in itertools.count():
        job_seed = (seed + job) & M32

        def on_chunk(image, spp_done, job=job, job_seed=job_seed):
            now = time.perf_counter()
            i = len(records)
            rays, values, captured, total = taps.end_pass()
            records.append(PassRecord(
                Pass(i, job, job_seed, spp_done - 1), mark[0] - t0, now - t0,
                rays, values, captured, total))
            mark[0] = now
            last[job] = (image, spp_done)
            taps.capture = (i + 1) in capture
            done = now - t0 >= seconds
            if after_pass is not None:
                done = after_pass(i) or done
            if done:
                raise _Closed

        try:
            prog.accumulate(job_seed, job_spp, on_chunk)
        except _Closed:
            break
    # the window has closed: read what it kept
    if bool((taps.rows < 0).any()):
        raise ValueError("a check pixel is in no lane of the pass's chunk")
    out = [r._replace(rays=int(r.rays), values=r.values.cpu().numpy())
           for r in records]
    accumulated = {job: image.reshape(-1, 3)[pixels].astype(np.float64)
                   * spp for job, (image, spp) in last.items()}
    finite = all(bool(np.isfinite(image).all()) for image, _ in last.values())
    return Window(out, out[-1].end_s, accumulated, finite)


class Plan(NamedTuple):
    """The (pass, pixel) pairs the reference follows."""

    passes: List[int]  # the compared passes, in order
    cols: np.ndarray   # the check pixels (columns) of an uncaptured pass
    jobs: List[int]    # the compared jobs, each with all of its passes
    pairs: int


def plan(window: Window, K: int, budget: int, seed: int) -> Plan:
    """Every pass at all K check pixels where the budget holds them; else
    every pass at k = (budget less the captured passes) / (the others)
    pixels of a seeded subset, the captured passes at all K; below K_MIN
    pixels a pass, all passes of a seeded choice of whole jobs at K_MIN,
    job 0, the last job and the captured passes' jobs always among them."""
    recs = window.passes
    n = len(recs)
    every = list(range(n))
    jobs = sorted({r.p.job for r in recs})
    if n * K <= budget:
        return Plan(every, np.arange(K), jobs, n * K)
    cap = [r.captured is not None for r in recs]
    c = sum(cap)
    rng = np.random.default_rng([seed & M32, seed >> 32, 0xB0D6E7])
    k = (budget - c * K) // max(n - c, 1)
    if k >= K_MIN:
        cols = np.sort(rng.choice(K, size=k, replace=False))
        return Plan(every, cols, jobs, c * K + (n - c) * k)
    k = min(K_MIN, K)
    cols = np.sort(rng.choice(K, size=k, replace=False))
    cost = dict.fromkeys(jobs, 0)
    for r, on in zip(recs, cap):
        cost[r.p.job] += K if on else k
    chosen = {jobs[0], jobs[-1]} | {r.p.job for r, on in zip(recs, cap)
                                    if on}
    pairs = sum(cost[j] for j in chosen)
    if pairs > budget:
        raise ValueError(f"check_pairs {budget} holds not even the {pairs} "
                         "pairs of the first, the last and captured jobs")
    for j in rng.permutation([j for j in jobs if j not in chosen]):
        if pairs + cost[j] <= budget:
            chosen.add(int(j))
            pairs += cost[j]
    return Plan([i for i in every if recs[i].p.job in chosen], cols,
                sorted(chosen), pairs)


def compare(sc, config: dict, window: Window, pixels: np.ndarray,
            budget: int, seed: int, stats: dict | None = None
            ) -> Dict[str, float]:
    """The numbers compared (NUMBERS), for the window's passes, at most
    `budget` (pass, pixel) pairs of them (`plan`, drawn from the run's
    `seed`). `stats`, where given, gets what was followed and how long
    the reference's calls took."""
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
            b, a = traversal_mismatch(sc, c)
            bad, act = bad + b, act + a
    out["traversal_mismatch"] = bad / max(act, 1)

    # the compared (pass, pixel) pairs, pass by pass, as one list of lanes
    # whatever their jobs: each lane carries its job's seed
    pl = plan(window, K, budget, seed)
    every = np.arange(K)
    cols = [every if window.passes[i].captured is not None else pl.cols
            for i in pl.passes]
    ps = [window.passes[i].p for i in pl.passes]
    width_of = [len(c) for c in cols]
    lane_pass = np.repeat(pl.passes, width_of)
    lane_job = np.repeat([p.job for p in ps], width_of)
    lane_col = np.concatenate(cols)
    col = torch.as_tensor(lane_col, device=dev)
    lanes = Lanes(px[col], py[col], *(
        torch.as_tensor(np.repeat(v, width_of), device=dev)
        for v in ([p.sample for p in ps], [p.seed for p in ps])))
    rad, rays = [], []
    t0 = time.perf_counter()
    for a in range(0, lane_col.shape[0], LANES_PER_BLOCK):
        block = Lanes(*(x[a:a + LANES_PER_BLOCK] for x in lanes))
        r, n = trace(sc, 0, block, depth, n_l)
        rad.append(r)
        rays.append(n)
    ref = torch.cat(rad).cpu().numpy()
    ref_rays = torch.cat(rays).cpu().numpy()
    if stats is not None:
        stats.update(pairs=pl.pairs, passes=len(window.passes),
                     k=len(pl.cols), jobs=len(pl.jobs),
                     all_jobs=len({r.p.job for r in window.passes}),
                     calls=len(rad), call_s=time.perf_counter() - t0)

    prog = np.concatenate([window.passes[i].values[c]
                           for i, c in zip(pl.passes, cols)])
    ok = np.abs(prog - ref) <= L_RTOL * np.abs(ref) + L_ATOL
    out["radiance_mismatch"] = float((~ok.all(axis=-1)).mean())
    ref_sum = float(ref.astype(np.float64).sum())
    out["radiance_mean_gap"] = abs(
        float(prog.astype(np.float64).sum()) - ref_sum) / max(ref_sum, 1e-30)
    # a job's accumulated image against its passes at the subset's pixels
    in_cols = np.isin(lane_col, pl.cols)
    gaps = []
    for job in pl.jobs:
        want = float(ref[(lane_job == job) & in_cols]
                     .astype(np.float64).sum())
        got = float(np.asarray(window.accumulated[job], np.float64)[pl.cols]
                    .sum())
        gaps.append(abs(got - want) / max(want, 1e-30))
    out["accum_gap"] = max(gaps)
    lanes = [(sum(c["active"].to(torch.int64) for c in rec.captured)
              .cpu().numpy(), ref_rays[lane_pass == i])
             for i, rec in enumerate(window.passes) if rec.captured]
    out["rays_lane_mismatch"] = float(np.mean(
        [got != want for got, want in lanes])) if lanes else 0.0
    if not window.all_finite:
        out["radiance_mismatch"] = float("inf")
    return out


def control_window(sc, config: dict, traffic: dict, seed: int,
                   n_passes: int, pixels: np.ndarray,
                   captured_passes=(0, 1)) -> Window:
    """The check's control: the reference put in the program's place and
    computed in TF32 (reference/lowp.py), over the check's pixels of
    `n_passes` passes, with the traversal queries of the captured passes
    kept as the program's taps keep them."""
    dev = sc.device
    s = config["settings"]
    width, depth, n_l = (s["width"], s["max_ray_depth"],
                         s["light_sample_count"])
    px = torch.as_tensor(pixels % width, device=dev)
    py = torch.as_tensor(pixels // width, device=dev)
    K = pixels.shape[0]
    plan = list(itertools.islice(passes(traffic, seed), n_passes))
    by_job: Dict[int, List[int]] = {}
    for i, p in enumerate(plan):
        by_job.setdefault(p.job, []).append(i)
    values = np.zeros((n_passes, K, 3), np.float32)
    rays = np.zeros(n_passes, np.int64)
    with tf32():
        for idx in by_job.values():
            lanes = Lanes(px.repeat(len(idx)), py.repeat(len(idx)),
                          torch.as_tensor([plan[i].sample for i in idx],
                                          device=dev).repeat_interleave(K))
            r, n = trace(sc, plan[idx[0]].seed, lanes, depth, n_l)
            values[idx] = r.cpu().numpy().reshape(len(idx), K, 3)
            rays[idx] = n.reshape(len(idx), K).sum(dim=1).cpu().numpy()
        captured = {}
        for i in captured_passes[:n_passes]:
            recs = []

            def keep(closest, o, d, lo, hi, act, ans, recs=recs):
                rec = dict(kind="intersect_scene" if closest else "occluded",
                           origin=o.clone(), direction=d.clone(),
                           t_min=lo.clone(), t_max=hi.clone(),
                           active=act.clone())
                if closest:
                    rec["t"], rec["prim"] = ans[0].clone(), ans[1].clone()
                else:
                    rec["occluded"] = ans.clone()
                recs.append(rec)

            trace(sc, plan[i].seed,
                  Lanes(px, py, torch.full_like(px, plan[i].sample)), depth,
                  n_l, on_query=keep)
            captured[i] = recs
    records, accumulated = [], {}
    for i, p in enumerate(plan):
        recs = captured.get(i)
        total = (sum(int(r["active"].sum()) for r in recs)
                 if recs is not None else None)
        records.append(PassRecord(p, float(i), float(i + 1), int(rays[i]),
                                  values[i], recs, total))
        accumulated[p.job] = accumulated.get(p.job, 0.0) + values[i]
    return Window(records, float(n_passes), accumulated,
                  bool(np.isfinite(values).all()))
