"""The `aov` traffic kind: one user's feature-buffer export, a closed loop
of AOV-only frames (first-hit normals and albedo, no beauty), each the
port's `integrator.render.render` of the whole frame, as `cli.py full
--aov n,a --no-beauty` calls it.

The configuration's settings name the buffers (`outputs`, normals and
albedo) and `no_beauty`. A frame ends when its buffers are on the host
(`render` returns), and the next starts then; a frame's rays are the
program's `RenderOutput.aov_rays_traced`. At the window's close the frame
in flight completes and counts.

The first-hit buffers draw nothing from the seed, so every frame is the
same image. The timed loop keeps frame 0's buffers at the check's pixels
and holds every later frame to them bit for bit there (a gather and a
compare of K pixels, well under 1% of a frame); the reference follows
frame 0 at those pixels after the window. Numbers compared, each against
its limit in the cell's file:

- camera_ray_err: the largest gap, over origin and direction components,
  between the camera rays the captured frame handed its closest-hit call
  and the reference's pixel-centre rays;
- traversal_mismatch: the share of active lanes of the captured frame's
  traversal calls whose answer differs from the reference's brute force
  on the same rays (harness/check.py);
- hit_mismatch: the share of check pixels hit (a normal not zero) in
  frame 0 and missed by the reference, or the other way round; infinite
  where frame 0 holds a non-finite value anywhere;
- normal_mismatch: the share of check pixels hit by both whose normal
  differs from the reference's by more than N_ATOL in a component;
- albedo_mismatch: the share of check pixels whose albedo is not the
  reference's, bit for bit;
- frame_drift: the share of frames after frame 0 that differ from it at
  any check pixel, bit for bit (exact);
- rays_counter_diff: the largest gap between a captured frame's
  `aov_rays_traced` and the active lanes it handed traversal, and
  between any frame's and frame 0's (exact).

A traced run (run.py's `Slice` as `after_pass`) profiles its slice of
frames with the port's tracing off, since the profiler would record each
span a second time on the card's timeline, where the harness reads every
event as a kernel. As many frames again follow the slice with the
port's tracing on and no session open; its counters over them (the
`rt.aov*` spans' host nanoseconds among them) and their host wall ride
on the window (`program_trace`) for the `aov.*` readers.
"""
from __future__ import annotations

import contextlib
import importlib
import itertools
import math
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from harness.check import traversal_mismatch
from harness.trace import Slice
from harness.window import Pass, PassRecord
from reference.aov import first_hit
from reference.lowp import tf32

RENDER_MODULE = "tpu_raytracing_torch.integrator.render"
M32 = 0xFFFFFFFF
# a unit normal's components: float32 rounding over the shading chain is
# ~1e-6, and a tie at an edge of the bunny's mesh resolved to the
# neighbouring triangle interpolates the same vertex normals there;
# TF32's 10 mantissa bits put the bunny's normals ~5e-4 off
N_ATOL = 1e-5
OUTPUTS = ("normals", "albedo")
NUMBERS = ("camera_ray_err", "traversal_mismatch", "hit_mismatch",
           "normal_mismatch", "albedo_mismatch", "frame_drift",
           "rays_counter_diff")


class AovWindow(NamedTuple):
    passes: List[PassRecord]  # a frame each; values (K, 6) on frame 0
    seconds: float            # window start to the end of its last frame
    drifted: int              # frames after 0 that differ from it
    all_finite: bool          # frame 0's buffers, whole
    program_trace: Optional[dict]  # traced: {"counts", "wall_ns"}


def validate(traffic: dict) -> dict:
    if traffic.get("kind") != "aov":
        raise ValueError("not an aov traffic file")
    return traffic


def _settings(prog, seed: int):
    from tpu_raytracing_torch.settings import AovFlags, RaytracerSettings
    s = prog.s
    if tuple(s["outputs"]) != OUTPUTS or not s["no_beauty"]:
        raise ValueError(f"the aov traffic renders {OUTPUTS} with no "
                         "beauty")
    return RaytracerSettings(samples_per_pixel=s["samples_per_pixel"],
                             seed=seed & M32,
                             outputs=AovFlags.NORMALS | AovFlags.ALBEDO)


def _frame(prog, settings):
    """One AOV-only render: (normals, albedo) (H*W, 3) each, rays."""
    render = importlib.import_module(RENDER_MODULE).render
    out = render(prog.ds, settings, prog.device)
    return (out.normals.reshape(-1, 3), out.albedo.reshape(-1, 3),
            int(out.aov_rays_traced))


def warm_up(prog, traffic: dict, seed: int, n: int) -> None:
    """`n` frames, every shape the window uses."""
    settings = _settings(prog, seed)
    for _ in range(n):
        _frame(prog, settings)


@contextlib.contextmanager
def _capturing(taps):
    """Within: the frame's traversal calls are kept at the check's pixels
    (the taps' capture), placed by the px, py its one chunk was handed."""
    mod = importlib.import_module(RENDER_MODULE)
    real = mod.render_aov_chunk
    chunks = []

    def placed(ds, cfg, st, px, py, *args, active, **kw):
        chunks.append(px.shape[0])
        if len(chunks) > 1:
            raise ValueError("the check reads one pixel chunk a frame")
        rows = taps._place(px, py, 0, 1, active)
        if bool((rows < 0).any()):
            raise ValueError("a check pixel is in no lane of the chunk")
        taps.capture_lanes = rows
        return real(ds, cfg, st, px, py, *args, active=active, **kw)

    taps.captured, taps.active_total = [], None
    mod.render_aov_chunk = placed
    try:
        yield
    finally:
        mod.render_aov_chunk = real
        taps.capture_lanes = None


class _Frames:
    """The window's frames as they end: a record each, frame 0's buffers
    at the check's pixels (as bits), and how many later frames differ
    from them."""

    def __init__(self, prog, seed: int, taps, pixels, capture):
        self.prog, self.seed, self.taps = prog, seed, taps
        self.capture = capture
        # the check pixels' components in a flat (H*W*3) buffer: a 1-D take
        # is the cheapest gather the loop can make
        self.flat = (pixels[:, None] * 3 + np.arange(3)).ravel()
        self.settings = _settings(prog, seed)
        self.records: List[PassRecord] = []
        self.first = None
        self.finite = True
        self.drifted = 0
        self.t0 = self.mark = time.perf_counter()

    def run(self) -> float:
        """One frame; the seconds from the window's start to its end."""
        i = len(self.records)
        on = i in self.capture
        with _capturing(self.taps) if on else contextlib.nullcontext():
            normals, albedo, rays = _frame(self.prog, self.settings)
        now = time.perf_counter()
        bits = [b.reshape(-1).view(np.uint32).take(self.flat)
                for b in (normals, albedo)]
        values = None
        if self.first is None:
            self.first = bits
            values = np.concatenate(
                [b.view(np.float32).reshape(-1, 3) for b in bits], 1)
            self.finite = bool(np.isfinite(normals).all()
                               and np.isfinite(albedo).all())
        else:
            self.drifted += not all(map(np.array_equal, bits, self.first))
        total = self.taps.active_total
        self.records.append(PassRecord(
            Pass(i, i, self.seed & M32, 0), self.mark - self.t0,
            now - self.t0, rays, values,
            self.taps.captured if on else None,
            int(total) if on and total is not None else None))
        self.mark = now
        return now - self.t0

    def window(self, program_trace=None) -> AovWindow:
        return AovWindow(self.records, self.records[-1].end_s, self.drifted,
                         self.finite, program_trace)


def drive(prog, traffic: dict, seed: int, taps, pixels: np.ndarray,
          seconds: float = math.inf, capture=(0,),
          after_pass=None) -> AovWindow:
    """Render frames until `seconds` have passed, or `after_pass(i)`,
    called at the end of each frame, returns true. Frames whose place is
    in `capture` run with the taps' capture on. After a traced run's
    profiled slice, `_spanned` frames."""
    frames = _Frames(prog, seed, taps, pixels, capture)
    for i in itertools.count():
        done = frames.run() >= seconds
        if after_pass is not None:
            done = after_pass(i) or done
        if done:
            break
    sliced = getattr(after_pass, "__self__", None)
    if isinstance(sliced, Slice):
        return frames.window(_spanned(frames, sliced.passes))
    return frames.window()


def _spanned(frames: _Frames, n: int) -> dict:
    """`n` more frames with the port's tracing on and no profiler session
    open: its counters over them and their host wall in ns."""
    from tpu_raytracing_torch import tracing
    tracing.reset()
    tracing.enable()
    try:
        began = time.perf_counter_ns()
        for _ in range(n):
            frames.run()
        wall_ns = time.perf_counter_ns() - began
        return {"counts": tracing.snapshot(), "wall_ns": wall_ns}
    finally:
        tracing.disable()
        tracing.reset()


def compare(sc, config: dict, window: AovWindow, pixels: np.ndarray,
            budget: int, seed: int, stats: dict | None = None) -> dict:
    """The numbers compared (NUMBERS). The reference follows frame 0 at
    the K check pixels in one call (K <= `budget`); every later frame was
    held to frame 0 there in the loop."""
    dev = sc.device
    width = config["settings"]["width"]
    K = pixels.shape[0]
    if K > budget:
        raise ValueError(f"check_pairs {budget} holds not the {K} pixels "
                         "of frame 0")
    px = torch.as_tensor(pixels % width, device=dev)
    py = torch.as_tensor(pixels // width, device=dev)
    t0 = time.perf_counter()
    ref = first_hit(sc, px, py)
    call_s = time.perf_counter() - t0
    out = dict(camera_ray_err=0.0, rays_counter_diff=0.0)

    bad = act = 0
    rays0 = window.passes[0].rays
    for rec in window.passes:
        out["rays_counter_diff"] = max(out["rays_counter_diff"],
                                       abs(rec.rays - rays0))
        if rec.captured is None:
            continue
        out["rays_counter_diff"] = max(out["rays_counter_diff"],
                                       abs(rec.rays - rec.active_total))
        cam = next(c for c in rec.captured if c["kind"] == "intersect_scene")
        err = torch.maximum((cam["origin"] - ref.origin).abs().amax(),
                            (cam["direction"] - ref.direction).abs().amax())
        out["camera_ray_err"] = max(out["camera_ray_err"], float(err))
        for c in rec.captured:
            b, a = traversal_mismatch(sc, c)
            bad, act = bad + b, act + a
    out["traversal_mismatch"] = bad / max(act, 1)

    values = window.passes[0].values
    normals, albedo = values[:, :3], values[:, 3:]
    ref_normals = ref.normal.cpu().numpy()
    hit = np.any(normals != 0, axis=-1)
    ref_hit = (ref.prim >= 0).cpu().numpy()
    out["hit_mismatch"] = (float(np.mean(hit != ref_hit))
                           if window.all_finite else math.inf)
    both = hit & ref_hit
    close = np.all(np.abs(normals - ref_normals) <= N_ATOL, axis=-1)
    out["normal_mismatch"] = float(np.mean(~close[both])) if both.any() \
        else 0.0
    same = np.all(albedo.view(np.uint32)
                  == ref.albedo.cpu().numpy().view(np.uint32), axis=-1)
    out["albedo_mismatch"] = float(np.mean(~same))
    out["frame_drift"] = window.drifted / max(len(window.passes) - 1, 1)
    if stats is not None:
        n = len(window.passes)
        stats.update(pairs=K, passes=n, k=K, jobs=n, all_jobs=n, calls=1,
                     call_s=call_s)
    return out


def control_window(sc, config: dict, traffic: dict, seed: int,
                   n_passes: int, pixels: np.ndarray,
                   captured_passes=(0,)) -> AovWindow:
    """The check's control: the reference put in the program's place and
    computed in TF32 (reference/lowp.py), at the check's pixels of
    `n_passes` frames, with the traversal query of the captured frames
    kept as the program's taps keep it."""
    dev = sc.device
    width = config["settings"]["width"]
    px = torch.as_tensor(pixels % width, device=dev)
    py = torch.as_tensor(pixels // width, device=dev)
    recs = []

    def keep(o, d, lo, hi, act, ans):
        recs.append(dict(kind="intersect_scene", origin=o.clone(),
                         direction=d.clone(), t_min=lo.clone(),
                         t_max=hi.clone(), active=act.clone(),
                         t=ans[0].clone(), prim=ans[1].clone()))

    with tf32():
        fh = first_hit(sc, px, py, on_query=keep)
    values = np.concatenate([fh.normal.cpu().numpy(),
                             fh.albedo.cpu().numpy()], 1)
    K = pixels.shape[0]
    records = []
    for i in range(n_passes):
        on = i in captured_passes
        records.append(PassRecord(
            Pass(i, i, seed & M32, 0), float(i), float(i + 1), K,
            values if i == 0 else None, recs if on else None,
            K if on else None))
    return AovWindow(records, float(n_passes), 0,
                     bool(np.isfinite(values).all()), None)
