"""The system under test: the PyTorch and CUDA port, driven through its
public render entries.

`build_scene` turns a configuration's scene description into the port's
`Scene` with its own `SceneBuilder`, each camera, material, shape and
light through the `port` side of its kind file (reference/kinds.py).
`Program` compiles it with `compile_scene` and renders a job with
`integrator.accumulate.render_accumulated(spp_chunk=1)`, as the port's
viewer and the CLI's accumulate path do: one 1-spp pass of the whole
frame at a time, its image on the host before the callback.

`Taps` wraps the calls the timed path makes (module attributes looked up
at call time): `sample_sum` as `render_accumulated` calls it, for each
pass's ray count and its radiance at the check's pixels; the
integrator's calls into traversal and shading, for the check's copy of
what traversal was handed and answered, and for host spans. A wrapper
passes its call through untouched.
"""
from __future__ import annotations

import importlib
import time
from pathlib import Path

import torch

from reference.kinds import load_kind

RENDER_MODULE = "tpu_raytracing_torch.integrator.render"
ACCUMULATE_MODULE = "tpu_raytracing_torch.integrator.accumulate"


def build_scene(desc: dict, width: int, height: int, root: Path):
    """The port's Scene for a description (see reference/scene.py)."""
    from tpu_raytracing_torch.geometry import v3, v4
    from tpu_raytracing_torch.scene.scene import SceneBuilder

    sb = SceneBuilder()

    def tex(*vals):
        vals = list(vals) + [0.0] * (4 - len(vals))
        return sb.add_constant_texture(v4(*vals))

    mat_ids = [sb.add_material(load_kind(root, "material", m["kind"])
                               .port(m, tex)) for m in desc["materials"]]
    for s in desc["shapes"]:
        shape = load_kind(root, "shape", s["kind"]).port(s, root)
        sb.add_shape_at_position(shape, mat_ids[s["material"]],
                                 v3(*s["position"]))
    for li in desc["lights"]:
        load_kind(root, "light", li["kind"]).port(sb, li)
    cam = desc["camera"]
    load_kind(root, "camera", cam["kind"]).port(sb, cam, width, height)
    return sb.build()


class Program:
    """The compiled scene and the configuration's render settings."""

    def __init__(self, config: dict, root: Path, device):
        from tpu_raytracing_torch.device.scene_buffers import compile_scene

        self.s = config["settings"]
        self.width, self.height = self.s["width"], self.s["height"]
        self.device = torch.device(device)
        scene = build_scene(config["scene"], self.width, self.height, root)
        self.ds = compile_scene(scene, self.device)

    def settings(self, seed: int, spp: int):
        from tpu_raytracing_torch.settings import AovFlags, RaytracerSettings
        s = self.s
        return RaytracerSettings(
            max_ray_depth=s["max_ray_depth"],
            accumulate_bounces=s["accumulate_bounces"],
            light_sample_count=s["light_sample_count"],
            samples_per_pixel=spp, seed=seed,
            antialias_primary_rays=s["antialias_primary_rays"],
            outputs=AovFlags.BEAUTY)

    def accumulate(self, seed: int, spp: int, on_chunk=None):
        """A render of `spp` 1-spp passes whose settings.seed is `seed`;
        `on_chunk(image (H, W, 3) mean so far, spp done)` after each."""
        accumulate = importlib.import_module(ACCUMULATE_MODULE)
        return accumulate.render_accumulated(
            self.ds, self.settings(seed, spp), spp_chunk=1,
            on_chunk=on_chunk, device=self.device)

    def close(self) -> None:
        """Drop the compiled scene, and the allocator's cache with it."""
        self.ds = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


class Taps:
    """Wrappers around the timed path's calls.

    `sample_sum` (always): each call keeps its rays traced and its
    radiance at the check's pixels (`pixels`, raster indices on the
    device, placed in the chunk by the px, py it was handed) for
    `end_pass`. While `capture` is on, each traversal call keeps its
    inputs and answers at those places and adds the lanes it was handed
    active to `active_total`. Each call named in `span_names` records its
    host interval and keeps its `active` argument in `spans`."""

    TRAVERSAL = ("intersect_scene", "occluded")
    PASS = "sample_sum"

    def __init__(self, pixels: torch.Tensor, width: int, height: int):
        self.render = importlib.import_module(RENDER_MODULE)
        self.accumulate = importlib.import_module(ACCUMULATE_MODULE)
        self.pixels, self.width, self.height = pixels, width, height
        self.rows = None          # the check's places in the chunk
        self.originals = {}
        self.capture = False
        self.capture_lanes = None
        self.captured = []        # per traversal call: dict of tensors
        self.active_total = None
        self.calls = []           # sample_sum calls of the pass in flight
        self.span_names = set()
        self.spans = []           # (name, start_ns, end_ns, active or None)
        self._hook(self.accumulate, self.PASS, self._pass_call)

    def _hook(self, mod, name, make) -> None:
        if (mod, name) not in self.originals:
            fn = getattr(mod, name)
            self.originals[(mod, name)] = fn
            setattr(mod, name, make(name, fn))

    def install(self, names) -> None:
        for name in names:
            self._hook(self.render, name, self._wrap)

    def uninstall(self, names=None) -> None:
        for (mod, name), fn in list(self.originals.items()):
            if names is None or (mod is self.render and name in names):
                setattr(mod, name, fn)
                del self.originals[(mod, name)]

    def _pass_call(self, name, fn):
        def wrapped(ds, cfg, st, px, py, *args, **kwargs):
            if self.rows is None:
                self.rows = self._place(px, py, *args, **kwargs)
            self.capture_lanes = self.rows if self.capture else None
            radiance, rays = fn(ds, cfg, st, px, py, *args, **kwargs)
            self.capture_lanes = None
            self.calls.append((rays, radiance[self.rows]))
            return radiance, rays
        return wrapped

    def _place(self, px, py, first, count, active=None):
        """Each check pixel's place among the chunk's active lanes, -1
        where it has none (read after the window)."""
        lanes = (torch.arange(px.shape[0], device=px.device)
                 if active is None else torch.nonzero(active)[:, 0])
        where = torch.full((self.width * self.height,), -1,
                           dtype=torch.int64, device=px.device)
        where[(py * self.width + px)[lanes]] = lanes
        return where[self.pixels]

    def end_pass(self):
        """(rays, radiance at the check's pixels, captured calls or None,
        active lanes handed traversal or None) of the pass just ended."""
        calls, self.calls = self.calls, []
        if len(calls) != 1:
            raise ValueError("the check reads one pixel chunk a pass; "
                             f"this pass made {len(calls)}")
        kept = ((self.captured, self.active_total) if self.capture
                else (None, None))
        self.captured, self.active_total = [], None
        return (*calls[0], *kept)

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            spanned = name in self.span_names
            t0 = time.perf_counter_ns() if spanned else 0
            out = fn(*args, **kwargs)
            if spanned:
                self.spans.append((name, t0, time.perf_counter_ns(),
                                   kwargs.get("active")))
            if self.capture_lanes is not None and name in self.TRAVERSAL:
                self._keep(name, args, kwargs, out)
            return out
        return wrapped

    def _keep(self, name, args, kwargs, out) -> None:
        _, origin, direction, t_min, t_max = args[:5]
        active = kwargs["active"]
        idx = self.capture_lanes
        rec = dict(kind=name, origin=origin[idx], direction=direction[idx],
                   t_min=t_min.expand(origin.shape[0])[idx],
                   t_max=t_max.expand(origin.shape[0])[idx],
                   active=active[idx])
        if name == "occluded":
            rec["occluded"] = out[idx]
        else:
            rec["t"], rec["prim"] = out[0][idx], out[1][idx]
        self.captured.append(rec)
        n = active.sum()
        self.active_total = n if self.active_total is None \
            else self.active_total + n
