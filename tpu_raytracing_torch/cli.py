"""Command-line frontend of the port, mirroring tpu_raytracing/cli.py.

The same flags, subcommands and outputs as the JAX package's CLI, which the
rttest harness drives: `--scene-path` (glTF/GLB or PBRT) or `--scene-name`
(a builtin scene), `-o`, `--output-format png|exr`, `-d`, `-s`, `-l`,
`--sampler`, `--chunk-pixels`, `--checkpoint` with `--spp-chunk`,
`--profile`; subcommands `full {--aov n,a,u,m --no-beauty}`, `pixel x y
[count] [offset]` and `list-scenes`. Settings are the builtin scene's,
overridden by the flags. EXR channel names are R/G/B, Normal.X/Y/Z,
Albedo.X/Y/Z, U/V and "Mip Level"; PNG outputs get one file per AOV and
the beauty exposure 1000. Outputs are written under ``scenes/output/``.

`--backend cuda` (the default) renders on the card and raises without
one; `--backend cpu` runs the plain versions on the host. `--profile DIR`
writes a `torch.profiler` Chrome trace of the render to DIR/trace.json.
`-i` opens the settings form (tui.py) first. `-t` is accepted for the
harness's sake and has no effect.

`--multichip` renders the beauty over a (tiles, `--spp-shards`) mesh of
ranks (parallel/mesh.py; with `--checkpoint`, accumulated in chunks),
and the AOVs on rank 0's device alone. Under torchrun (RANK and WORLD_SIZE
set) the ranks are torchrun's; started alone, one rank a visible card
(spawned, on a file store in a temp dir), or one gloo rank with `--backend
cpu`. Rank 0 writes the outputs.

    python -m tpu_raytracing_torch.cli --scene-name sphere -s 2 full
    torchrun --nproc-per-node 4 -m tpu_raytracing_torch.cli \
        --scene-name checkered_plane --backend cpu --multichip full
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import logging
import math
import os
import sys
import tempfile
from pathlib import Path

log = logging.getLogger("tpu_raytracing_torch")


def _add_common(p: argparse.ArgumentParser, suppress: bool) -> None:
    """Global options, on the main parser and on every subparser so that
    they may come before or after the subcommand. The subparsers' copies
    default to SUPPRESS, so they override only when given."""

    def d(value):
        return argparse.SUPPRESS if suppress else value

    p.add_argument(
        "-i", "--interactive", action="store_true", default=d(False),
        help="Interactive TUI",
    )
    g = p.add_mutually_exclusive_group()
    g.add_argument(
        "--scene-path", type=Path, default=d(None),
        help="Load a scene from disk (GLTF or PBRT)",
    )
    g.add_argument(
        "--scene-name", default=d(None), help="Load a builtin test scene by name"
    )
    p.add_argument(
        "-o", "--output", type=Path, default=d(None),
        help="Output filename (written under scenes/output/)",
    )
    p.add_argument(
        "--output-format", choices=["png", "exr"], default=d(None),
        help="Force output format (otherwise inferred from extension)",
    )
    p.add_argument(
        "--backend", choices=["cuda", "cpu"], default=d("cuda"),
        help="cuda (the default; raises without a card) or cpu",
    )
    p.add_argument(
        "-t", "--num-threads", type=int, default=d(None),
        help="Host worker threads (accepted for compatibility; no effect)",
    )
    p.add_argument(
        "-d", "--ray-depth", type=int, default=d(None),
        help="Maximum ray depth (bounces)",
    )
    p.add_argument("-s", "--spp", type=int, default=d(None), help="Samples per pixel")
    p.add_argument(
        "-l", "--light-samples", type=int, default=d(None), help="Light sample count"
    )
    p.add_argument(
        "--sampler", choices=["independent", "stratified"], default=d(None),
        help="Sampler type",
    )
    p.add_argument(
        "--chunk-pixels", type=int, default=d(None),
        help="Pixels per device dispatch",
    )
    p.add_argument(
        "--profile", type=Path, default=d(None), metavar="DIR",
        help="Write a torch.profiler Chrome trace of the render to DIR",
    )
    p.add_argument(
        "--checkpoint", type=Path, default=d(None), metavar="FILE",
        help="Accumulate spp in chunks, checkpointing to FILE (resumable)",
    )
    p.add_argument(
        "--multichip", action="store_true", default=d(False),
        help="Shard the beauty over a mesh of ranks (one a card)",
    )
    p.add_argument(
        "--spp-shards", type=int, default=d(1),
        help="spp axis of the device mesh (with --multichip)",
    )
    p.add_argument(
        "--spp-chunk", type=int, default=d(32),
        help="Samples per accumulation chunk when --checkpoint is used",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-raytracing-torch",
        description="The path tracer's PyTorch + CUDA port "
                    "(reference-compatible CLI)",
    )
    _add_common(p, suppress=False)

    sub = p.add_subparsers(dest="command")
    full = sub.add_parser("full", help="Full frame render with AOV control")
    _add_common(full, suppress=True)
    full.add_argument(
        "--aov", action="append", default=None,
        help="Comma-separated AOV list (e.g. normal,uv or n,u)",
    )
    full.add_argument(
        "--no-beauty", action="store_true",
        help="Disable beauty output (useful when only AOVs are desired)",
    )
    pixel = sub.add_parser("pixel", help="Render a single pixel and print diagnostics")
    _add_common(pixel, suppress=True)
    pixel.add_argument("x", type=int, help="Pixel x coordinate")
    pixel.add_argument("y", type=int, help="Pixel y coordinate")
    pixel.add_argument("sample_count", type=int, nargs="?", default=1)
    pixel.add_argument("sample_offset", type=int, nargs="?", default=0)
    ls = sub.add_parser("list-scenes", help="List all builtin test scenes as JSON")
    _add_common(ls, suppress=True)
    return p


def _load_scene(args):
    """(builtin settings or None, scene)."""
    from .scene import loaders, test_scenes

    if args.scene_path is not None:
        path = args.scene_path
        ext = path.suffix.lower()
        if ext == ".pbrt":
            return None, loaders.scene_from_pbrt_file(path)
        if ext not in (".gltf", ".glb"):
            log.warning("unrecognized file extension %r, trying to import as gltf", ext)
        return None, loaders.scene_from_gltf_file(path)
    ts = test_scenes.get_test_scene(args.scene_name)
    return ts.settings_func(), ts.scene_func()


def _merge_settings(builtin, args):
    from .sampling import Independent, Stratified
    from .settings import RaytracerSettings

    settings = builtin if builtin is not None else RaytracerSettings()
    if args.ray_depth is not None:
        settings.max_ray_depth = args.ray_depth
    if args.light_samples is not None:
        settings.light_sample_count = args.light_samples
    if args.spp is not None:
        settings.samples_per_pixel = args.spp
    settings.accumulate_bounces = True
    if args.sampler == "independent":
        settings.sampler = Independent()
    elif args.sampler == "stratified":
        strata = int(math.ceil(math.sqrt(settings.samples_per_pixel)))
        settings.sampler = Stratified(jitter=True, x_strata=strata, y_strata=strata)
    return settings


def _apply_aov_flags(settings, args):
    from .settings import AovFlags

    flags = settings.outputs
    for group in args.aov or []:
        for aov in group.split(","):
            aov = aov.strip()
            if aov in ("n", "normal"):
                flags |= AovFlags.NORMALS
            elif aov in ("a", "albedo"):
                flags |= AovFlags.ALBEDO
            elif aov in ("u", "uv"):
                flags |= AovFlags.UV_COORDS
            elif aov in ("m", "mip"):
                flags |= AovFlags.MIP_LEVEL
            elif aov in ("b", "beauty"):
                log.warning("beauty is implicit")
            elif aov:
                log.warning("unknown AOV specified: %s", aov)
    if args.no_beauty:
        flags &= ~AovFlags.BEAUTY
    settings.outputs = flags
    return settings


def _add_suffix(path: Path, suffix: str) -> Path:
    return path.parent / f"{path.stem}_{suffix}.png"


def save_render_output(out, flags, output_format, output_path: Path) -> None:
    if output_format is None:
        ext = output_path.suffix.lower().lstrip(".")
        if ext in ("png", "exr"):
            output_format = ext
        else:
            log.warning("extension not recognized, defaulting to exr")
            output_format = "exr"
    output_path.parent.mkdir(parents=True, exist_ok=True)
    if output_format == "png":
        _save_to_png(out, flags, output_path)
    else:
        _save_to_exr(out, flags, output_path)


def _save_to_png(out, flags, output_path: Path) -> None:
    from .settings import AovFlags
    from .utils.png import normals_to_rgb, save_png, uvs_to_rgb

    if flags & AovFlags.BEAUTY and out.beauty is not None:
        save_png(output_path, out.beauty, exposure=1000.0)
    if flags & AovFlags.NORMALS and out.normals is not None:
        save_png(_add_suffix(output_path, "NORMALS"), normals_to_rgb(out.normals))
    if flags & AovFlags.ALBEDO and out.albedo is not None:
        save_png(_add_suffix(output_path, "ALBEDO"), out.albedo)
    if flags & AovFlags.UV_COORDS and out.uv is not None:
        save_png(_add_suffix(output_path, "UV_COORDS"), uvs_to_rgb(out.uv))
    if flags & AovFlags.MIP_LEVEL:
        log.warning("MIP_LEVEL png output not supported (yet)")


def _save_to_exr(out, flags, output_path: Path) -> None:
    from .settings import AovFlags
    from .utils.exr import write_exr

    channels = {}
    if flags & AovFlags.BEAUTY and out.beauty is not None:
        for k, c in enumerate("RGB"):
            channels[c] = out.beauty[..., k]
    if flags & AovFlags.NORMALS and out.normals is not None:
        for k, c in enumerate("XYZ"):
            channels[f"Normal.{c}"] = out.normals[..., k]
    if flags & AovFlags.ALBEDO and out.albedo is not None:
        for k, c in enumerate("XYZ"):
            channels[f"Albedo.{c}"] = out.albedo[..., k]
    if flags & AovFlags.UV_COORDS and out.uv is not None:
        channels["U"] = out.uv[..., 0]
        channels["V"] = out.uv[..., 1]
    if flags & AovFlags.MIP_LEVEL and out.mip_level is not None:
        channels["Mip Level"] = out.mip_level
    write_exr(output_path, channels)


@contextlib.contextmanager
def _process_group(backend: str):
    """The ranks' process group: the caller's where one is running (a
    spawned rank's, or a program's own), torchrun's where RANK and
    WORLD_SIZE are set, else a world of one rank on a file store. A group
    started here is destroyed on the way out."""
    import torch.distributed as dist

    from .parallel import init_render_group

    if dist.is_initialized():
        yield
        return
    with tempfile.TemporaryDirectory(prefix="tpu_rt_group_") as tmp:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            init_render_group(backend)
        else:
            init_render_group(backend, f"file://{tmp}/store", 0, 1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _rank_main(rank: int, args, init_method: str, world: int) -> None:
    """One spawned rank: join the group, run the parsed command line,
    leave."""
    import torch.distributed as dist

    from .parallel import init_render_group

    init_render_group("cuda", init_method, rank, world)
    try:
        code = _run(args)[0]
    finally:
        dist.destroy_process_group()
    if code:
        raise SystemExit(code)


def _spawn_ranks(args, world: int) -> None:
    """Started alone with several cards: one rank a card, each running the
    command line; a rank that fails stops the others and raises here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="tpu_rt_group_") as tmp:
        mp.spawn(_rank_main, args=(args, f"file://{tmp}/store", world),
                 nprocs=world, join=True)


def _render_distributed(scene, settings, args):
    """The beauty over every rank (--multichip): the whole frame on rank 0,
    None on the others."""
    import torch.distributed as dist

    from .parallel import render_accumulated_distributed, render_distributed

    with _process_group(args.backend):
        if args.checkpoint is None:
            out = render_distributed(
                scene, settings, n_spp_shards=args.spp_shards,
                chunk_pixels=args.chunk_pixels)
        else:
            out = render_accumulated_distributed(
                scene, settings, n_spp_shards=args.spp_shards,
                spp_chunk=args.spp_chunk, checkpoint_path=args.checkpoint,
                chunk_pixels=args.chunk_pixels)
        return out if dist.get_rank() == 0 else None


def _render(scene, settings, args, device):
    """The frame, or None on a rank other than 0."""
    from .integrator.render import render
    from .settings import AovFlags

    if args.multichip:
        out = _render_distributed(scene, settings, args)
        if out is None:
            return None
    elif args.checkpoint is None:
        return render(scene, settings, device, chunk_pixels=args.chunk_pixels)
    else:
        from .integrator.accumulate import render_accumulated

        out = render_accumulated(
            scene, settings, spp_chunk=args.spp_chunk,
            checkpoint_path=args.checkpoint, chunk_pixels=args.chunk_pixels,
            device=device)
    if settings.outputs & ~AovFlags.BEAUTY:
        aovs = copy.copy(settings)
        aovs.outputs = settings.outputs & ~AovFlags.BEAUTY
        aov_only = render(scene, aovs, device, chunk_pixels=args.chunk_pixels)
        for f in ("normals", "albedo", "uv", "mip_level"):
            setattr(out, f, getattr(aov_only, f))
    return out


def run(argv=None):
    """Run the CLI: (exit code, the RenderOutput it wrote or None)."""
    logging.basicConfig(
        level=logging.INFO, format="%(levelname)s %(name)s: %(message)s",
        stream=sys.stderr,
    )
    args = build_parser().parse_args(argv)

    if args.command == "list-scenes":
        from .scene import test_scenes

        print(json.dumps([s.name for s in test_scenes.all_test_scenes()]))
        return 0, None
    if args.interactive:
        from . import tui

        new_args = tui.run(args)
        if new_args is None:
            print("Render cancelled.")
            return 0, None
        args = new_args
    return _run(args)


def _run(args):
    """run() after parsing: (exit code, the RenderOutput it wrote or
    None)."""
    if args.scene_path is None and args.scene_name is None:
        print("error: either --scene-path or --scene-name is required",
              file=sys.stderr)
        return 1, None
    if (args.multichip and args.command != "pixel" and args.backend == "cuda"
            and "RANK" not in os.environ):
        import torch
        import torch.distributed as dist

        if not dist.is_initialized() and torch.cuda.device_count() > 1:
            _spawn_ranks(args, torch.cuda.device_count())
            return 0, None

    from .settings import AovFlags

    builtin_settings, scene = _load_scene(args)
    settings = _merge_settings(builtin_settings, args)
    device = args.backend

    if args.command == "pixel":
        from .integrator.render import render_single_pixel

        outputs = render_single_pixel(
            scene, settings, args.x, args.y, args.sample_count,
            args.sample_offset, device=device)
        for o in outputs:
            print(f"sample {o.sample_index}")
            print(f"hit: {o.hit}")
            print(f"uv: ({o.uv[0]}, {o.uv[1]})")
            print(f"normal: ({o.normal[0]}, {o.normal[1]}, {o.normal[2]})")
            print(f"radiance: ({o.radiance[0]}, {o.radiance[1]}, {o.radiance[2]})")
        return 0, None

    if args.command == "full":
        settings = _apply_aov_flags(settings, args)
    if settings.outputs == AovFlags.NONE:
        log.warning("no outputs specified (--no-beauty, and no AOVs), quitting...")
        return 0, None

    if args.profile is not None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            out = _render(scene, settings, args, device)
        args.profile.mkdir(parents=True, exist_ok=True)
        trace = args.profile / "trace.json"
        prof.export_chrome_trace(str(trace))
        log.info("profiler trace written to %s", trace)
    else:
        out = _render(scene, settings, args, device)
    if out is None:  # a rank other than 0
        return 0, None

    output_file = Path("scenes/output") / (args.output or Path("output.exr"))
    save_render_output(out, settings.outputs, args.output_format, output_file)
    log.info("wrote %s", output_file)
    return 0, out


def main(argv=None) -> int:
    """The command line's entry point: the exit code of `run`."""
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
