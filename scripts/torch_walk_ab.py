"""Time the port's redesigned BVH4 walk (K4, quad and quadrow) and skip-link
walk (K6) against their versions of commit 6c8ef30 and against the change
with one step of its design undone, and K1/K2 (the bvh8t walk, whose
scheduler moved into the shared header) beside them, on one NVIDIA GPU.

    python3 scripts/torch_walk_ab.py [--parent DIR] [--reps 20] [--rounds 2]

The parent's quad_walk.cu, skip_walk.cu, bvh8t_walk.cu and
traverse_common.cuh are read from DIR, or from `git show 6c8ef30:...` when
no DIR is given (a git checkout). Builds, each with the port's nvcc flags
(native_cuda.NVCC_FLAGS) into a library of its own in a temporary
directory, all nvcc runs started together:

- parent: those four sources;
- change: tpu_raytracing_torch/csrc as it is;
- one build a step of the design, the change with that step undone by a
  text substitution (STEPS below): K6's other kChunk candidate (32
  consecutive rays a warp where the source has 4, and 4 where it has 32),
  K6's loads of both successor candidates before the slab test, the
  select-form NaN min / max in K4's and K6's slab test, and the other
  refill threshold (16 idle lanes of a warp where the source waits for all
  32, and 32 where it takes 16) in K4 and K6.

Each is called through its C entries on chip_smoke.py's path shape: the
camera rays of coated_diffuse_bunny at 500x500 (closest-hit) and their
shadow rays (any-hit). For every comparison and mode, one call of each
build checks that the two agree bit for bit (t, winner and the per-ray
counters); then each round times A B B A, the mean of `reps` calls by CUDA
events each (A = the parent or the step undone, B = the change). Prints
the card's name and power limit, ptxas's report of each build, every time,
and a JSON summary (the mean over rounds and both positions, and B / A) as
the last line. Exits nonzero when two builds disagree.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PARENT = "6c8ef30"
SOURCES = ("quad_walk.cu", "skip_walk.cu", "bvh8t_walk.cu",
           "traverse_common.cuh")
CHUNK = re.compile(r"constexpr int kChunk = (\d+);")
_P, _I = ctypes.c_void_p, ctypes.c_int
_RAYS = [_P] * 8
# the parent's C entries: K4 and K6 took no fetch counter
PARENT_SIGNATURES = {
    "tpu_rt_quad_walk": [_P, _P, *_RAYS, _I, _I, _I, _I, _I, _P],
    "tpu_rt_skip_walk": [_P, _P, *_RAYS, _I, _I, _I, _I, _P],
}
ENTRY = {"bvh8t": "tpu_rt_bvh8t_walk", "quad": "tpu_rt_quad_walk",
         "quadrow": "tpu_rt_quad_walk", "walk": "tpu_rt_skip_walk"}


def parent_sources(directory: Path | None, tmp: Path) -> Path:
    """The directory that holds the parent's sources."""
    if directory is not None:
        return directory
    out = tmp / "parent"
    out.mkdir()
    for name in SOURCES:
        text = subprocess.run(
            ["git", "show", f"{PARENT}:tpu_raytracing_torch/csrc/{name}"],
            cwd=ROOT, capture_output=True, text=True, check=True).stdout
        (out / name).write_text(text)
    return out


# a step of the design undone: name -> (walks it touches, {source:
# [(text, replacement)]}); in the texts, {ours} is the source's kChunk and
# {chunk} the other candidate
STEPS = {
    "kChunk {chunk}": (("walk",), {"skip_walk.cu": [
        ("constexpr int kChunk = {ours};",
         "constexpr int kChunk = {chunk};")]}),
    "both successors loaded first": (("walk",), {"skip_walk.cu": [
        ("""      ++visits;
      const float box[6]""",
         """      const float4 da = __ldg(down_rec), db = __ldg(down_rec + 1);
      const float4 sa = __ldg(skip_rec), sb = __ldg(skip_rec + 1);
      ++visits;
      const float box[6]"""),
        ("""      const float4* next = down ? down_rec : skip_rec;
      na = __ldg(next);
      nb = __ldg(next + 1);""",
         """      na = down ? da : sa;
      nb = down ? db : sb;""")]}),
    "select-form slab min / max": (("quad", "quadrow", "walk"), {
        name: [("tpu_rt::slab_hit<true>(", "tpu_rt::slab_hit<false>(")]
        for name in ("quad_walk.cu", "skip_walk.cu")}),
    "the other refill threshold": (("quad", "quadrow", "walk"), {
        "quad_walk.cu": [("constexpr int kRefill = EARLY_EXIT ? 32 : 16;",
                          "constexpr int kRefill = EARLY_EXIT ? 16 : 32;")],
        "skip_walk.cu": [("constexpr int kRefill = 16;",
                          "constexpr int kRefill = 32;")]}),
}


def undo_step(csrc: Path, tmp: Path, i: int, subs: dict) -> Path:
    """A copy of the change's sources with one step's substitutions; each
    must apply exactly once."""
    text = (csrc / "skip_walk.cu").read_text()
    ours = int(CHUNK.search(text).group(1))
    chunk = 4 if ours == 32 else 32
    out = tmp / f"step{i}"
    out.mkdir()
    for name in SOURCES:
        src = (csrc / name).read_text()
        for old, new in subs.get(name, []):
            old = old.format(ours=ours, chunk=chunk)
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the text to undo is not there "
                                   f"once: {old!r}")
            src = src.replace(old, new.format(ours=ours, chunk=chunk))
        (out / name).write_text(src)
    return out


def chunk_candidate(csrc: Path) -> int:
    """K6's other kChunk candidate."""
    ours = int(CHUNK.search((csrc / "skip_walk.cu").read_text()).group(1))
    return 4 if ours == 32 else 32


def build_all(dirs: dict, tmp: Path) -> dict:
    """tag -> (library, ptxas lines), every nvcc started together."""
    from tpu_raytracing_torch import native_cuda as nc

    jobs = {}
    for i, (tag, d) in enumerate(dirs.items()):
        out = tmp / f"walk_ab_{i}.so"
        srcs = [str(d / n) for n in SOURCES if n.endswith(".cu")]
        jobs[tag] = (out, subprocess.Popen(
            [nc._nvcc(), *nc.NVCC_FLAGS, "-shared", "-I", str(d), "-o",
             str(out), *srcs], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for tag, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {dirs[tag]}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for name, sig in nc.SIGNATURES.items():
            if name not in ENTRY.values():
                continue
            fn = getattr(lib, name)
            fn.restype = _I
            fn.argtypes = (PARENT_SIGNATURES.get(name, sig)
                           if tag == "parent" else sig)
        built[tag] = (lib, [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln
                            or "Compiling" in ln])
    return built


def call(lib, parent: bool, walk: str, ds, rays, counts=None):
    """(t, winner) of one launch of `walk` from `lib` on the ray batch."""
    o, d, t_min, t_max, active, early_exit = rays
    n = o.shape[0]
    dev = o.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    best = torch.empty(n, dtype=torch.int32, device=dev)
    next_ray = torch.empty(1, dtype=torch.int32, device=dev)
    ray_args = [x.data_ptr() for x in (o, d, t_min, t_max, active, t, best)]
    ray_args.append(None if counts is None else counts.data_ptr())
    ctr = [] if parent and walk != "bvh8t" else [next_ray.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    ee = int(early_exit)
    if walk == "bvh8t":
        c = ds.t8_card
        rc = lib.tpu_rt_bvh8t_walk(
            c.nodes.data_ptr(), c.children.data_ptr(), c.tris.data_ptr(),
            *ctr, *ray_args, n, int(ds.meta.t8_width), ee, stream)
    elif walk == "walk":
        rc = lib.tpu_rt_skip_walk(
            ds.bvh_nodes_pk.data_ptr(), ds.tri_pack_pk.data_ptr(), *ctr,
            *ray_args, n, int(ds.meta.n_bvh_nodes), int(ds.meta.n_tris), ee,
            stream)
    else:
        rowrec = walk == "quadrow"
        recs, tris, root = ((ds.bvh4_rows, ds.tri_rows, ds.meta.root_meta4r)
                            if rowrec else (ds.bvh4_recs_pk, ds.tri_pack_pk,
                                            ds.meta.root_meta4))
        rc = lib.tpu_rt_quad_walk(
            recs.data_ptr(), tris.data_ptr(), *ctr, *ray_args, n, int(root),
            int(ds.meta.n_tris), int(rowrec), ee, stream)
    if rc != 0:
        raise RuntimeError(f"{ENTRY[walk]} launch failed: CUDA error {rc}")
    return t, best


def agree(libs: dict, parents: dict, walk: str, ds, rays) -> bool:
    """One call of each build: t bits, winners and counters equal."""
    outs = []
    for tag, lib in libs.items():
        counts = torch.zeros((rays[0].shape[0], 3), dtype=torch.int32,
                             device=rays[0].device)
        t, best = call(lib, parents[tag], walk, ds, rays, counts)
        outs.append((t.view(torch.int32), best, counts))
    torch.cuda.synchronize()
    return all(torch.equal(x, y) for x, y in zip(*outs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_walk_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpu_raytracing_torch import native_cuda as nc
    from tpu_raytracing_torch.device import compile_scene
    from tpu_raytracing_torch.scene.test_scenes import get_test_scene
    from tpu_raytracing_torch.settings import AovFlags, RaytracerSettings

    card_name = cs.card_line()
    print(f"# card: {card_name}", flush=True)
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        dirs = {"parent": parent_sources(args.parent, tmp),
                "change": nc.CSRC}
        pairs = [(w, w, "parent") for w in ("bvh8t", "quad", "quadrow",
                                            "walk")]
        for i, (step, (step_walks, subs)) in enumerate(STEPS.items()):
            label = step.format(chunk=chunk_candidate(nc.CSRC))
            dirs[label] = undo_step(nc.CSRC, tmp, i, subs)
            pairs += [(f"{w} with {label}", w, label) for w in step_walks]
        built = build_all(dirs, tmp)
        for tag, (_, ptxas) in built.items():
            print(f"# {tag} = {dirs[tag]}:", flush=True)
            for ln in ptxas:
                print(f"#   {ln}")
        settings = RaytracerSettings(
            samples_per_pixel=8, light_sample_count=1, max_ray_depth=8,
            outputs=AovFlags.BEAUTY)
        ds = compile_scene(get_test_scene(cs.SCENE).scene_func())
        _, path_shape = cs.path_shapes(ds, settings)
        parents = {tag: tag == "parent" for tag in dirs}
        times = {}
        for (label, walk, a), (mode, shape) in (
                (p, m) for p in pairs for m in path_shape.items()):
            rays = [x.contiguous() for x in shape[:5]] + [shape[5]]
            libs = {a: built[a][0], "change": built["change"][0]}
            same = agree(libs, parents, walk, ds, rays)
            print(f"# {label} {mode}: {rays[0].shape[0]} rays, "
                  f"{int(rays[4].sum())} live; A ({a}) and B (the change) "
                  f"{'agree bit for bit' if same else 'DISAGREE'} (t, "
                  "winner, counters)", flush=True)
            if not same:
                return 1
            for rnd in range(args.rounds):
                for tag, build in (("A", a), ("B", "change"),
                                   ("B", "change"), ("A", a)):
                    ms = cs.time_ms(lambda: call(  # noqa: B023
                        libs[build], parents[build], walk, ds, rays),
                        args.reps)
                    times.setdefault((label, mode, tag), []).append(ms)
                    print(f"# {label} {mode} round {rnd} {tag}: {ms:.4f} ms",
                          flush=True)
    summary = {}
    for (label, mode, tag), v in times.items():
        summary.setdefault(f"{label} {mode}", {})[tag] = sum(v) / len(v)
    for v in summary.values():
        v["B/A"] = v["B"] / v["A"]
    print(card_name)
    print(json.dumps({"card": card_name, "parent": PARENT,
                      "mean_ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
