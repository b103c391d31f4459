"""Time the port's redesigned child-pair walk (K5) against its version of
commit 5695c8b and against the change with one step of its design undone,
and the other persistent walks (K1/K2 bvh8t, K4 quad and quadrow, K6
skip-link) against the same commit beside it, on one NVIDIA GPU.

    python3 scripts/torch_walk_ab.py [--parent DIR] [--reps 20] [--rounds 2]

The parent's walk sources (SOURCES) are read from DIR, or from `git show
5695c8b:...` when no DIR is given (a git checkout). Builds, each with the
port's nvcc flags (native_cuda.NVCC_FLAGS) into a library of its own in a
temporary directory, all nvcc runs started together:

- parent: those sources;
- change: tpu_raytracing_torch/csrc as it is;
- one build a step of the design, the change with that step undone by a
  text substitution (STEPS below), of the sources of the walks it touches;
  or with a step it left out put in. K5: four 16-byte row loads in place
  of its 15 4-byte ones, the next row's loads at the top of the visit in
  place of before the leaf test, and both of these; the select-form
  NaN min / max in place of the PTX one in the slab test, no cross-lane
  leaf test of sparse warps, the other refill threshold (also K4 and K6),
  and kChunk 1 or 32 in place of 4. K6: kChunk 32 in place of 4, and both
  successor candidates loaded in place of the chosen one.

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
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PARENT = "5695c8b"
SOURCES = ("pair_walk.cu", "quad_walk.cu", "skip_walk.cu", "bvh8t_walk.cu",
           "traverse_common.cuh")
SOURCE_OF = {"bvh8t": "bvh8t_walk.cu", "quad": "quad_walk.cu",
             "quadrow": "quad_walk.cu", "pair": "pair_walk.cu",
             "walk": "skip_walk.cu"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_RAYS = [_P] * 8
# the parent's C entries: K5 took no fetch counter
PARENT_SIGNATURES = {
    "tpu_rt_pair_walk": [_P, _P, *_RAYS, _I, _I, _I, _I, _P],
}
ENTRY = {"bvh8t": "tpu_rt_bvh8t_walk", "quad": "tpu_rt_quad_walk",
         "quadrow": "tpu_rt_quad_walk", "pair": "tpu_rt_pair_walk",
         "walk": "tpu_rt_skip_walk"}


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


# K5's row loads as the source has them (15 4-byte loads), and as four
# 16-byte loads
_SCALAR_ROW = """  const float* f = rows + static_cast<size_t>(m) * 16;
  return Row{make_float4(f[0], f[1], f[2], f[3]),
             make_float4(f[4], f[5], f[6], f[7]),
             make_float4(f[8], f[9], f[10], f[11]),
             make_float4(f[12], f[13], f[14], 0.f)};"""
_VECTOR_ROW = """  const float4* p =
      reinterpret_cast<const float4*>(rows + static_cast<size_t>(m) * 16);
  return Row{__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};"""
# K5's next row loaded at the top of the next visit, in place of as soon
# as the visit has chosen it
_LATE_ROW = [
    ("  Row row{};\n", ""),
    ("          if ((cur & 7) == 0) row = load_row(rows, cur >> 3);\n", ""),
    ("""      // the next row goes out now, before the leaf test
      if (cur != kDone) row = load_row(rows, cur >> 3);
""", ""),
    ("""      ++visits;
      const float box_l[6]""", """      const Row row = load_row(rows, cur >> 3);
      ++visits;
      const float box_l[6]""")]
# a step of the design undone, or one it left out put in: name -> (walks
# it touches, {source: [(text, replacement)]}); every text must be in its
# source
STEPS = {
    "16-byte row loads": (("pair",), {"pair_walk.cu": [
        (_SCALAR_ROW, _VECTOR_ROW)]}),
    "next row loaded at the top of the visit": (("pair",), {
        "pair_walk.cu": _LATE_ROW}),
    "16-byte rows loaded at the top of the visit": (("pair",), {
        "pair_walk.cu": [(_SCALAR_ROW, _VECTOR_ROW), *_LATE_ROW]}),
    "select-form slab min / max": (("quad", "quadrow", "pair", "walk"), {
        name: [("tpu_rt::slab_hit<true>(", "tpu_rt::slab_hit<false>(")]
        for name in ("quad_walk.cu", "pair_walk.cu", "skip_walk.cu")}),
    "no cross-lane leaves": (("pair",), {"traverse_common.cuh": [
        ("  if (__popc(leafy) <= kCoop) {", "  if (false) {")]}),
    "the other refill threshold": (("quad", "quadrow", "pair", "walk"), {
        "quad_walk.cu": [("constexpr int kRefill = EARLY_EXIT ? 32 : 16;",
                          "constexpr int kRefill = EARLY_EXIT ? 16 : 32;")],
        **{name: [("constexpr int kRefill = 16;",
                   "constexpr int kRefill = 32;")]
           for name in ("pair_walk.cu", "skip_walk.cu")}}),
    "kChunk 1": (("pair",), {"pair_walk.cu": [
        ("constexpr int kChunk = 4;", "constexpr int kChunk = 1;")]}),
    "kChunk 32": (("pair", "walk"), {
        name: [("constexpr int kChunk = 4;", "constexpr int kChunk = 32;")]
        for name in ("pair_walk.cu", "skip_walk.cu")}),
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
}


def undo_step(csrc: Path, tmp: Path, i: int, subs: dict) -> Path:
    """A copy of the change's sources with one step's substitutions, each of
    whose texts must be in its source."""
    out = tmp / f"step{i}"
    out.mkdir()
    for name in SOURCES:
        src = (csrc / name).read_text()
        for old, new in subs.get(name, []):
            if old not in src:
                raise RuntimeError(f"{name}: the text to undo is not there: "
                                   f"{old!r}")
            src = src.replace(old, new)
        (out / name).write_text(src)
    return out


def build_all(dirs: dict, tmp: Path) -> dict:
    """tag -> (library, ptxas lines), every nvcc started together; dirs:
    tag -> (source directory, the walks whose sources it builds)."""
    from tpu_raytracing_torch import native_cuda as nc

    jobs = {}
    for i, (tag, (d, walks)) in enumerate(dirs.items()):
        out = tmp / f"walk_ab_{i}.so"
        srcs = [str(d / n) for n in sorted({SOURCE_OF[w] for w in walks})]
        jobs[tag] = (out, subprocess.Popen(
            [nc._nvcc(), *nc.NVCC_FLAGS, "-shared", "-I", str(d), "-o",
             str(out), *srcs], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for tag, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {dirs[tag][0]}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for name, sig in nc.SIGNATURES.items():
            if name not in {ENTRY[w] for w in dirs[tag][1]}:
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
    ctr = [] if parent and walk == "pair" else [next_ray.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    ee = int(early_exit)
    if walk == "bvh8t":
        c = ds.t8_card
        rc = lib.tpu_rt_bvh8t_walk(
            c.nodes.data_ptr(), c.children.data_ptr(), c.tris.data_ptr(),
            *ctr, *ray_args, n, int(ds.meta.t8_width), ee, stream)
    elif walk == "pair":
        rc = lib.tpu_rt_pair_walk(
            ds.bvh2_rows_pk.data_ptr(), ds.tri_pack_pk.data_ptr(), *ctr,
            *ray_args, n, int(ds.meta.root_meta), int(ds.meta.n_tris), ee,
            stream)
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
        dirs = {"parent": (parent_sources(args.parent, tmp), tuple(ENTRY)),
                "change": (nc.CSRC, tuple(ENTRY))}
        pairs = [(w, w, "parent") for w in ENTRY]
        for i, (step, (step_walks, subs)) in enumerate(STEPS.items()):
            dirs[step] = (undo_step(nc.CSRC, tmp, i, subs), step_walks)
            pairs += [(f"{w} with {step}", w, step) for w in step_walks]
        built = build_all(dirs, tmp)
        for tag, (_, ptxas) in built.items():
            print(f"# {tag} = {dirs[tag][0]}:", flush=True)
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
