"""Time the port's redesigned probes against their parents' versions and
against the change with one step of its design undone, on one NVIDIA GPU:
P1 (walk-visit ablation) and P4 (bf16 slab) against commit 4da0630, P2
(slab cost) and P3 (iteration cost) against commit 5f953d9.

    python3 scripts/torch_probe_ab.py [--parent COMMIT=DIR ...]
        [--probes P1,P2,P3,P4] [--reps 5] [--rounds 2]

Each parent's probe sources (SOURCES) are read from the DIR given for its
commit, or from `git show COMMIT:...` when none is given (a git
checkout). Builds, each of the probe sources it needs (BUILT) with the
port's nvcc flags (native_cuda.NVCC_FLAGS) into a library of its own in a
temporary directory, all nvcc runs started together:

- a parent: its commit's sources of the probes that have it as parent
  (PARENT_OF);
- change: tpu_raytracing_torch/csrc as it is;
- one build a step of the design, the change with that step undone, by
  a text substitution (STEPS below). P1: the thread-0 handoff of the visit's state behind a second
  barrier, in place of every warp forming it; all 16 slots tested, in
  place of those below ni; one slot a trip of the slot loop in place of
  four; the full-block leaf trip (every thread runs probe::group, the gate
  applied at the end), in place of the gated rays across their warps'
  lanes; the triangles read through L1 and L2 and the node table staged
  whole, in place of the boxes and the triangle groups staged. P4: one
  iteration a loop trip (U = 1) in place of 8; float32 at one chain a
  thread (1,024 threads) in place of two; bf16 at two chains a thread (512
  threads) in place of one. P2: without its ring of node blocks in
  shared memory (each visit reads its boxes from device memory through
  L1, as the parent did); two ring stages in place of three; mxu at one
  or four columns a thread in place of two; cur at one or four rays a
  thread in place of two (floor's block follows cur's); floor's compares
  in all its threads in place of 128; the parent's drain (one word that
  every warp atomicOr's, in place of a slot a warp; P1 shares the
  drain). P3: without K3's prefilter (every (row, ray) takes the full
  test); two or four rays a thread in place of one.

Every probe runs on the scripts' inputs at 4,096 visits or iterations
(P4 at its script's 20,000): P1's seven levels, P2's four kernels (hoist
runs cur's), P3's five configurations, P4's two types. For each
comparison one call of each build checks that the two agree bit for bit
(P1 and P2: output, stats and every visit's drained mask, P1 also on its
second input set; P3: output and iterations run; P4: output); then each
round times A B B A, the mean of `reps` calls by CUDA events each (A = the
parent, the step undone or the option; B = the change). Prints the card's
name and power limit, ptxas's report of each build, each P1 and P4
build's loop in SASS by opcode (cuobjdump), every time, and a JSON summary
(the mean over rounds and both positions, B / A, and ns a visit or
iteration run) as the last line. Exits nonzero when two builds disagree.
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

# each probe's parent commit, the sources of each probe, and the sources
# the builds read (includes included)
PARENT_OF = {"P1": "4da0630", "P2": "5f953d9", "P3": "5f953d9",
             "P4": "4da0630"}
BUILT = {"P1": "probe_walk_cost.cu", "P2": "probe_slab_cost.cu",
         "P3": "probe_iter_cost.cu", "P4": "probe_bf16_vpu.cu"}
SOURCES = (*BUILT.values(), "probe_common.cuh", "traverse_common.cuh")
ENTRY = {"P1": "tpu_rt_probe_walk_cost", "P2": "tpu_rt_probe_slab_cost",
         "P3": "tpu_rt_probe_iter_cost", "P4": "tpu_rt_probe_bf16_vpu"}
ITERS = 4096
P4_ITERS = 20000
# P2's kernels (hoist runs cur's) by their C entry's variant number
P2_KERNELS = {"floor": 0, "cur": 1, "row0": 2, "mxu": 3}
# the drain's block-wide OR as the change has it (a slot a warp, then every
# thread ORs the slots) and as the parent had it (every warp's lane 0
# atomicOr's one word, which thread 0 zeroes two visits ahead)
_SLOT_DRAIN = """  unsigned* set = words + (v & 1) * 32;
  if ((threadIdx.x & 31) == 0) set[threadIdx.x >> 5] = w;
  __syncthreads();
  unsigned all = 0u;
#pragma unroll
  for (int i = 0; i < kWarps; i += 4) {  // slots past kWarps hold zeros
    const uint4 x = *reinterpret_cast<const uint4*>(set + i);
    all |= x.x | x.y | x.z | x.w;
  }
  return all;"""
_ATOMIC_DRAIN = """  unsigned* word = words + v % 3;
  if ((threadIdx.x & 31) == 0) atomicOr(word, w);
  __syncthreads();
  const unsigned all = *word;
  if (threadIdx.x == 0) words[(v + 2) % 3] = 0u;
  return all;"""
# a step of the design undone: name -> (probe, the cases it touches or None
# for all, {source: [(text, replacement)]}); every text must be in its
# source
STEPS = {
    "the thread-0 handoff": ("P1", ("smem", "when", "inner0", "inner50",
                                    "cond", "cond50"), {
        "probe_walk_cost.cu": [("constexpr bool kWarpState = true;",
                                "constexpr bool kWarpState = false;")]}),
    "all 16 slots": ("P1", None, {"probe_walk_cost.cu": [
        ("constexpr bool kNeededSlots = true;",
         "constexpr bool kNeededSlots = false;")]}),
    "one slot a loop trip": ("P1", ("smem", "when", "inner0", "inner50",
                                    "cond", "cond50"), {
        "probe_walk_cost.cu": [("constexpr int kSlotUnroll = 4;",
                                "constexpr int kSlotUnroll = 1;")]}),
    "the full-block leaf trip": ("P1", ("inner50", "cond50"), {
        "probe_walk_cost.cu": [("constexpr bool kWarpLeaf = true;",
                                "constexpr bool kWarpLeaf = false;")]}),
    "triangles through L1 and L2": ("P1", None, {"probe_walk_cost.cu": [
        ("constexpr bool kStageTris = true;",
         "constexpr bool kStageTris = false;")]}),
    "U = 1": ("P4", None, {"probe_bf16_vpu.cu": [
        ("constexpr int kUnroll = 8;", "constexpr int kUnroll = 1;")]}),
    "float32 at one chain a thread": ("P4", ("float32",), {
        "probe_bf16_vpu.cu": [
            ("template <> constexpr int kChains<float2> = 2;",
             "template <> constexpr int kChains<float2> = 1;")]}),
    "bf16 at two chains a thread": ("P4", ("bfloat16",), {
        "probe_bf16_vpu.cu": [
            ("template <typename V> constexpr int kChains = 1;",
             "template <typename V> constexpr int kChains = 2;")]}),
    "no ring of node blocks": ("P2", None, {"probe_slab_cost.cu": [
        ("constexpr bool kStaged = true;",
         "constexpr bool kStaged = false;")]}),
    "two ring stages": ("P2", None, {"probe_slab_cost.cu": [
        ("constexpr int kStages = 3;", "constexpr int kStages = 2;")]}),
    "mxu at one column a thread": ("P2", ("mxu",), {"probe_slab_cost.cu": [
        ("constexpr int kCols = 2;", "constexpr int kCols = 1;")]}),
    "mxu at four columns a thread": ("P2", ("mxu",), {"probe_slab_cost.cu": [
        ("constexpr int kCols = 2;", "constexpr int kCols = 4;")]}),
    "cur at one ray a thread": ("P2", ("floor", "cur"), {
        "probe_slab_cost.cu": [
            ("constexpr int kCurRays = 2;", "constexpr int kCurRays = 1;")]}),
    "cur at four rays a thread": ("P2", ("floor", "cur"), {
        "probe_slab_cost.cu": [
            ("constexpr int kCurRays = 2;", "constexpr int kCurRays = 4;")]}),
    "floor's compares in every thread": ("P2", ("floor",), {
        "probe_slab_cost.cu": [("      if (tid < kLane) {",
                                "      if (true) {")]}),
    "the atomic drain": ("P2", None, {"probe_common.cuh": [
        (_SLOT_DRAIN, _ATOMIC_DRAIN)]}),
    "no prefilter": ("P3", None, {"probe_common.cuh": [
        ("constexpr bool kPrefilter = true;",
         "constexpr bool kPrefilter = false;")]}),
    "P3 at two rays a thread": ("P3", None, {"probe_iter_cost.cu": [
        ("constexpr int kRaysPerThread = 1;",
         "constexpr int kRaysPerThread = 2;")]}),
    "P3 at four rays a thread": ("P3", None, {"probe_iter_cost.cu": [
        ("constexpr int kRaysPerThread = 1;",
         "constexpr int kRaysPerThread = 4;")]}),
}
_P, _I = ctypes.c_void_p, ctypes.c_int


def parent_sources(commit: str, directory: Path | None, tmp: Path) -> Path:
    """The directory that holds a parent commit's sources (a source its
    probes do not include may be missing)."""
    if directory is not None:
        return directory
    out = tmp / f"parent_{commit}"
    out.mkdir()
    for name in SOURCES:
        res = subprocess.run(
            ["git", "show", f"{commit}:tpu_raytracing_torch/csrc/{name}"],
            cwd=ROOT, capture_output=True, text=True)
        if res.returncode == 0:
            (out / name).write_text(res.stdout)
    return out


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


def build_all(builds: dict, tmp: Path) -> dict:
    """tag -> (library, ptxas lines), for builds {tag: (directory, the
    probes it builds)}, every nvcc started together."""
    from tpu_raytracing_torch import native_cuda as nc

    jobs = {}
    for i, (tag, (d, probes)) in enumerate(builds.items()):
        out = tmp / f"probe_ab_{i}.so"
        jobs[tag] = (out, subprocess.Popen(
            [nc._nvcc(), *nc.NVCC_FLAGS, "-shared", "-I", str(d), "-o",
             str(out), *[str(d / BUILT[p]) for p in probes]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for tag, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {builds[tag][0]}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for p in builds[tag][1]:
            fn = getattr(lib, ENTRY[p])
            fn.restype = _I
            fn.argtypes = nc.SIGNATURES[ENTRY[p]]
        built[tag] = (lib, out, [ln.strip() for ln in log.splitlines()
                                 if "registers" in ln or "spill" in ln
                                 or "Compiling" in ln])
    return built


def run_p1(lib, ins, level: str, record: bool = False):
    """One launch of P1's kernel: (output, stats, visits or None)."""
    from tpu_raytracing_torch.probes import walk_cost as P1

    dev = ins[0].device
    out = torch.empty((P1.R, P1.LANE), dtype=torch.float32, device=dev)
    stats = torch.empty(2, dtype=torch.int32, device=dev)
    visits = (torch.zeros(ITERS, dtype=torch.int32, device=dev) if record
              else None)
    rc = lib.tpu_rt_probe_walk_cost(
        *[x.data_ptr() for x in ins], out.data_ptr(),
        None if visits is None else visits.data_ptr(), stats.data_ptr(),
        P1.LEVELS.index(level), ITERS,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tpu_rt_probe_walk_cost: CUDA error {rc}")
    return out, stats, visits


def run_p4(lib, ins, dtype: str):
    """One launch of P4's kernel: (output,)."""
    box, ray = ins[dtype]
    out = torch.empty(box.shape, dtype=torch.float32, device=box.device)
    rc = lib.tpu_rt_probe_bf16_vpu(
        box.data_ptr(), ray.data_ptr(), out.data_ptr(),
        int(dtype == "bfloat16"), P4_ITERS,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tpu_rt_probe_bf16_vpu: CUDA error {rc}")
    return (out,)


def sass_lines(tag: str, library: Path, probes) -> list[str]:
    """The loop of each P1 level's and P4 type's kernel in a build's SASS,
    by opcode."""
    from tpu_raytracing_torch.probes import common
    from tpu_raytracing_torch.probes import walk_cost as P1

    names = []
    if "P1" in probes:
        names += [(f"P1 {lv}", f"probe_walk_costILi{i}E")
                  for i, lv in enumerate(P1.LEVELS)]
    if "P4" in probes:
        names += [("P4 float32", "probe_bf16_vpuI6float2E"),
                  ("P4 bfloat16", "probe_bf16_vpuI14__nv_bfloat162E")]
    lines = []
    for label, kernel in names:
        sass = common.loop_instructions(kernel, library=library)
        lines.append(f"# {tag}, {label}: loop in SASS, " + (
            f"{sum(sass.values())} instructions: {dict(sorted(sass.items()))}"
            if sass else "not found"))
    return lines


def run_p2(lib, ins, variant: str, record: bool = False):
    """One launch of P2's kernel: (output, stats, visits or None)."""
    dev = ins[0].device
    out = torch.empty((4, 128), dtype=torch.float32, device=dev)
    stats = torch.empty(2, dtype=torch.int32, device=dev)
    visits = (torch.zeros(ITERS, dtype=torch.int32, device=dev) if record
              else None)
    rc = lib.tpu_rt_probe_slab_cost(
        *[x.data_ptr() for x in ins], out.data_ptr(),
        None if visits is None else visits.data_ptr(), stats.data_ptr(),
        P2_KERNELS[variant], ITERS, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tpu_rt_probe_slab_cost: CUDA error {rc}")
    return out, stats, visits


def run_p3(lib, ins, config):
    """One launch of P3's kernel: (output, iterations run)."""
    from tpu_raytracing_torch.probes import iter_cost as P3

    R, _, _, chain, loop = config
    dev = ins[0].device
    out = torch.empty((R, 128), dtype=torch.float32, device=dev)
    counts = torch.zeros(1, dtype=torch.int32, device=dev)
    rc = lib.tpu_rt_probe_iter_cost(
        *[x.data_ptr() for x in ins], out.data_ptr(), counts.data_ptr(), R,
        int(chain), P3.LOOPS.index(loop), ITERS,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tpu_rt_probe_iter_cost: CUDA error {rc}")
    return out, counts


def agree(a, b) -> bool:
    """Two launches' results equal bit for bit (floats as int32 bits)."""
    torch.cuda.synchronize()
    return all(x is None and y is None or torch.equal(
        x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def parse_parents(items) -> dict:
    """{commit: directory} from --parent COMMIT=DIR arguments."""
    out = {}
    for item in items:
        commit, sep, directory = item.partition("=")
        if not sep or commit not in PARENT_OF.values():
            raise SystemExit(f"--parent takes COMMIT=DIR with COMMIT one of "
                             f"{sorted(set(PARENT_OF.values()))}: {item!r}")
        out[commit] = Path(directory)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", action="append", default=[],
                    metavar="COMMIT=DIR")
    ap.add_argument("--probes", default="P1,P2,P3,P4")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    probes = [p for p in BUILT if p in args.probes.split(",")]
    parents = parse_parents(args.parent)
    if not torch.cuda.is_available():
        print("torch_probe_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpu_raytracing_torch import native_cuda as nc
    from tpu_raytracing_torch.probes import bf16_vpu as P4
    from tpu_raytracing_torch.probes import iter_cost as P3
    from tpu_raytracing_torch.probes import slab_cost as P2
    from tpu_raytracing_torch.probes import walk_cost as P1

    card_name = cs.card_line()
    print(f"# card: {card_name}", flush=True)
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        builds = {"change": (nc.CSRC, probes)}
        for commit in dict.fromkeys(PARENT_OF[p] for p in probes):
            builds[f"parent {commit}"] = (
                parent_sources(commit, parents.get(commit), tmp),
                [p for p in probes if PARENT_OF[p] == commit])
        for i, (step, (probe, _, subs)) in enumerate(STEPS.items()):
            if probe in probes:
                builds[step] = (undo_step(nc.CSRC, tmp, i, subs), [probe])
        built = build_all(builds, tmp)
        for tag, (_, library, ptxas) in built.items():
            print(f"# {tag}:", flush=True)
            for ln in ptxas:
                print(f"#   {ln}")
            for ln in sass_lines(tag, library, builds[tag][1]):
                print(ln, flush=True)
        libs = {tag: lib for tag, (lib, _, _) in built.items()}
        ins = {"P1": P1.script_inputs("cuda"), "P2": P2.script_inputs("cuda"),
               "P3": P3.script_inputs("cuda"), "P4": P4.script_inputs("cuda")}
        p1_varied = P1.varied_inputs("cuda")
        cases = {"P1": P1.LEVELS, "P2": list(P2_KERNELS),
                 "P3": P3.CONFIGS, "P4": list(P4.DTYPES)}
        # (label, probe, case, A's build)
        pairs = []
        for probe in probes:
            for case in cases[probe]:
                name = P3.label(case) if probe == "P3" else case
                for a in (f"parent {PARENT_OF[probe]}", *[
                        s for s, (p, only, _) in STEPS.items()
                        if p == probe and (only is None or case in only)]):
                    pairs.append((f"{probe} {name}, {a}", probe, case, a))
        times, runs = {}, {}
        for label, probe, case, a in pairs:
            def run(tag, rec=False, probe=probe, case=case, inputs=None):
                lib, x = libs[tag], inputs or ins[probe]
                if probe == "P1":
                    return run_p1(lib, x, case, rec)
                if probe == "P2":
                    return run_p2(lib, x, case, rec)
                if probe == "P3":
                    return run_p3(lib, x, case)
                return run_p4(lib, x, case)

            res_a, res_b = run(a, True), run("change", True)
            same = agree(res_a, res_b)
            if probe == "P1":
                same = same and agree(run(a, True, inputs=p1_varied),
                                      run("change", True, inputs=p1_varied))
            n_run = P4_ITERS if probe == "P4" else int(res_b[1][0])
            held = {"P1": "output, stats, visits, both input sets",
                    "P2": "output, stats, visits",
                    "P3": "output, iterations run", "P4": "output"}[probe]
            print(f"# {label}: A and B "
                  f"{'agree bit for bit' if same else 'DISAGREE'} ({held}; "
                  f"{n_run} run)", flush=True)
            if not same:
                return 1
            runs[label] = n_run
            for rnd in range(args.rounds):
                for tag, build in (("A", a), ("B", "change"),
                                   ("B", "change"), ("A", a)):
                    ms = cs.time_ms(lambda: run(build), args.reps)  # noqa: B023
                    times.setdefault((label, tag), []).append(ms)
                    print(f"# {label} round {rnd} {tag}: {ms:.4f} ms",
                          flush=True)
    summary = {}
    for (label, tag), v in times.items():
        summary.setdefault(label, {})[tag] = sum(v) / len(v)
    for label, v in summary.items():
        v["B/A"] = v["B"] / v["A"]
        v["runs"] = runs[label]
        v["ns_a_run_A"] = v["A"] * 1e6 / runs[label]
        v["ns_a_run_B"] = v["B"] * 1e6 / runs[label]
    print(card_name)
    print(json.dumps({"card": card_name,
                      "parents": {p: PARENT_OF[p] for p in probes},
                      "iters": ITERS, "p4_iters": P4_ITERS,
                      "mean_ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
