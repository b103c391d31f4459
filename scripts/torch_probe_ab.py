"""Time the port's redesigned probes P2 (slab cost) and P3 (iteration cost)
against their versions of commit 5f953d9 and against the change with one
step of its design undone, on one NVIDIA GPU.

    python3 scripts/torch_probe_ab.py [--parent DIR] [--reps 5] [--rounds 2]

The parent's probe sources (SOURCES) are read from DIR, or from `git show
5f953d9:...` when no DIR is given (a git checkout). Builds, each of
csrc/probe_slab_cost.cu and csrc/probe_iter_cost.cu with the port's nvcc
flags (native_cuda.NVCC_FLAGS) into a library of its own in a temporary
directory, all nvcc runs started together:

- parent: those sources;
- change: tpu_raytracing_torch/csrc as it is;
- one build a step of the design, the change with that step undone, or
  with an option it left out put in, by a text substitution (STEPS
  below). P2: without its ring of node blocks in shared memory (each
  visit reads its boxes from device memory through L1, as the parent
  did); two ring stages in place of three; mxu at one or four columns a
  thread in place of two; cur at one or four rays a thread in place of
  two (floor's block follows cur's); floor's compares in all its threads
  in place of 128; the parent's
  drain (one word that every warp atomicOr's, in place of a slot a warp;
  P1 shares the drain). P3: without K3's prefilter (every (row, ray)
  takes the full test); two or four rays a thread in place of one.

Every probe runs on the scripts' inputs at the scripts' counts (4,096
visits or iterations): P2's four kernels (hoist runs cur's) and P3's five
configurations. For each comparison one call of each build checks that the
two agree bit for bit (P2: output, stats and every visit's drained mask;
P3: output and iterations run); then each round times A B B A, the mean of
`reps` calls by CUDA events each (A = the parent, the step undone or the
other S; B = the change). Prints the card's name and power limit, ptxas's
report of each build, every time, and a JSON summary (the mean over rounds
and both positions, B / A, and ns a visit or iteration run) as the last
line. Exits nonzero when two builds disagree.
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

PARENT = "5f953d9"
SOURCES = ("probe_slab_cost.cu", "probe_iter_cost.cu", "probe_common.cuh",
           "traverse_common.cuh")
BUILT = ("probe_slab_cost.cu", "probe_iter_cost.cu")
ITERS = 4096
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


def parent_sources(directory: Path | None, tmp: Path) -> Path:
    """The directory that holds the parent's sources (the parent's probes
    do not include traverse_common.cuh, which may be missing)."""
    if directory is not None:
        return directory
    out = tmp / "parent"
    out.mkdir()
    for name in SOURCES:
        res = subprocess.run(
            ["git", "show", f"{PARENT}:tpu_raytracing_torch/csrc/{name}"],
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


def build_all(dirs: dict, tmp: Path) -> dict:
    """tag -> (library, ptxas lines), every nvcc started together."""
    from tpu_raytracing_torch import native_cuda as nc

    jobs = {}
    for i, (tag, d) in enumerate(dirs.items()):
        out = tmp / f"probe_ab_{i}.so"
        jobs[tag] = (out, subprocess.Popen(
            [nc._nvcc(), *nc.NVCC_FLAGS, "-shared", "-I", str(d), "-o",
             str(out), *[str(d / n) for n in BUILT]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for tag, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {dirs[tag]}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for name in ("tpu_rt_probe_slab_cost", "tpu_rt_probe_iter_cost"):
            fn = getattr(lib, name)
            fn.restype = _I
            fn.argtypes = nc.SIGNATURES[name]
        built[tag] = (lib, [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln
                            or "Compiling" in ln])
    return built


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_probe_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpu_raytracing_torch import native_cuda as nc
    from tpu_raytracing_torch.probes import iter_cost as P3
    from tpu_raytracing_torch.probes import slab_cost as P2

    card_name = cs.card_line()
    print(f"# card: {card_name}", flush=True)
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        dirs = {"parent": parent_sources(args.parent, tmp),
                "change": nc.CSRC}
        for i, (step, (_, _, subs)) in enumerate(STEPS.items()):
            dirs[step] = undo_step(nc.CSRC, tmp, i, subs)
        built = build_all(dirs, tmp)
        for tag, (_, ptxas) in built.items():
            print(f"# {tag}:", flush=True)
            for ln in ptxas:
                print(f"#   {ln}")
        libs = {tag: lib for tag, (lib, _) in built.items()}
        p2_ins = P2.script_inputs("cuda")
        p3_ins = P3.script_inputs("cuda")
        # (label, probe, case, A's build)
        pairs = []
        for v in P2_KERNELS:
            for a in ("parent", *[s for s, (p, cases, _) in STEPS.items()
                                  if p == "P2" and (cases is None
                                                    or v in cases)]):
                pairs.append((f"P2 {v}, {a}", "P2", v, a))
        for config in P3.CONFIGS:
            for a in ("parent", *[s for s, (p, _, _) in STEPS.items()
                                  if p == "P3"]):
                pairs.append((f"P3 {P3.label(config)}, {a}", "P3", config,
                              a))
        times, runs = {}, {}
        for label, probe, case, a in pairs:
            def run(tag, rec=False, probe=probe, case=case):
                if probe == "P2":
                    return run_p2(libs[tag], p2_ins, case, rec)
                return run_p3(libs[tag], p3_ins, case)

            res_a, res_b = run(a, True), run("change", True)
            n_run = int(res_b[1][0])
            same = agree(res_a, res_b)
            held = ("output, stats, visits" if probe == "P2"
                    else "output, iterations run")
            print(f"# {label}: A and B "
                  f"{'agree bit for bit' if same else 'DISAGREE'} ({held}; "
                  f"{n_run} of {ITERS} run)", flush=True)
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
    print(json.dumps({"card": card_name, "parent": PARENT, "iters": ITERS,
                      "mean_ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
