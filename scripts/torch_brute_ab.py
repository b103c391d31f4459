"""Time two builds of the port's brute kernel against each other on one
NVIDIA GPU.

    python3 scripts/torch_brute_ab.py A.cu B.cu [--reps 20] [--rounds 2]

A and B are two versions of tpu_raytracing_torch/csrc/t8_brute.cu with the
same C entry (`tpu_rt_t8_brute`). Each is built with the port's nvcc flags
into a library of its own under tpu_raytracing_torch/_build/, and called
through its C entry on chip_smoke.py's path shape: the camera rays of
coated_diffuse_bunny at 500x500 (closest-hit) and their shadow rays
(any-hit). Each round times A, B, B, A in that order, the mean of `reps`
calls by CUDA events each, after one call that checks A and B agree bit for
bit (t and winner). Prints the card's name and power limit, every time,
and a JSON summary (the mean over rounds and both positions) as the last
line. Exits nonzero when the two disagree.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def build(src: Path, tag: str):
    """The C entry of `src`, built into its own library."""
    from tpu_raytracing_torch import native_cuda as nc

    nc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = nc.BUILD_DIR / f"brute_ab_{tag}.so"
    res = subprocess.run(
        [nc._nvcc(), *nc.NVCC_FLAGS, "-shared", "-I", str(nc.CSRC), "-o",
         str(out), str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(out)).tpu_rt_t8_brute
    fn.restype = ctypes.c_int
    fn.argtypes = nc.SIGNATURES["tpu_rt_t8_brute"]
    ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return fn, ptxas


def call(fn, card, rays):
    """(t, winner) of one launch of `fn` on the ray batch."""
    o, d, t_min, t_max, active = rays
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    best = torch.empty(n, dtype=torch.int32, device=o.device)
    rc = fn(card.tris.data_ptr(), card.groups.data_ptr(), o.data_ptr(),
            d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            active.data_ptr(), t.data_ptr(), best.data_ptr(), None, n,
            card.tris.shape[0], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tpu_rt_t8_brute launch failed: CUDA error {rc}")
    return t, best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_brute_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpu_raytracing_torch.device import compile_scene
    from tpu_raytracing_torch.scene.test_scenes import get_test_scene
    from tpu_raytracing_torch.settings import AovFlags, RaytracerSettings

    card_name = cs.card_line()
    print(f"# card: {card_name}", flush=True)
    fns = {}
    for tag, src in (("A", args.a), ("B", args.b)):
        fns[tag], ptxas = build(src, tag)
        print(f"# {tag} = {src}: " + "; ".join(ptxas), flush=True)
    settings = RaytracerSettings(
        samples_per_pixel=8, light_sample_count=1, max_ray_depth=8,
        outputs=AovFlags.BEAUTY)
    ds = compile_scene(get_test_scene(cs.SCENE).scene_func())
    _, path_shape = cs.path_shapes(ds, settings)
    card = ds.t8_card
    times = {}
    for mode, shape in path_shape.items():
        rays = [x.contiguous() for x in shape[:5]]
        ta, ba = call(fns["A"], card, rays)
        tb, bb = call(fns["B"], card, rays)
        torch.cuda.synchronize()
        same = (torch.equal(ta.view(torch.int32), tb.view(torch.int32))
                and torch.equal(ba, bb))
        live = int(rays[4].sum())
        print(f"# {mode}: {rays[0].shape[0]} rays, {live} live; A and B "
              f"{'agree bit for bit' if same else 'DISAGREE'}", flush=True)
        if not same:
            return 1
        for rnd in range(args.rounds):
            for tag in ("A", "B", "B", "A"):
                ms = cs.time_ms(lambda: call(fns[tag], card, rays), args.reps)
                times.setdefault((mode, tag), []).append(ms)
                print(f"# {mode} round {rnd} {tag}: {ms:.4f} ms", flush=True)
    summary = {f"{mode} {tag}": sum(v) / len(v)
               for (mode, tag), v in times.items()}
    print(card_name)
    print(json.dumps({"card": card_name, "mean_ms": summary,
                      "a": str(args.a), "b": str(args.b)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
