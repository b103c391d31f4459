"""Build and load the port's CUDA kernels (csrc/*.cu -> a ctypes library).

Counterpart of tpu_raytracing/native.py for the device side. At first use,
`load()` compiles every source under tpu_raytracing_torch/csrc/ with nvcc
for sm_90a into tpu_raytracing_torch/_build/: one nvcc per .cu file, all
started together, then one link (the objects are removed whether or not
the build succeeds). The library is named by a hash of the
sources and flags (a changed source rebuilds) and loaded with ctypes. It
has a plain C interface, so the build does not include PyTorch's headers
and takes seconds.

There is no fallback: a missing nvcc or a failed build raises. What every
kernel wrapper shares is here too: the device rule (`on_card`), the
check of a tensor the kernel reads (`check_tensor`) and the launch of a C
entry on the current stream (`launch`), which raises on a refused launch
and counts every launch the card takes (`launch_counts`,
`reset_launch_counts`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No fast math: IEEE divides in 1/d and Moller-Trumbore; -fmad=false keeps
# t equal to the plain PyTorch walks'.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpurt_cuda_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the sources if the hashed library is missing.

    Returns (library path, build seconds (0.0 when it existed), compiler
    output, which holds ptxas's register and spill report)."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    srcs = [src for src in _sources() if src.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        jobs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for obj, src in zip(objs, srcs)]
        logs, failed = [], []
        for obj, proc in zip(objs, jobs):
            log, _ = proc.communicate()
            logs.append(log)
            if proc.returncode != 0:
                failed.append(f"{obj.name} ({proc.returncode}):\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        res = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *[str(obj) for obj in objs]],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out, time.perf_counter() - t0, "".join(logs)


# ctypes signatures: p = pointer (data_ptr or stream), i = int
_P, _I = ctypes.c_void_p, ctypes.c_int
_RAYS = [_P] * 5 + [_P] * 3   # origin, direction, t_min, t_max, active;
                              # t_out, best_out, counts (nullptr or (B, 3) i32)
SIGNATURES = {
    "tpu_rt_bvh8t_walk": [_P, _P, _P, _P, *_RAYS, _I, _I, _I, _P],
    # nodes, children, tris, next_ray | n_rays, width, early_exit | stream
    "tpu_rt_t8_brute": [_P, _P, *_RAYS, _I, _I, _P],
    # card tris, card groups | n_rays, n_records | stream
    "tpu_rt_skip_walk": [_P, _P, _P, *_RAYS, _I, _I, _I, _I, _P],
    # nodes_pk, tris_pk, next_ray | n_rays, sentinel, n_tris, early_exit |
    # stream
    "tpu_rt_pair_walk": [_P, _P, _P, *_RAYS, _I, _I, _I, _I, _P],
    # rows_pk, tris_pk, next_ray | n_rays, root_meta, n_tris, early_exit |
    # stream
    "tpu_rt_quad_walk": [_P, _P, _P, *_RAYS, _I, _I, _I, _I, _I, _P],
    # recs, tris, next_ray | n_rays, root_meta, n_tris, rowrec, early_exit |
    # stream
    "tpu_rt_probe_iter_cost": [_P] * 6 + [_I] * 4 + [_P],
    # tris, o, d, t_min, out, iters_run | R, chain, loop, iters | stream
    "tpu_rt_probe_bf16_vpu": [_P] * 3 + [_I] * 2 + [_P],
    # box, ray, out | bf16, iters | stream
    "tpu_rt_probe_slab_cost": [_P] * 8 + [_I] * 2 + [_P],
    # nodes, o, inv, t_min, act, out, visits, stats | variant, iters | stream
    "tpu_rt_probe_walk_cost": [_P] * 9 + [_I] * 2 + [_P],
    # nodes, tris, meta, o, d, t_min, out, visits, stats | level, iters |
    # stream
    "tpu_rt_layered_eval": [_P] * 11 + [_I, _P],
    # albedo, eta, alpha_x, alpha_y, top_kind, thickness, coat_albedo, wo,
    # wi, f_out, steps | n | stream
    "tpu_rt_layered_sample": [_P] * 15 + [_I, _P],
    # the eval's seven coat fields, wo, draw_base, wi_out, f_out, pdf_out,
    # comp_out, valid_out, steps | n | stream
    "tpu_rt_bsdf_eval": [_P] * 9 + [_I, _I, _P],
    # kind, albedo, eta, kappa, alpha_x, alpha_y, wo, wi, f_out | kinds, n |
    # stream
    "tpu_rt_bsdf_sample": [_P] * 14 + [_I, _I, _P],
    # the eval's seven inputs, u2, u1, wi_out, f_out, pdf_out, comp_out,
    # valid_out | kinds, n | stream
    "tpu_rt_hit_details": [_P] * 22 + [_I] * 7 + [_P],
    # tri_shade, the six sphere tables, inst_xf, inst_bases, origin,
    # direction, t, prim, the nine outputs | n, n_tris, tri_shade rows,
    # n_spheres, sphere rows, n_inst, inst_vtri_base0 | stream
}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load the library; argtypes set for every entry.
    Every entry returns cudaGetLastError() after its launch."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = _I
        fn.argtypes = argtypes
    return lib


def on_card(name: str, x: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; other devices raise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type == "cuda"


def check_tensor(name: str, x: torch.Tensor, shape, dtype, device):
    """x as a contiguous tensor, or raise if its shape, type or device is
    not the kernel's."""
    if tuple(x.shape) != tuple(shape) or x.dtype != dtype or x.device != device:
        raise ValueError(
            f"{name}: expected {tuple(shape)} {dtype} on {device}, got "
            f"{tuple(x.shape)} {x.dtype} on {x.device}")
    return x.contiguous()


_LAUNCHES: Counter = Counter()


def launch(entry: str, device, *args, tag: str = "") -> None:
    """Call the C entry `entry` with `args` and the current stream of
    `device`; a launch the card refuses raises, and each launch it takes
    adds one to the count of (entry, tag). `tag` tells apart what one entry
    launches: a walk and its mode, a probe's configuration."""
    rc = getattr(load(), entry)(*args,
                                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    _LAUNCHES[entry, tag] += 1


def launch_counts() -> dict[tuple[str, str], int]:
    """(entry, tag) -> the launches since the last reset_launch_counts()."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
