"""Build and load the port's CUDA kernels (csrc/*.cu -> a ctypes library).

Counterpart of tpu_raytracing/native.py for the device side. At first use,
`load()` compiles every source under tpu_raytracing_torch/csrc/ with nvcc
for sm_90a into tpu_raytracing_torch/_build/, named by a hash of the
sources and flags (a changed source rebuilds), and loads it with ctypes.
The library has a plain C interface, so the build does not include
PyTorch's headers and takes seconds.

There is no fallback: a missing nvcc or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No fast math: IEEE divides in 1/d and Moller-Trumbore; -fmad=false keeps
# t equal to the plain PyTorch walk's.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
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
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out, seconds, res.stdout + res.stderr


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load the library; argtypes set for every entry."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.tpu_rt_bvh8t_walk.restype = i
    lib.tpu_rt_bvh8t_walk.argtypes = [
        p, p, p,        # nodes, tris, meta
        p, p, p, p, p,  # origin, direction, t_min, t_max, active
        p, p,           # t_out, best_out
        i, i, i, i,     # n_rays, width, leaf_rows, early_exit
        p,              # stream
    ]
    return lib
