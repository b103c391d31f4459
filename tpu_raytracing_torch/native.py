"""Build and load the port's native host library (csrc/host/*.cpp -> ctypes).

Counterpart of tpu_raytracing/native.py for the host side: the binned-SAH
BVH builder (`csrc/host/bvh_builder.cpp`) and the PIZ Huffman decode
(`csrc/host/exr_huf.cpp`), copies of the JAX package's sources. At first
use `get_lib()` compiles both with g++ (`$CXX` where set) and the JAX
package's Makefile flags (`-O3 -fPIC -std=c++17 -fno-fast-math`, without
its warning flags) into tpu_raytracing_torch/_build/, under a name
hashed from the sources and flags (a changed source rebuilds), and checks
the library's ABI version.

`TPU_RAYTRACING_NO_NATIVE`, read at each call as in the JAX package,
selects the numpy builder and the Python Huffman decode: `get_lib()` then
returns None. Unlike the JAX package, a build or load failure while the
switch is unset raises; nothing falls back quietly. Both builders emit the
same arrays, so the switch never changes a scene table.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
HOST_SRC = _PKG / "csrc" / "host"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-fno-fast-math", "-shared")
ABI_VERSION = 2

_lib = None


def disabled() -> bool:
    return bool(os.environ.get("TPU_RAYTRACING_NO_NATIVE"))


def _sources() -> list[Path]:
    return sorted(HOST_SRC.glob("*.cpp"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpurt_host_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources into the hashed library if it is missing:
    (library path, build seconds, 0.0 when it existed)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           *map(str, _sources())]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"native host library build failed "
                               f"({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
    except OSError as e:
        raise RuntimeError(f"native host library build failed: {e}") from e
    finally:
        tmp.unlink(missing_ok=True)
    return out, time.perf_counter() - t0


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built at first use; None when the switch is set."""
    global _lib
    if disabled():
        return None
    if _lib is not None:
        return _lib
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.tpu_rt_abi_version.restype = ctypes.c_int
    if lib.tpu_rt_abi_version() != ABI_VERSION:
        raise RuntimeError(f"{path.name}: ABI version "
                           f"{lib.tpu_rt_abi_version()}, want {ABI_VERSION}")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.tpu_rt_build_bvh.restype = ctypes.c_int
    lib.tpu_rt_build_bvh.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int,
        f32p, f32p, i32p, i32p, i32p, i32p, ctypes.c_int,
    ]
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.tpu_rt_huf_uncompress.restype = ctypes.c_int
    lib.tpu_rt_huf_uncompress.argtypes = [
        u8p, ctypes.c_int64, u16p, ctypes.c_int64,
    ]
    _lib = lib
    return lib


def build_bvh_native(lib, prim_min, prim_max, max_leaf_size):
    """The native BVH build: LinearBVH's arrays (node_min, node_max,
    left_first, count, skip, prim_order)."""
    prim_min = np.ascontiguousarray(prim_min, np.float32).reshape(-1, 3)
    prim_max = np.ascontiguousarray(prim_max, np.float32).reshape(-1, 3)
    n = prim_min.shape[0]
    cap = max(2 * n + 1, 1)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    left_first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    skip = np.empty(cap, np.int32)
    prim_order = np.empty(max(n, 1), np.int32)
    n_nodes = lib.tpu_rt_build_bvh(
        prim_min, prim_max, n, int(max_leaf_size),
        node_min, node_max, left_first, count, skip, prim_order, cap,
    )
    if n_nodes < 0:
        raise RuntimeError(f"native BVH build overflowed {cap} nodes")
    return (
        node_min[:n_nodes].copy(),
        node_max[:n_nodes].copy(),
        left_first[:n_nodes].copy(),
        count[:n_nodes].copy(),
        skip[:n_nodes].copy(),
        prim_order[:n].copy(),
    )


def huf_uncompress_native(lib, comp: bytes, n_out: int) -> np.ndarray:
    """The native PIZ Huffman decode of `comp` into n_out u16 values."""
    buf = np.frombuffer(comp, np.uint8)
    out = np.empty(max(n_out, 1), np.uint16)
    rc = lib.tpu_rt_huf_uncompress(np.ascontiguousarray(buf), len(comp), out,
                                   n_out)
    if rc != 0:
        raise ValueError(f"malformed PIZ huffman data (rc={rc})")
    return out[:n_out]
