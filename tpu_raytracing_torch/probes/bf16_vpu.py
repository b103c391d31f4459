"""P4: does elementwise bf16 run at twice the float32 rate?

Counterpart of scripts/probe_bf16_vpu.py (the Pallas kernel that
`make(dtype)` builds, pallas_call at :56). ITERS iterations of a synthetic
3-axis slab update on a (16, 128) block, in float32 or in bf16:

    box = box + t0 * 1e-7
    3 times: a = (box - o) * 0.5;  b = (box + o) * 0.5
             t0 = max(t0, min(a, b));  t1 = min(t1, max(a, b))
    t0 = t0 * 0.999

from t0 = -1e3, t1 = 1e3, and the output is float32(t0) + float32(t1).
That is 27 operations an element an iteration as written, but the
function needs 11: the second and third axis passes compute the first
pass's a and b again, and max(max(t0, m), m) = max(t0, m), min likewise,
so they change nothing. The script divides its time by 14; the port's
line divides by the 11 needed. Every operation rounds to the working
type, and the constants are that type's (in bf16 0.999 rounds to 1.0);
the last add is in float32, as the JAX package's interpret mode does it.

`bf16_vpu` launches csrc/probe_bf16_vpu.cu for CUDA tensors (packed
__nv_bfloat162 ops in bf16) and runs `bf16_vpu_plain` for CPU tensors.
`python -m tpu_raytracing_torch.probes.bf16_vpu` times both types on the
card (`--device cpu` runs the plain version).
"""
from __future__ import annotations

import sys
from collections import Counter

import numpy as np
import torch

from ..native_cuda import check_tensor, launch, on_card
from . import common
from .common import best_ms, device_name, parse_args

ITERS = 20000           # as in the script
SHAPE = (16, 128)
_SRC = "probe_bf16_vpu.cu"
# the kernel's iterations a loop trip, and its chains a thread a type
UNROLL = common.source_int(_SRC, "constexpr int kUnroll")
CHAINS = {"float32": common.source_int(
              _SRC, "template <> constexpr int kChains<float2>"),
          "bfloat16": common.source_int(
              _SRC, "template <typename V> constexpr int kChains")}
OPS_PER_ELEMENT = 11    # needed per iteration: mul, add, one axis pass
                        # (add, sub, 2 mul, 2 min, 2 max), mul
WRITTEN_OPS = 27        # as written: the axis pass 3 times
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def bf16_vpu_plain(box, ray, iters: int):
    """The probe in plain PyTorch, in box's type: each op rounds to it."""
    c = lambda x: torch.tensor(x, dtype=box.dtype, device=box.device)  # noqa: E731
    eps, half, decay = c(1e-7), c(0.5), c(0.999)
    t0 = torch.full_like(box, -1e3)
    t1 = torch.full_like(box, 1e3)
    for _ in range(iters):
        box = box + t0 * eps
        for _ax in range(3):
            a = (box - ray) * half
            b = (box + ray) * half
            t0 = torch.maximum(t0, torch.minimum(a, b))
            t1 = torch.minimum(t1, torch.maximum(a, b))
        t0 = t0 * decay
    return t0.float() + t1.float()


def bf16_vpu(box, ray, iters: int = ITERS):
    """P4: the kernel for CUDA tensors, bf16_vpu_plain for CPU tensors.
    box and ray: (16, 128), both float32 or both bfloat16."""
    if box.dtype not in DTYPES.values():
        raise ValueError(f"probe_bf16_vpu: dtype {box.dtype} is neither "
                         "float32 nor bfloat16")
    if not on_card("probe_bf16_vpu", box):
        return bf16_vpu_plain(box, ray, iters)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    dev = box.device
    ins = [check_tensor("box", box, SHAPE, box.dtype, dev),
           check_tensor("ray", ray, SHAPE, box.dtype, dev)]
    out = torch.empty(SHAPE, dtype=torch.float32, device=dev)
    bf16 = box.dtype == torch.bfloat16
    launch("tpu_rt_probe_bf16_vpu", dev, *[x.data_ptr() for x in ins],
           out.data_ptr(), int(bf16), iters,
           tag="bfloat16" if bf16 else "float32")
    return out


def script_inputs(device="cpu"):
    """{dtype name: (box, ray)}, drawn as the script draws them
    (probe_bf16_vpu.py:66-69). The bf16 values are rounded through float32,
    where the script rounds from float64: with seed 0 they are the same."""
    rng = np.random.default_rng(0)
    out = {}
    for name, dt in DTYPES.items():
        out[name] = tuple(
            torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
            .to(device=device, dtype=dt) for _ in range(2))
    return out


def loop_instructions(dtype: str) -> Counter | None:
    """Opcodes of the kernel's loop body in SASS for one type (cuobjdump on
    the built library): UNROLL iterations of each of a thread's
    CHAINS[dtype] chains; None where it is not found."""
    tag = "14__nv_bfloat162" if dtype == "bfloat16" else "6float2"
    return common.loop_instructions(f"probe_bf16_vpuI{tag}E")


def main(argv=None) -> list[dict]:
    """Time both types at --iters iterations (default 20,000) and print the
    script's line for each, with the port's divisor of 11 operations."""
    args = parse_args(argv, __doc__.splitlines()[0], ITERS)
    dev = args.device
    print(f"device={device_name(dev)}", flush=True)
    results = []
    for name, (box, ray) in script_inputs(dev).items():
        ms = best_ms(lambda: bf16_vpu(box, ray, args.iters), dev)
        ns_per_op = ms * 1e6 / max(args.iters, 1) / OPS_PER_ELEMENT
        print(f"{name:>9}: {ms:8.3f} ms ({ns_per_op:.2f} ns per (16,128) op, "
              f"{OPS_PER_ELEMENT} ops per iteration, {WRITTEN_OPS} written)",
              flush=True)
        sass = loop_instructions(name) if dev == "cuda" else None
        if sass is not None:
            print(f"{name:>9}: loop body in SASS ({UNROLL} iterations of "
                  f"{CHAINS[name]} chain(s) a thread), {sum(sass.values())} "
                  f"instructions: {dict(sorted(sass.items()))}", flush=True)
        results.append(dict(dtype=name, ms=ms, iters=args.iters,
                            ns_per_op=ns_per_op,
                            sass=None if sass is None else dict(sass)))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
