"""Cost probes: the port's counterparts of the JAX package's Pallas probes.

Each probe is a microbenchmark with its own entry point, not part of the
renderer. It has a hand-written CUDA kernel (csrc/probe_*.cu), a plain
PyTorch version of the same function, a wrapper that launches the kernel
for CUDA tensors (and counts the launch) or runs the plain version for CPU
tensors, and a `main()` that times the kernel on the card:

- iter_cost (P3): ITERS iterations of a brute-group body, with and without
  a tile-wide drain that picks the next block
  (`python -m tpu_raytracing_torch.probes.iter_cost`);
- bf16_vpu (P4): an elementwise 3-axis slab update in float32 and in bf16
  (`python -m tpu_raytracing_torch.probes.bf16_vpu`);
- slab_cost (P2): a bvh8t visit's slab phase in five variants, each visit
  drained into one mask (`python -m tpu_raytracing_torch.probes.slab_cost`);
- walk_cost (P1): a bvh8t node visit rebuilt level by level, in seven
  levels (`python -m tpu_raytracing_torch.probes.walk_cost`).
"""
from __future__ import annotations

from . import bf16_vpu, iter_cost, slab_cost, walk_cost

PROBES = {"probe_iter_cost": iter_cost.iter_cost,
          "probe_bf16_vpu": bf16_vpu.bf16_vpu,
          "probe_slab_cost": slab_cost.slab_cost,
          "probe_walk_cost": walk_cost.walk_cost}


def reset_launch_counts() -> None:
    """Set every probe's launch counts to 0."""
    for fn in PROBES.values():
        for k in fn.launches:
            fn.launches[k] = 0
