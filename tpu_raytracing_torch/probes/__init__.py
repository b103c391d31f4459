"""Cost probes: the port's counterparts of the JAX package's Pallas probes.

Each probe is a microbenchmark with its own entry point, not part of the
renderer. It has a hand-written CUDA kernel (csrc/probe_*.cu), a plain
PyTorch version of the same function, a wrapper that launches the kernel
for CUDA tensors (native_cuda counts the launch under the probe's entry
and its configuration) or runs the plain version for CPU tensors, and a
`main()` that times the kernel on the card:

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

from . import bf16_vpu, iter_cost, slab_cost, walk_cost  # noqa: F401
