"""tpu_raytracing_torch: the renderer ported to PyTorch and CUDA (H100).

The JAX package `tpu_raytracing` stays the reference. This package keeps
its module paths and function names so that each counterpart is easy to
find, keeps its own copies of the host-side modules (scene with the glTF
and PBRT loaders, geometry, accel, materials, lights, settings, sampling,
utils with the EXR and PNG writers), and never imports jax.

Layering (host -> device):
  cli.py       the command line (`python -m tpu_raytracing_torch.cli`)
  device/      scene -> torch tensors on one device ("compiled scene")
  ops/         RNG, camera rays, traversal, BSDFs, textures, lights
  csrc/        hand-written CUDA kernels (sm_90a), built by native_cuda.py
  integrator/  the path tracer's bounce loop, render driver and
               checkpointed accumulation
"""

__version__ = "0.1.0"
