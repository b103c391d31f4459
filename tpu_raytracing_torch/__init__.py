"""tpu_raytracing_torch: the renderer ported to PyTorch and CUDA (H100).

The JAX package `tpu_raytracing` stays the reference. This package keeps
its module paths and function names so that each counterpart is easy to
find, imports only its host-side modules (scene, geometry, accel,
materials, lights, settings, sampling), and never imports jax.

Layering (host -> device):
  device/      scene -> torch tensors on one device ("compiled scene")
  ops/         RNG, camera rays, traversal, BSDFs, textures, lights
  csrc/        hand-written CUDA kernels (sm_90a), built by native_cuda.py
  integrator/  the path tracer's bounce loop and render driver
"""

__version__ = "0.1.0"
