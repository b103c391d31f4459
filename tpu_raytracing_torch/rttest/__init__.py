"""rttest for the port: the statistical-gate harness of the PyTorch port.

The counterpart of visual_testing/rttest/, with the same module names
(test_spec, diff, runner, perf, main): it renders every row of the JAX
harness's suite through `python -m tpu_raytracing_torch.cli` (`--backend
cuda` by default, or `cpu`) and holds each output against the JAX
package's CPU references with the JAX harness's cross-backend statistical
gate. The port is never its own reference: the JAX harness's bless is not
ported, and `digest` (digest.py) makes the committed references,
references/digest.json and the AOV rows' EXRs, from the JAX package's CPU
renders. It imports nothing of tpu_raytracing or visual_testing; it reads
the suite's TOML by path and EXRs with the port's utils/exr.py.
"""
