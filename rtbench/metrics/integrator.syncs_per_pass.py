"""Host-blocking synchronisations a pass: the CUDA runtime calls in the
traced slice that make the host wait for the card (stream, event and
device synchronises, and blocking copies), over its passes. `alive.any()`,
`nonzero` and every read of a device value to the host end in one."""

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def read(run):
    tr = run.trace
    if tr is None or not run.traced_passes:
        return None
    n = sum(1 for name, _, _ in tr.runtime if name in SYNC_CALLS)
    return n / run.traced_passes
