"""The walk kernels' share of their bytes roofline, in %: the least time
the card could take to move the bytes the traced slice's traversal calls
need, at the published 3.35 TB/s of an H100 SXM (700 W), over the walk
kernels' device time.

Bytes, counted from the rays and the scene, whatever walk runs: per
active ray its origin, direction, t_min, t_max and active flag in (33 B)
and t and winner out (8 B); per inactive ray t_max and the flag in (5 B)
and t and winner out (8 B); per call each triangle of the scene once, as
p0, e1, e2 and its id (10 words). A tree's node words depend on the
walk's own layout and are left out, so the bound is a lower one. The
power limit the card ran at is printed beside the result (device.card).
"""

HBM_BYTES_PER_S = 3.35e12
RAY_BYTES = 33 + 8
IDLE_RAY_BYTES = 5 + 8
TRI_WORDS = 10
KERNELS = ("bvh8t_walk",)
SPANS = ("intersect_scene", "occluded")


def call_bytes(n_active: int, n_lanes: int, n_tris: int) -> int:
    """Bytes one traversal call needs to move."""
    return (n_active * RAY_BYTES + (n_lanes - n_active) * IDLE_RAY_BYTES
            + 4 * TRI_WORDS * n_tris)


def read(run):
    tr = run.trace
    if tr is None:
        return None
    walk = sum(e - s for name, s, e in tr.kernels
               if any(k in name for k in KERNELS))
    calls = [a for name, _, _, a in tr.spans if name in SPANS]
    if not walk or not calls:
        return None
    nbytes = sum(call_bytes(int(a.sum()), a.numel(), run.n_tris)
                 for a in calls)
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / (walk / 1e9)
