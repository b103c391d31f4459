"""Share of the traced passes' wall spent inside the integrator's calls
into shading: the BSDF's evaluation and sampling and the light's
sampling, as integrator/render.py calls them (host spans the benchmark
records around those calls)."""

SPANS = ("bsdf_eval", "bsdf_sample", "sample_light")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    inside = sum(e - s for name, s, e, _ in tr.spans if name in SPANS)
    return 100.0 * inside / (tr.window_ns[1] - tr.window_ns[0])
