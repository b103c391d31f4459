"""Share of the traced frames' host wall inside the port's
`rt.aov.to_host` span (the AOV buffers' copies to the host, which wait
for the card, and their Morton reorder): the span's host nanoseconds as
the port's tracing counts them, over the slice's wall, both carried by
the aov traffic's window. None where the program keeps no such
counter. A traced run whose aov window carries none raises: the kind
found no `Slice` behind `after_pass`."""

SPAN = "rt.aov.to_host"


def read(run):
    pt = getattr(run.window, "program_trace", None)
    if (pt is None and getattr(run, "traced_passes", 0)
            and hasattr(run.window, "program_trace")):
        raise RuntimeError("a traced aov window carries no program trace: "
                           "the traffic kind did not find run.py's Slice")
    if not pt or not pt["wall_ns"]:
        return None
    ns = pt["counts"].get("host_ns." + SPAN)
    return None if ns is None else 100.0 * ns / pt["wall_ns"]
