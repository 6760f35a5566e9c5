"""Mean host microseconds of a ply of ``run_match``: the program's own
``match.ply`` span (both sides' observe, forward and pick, and the step),
over the matches the driver plays inside the program's tracing after the
window (``harness.program_span_ms``)."""

from benchmark import harness


def read(r):
    ms = harness.program_span_ms(r, "match", "match.ply")
    return None if ms is None else 1e3 * ms
