"""Mean host milliseconds of one side's load in ``run_match``: the
program's own ``match.load`` span (``load_policy_params``, two a match),
over the matches the driver plays inside the program's tracing after the
window (``harness.program_span_ms``)."""

from benchmark import harness


def read(r):
    return harness.program_span_ms(r, "match", "match.load")
