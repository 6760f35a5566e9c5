"""Mean host microseconds of one side's policy forward in ``run_match``:
the program's own ``ply.forward`` span (two a ply), over the matches the
driver plays inside the program's tracing after the window
(``harness.program_span_ms``).

It is the host's time to issue the forward, waits included.  It stands for
the forward's cost only while the match is bound by the host, as
``mlp7-match-det`` is (about nine tenths of the device idle).  In a match
bound by the device the launch queue is full, and the span reads the wait
for earlier plies' device work: there it needs the device's time inside
the ``hex.ply.forward`` ranges of the trace beside it."""

from benchmark import harness


def read(r):
    ms = harness.program_span_ms(r, "match", "ply.forward")
    return None if ms is None else 1e3 * ms
