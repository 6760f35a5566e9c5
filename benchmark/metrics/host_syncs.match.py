"""Host syncs a match: the program's ``host_syncs`` counter (a copy from the
card that the host waits for) over its ``matches`` (``counters.per_match``)."""

from benchmark import counters


def read(r):
    return counters.per_match(r, "host_syncs")
