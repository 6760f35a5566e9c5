"""Bytes copied from the host to the card a match: the program's
``h2d_bytes`` counter (the policies' loads, and injected words) over its
``matches`` (``counters.per_match``)."""

from benchmark import counters


def read(r):
    return counters.per_match(r, "h2d_bytes")
