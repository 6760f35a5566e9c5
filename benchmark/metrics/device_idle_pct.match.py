"""The device's idle share of a match unit, in percent (``harness.idle``)."""

from benchmark import harness


def read(r):
    return harness.idle(r, "match")
