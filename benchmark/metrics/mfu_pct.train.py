"""The share of one H100's float32 peak that a train unit's needed operations
take over its wall time, in percent (``harness.mfu``)."""

from benchmark import harness


def read(r):
    return harness.mfu(r, "train")
