"""The ``rollout`` span's least time over the device time of the kernels
launched inside its calls, in percent (``harness.roofline``)."""

from benchmark import harness


def read(r):
    return harness.roofline(r, "rollout")
