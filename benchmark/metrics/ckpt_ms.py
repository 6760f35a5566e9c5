"""Mean host-clock milliseconds of the trainer's checkpoint saves outside
the profiled part of the traced window."""

from benchmark import harness


def read(r):
    return harness.span_ms(r, "ckpt", clock="host")
