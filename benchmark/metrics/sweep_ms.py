"""Mean CUDA-event milliseconds of the ``sweep`` span's calls outside the
profiled part of the traced window."""

from benchmark import harness


def read(r):
    return harness.span_ms(r, "sweep")
