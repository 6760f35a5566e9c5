"""Mean CUDA-event milliseconds of the ``eval`` span's calls outside the
profiled part of the traced window."""

from benchmark import harness


def read(r):
    return harness.span_ms(r, "eval")
