"""Mean CUDA-event milliseconds of the ``rollout`` span's calls outside the
profiled part of the traced window."""

from benchmark import harness


def read(r):
    return harness.span_ms(r, "rollout")
