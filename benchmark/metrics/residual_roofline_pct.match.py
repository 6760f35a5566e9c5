"""The residual epilogue's share of its roofline, in percent
(``harness.roofline``): a launch's least time, its bytes
(``work_resnet.residual_bytes``: the conv's output and the skip read, the
output written, BatchNorm's three vectors) over 3.35 TB/s, over the device
time of the kernels launched inside the driver's ``epilogue.residual``
bench spans in the profiled matches.  None where the run has no such span
(an untraced run, or a program without the residual entry)."""

from benchmark import harness


def read(r):
    return harness.roofline(r, "epilogue.residual") if r.kind == "match" else None
