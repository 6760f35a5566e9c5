"""The pre-activation epilogue's share of its roofline, in percent
(``harness.roofline``): a launch's least time, averaged over a forward's
launches (``work_nbt.preact_least_s``: y read and a written, with a skip
the skip read and s written, with a board bias its (B, C), BatchNorm's
three vectors, over 3.35 TB/s), over the device time of the kernels
launched inside the driver's ``epilogue.preact`` bench spans in the
profiled matches.  None where the run has no such span (an untraced run,
or a program without the pre-activation entry)."""

from benchmark import harness


def read(r):
    return harness.roofline(r, "epilogue.preact") if r.kind == "match" else None
