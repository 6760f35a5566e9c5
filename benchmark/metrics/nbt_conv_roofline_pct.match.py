"""The nested-bottleneck tower's Winograd conv's share of its roofline, in
percent (``harness.roofline``): a call's least time, averaged over a
forward's 3x3 convs (``work_nbt.conv_least_s``: the products the kernels
run, 36 x the padded tiles x C_in x C_out x 2, over 67 TFLOP/s, or x, y and
the filter image once over 3.35 TB/s, whichever is larger), over the
device time of the three kernels launched inside the driver's
``conv.winograd`` bench spans in the profiled matches.  None where the run
has no such span (an untraced run, or a program without the family)."""

from benchmark import harness


def read(r):
    return harness.roofline(r, "conv.winograd") if r.kind == "match" else None
