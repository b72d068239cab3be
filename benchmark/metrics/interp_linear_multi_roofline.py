"""Kernel F (`csrc/interp_linear.cu`, several variables):
`interp_linear_kernel` under the linear `transform_multi` span.

The share of the roofline: the least time of the step's work for this
kernel over the device time of the operations below, in %."""

from benchmark.readers import roofline_share

NAMES = ("interp_linear_kernel",)
SPAN = "grid.transform_multi.linear"


def read(trace, cell):
    return roofline_share(trace, cell, "interp_linear_multi", NAMES, SPAN)
