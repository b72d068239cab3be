"""Kernel C (`csrc/interp_linear.cu`, one variable): the step's remap;
`interp_linear_kernel` serves C and F, and the step launches only C.

The share of the roofline: the least time of the step's work for this
kernel over the device time of the operations below, in %."""

from benchmark.readers import roofline_share

NAMES = ("interp_linear_kernel",)
SPAN = None


def read(trace, cell):
    return roofline_share(trace, cell, "interp_linear", NAMES, SPAN)
