"""Kernel G (`csrc/conservative.cu`, one variable): `conservative_kernel` under
the conservative `transform` span.

The share of the roofline: the least time of the step's work for this
kernel over the device time of the operations below, in %."""

from benchmark.readers import roofline_share

NAMES = ("conservative_kernel",)
SPAN = "grid.transform.conservative"


def read(trace, cell):
    return roofline_share(trace, cell, "conservative", NAMES, SPAN)
