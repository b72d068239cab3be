"""Kernel A (`csrc/shift.cu`) down the levels of a face-connected grid: the
vertical diffs, which no face connection names, on A's two routes.

The share of the roofline: the least time of the step's work for this
kernel over the device time of the operations below, in %."""

from benchmark.readers import roofline_share

NAMES = ("shift_rows", "shift_planes")
SPAN = None


def read(trace, cell):
    return roofline_share(trace, cell, "shift", NAMES, SPAN)
