"""Kernel E (`csrc/face_shift.cu`) on faces whose side is no multiple of
its vector (90 in LLC90): every launch runs one element a thread, the
route that `face_shift.ROUTES` counts as ``scalar``.

The share of the roofline: the least time of the step's work for this
kernel over the device time of the operations below, in %."""

from benchmark.readers import roofline_share

NAMES = ("face_shift_kernel",)
SPAN = None


def read(trace, cell):
    return roofline_share(trace, cell, "face_shift", NAMES, SPAN)
