"""The least time the card could take for a kernel's work.

Copied from ``chip_smoke.py`` (``bound``, ``linear_bound``,
``conservative_bound`` and the data-sheet peaks) so that the yardstick stays
with the benchmark: bytes count each input read once and each output
written once, operations count what the algorithm needs for these shapes,
whatever a kernel does again.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at 700 W
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores, data sheet


def bound(nbytes: float, flops: float):
    """(least ms on the card, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the float32 operations over the peak
    rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stencil_work(points: int, itemsize: int = 4, halo_points: int = 0):
    """(bytes, operations) of a two-point stencil (kernels A and E) over
    ``points`` values: x read and the result written once, the halo line
    read once, one operation per point."""
    return (2 * points + halo_points) * itemsize, points


def linear_work(cols, nv, n, m, broadcast_phi=False):
    """(bytes, operations) of kernels C (nv = 1) and F on (cols, n) columns
    onto m shared levels: theta and the nv phis read once (a phi broadcast
    along the column, knot stride 0, is one value per column), the targets,
    the nv outputs written once; a merge of the sorted knots and levels
    needs about 2 (n + m) compares and 3 m operations per variable for each
    column."""
    phi_values = 1 if broadcast_phi else n
    nbytes = (cols * (n + nv * phi_values) + m + nv * cols * m) * 4
    return nbytes, cols * (2 * (n + m) + 3 * m * nv)


def conservative_work(cols, nv, n, m):
    """(bytes, operations) of kernels G (nv = 1) and H on (cols, n + 1)
    bounds into m - 1 bins: the bounds, the nv fields and the edges read
    once, the nv outputs written once; a merge of the sorted bounds and
    edges touches about n + m (cell, bin) overlaps per column at about 8
    operations each per variable."""
    nbytes = (cols * (n + 1) + nv * cols * n + m + nv * cols * (m - 1)) * 4
    return nbytes, cols * (n + m) * 8 * nv
