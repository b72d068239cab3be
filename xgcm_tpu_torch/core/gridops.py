"""Predefined grid ufuncs: the operator/position table.

One GridUFunc per (operator, from-position, to-position) pair, the same
names, signatures and boundary widths as :mod:`xgcm_tpu.core.gridops`.
``Grid._select_grid_ufunc`` discovers these by name prefix + signature
equivalence, so the naming convention ``<method>_<from>_to_<to>`` is load-
bearing.  The cumsum family pads after the prefix sum
(``pad_before_func=False``) with ``fill_value=0``, so a boundary starts
from zero unless the caller passes another ``fill_value``.
"""

from __future__ import annotations

from ..ops.stencils import (
    cumsum_full,
    cumsum_trim_last,
    diff_forward,
    interp_forward,
    pairwise_max,
    pairwise_min,
)
from .grid_ufunc import as_grid_ufunc

# -- diff -------------------------------------------------------------------


@as_grid_ufunc(signature="(X:center)->(X:left)", boundary_width={"X": (1, 0)})
def diff_center_to_left(a):
    return diff_forward(a)


@as_grid_ufunc(signature="(X:left)->(X:center)", boundary_width={"X": (0, 1)})
def diff_left_to_center(a):
    return diff_forward(a)


@as_grid_ufunc(signature="(X:center)->(X:right)", boundary_width={"X": (0, 1)})
def diff_center_to_right(a):
    return diff_forward(a)


@as_grid_ufunc(signature="(X:right)->(X:center)", boundary_width={"X": (1, 0)})
def diff_right_to_center(a):
    return diff_forward(a)


@as_grid_ufunc(signature="(X:center)->(X:outer)", boundary_width={"X": (1, 1)})
def diff_center_to_outer(a):
    return diff_forward(a)


@as_grid_ufunc(signature="(X:outer)->(X:center)", boundary_width={"X": (0, 0)})
def diff_outer_to_center(a):
    # shrinking op: no padding needed (reference gridops.py:52-56)
    return diff_forward(a)


@as_grid_ufunc(signature="(X:center)->(X:inner)", boundary_width={"X": (0, 0)})
def diff_center_to_inner(a):
    return diff_forward(a)


@as_grid_ufunc(signature="(X:inner)->(X:center)", boundary_width={"X": (1, 1)})
def diff_inner_to_center(a):
    return diff_forward(a)


@as_grid_ufunc(signature="(X:left)->(X:inner)")
def diff_left_to_inner(a):
    # declared but unimplemented, as in the reference (gridops.py:69-71)
    raise NotImplementedError


# -- interp -----------------------------------------------------------------


@as_grid_ufunc(signature="(X:center)->(X:left)", boundary_width={"X": (1, 0)})
def interp_center_to_left(a):
    return interp_forward(a)


@as_grid_ufunc(signature="(X:left)->(X:center)", boundary_width={"X": (0, 1)})
def interp_left_to_center(a):
    return interp_forward(a)


@as_grid_ufunc(signature="(X:center)->(X:right)", boundary_width={"X": (0, 1)})
def interp_center_to_right(a):
    return interp_forward(a)


@as_grid_ufunc(signature="(X:right)->(X:center)", boundary_width={"X": (1, 0)})
def interp_right_to_center(a):
    return interp_forward(a)


@as_grid_ufunc(signature="(X:center)->(X:outer)", boundary_width={"X": (1, 1)})
def interp_center_to_outer(a):
    return interp_forward(a)


@as_grid_ufunc(signature="(X:outer)->(X:center)", boundary_width={"X": (0, 0)})
def interp_outer_to_center(a):
    return interp_forward(a)


@as_grid_ufunc(signature="(X:center)->(X:inner)", boundary_width={"X": (0, 0)})
def interp_center_to_inner(a):
    return interp_forward(a)


@as_grid_ufunc(signature="(X:inner)->(X:center)", boundary_width={"X": (1, 1)})
def interp_inner_to_center(a):
    return interp_forward(a)


# -- min --------------------------------------------------------------------


@as_grid_ufunc(signature="(X:center)->(X:left)", boundary_width={"X": (1, 0)})
def min_center_to_left(a):
    return pairwise_min(a)


@as_grid_ufunc(signature="(X:left)->(X:center)", boundary_width={"X": (0, 1)})
def min_left_to_center(a):
    return pairwise_min(a)


@as_grid_ufunc(signature="(X:center)->(X:right)", boundary_width={"X": (0, 1)})
def min_center_to_right(a):
    return pairwise_min(a)


@as_grid_ufunc(signature="(X:right)->(X:center)", boundary_width={"X": (1, 0)})
def min_right_to_center(a):
    return pairwise_min(a)


@as_grid_ufunc(signature="(X:center)->(X:outer)", boundary_width={"X": (1, 1)})
def min_center_to_outer(a):
    return pairwise_min(a)


@as_grid_ufunc(signature="(X:outer)->(X:center)", boundary_width={"X": (0, 0)})
def min_outer_to_center(a):
    return pairwise_min(a)


@as_grid_ufunc(signature="(X:center)->(X:inner)", boundary_width={"X": (0, 0)})
def min_center_to_inner(a):
    return pairwise_min(a)


@as_grid_ufunc(signature="(X:inner)->(X:center)", boundary_width={"X": (1, 1)})
def min_inner_to_center(a):
    return pairwise_min(a)


# -- max --------------------------------------------------------------------


@as_grid_ufunc(signature="(X:center)->(X:left)", boundary_width={"X": (1, 0)})
def max_center_to_left(a):
    return pairwise_max(a)


@as_grid_ufunc(signature="(X:left)->(X:center)", boundary_width={"X": (0, 1)})
def max_left_to_center(a):
    return pairwise_max(a)


@as_grid_ufunc(signature="(X:center)->(X:right)", boundary_width={"X": (0, 1)})
def max_center_to_right(a):
    return pairwise_max(a)


@as_grid_ufunc(signature="(X:right)->(X:center)", boundary_width={"X": (1, 0)})
def max_right_to_center(a):
    return pairwise_max(a)


@as_grid_ufunc(signature="(X:center)->(X:outer)", boundary_width={"X": (1, 1)})
def max_center_to_outer(a):
    return pairwise_max(a)


@as_grid_ufunc(signature="(X:outer)->(X:center)", boundary_width={"X": (0, 0)})
def max_outer_to_center(a):
    return pairwise_max(a)


@as_grid_ufunc(signature="(X:center)->(X:inner)", boundary_width={"X": (0, 0)})
def max_center_to_inner(a):
    return pairwise_max(a)


@as_grid_ufunc(signature="(X:inner)->(X:center)", boundary_width={"X": (1, 1)})
def max_inner_to_center(a):
    return pairwise_max(a)


# -- cumsum -----------------------------------------------------------------


@as_grid_ufunc(
    signature="(X:center)->(X:left)",
    boundary_width={"X": (1, 0)},
    fill_value=0,
    pad_before_func=False,
)
def cumsum_center_to_left(a):
    return cumsum_trim_last(a)


@as_grid_ufunc(signature="(X:left)->(X:center)", boundary_width={"X": (0, 0)})
def cumsum_left_to_center(a):
    return cumsum_full(a)


@as_grid_ufunc(signature="(X:center)->(X:right)", boundary_width={"X": (0, 0)})
def cumsum_center_to_right(a):
    return cumsum_full(a)


@as_grid_ufunc(
    signature="(X:right)->(X:center)",
    boundary_width={"X": (1, 0)},
    fill_value=0,
    pad_before_func=False,
)
def cumsum_right_to_center(a):
    return cumsum_trim_last(a)


@as_grid_ufunc(
    signature="(X:center)->(X:outer)",
    boundary_width={"X": (1, 0)},
    fill_value=0,
    pad_before_func=False,
)
def cumsum_center_to_outer(a):
    return cumsum_full(a)


@as_grid_ufunc(signature="(X:outer)->(X:center)", boundary_width={"X": (0, 0)})
def cumsum_outer_to_center(a):
    return cumsum_trim_last(a)


@as_grid_ufunc(signature="(X:center)->(X:inner)", boundary_width={"X": (0, 0)})
def cumsum_center_to_inner(a):
    return cumsum_trim_last(a)


@as_grid_ufunc(
    signature="(X:inner)->(X:center)",
    boundary_width={"X": (1, 0)},
    fill_value=0,
    pad_before_func=False,
)
def cumsum_inner_to_center(a):
    return cumsum_full(a)
