"""Fused fast paths for the hot 1D shift stencils.

``op(x, shift(x))`` with the one wrapped edge line fixed up in place of a
padded intermediate: bit-identical to the generic pad-then-stencil path for
every length-preserving position pair.  Eager PyTorch does not fuse the roll
and the select the way XLA does, so on the card each path is a kernel:

* :func:`fused_shift_op`, face-less grids: the shift kernel
  (``csrc/shift.cu``, A);
* :func:`fused_face_shift_op`, face-connected grids: the per-face shift
  kernel (``csrc/face_shift.cu``, E), whose wrapped edge line per face is a
  halo strip gathered from the neighbour faces by the compiled face plan.

A CPU tensor takes the kernels' plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.dataarray import as_tensor
from ..core.topology import DeviceFacePlan, basic_edge_line, face_halo_lines
from ..utils.profiling import span
from .kernels.face_shift import face_shift
from .kernels.shift import shift

__all__ = [
    "fused_face_shift_op",
    "fused_shift_op",
    "FUSABLE_PAIRS",
    "FUSABLE_OPS",
]

# (from_pos, to_pos) -> neighbour direction, for length-preserving shifts.
# "left": out[i] = op(x[i-1], x[i]);  "right": out[i] = op(x[i], x[i+1]).
FUSABLE_PAIRS = {
    ("center", "left"): "left",
    ("right", "center"): "left",
    ("left", "center"): "right",
    ("center", "right"): "right",
}

FUSABLE_OPS = ("diff", "interp", "min", "max")


def fused_shift_op(
    x,
    axis: int,
    op: str,
    direction: str,
    boundary: Optional[str],
    fill_value: float = 0.0,
) -> torch.Tensor:
    """op(x, neighbour) along ``axis`` with the boundary condition applied
    to the wrapped edge line (periodic/None, fill, extend, extrapolate)."""
    return shift(as_tensor(x).contiguous(), axis, op, direction, boundary, fill_value)


def _edge_strips(x: torch.Tensor) -> torch.Tensor:
    """The (..., F, 4, L) table of the four one-wide edge lines of square
    (..., F, L, L) faces: X-left, X-right, Y-left, Y-right, each in
    increasing tangential coordinate.  Columns are plain strided slices."""
    return torch.stack([x[..., :, 0], x[..., :, -1], x[..., 0, :], x[..., -1, :]], dim=-2)


def fused_face_shift_op(
    x,
    plan: DeviceFacePlan,
    axis_is_x: bool,
    op: str,
    direction: str,
    boundary: Optional[str],
    fill_value: float = 0.0,
    partner: Optional[torch.Tensor] = None,
    vector_axis_code: Optional[int] = None,
) -> torch.Tensor:
    """Face-connected 1D shift stencil on square (..., F, L, L) faces
    without padded intermediates.

    Each face's one wrapped edge line is built from the (..., F, 4, L)
    edge table by the plan's rule (:func:`~xgcm_tpu_torch.core.topology.face_halo_lines`,
    reading the partner component's table on axis-swapping connections), or
    is the basic boundary condition on an unconnected edge; kernel E then
    computes op(x, neighbour) in one pass.  ``vector_axis_code`` is 0 for
    the x-axis component, 1 for the y-axis one.
    """
    with span("xtt.face_halo.gather"):
        x = as_tensor(x).contiguous()
        side = (0 if direction == "left" else 1) + (0 if axis_is_x else 2)
        halo = face_halo_lines(
            _edge_strips(x), plan, slice(None), side, x.shape[-1],
            lambda: basic_edge_line(x, side, boundary, fill_value, doubled=True),
            partner=None if partner is None else _edge_strips(as_tensor(partner)),
            vector_axis_code=vector_axis_code,
        )
    return face_shift(x, halo, op, direction, axis_is_x)
