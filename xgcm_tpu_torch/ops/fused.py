"""Fused fast path for the hot 1D shift stencils.

``op(x, shift(x))`` with the one wrapped edge line fixed up in place of a
padded intermediate: bit-identical to the generic pad-then-stencil path for
every length-preserving position pair.  Eager PyTorch does not fuse the roll
and the select the way XLA does, so on the card this path is the shift
kernel (``csrc/shift.cu``) itself; a CPU tensor takes its plain version, the
roll formulation.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.dataarray import as_tensor
from .kernels.shift import shift

__all__ = ["fused_shift_op", "FUSABLE_PAIRS", "FUSABLE_OPS"]

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
