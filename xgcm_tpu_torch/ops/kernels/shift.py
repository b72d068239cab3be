"""Kernel A: the fused 1D shift stencil (``csrc/shift.cu``) and its plain
PyTorch version.

``shift`` computes ``op(x, neighbour)`` along one axis with the boundary
condition applied to the one wrapped edge line.  A CPU tensor takes the
plain version, :func:`shift_plain` (the roll formulation of
``xgcm_tpu.ops.fused.fused_shift_op``); a CUDA tensor launches the kernel
or raises, whatever its alignment and widths (the kernel has a scalar
route for those).  Gradients run through the plain version; a tensor that
needs none goes straight to the launch, past autograd.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..stencils import apply_pair
from ...utils.profiling import span
from . import build

__all__ = ["shift", "shift_plain", "SHIFT_DTYPES"]

SHIFT_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16)
_OPS = {"diff": 0, "interp": 1, "min": 2, "max": 3}
_DIRECTIONS = {"left": 0, "right": 1}
_BCS = {"periodic": 0, None: 0, "fill": 1, "extend": 2, "extrapolate": 3}


def shift_plain(
    x: torch.Tensor,
    axis: int,
    op: str,
    direction: str,
    boundary: Optional[str],
    fill_value: float = 0.0,
) -> torch.Tensor:
    """The roll formulation: roll by one, fix the wrapped edge line with a
    ``where``, then apply the 2-point op."""
    n = x.shape[axis]
    if direction == "left":
        nb = torch.roll(x, 1, dims=axis)
        edge = 0
    else:
        nb = torch.roll(x, -1, dims=axis)
        edge = n - 1

    if boundary in ("fill", "extend", "extrapolate"):
        shape = [1] * x.ndim
        shape[axis] = n
        at_edge = (torch.arange(n, device=x.device) == edge).reshape(shape)
        if boundary == "fill":
            fill = torch.tensor(fill_value, dtype=x.dtype, device=x.device)
            nb = torch.where(at_edge, fill, nb)
        elif boundary == "extend":
            nb = torch.where(at_edge, x, nb)
        else:
            # linear: one cell beyond the edge is 2*edge - next-inward
            inward = torch.roll(x, -1 if direction == "left" else 1, dims=axis)
            nb = torch.where(at_edge, 2.0 * x - inward, nb)
    # periodic / None: the roll already wraps

    if direction == "left":
        return apply_pair(op, nb, x)
    return apply_pair(op, x, nb)


@span("xtt.kernels.shift")
def shift(
    x: torch.Tensor,
    axis: int,
    op: str,
    direction: str,
    boundary: Optional[str],
    fill_value: float = 0.0,
) -> torch.Tensor:
    """``op(x, neighbour)`` along ``axis``: the plain version for a CPU
    tensor, the CUDA kernel for a CUDA tensor (contiguous, float16,
    bfloat16, float32 or float64)."""
    if op not in _OPS or direction not in _DIRECTIONS or boundary not in _BCS:
        raise ValueError(
            f"unsupported shift: op={op!r} direction={direction!r} boundary={boundary!r}"
        )
    axis = axis % x.ndim
    if x.device.type == "cpu":
        return shift_plain(x, axis, op, direction, boundary, fill_value)

    build.require_cuda(x)
    if x.dtype not in SHIFT_DTYPES:
        raise TypeError(f"shift kernel takes {SHIFT_DTYPES}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("shift kernel needs a contiguous tensor")

    def launch(x):
        out = torch.empty_like(x)
        build.launch(
            "xt_shift", x.device, x.data_ptr(), out.data_ptr(), build.DTYPE_CODES[x.dtype],
            math.prod(x.shape[:axis]), x.shape[axis], math.prod(x.shape[axis + 1:]),
            _OPS[op], _DIRECTIONS[direction], _BCS[boundary], float(fill_value),
        )
        build.LAUNCHES["shift"] += 1
        return out

    def plain(x):
        return shift_plain(x, axis, op, direction, boundary, fill_value)

    return build.autograd_launch(launch, plain, x)
