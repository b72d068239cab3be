"""Kernel E: the per-face shift stencil of the face-connected fast path
(``csrc/face_shift.cu``) and its plain PyTorch version.

``face_shift`` computes ``op(x, neighbour)`` along the x (last) or y
(second-to-last) axis of ``(..., F, ny, nx)`` faces, where the one wrapped
edge line of each face is the caller's ``halo`` strip: ``(..., F, ny)`` for
an x-axis op, ``(..., F, nx)`` for a y-axis op.  Its ``axis=`` form takes
any axis of any array, with the halo line ``x.shape`` less that axis: the
ring route of the sharded layer (``parallel/halo.py``) passes a block and
the neighbour shard's edge line.  A CPU tensor takes the plain version,
:func:`face_shift_plain` (the concat formulation that ends
``xgcm_tpu.ops.fused.fused_face_shift_op``); a CUDA tensor launches the
kernel or raises.  Gradients run through the plain version.  :data:`ROUTES`
counts the kernel's launches by the route it took.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..stencils import apply_pair
from ...utils.profiling import span
from . import build
from .shift import _DIRECTIONS, _OPS, SHIFT_DTYPES

__all__ = ["ROUTES", "face_shift", "face_shift_plain"]

# Launches of the kernel by the route its C entry took and reported: "rows"
# (the roll axis is the last) and "planes" (it is not) in 16-byte vectors,
# "scalar" for a view the vectors cannot take.
ROUTES = {"rows": 0, "planes": 0, "scalar": 0}
_ROUTE_NAMES = ("rows", "planes", "scalar")  # the codes of csrc/face_shift.cu


def _resolve_axis(x: torch.Tensor, axis_is_x: Optional[bool], axis: Optional[int]) -> int:
    if (axis is None) == (axis_is_x is None):
        raise TypeError("face shift takes one of axis_is_x and axis")
    if axis is None:
        if x.ndim < 2:
            raise ValueError(f"face shift needs (..., ny, nx) faces, got {tuple(x.shape)}")
        return x.ndim - 1 if axis_is_x else x.ndim - 2
    if x.ndim < 1:
        raise ValueError("face shift needs at least one axis")
    return axis % x.ndim


def face_shift_plain(
    x: torch.Tensor, halo: torch.Tensor, op: str, direction: str,
    axis_is_x: Optional[bool] = None, *, axis: Optional[int] = None,
) -> torch.Tensor:
    """The concat formulation: the shifted neighbour is the halo line
    joined to x without its far edge line."""
    axis = _resolve_axis(x, axis_is_x, axis)
    n = x.shape[axis]
    h = halo.unsqueeze(axis)
    nb = (torch.cat([h, x.narrow(axis, 0, n - 1)], axis) if direction == "left"
          else torch.cat([x.narrow(axis, 1, n - 1), h], axis))
    if direction == "left":
        return apply_pair(op, nb, x)
    return apply_pair(op, x, nb)


@span("xtt.kernels.face_shift")
def face_shift(
    x: torch.Tensor, halo: torch.Tensor, op: str, direction: str,
    axis_is_x: Optional[bool] = None, *, axis: Optional[int] = None,
) -> torch.Tensor:
    """``op(x, neighbour)`` per face (``axis_is_x``) or along ``axis``:
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors
    (contiguous x and halo of one dtype, float16, bfloat16, float32 or
    float64)."""
    if op not in _OPS or direction not in _DIRECTIONS:
        raise ValueError(f"unsupported face shift: op={op!r} direction={direction!r}")
    axis = _resolve_axis(x, axis_is_x, axis)
    want = (*x.shape[:axis], *x.shape[axis + 1:])
    if tuple(halo.shape) != want:
        raise ValueError(f"halo must be {want} for these faces, got {tuple(halo.shape)}")
    if x.device.type == "cpu":
        return face_shift_plain(x, halo, op, direction, axis=axis)

    build.require_cuda(x, halo)
    if x.dtype not in SHIFT_DTYPES or halo.dtype != x.dtype:
        raise TypeError(f"face shift kernel takes x and halo of one dtype in "
                        f"{SHIFT_DTYPES}, got {x.dtype}, {halo.dtype}")
    if not (x.is_contiguous() and halo.is_contiguous()):
        raise ValueError("face shift kernel needs contiguous x and halo")
    n = int(x.shape[axis])
    inner = math.prod(x.shape[axis + 1:])
    outer = math.prod(x.shape[:axis])

    def launch(x, halo):
        out = torch.empty_like(x)
        route = ctypes.c_int(-1)
        build.launch(
            "xt_face_shift", x.device,
            x.data_ptr(), halo.data_ptr(), out.data_ptr(), build.DTYPE_CODES[x.dtype],
            outer, n, inner, _OPS[op], _DIRECTIONS[direction], ctypes.byref(route),
        )
        build.LAUNCHES["face_shift"] += 1
        if route.value >= 0:
            ROUTES[_ROUTE_NAMES[route.value]] += 1
        return out

    def plain(x, halo):
        return face_shift_plain(x, halo, op, direction, axis=axis)

    return build.autograd_launch(launch, plain, x, halo)
