"""Kernel E: the per-face shift stencil of the face-connected fast path
(``csrc/face_shift.cu``) and its plain PyTorch version.

``face_shift`` computes ``op(x, neighbour)`` along the x (last) or y
(second-to-last) axis of ``(..., F, ny, nx)`` faces, where the one wrapped
edge line of each face is the caller's ``halo`` strip: ``(..., F, ny)`` for
an x-axis op, ``(..., F, nx)`` for a y-axis op.  A CPU tensor takes the
plain version, :func:`face_shift_plain` (the concat formulation that ends
``xgcm_tpu.ops.fused.fused_face_shift_op``); a CUDA tensor launches the
kernel or raises.  Gradients run through the plain version.
"""

from __future__ import annotations

import torch

from ..stencils import apply_pair
from . import build
from .shift import _DIRECTIONS, _OPS, SHIFT_DTYPES

__all__ = ["face_shift", "face_shift_plain"]


def face_shift_plain(
    x: torch.Tensor, halo: torch.Tensor, op: str, direction: str, axis_is_x: bool
) -> torch.Tensor:
    """The concat formulation: the shifted neighbour is the halo line
    joined to x without its far edge line."""
    if axis_is_x:
        h = halo.unsqueeze(-1)
        nb = (torch.cat([h, x[..., :, :-1]], -1) if direction == "left"
              else torch.cat([x[..., :, 1:], h], -1))
    else:
        h = halo.unsqueeze(-2)
        nb = (torch.cat([h, x[..., :-1, :]], -2) if direction == "left"
              else torch.cat([x[..., 1:, :], h], -2))
    if direction == "left":
        return apply_pair(op, nb, x)
    return apply_pair(op, x, nb)


def face_shift(
    x: torch.Tensor, halo: torch.Tensor, op: str, direction: str, axis_is_x: bool
) -> torch.Tensor:
    """``op(x, neighbour)`` per face: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (contiguous x and halo of one dtype,
    float16, bfloat16, float32 or float64)."""
    if op not in _OPS or direction not in _DIRECTIONS:
        raise ValueError(f"unsupported face shift: op={op!r} direction={direction!r}")
    if x.ndim < 2:
        raise ValueError(f"face shift needs (..., ny, nx) faces, got {tuple(x.shape)}")
    ny, nx = x.shape[-2:]
    want = (*x.shape[:-2], ny if axis_is_x else nx)
    if tuple(halo.shape) != want:
        raise ValueError(f"halo must be {want} for these faces, got {tuple(halo.shape)}")
    if x.device.type == "cpu":
        return face_shift_plain(x, halo, op, direction, axis_is_x)

    build.require_cuda(x, halo)
    if x.dtype not in SHIFT_DTYPES or halo.dtype != x.dtype:
        raise TypeError(f"face shift kernel takes x and halo of one dtype in "
                        f"{SHIFT_DTYPES}, got {x.dtype}, {halo.dtype}")
    if not (x.is_contiguous() and halo.is_contiguous()):
        raise ValueError("face shift kernel needs contiguous x and halo")
    n = int(nx if axis_is_x else ny)
    inner = 1 if axis_is_x else int(nx)
    outer = x.numel() // (n * inner) if x.numel() else 0

    def launch(x, halo):
        out = torch.empty_like(x)
        status = build.load_library().xt_face_shift(
            x.data_ptr(), halo.data_ptr(), out.data_ptr(), build.DTYPE_CODES[x.dtype],
            outer, n, inner, _OPS[op], _DIRECTIONS[direction], build.stream_ptr(x.device),
        )
        build.check_status("xt_face_shift", status)
        build.LAUNCHES["face_shift"] += 1
        return out

    def plain(x, halo):
        return face_shift_plain(x, halo, op, direction, axis_is_x)

    return build.PlainBackward.apply(launch, plain, x, halo)
