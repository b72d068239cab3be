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

from typing import NamedTuple, Optional

import torch

from ..core.dataarray import as_tensor
from ..utils.profiling import span
from .kernels.face_shift import face_shift
from .kernels.shift import shift

__all__ = [
    "DeviceFacePlan",
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


class DeviceFacePlan(NamedTuple):
    """A :class:`~xgcm_tpu_torch.core.topology.FaceHaloPlan` as (F, 4)
    tensors on one device; the Grid keeps one per (x axis, y axis, device)
    so that no op copies the plan from the host."""

    connected: torch.Tensor
    src_face: torch.Tensor
    src_side: torch.Tensor
    tang_flip: torch.Tensor
    swap: torch.Tensor
    sign_ortho: torch.Tensor
    sign_tang: torch.Tensor

    @classmethod
    def from_plan(cls, plan, device) -> "DeviceFacePlan":
        def on(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return cls(
            connected=on(plan.connected),
            src_face=on(plan.src_face, torch.int64),
            src_side=on(plan.src_side, torch.int64),
            tang_flip=on(plan.tang_flip),
            swap=on(plan.swap),
            sign_ortho=on(plan.sign_ortho),
            sign_tang=on(plan.sign_tang),
        )


def _edge_strips(x: torch.Tensor) -> torch.Tensor:
    """The (..., F, 4, L) table of the four one-wide edge lines of square
    (..., F, L, L) faces: X-left, X-right, Y-left, Y-right, each in
    increasing tangential coordinate.  Columns are plain strided slices."""
    return torch.stack([x[..., :, 0], x[..., :, -1], x[..., 0, :], x[..., -1, :]], dim=-2)


def _inward_line(x: torch.Tensor, side: int) -> torch.Tensor:
    """The line one inward of ``side``, as a (..., F, L) strip."""
    ny, nx = x.shape[-2:]
    return (x[..., :, 1], x[..., :, nx - 2], x[..., 1, :], x[..., ny - 2, :])[side]


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

    The halo of each face's one wrapped edge line is the neighbour strip the
    plan names (gathered from the (..., F, 4, L) edge table, flipped, and
    for vector components signed, reading the partner component's strips
    on axis-swapping connections), or the basic boundary condition on an
    unconnected edge; kernel E then computes op(x, neighbour) in one pass.
    ``vector_axis_code`` is 0 for the x-axis component, 1 for the y-axis
    one.  Every choice is a ``torch.where`` or an exact gather, so NaN and
    infinities reach exactly the cells the generic engine gives them.
    """
    with span("xtt.face_halo.gather"):
        x = as_tensor(x).contiguous()
        if axis_is_x:
            side = 0 if direction == "left" else 1
        else:
            side = 2 if direction == "left" else 3
        strips = _edge_strips(x)  # (..., F, 4, L)

        src_face, src_side = plan.src_face[:, side], plan.src_side[:, side]
        picked = strips[..., src_face, src_side, :]  # (..., F, L)
        if partner is not None:
            # axis-swapping connections read the PARTNER component's edge
            picked_p = _edge_strips(as_tensor(partner))[..., src_face, src_side, :]
            picked = torch.where(plan.swap[:, side, None], picked_p.to(x.dtype), picked)
        picked = torch.where(plan.tang_flip[:, side, None], picked.flip(-1), picked)
        if vector_axis_code is not None:
            # sides 0/1 are x-axis halos, 2/3 y-axis halos; the sign is +-1,
            # so the product is exact
            sign = plan.sign_ortho if vector_axis_code == side // 2 else plan.sign_tang
            picked = picked * sign[:, side, None].to(x.dtype)

        # the basic boundary condition on unconnected edges
        opposite = {0: 1, 1: 0, 2: 3, 3: 2}[side]
        if boundary in ("periodic", None):
            basic = strips[..., opposite, :]
        elif boundary == "fill":
            basic = torch.full_like(strips[..., side, :], fill_value)
        elif boundary == "extend":
            basic = strips[..., side, :]
        elif boundary == "extrapolate":
            basic = 2.0 * strips[..., side, :] - _inward_line(x, side)
        else:
            raise ValueError(f"unknown boundary {boundary!r}")

        halo = torch.where(plan.connected[:, side, None], picked, basic).contiguous()
    return face_shift(x, halo, op, direction, axis_is_x)
