"""The face-connection plan: a static per-edge table of where each face's
halo strips come from, and the one rule that builds kernel E's halo line
from it.

The port's own copy of ``FaceHaloPlan`` and ``compile_face_plan`` from
:mod:`xgcm_tpu.parallel.face_sharded`, and the one plan compiler of the
port.  The Grid keeps the plan as :class:`DeviceFacePlan` tensors once per
device (``Grid._face_plan``), and both routes of kernel E build their halo
lines from it with :func:`face_halo_lines`, taking :func:`basic_edge_line`
on unconnected edges: the fused face path (``ops/fused.py``) for every
face at once, the face-sharded route (``parallel/face_sharded.py``) for
the faces of each block, on a plan with rows for the dummy faces beyond
the grid's.  Only the face-sharded engine's wider halos read the numpy
plan on the host.

Side codes: 0 = X-left, 1 = X-right, 2 = Y-left, 3 = Y-right.  The rules
reproduce the halo assembly of ``core/padding._pad_face_connections``:

* the halo is taken from the source face's side that is the right edge iff
  ``connection.reverse == is_right_edge``;
* the tangential direction flips iff the connection swaps axes and is not
  reversed;
* vector sign: the component parallel to the padded axis is negated on
  reverse; the other component on swap-without-reverse.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, NamedTuple, Optional

import numpy as np
import torch

if TYPE_CHECKING:
    from .grid import Grid

__all__ = [
    "DeviceFacePlan",
    "FaceHaloPlan",
    "basic_edge_line",
    "compile_face_plan",
    "face_halo_lines",
]


class FaceHaloPlan:
    """Static per-face halo parameters, (n_faces, 4) numpy arrays."""

    def __init__(self, n_faces: int):
        shape = (n_faces, 4)
        self.connected = np.zeros(shape, dtype=bool)
        self.src_face = np.zeros(shape, dtype=np.int32)
        self.src_side = np.zeros(shape, dtype=np.int32)
        self.tang_flip = np.zeros(shape, dtype=bool)
        self.sign_ortho = np.ones(shape, dtype=np.float32)  # for the || component
        self.sign_tang = np.ones(shape, dtype=np.float32)  # for the perp component
        self.swap = np.zeros(shape, dtype=bool)


def compile_face_plan(grid: "Grid", x_axis: str, y_axis: str,
                      n_faces_total: Optional[int] = None) -> FaceHaloPlan:
    """Compile the face-connection table into a static per-edge plan.

    ``x_axis``/``y_axis`` name the two grid axes spanning each face (the
    side codes 0/1 belong to ``x_axis``, 2/3 to ``y_axis``); a connection
    along any other axis raises ``KeyError``.  ``n_faces_total`` sizes the
    plan beyond the grid's face count: the extra rows are unconnected dummy
    faces (the face-sharded route rounds the face dim up to a multiple of
    its mesh axis with them).
    """
    facedim = grid._facedim
    connections = grid._face_connections[facedim]
    n_faces = grid._ds.dims[facedim]
    plan = FaceHaloPlan(max(n_faces, n_faces_total or 0))

    axis_code = {x_axis: 0, y_axis: 1}
    for f in range(n_faces):
        face_links = connections.get(f, {})
        for axname, (left_conn, right_conn) in face_links.items():
            a = axis_code[axname]
            for conn, is_right in ((left_conn, False), (right_conn, True)):
                if conn is None:
                    continue
                src, src_axis, reverse = conn
                side = a * 2 + (1 if is_right else 0)
                swap = src_axis != axname
                src_is_right = reverse == is_right
                plan.connected[f, side] = True
                plan.src_face[f, side] = src
                plan.src_side[f, side] = axis_code[src_axis] * 2 + (
                    1 if src_is_right else 0
                )
                plan.tang_flip[f, side] = swap and not reverse
                plan.swap[f, side] = swap
                plan.sign_ortho[f, side] = -1.0 if reverse else 1.0
                plan.sign_tang[f, side] = -1.0 if (swap and not reverse) else 1.0
    return plan


class DeviceFacePlan(NamedTuple):
    """A :class:`FaceHaloPlan` as (F, 4) tensors on one device; the Grid
    keeps one per (x axis, y axis, device, row count) so that no op copies
    the plan from the host."""

    connected: torch.Tensor
    src_face: torch.Tensor
    src_side: torch.Tensor
    tang_flip: torch.Tensor
    swap: torch.Tensor
    sign_ortho: torch.Tensor
    sign_tang: torch.Tensor

    @classmethod
    def from_plan(cls, plan: FaceHaloPlan, device) -> "DeviceFacePlan":
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


def basic_edge_line(b: torch.Tensor, side: int, boundary: Optional[str],
                    fill_value: float = 0.0, *, doubled: bool = False) -> torch.Tensor:
    """The one-wide halo line beyond side ``side`` of (..., ny, nx) blocks
    under a basic boundary condition, the side's axis dropped: the line
    ``core/padding._pad_axis`` pads there, read from at most two edge lines
    (a view of ``b`` for periodic and extend).

    ``doubled`` extrapolates as 2 x0 - x1, the fused single-device path's
    rounding (JAX's fused path's), where the pad's is x0 - (x1 - x0) (the
    face-sharded route's, as JAX's pre-pad); in float32 the two may differ
    in the last place."""
    axis = -1 if side < 2 else -2
    n = b.shape[axis]
    before = side % 2 == 0
    edge = b.select(axis, 0 if before else n - 1)
    if boundary in ("periodic", None):
        return b.select(axis, n - 1 if before else 0)
    if boundary == "fill":
        return torch.full_like(edge, fill_value)
    if boundary == "extend":
        return edge
    if boundary == "extrapolate":
        # narrow, as the pad does: a length-1 axis has no inward line after
        # its first, and the last's wraps onto the edge
        inward = b.narrow(axis, 1 if before else n - 2, 1).squeeze(axis)
        return 2.0 * edge - inward if doubled else edge - (inward - edge)
    raise ValueError(f"unknown boundary {boundary!r}")


def face_halo_lines(strips: torch.Tensor, plan: DeviceFacePlan, rows: slice, side: int,
                    length: int, basic: Callable[[], torch.Tensor], *,
                    partner: Optional[torch.Tensor] = None,
                    vector_axis_code: Optional[int] = None,
                    seg: slice = slice(None)) -> torch.Tensor:
    """Kernel E's (..., k, n) halo lines beyond side ``side`` of the k
    faces ``rows`` of ``plan``, as a new contiguous tensor.

    ``strips`` is the (..., F, 4, L) table of every face's four one-wide
    edge lines (X-left, X-right, Y-left, Y-right, each in increasing
    tangential coordinate); ``partner`` the partner component's table,
    read on axis-swapping connections.  A connected edge's line is the
    strip the plan names, cut to the tangential ``length``, flipped where
    the plan says, its part ``seg`` kept and, for a vector component
    (``vector_axis_code`` 0 for the x-axis one, 1 for the y-axis one),
    signed; an unconnected edge's is ``basic()``, (..., k, n), made last.
    Every choice is a ``torch.where``, an exact gather or a product by
    +-1, so NaN and infinities reach exactly the cells the generic engine
    gives them."""
    src_face, src_side = plan.src_face[rows, side], plan.src_side[rows, side]
    picked = strips[..., src_face, src_side, :]
    if partner is not None:
        # the partner's gathered lines in place of its table, which a
        # caller may hand over to be freed here
        partner = partner[..., src_face, src_side, :].to(picked.dtype)
        picked = torch.where(plan.swap[rows, side, None], partner, picked)
    picked = picked[..., :length]
    picked = torch.where(plan.tang_flip[rows, side, None], picked.flip(-1), picked)[..., seg]
    if vector_axis_code is not None:
        # sides 0/1 are x-axis halos, 2/3 y-axis halos
        sign = plan.sign_ortho if vector_axis_code == side // 2 else plan.sign_tang
        picked = picked * sign[rows, side, None].to(picked.dtype)
    return torch.where(plan.connected[rows, side, None], picked, basic()).contiguous()
