"""The face-connection plan: a static per-edge table of where each face's
halo strips come from.

The port's own copy of ``FaceHaloPlan`` and ``compile_face_plan`` from
:mod:`xgcm_tpu.parallel.face_sharded`, and the one plan compiler of the
port: the fused face path (``ops/fused.py``) turns the plan into device
tensors once per device and gathers the halo strips with it; the
face-sharded route (``parallel/face_sharded.py``) reads it on the host,
per face and side, with rows for dummy faces beyond the grid's.

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

from typing import TYPE_CHECKING, Optional

import numpy as np

if TYPE_CHECKING:
    from .grid import Grid

__all__ = ["FaceHaloPlan", "compile_face_plan"]


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
