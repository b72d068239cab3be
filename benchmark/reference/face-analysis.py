"""Plain reference of the face analysis of one LLC level, in plain PyTorch.

Each face is a (y, x) square of side L.  A two-point op along X or Y takes
one line beyond the face's edge, its halo.  Across an edge that
``llc_connections.json`` connects (``[neighbour, axis, reverse]``), the halo
is the neighbour's edge line along ``axis``: its right edge when the
connection is not reversed and the edge is a left one (and the reverse),
read in the opposite tangential order where the two faces' axes differ and
the connection is not reversed.  A vector component parallel to the edge's
axis changes sign across a reversed connection; the other component
changes sign where the axes differ and the connection is not reversed, and
there the halo is read from the partner component, which lies along the
neighbour's axis.  An edge with no connection takes the grid's boundary
condition, ``fill`` with 0.

The analysis: ∂θ/∂x and ∂θ/∂y to the left faces, ζ = ∂v/∂x - ∂u/∂y and
div = ∂u/∂x + ∂v/∂y with v and u as the X and Y components (as the example
passes them), and u, v interpolated to the centres.
"""

import json
import pathlib

import torch

from benchmark.precision import give, take

CONNECTIONS = json.loads((pathlib.Path(__file__).with_name("llc_connections.json"))
                         .read_text())["face"]
SIDES = {0: ("X", False), 1: ("X", True), 2: ("Y", False), 3: ("Y", True)}
SIDE_OF = {("X", False): 0, ("X", True): 1, ("Y", False): 2, ("Y", True): 3}
FILL = 0.0


def edge_line(face, side):
    """The edge line of a (y, x) face: X-left and X-right columns, Y-left
    and Y-right rows, each in increasing tangential order."""
    return (face[:, 0], face[:, -1], face[0, :], face[-1, :])[side]


def halo(arr, f, side, component=None, partner=None):
    """The line beyond ``side`` of face f of ``arr`` (faces, y, x); a vector
    component names the axis it lies along and its partner array."""
    axis, is_right = SIDES[side]
    conn = CONNECTIONS[str(f)].get(axis, [None, None])[int(is_right)]
    if conn is None:
        return torch.full_like(arr[f][0], FILL)
    src, src_axis, reverse = conn
    swap = src_axis != axis
    src_right = reverse == is_right
    source = partner if (swap and partner is not None) else arr
    line = edge_line(source[src], SIDE_OF[(src_axis, src_right)])
    if swap and not reverse:
        line = line.flip(0)
    if component is not None:
        flip_sign = reverse if component == axis else (swap and not reverse)
        if flip_sign:
            line = -line
    return line


def left(face, h, x_axis):
    """The neighbour below each cell (the halo before the first)."""
    if x_axis:
        return torch.cat([h[:, None], face[:, :-1]], 1)
    return torch.cat([h[None, :], face[:-1, :]], 0)


def right(face, h, x_axis):
    """The neighbour above each cell (the halo after the last)."""
    if x_axis:
        return torch.cat([face[:, 1:], h[:, None]], 1)
    return torch.cat([face[1:, :], h[None, :]], 0)


def blocks(inputs, precision):
    def t(a):
        return take(a, precision)

    th, u, v = (inputs[k] for k in ("theta", "u", "v"))
    for f in range(th.shape[0]):
        # halos are read from whole arrays; each face's arithmetic in the
        # reference's precision
        tf, uf, vf = t(th[f]), t(u[f]), t(v[f])
        yield "dtheta_dx", (f,), give(tf - left(tf, t(halo(th, f, 0)), True), precision)
        yield "dtheta_dy", (f,), give(tf - left(tf, t(halo(th, f, 2)), False), precision)
        a = vf - left(vf, t(halo(v, f, 0, "X", u)), True)
        b = uf - left(uf, t(halo(u, f, 2, "Y", v)), False)
        yield "zeta", (f,), give(a - b, precision)
        a = right(uf, t(halo(u, f, 1, "X", v)), True) - uf
        b = right(vf, t(halo(v, f, 3, "Y", u)), False) - vf
        yield "div", (f,), give(a + b, precision)
        yield "u_c", (f,), give(0.5 * (uf + right(uf, t(halo(u, f, 1, "X", v)), True)),
                                precision)
        yield "v_c", (f,), give(0.5 * (vf + right(vf, t(halo(v, f, 3, "Y", u)), False)),
                                precision)
