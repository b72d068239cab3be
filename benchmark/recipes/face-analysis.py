"""The face analysis of one LLC level (``examples/llc_analysis.py``).

∂θ/∂x and ∂θ/∂y, vorticity and divergence through ``Grid.diff`` with
``other_component``, and the 2-D vector interpolation to the centres, on
``grids.llc_grid`` with its 13 face connections: each call a
length-preserving pair, so each launches the face-shift kernel (E) once,
with its halo strips gathered from the neighbour faces.
"""

import warnings

from benchmark.roofline import stencil_work

LAUNCHES = {"face_shift": 8}


def setup(xtt, sizes, inputs, device):
    _, grid = xtt.grids.llc_grid(n=sizes["nx"])
    return {
        "grid": grid,
        "theta": xtt.GriddedArray(inputs["theta"], ("face", "y", "x"), name="theta"),
        "u": xtt.GriddedArray(inputs["u"], ("face", "y", "xl"), name="u"),
        "v": xtt.GriddedArray(inputs["v"], ("face", "yl", "x"), name="v"),
    }


def step(xtt, s, span):
    grid, t, gu, gv = s["grid"], s["theta"], s["u"], s["v"]
    with span("grid.diff"):
        dtheta_dx = grid.diff(t, "X")  # (face, y, xl)
    with span("grid.diff"):
        dtheta_dy = grid.diff(t, "Y")  # (face, yl, x)
    with span("grid.diff"):
        a = grid.diff({"X": gv}, "X", other_component={"Y": gu})
    with span("grid.diff"):
        b = grid.diff({"Y": gu}, "Y", other_component={"X": gv})
    with span("arith"):
        zeta = a - b  # (face, yl, xl)
    del a, b
    with span("grid.diff"):
        a = grid.diff({"X": gu}, "X", other_component={"Y": gv})
    with span("grid.diff"):
        b = grid.diff({"Y": gv}, "Y", other_component={"X": gu})
    with span("arith"):
        div = a + b  # (face, y, x)
    del a, b
    with span("grid.interp_2d_vector"), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        vec = grid.interp_2d_vector({"X": gu, "Y": gv}, to="center")
    return {"dtheta_dx": dtheta_dx.data, "dtheta_dy": dtheta_dy.data, "zeta": zeta.data,
            "div": div.data, "u_c": vec["X"].data, "v_c": vec["Y"].data}


def kernel_work(shapes):
    """{kernel: [(bytes, operations) per launch]} of one step: x in, the
    result out and the halo line (one per face and row) in."""
    faces, ny, nx = shapes["theta"]
    return {"face_shift": [stencil_work(faces * ny * nx, halo_points=faces * ny)] * 8}
