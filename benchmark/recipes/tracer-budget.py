"""The tracer budget of one face (``examples/tracer_budget.py``).

The advective flux divergence of θ by (u, v, w) through ``Grid.interp``,
``Grid.get_metric`` and ``Grid.diff`` (six launches of the shift kernel,
A), the cell volumes, the tendency −div/vol, and the closure's two volume
integrals through ``Grid.integrate``.  Each intermediate is dropped once it
is used, as the example's own memory-frugal form does.  The grid is
``build_grid`` of the example: dx/dy/dz metrics at both positions of each
axis (float32, as LLC4320's grid files), X and Y periodic, Z filled with 0.
"""

import warnings

import numpy as np
import torch

from benchmark.roofline import stencil_work

LAUNCHES = {"shift": 6}


def metrics(nx, ny, nz):
    """The example's metrics, float32 host arrays."""
    f32 = np.float32
    return {
        "dx_c": (1.0 + 0.1 * np.sin(np.arange(nx))).astype(f32),
        "dx_g": (1.0 + 0.1 * np.sin(np.arange(nx) - 0.5)).astype(f32),
        "dy_c": (1.0 + 0.05 * np.cos(np.arange(ny))).astype(f32),
        "dy_g": (1.0 + 0.05 * np.cos(np.arange(ny) - 0.5)).astype(f32),
        "dz_c": (1.0 + 0.2 * np.arange(nz) / nz).astype(f32),
        "dz_g": (1.0 + 0.2 * (np.arange(nz) - 0.5) / nz).astype(f32),
    }


def setup(xtt, sizes, inputs, device):
    nx, ny, nz = sizes["nx"], sizes["ny"], sizes["nz"]
    m = metrics(nx, ny, nz)
    ds = xtt.Dataset(coords={
        "xc": ("xc", np.arange(nx) + 0.5), "xg": ("xg", np.arange(nx) * 1.0),
        "yc": ("yc", np.arange(ny) + 0.5), "yg": ("yg", np.arange(ny) * 1.0),
        "zc": ("zc", np.arange(nz) + 0.5), "zg": ("zg", np.arange(nz) * 1.0),
        "dx_c": ("xc", m["dx_c"]), "dx_g": ("xg", m["dx_g"]),
        "dy_c": ("yc", m["dy_c"]), "dy_g": ("yg", m["dy_g"]),
        "dz_c": ("zc", m["dz_c"]), "dz_g": ("zg", m["dz_g"]),
    })
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        grid = xtt.Grid(
            ds,
            coords={"X": {"center": "xc", "left": "xg"}, "Y": {"center": "yc", "left": "yg"},
                    "Z": {"center": "zc", "left": "zg"}},
            boundary={"X": "periodic", "Y": "periodic", "Z": "fill"},
            fill_value=0.0,
            metrics={("X",): ["dx_c", "dx_g"], ("Y",): ["dy_c", "dy_g"],
                     ("Z",): ["dz_c", "dz_g"]},
            autoparse_metadata=False,
        )
    # the metrics go to the reference as the same values, as tensors
    for k, a in m.items():
        inputs[k] = torch.as_tensor(a, device=device)
    return {
        "grid": grid,
        "theta": xtt.GriddedArray(inputs["theta"], ("zc", "yc", "xc")),
        "u": xtt.GriddedArray(inputs["u"], ("zc", "yc", "xg")),
        "v": xtt.GriddedArray(inputs["v"], ("zc", "yg", "xc")),
        "w": xtt.GriddedArray(inputs["w"], ("zg", "yc", "xc")),
    }


def step(xtt, s, span):
    grid, theta, u, v, w = s["grid"], s["theta"], s["u"], s["v"], s["w"]
    # the tracer on the three face families, times the transport and the
    # face area from the metric registry
    with span("grid.interp"):
        th_x = grid.interp(theta, "X")
    with span("grid.get_metric"):
        area = grid.get_metric(th_x, ("Y", "Z"))
    with span("arith"):
        fx = u * th_x * area
    del th_x, area
    with span("grid.interp"):
        th_y = grid.interp(theta, "Y")
    with span("grid.get_metric"):
        area = grid.get_metric(th_y, ("X", "Z"))
    with span("arith"):
        fy = v * th_y * area
    del th_y, area
    with span("grid.interp"):
        th_z = grid.interp(theta, "Z", boundary="extend")
    with span("grid.get_metric"):
        area = grid.get_metric(th_z, ("X", "Y"))
    with span("arith"):
        fz = w * th_z * area
    del th_z, area
    # divergence back on the centres; the vertical fill_value=0 is the
    # closed budget's "no flux through the surface and bottom"
    with span("grid.diff"):
        d = grid.diff(fx, "X", to="center")
    del fx
    with span("grid.diff"):
        dy = grid.diff(fy, "Y", to="center")
    del fy
    with span("arith"):
        div = d + dy
    del d, dy
    with span("grid.diff"):
        dz = grid.diff(fz, "Z", to="center")
    del fz
    with span("arith"):
        div = div + dz
    del dz
    with span("grid.get_metric"):
        vol = grid.get_metric(theta, ("X", "Y", "Z"))
    with span("arith"):
        tendency = -div / vol
    with span("grid.integrate"):
        total = grid.integrate(tendency, ["X", "Y", "Z"])
    with span("arith"):
        mag = abs(tendency)
    with span("grid.integrate"):
        scale = grid.integrate(mag, ["X", "Y", "Z"])
    del mag
    return {"div": div.data, "vol": vol.transpose("zc", "yc", "xc").data,
            "tendency": tendency.data, "total": total.data, "scale": scale.data}


def kernel_work(shapes):
    """{kernel: [(bytes, operations) per launch]} of one step: three
    interps and three diffs over (nz, ny, nx)."""
    nz, ny, nx = shapes["theta"]
    return {"shift": [stencil_work(nz * ny * nx)] * 6}
