"""The density-space analysis of one face (``examples/density_transform.py``).

Three calls on a grid with one vertical axis (centres and bounds): one
field into the density classes (``Grid.transform``, conservative: kernel
G), the four fields T, S, u, v into the same classes
(``Grid.transform_multi``, conservative: kernel H), and the four onto the
density levels (``Grid.transform_multi``, linear: kernel F).
"""

import numpy as np

from benchmark.roofline import conservative_work, linear_work

LAUNCHES = {"conservative": 1, "conservative_multi": 1, "interp_linear_multi": 1}
FIELDS = ("T", "S", "u", "v")


def setup(xtt, sizes, inputs, device):
    nz = sizes["nz"]
    ds = xtt.Dataset(coords={"zc": ("zc", np.arange(nz) + 0.5),
                             "zo": ("zo", np.arange(nz + 1.0))})
    grid = xtt.Grid(ds, coords={"Z": {"center": "zc", "outer": "zo"}}, periodic=False,
                    autoparse_metadata=False)
    return {
        "grid": grid,
        "das": [xtt.GriddedArray(inputs[f], ("y", "x", "zc"), name=f) for f in FIELDS],
        "sb": xtt.GriddedArray(inputs["sigma_b"], ("y", "x", "zo"), name="sigma"),
        "sc": xtt.GriddedArray(inputs["sigma_c"], ("y", "x", "zc"), name="sigma"),
        "edges": inputs["edges"],
        "levels": inputs["levels"],
    }


def step(xtt, s, span):
    grid, das = s["grid"], s["das"]
    out = {}
    with span("grid.transform.conservative"):
        g = grid.transform(das[0], "Z", s["edges"], target_data=s["sb"], method="conservative")
    out["G_T"] = g.data
    with span("grid.transform_multi.conservative"):
        h = grid.transform_multi(das, "Z", s["edges"], target_data=s["sb"],
                                 method="conservative")
    out.update({f"H_{f}": o.data for f, o in zip(FIELDS, h)})
    with span("grid.transform_multi.linear"):
        lin = grid.transform_multi(das, "Z", s["levels"], target_data=s["sc"])
    out.update({f"F_{f}": o.data for f, o in zip(FIELDS, lin)})
    return out


def kernel_work(shapes):
    """{kernel: [(bytes, operations) per launch]} of one step."""
    ny, nx, nz = shapes["T"]
    cols, m_edges, m_levels = ny * nx, shapes["edges"][0], shapes["levels"][0]
    return {
        "conservative": [conservative_work(cols, 1, nz, m_edges)],
        "conservative_multi": [conservative_work(cols, len(FIELDS), nz, m_edges)],
        "interp_linear_multi": [linear_work(cols, len(FIELDS), nz, m_levels)],
    }
