"""The face analysis of a slab of LLC levels, face-sharded over four cards.

The eight calls of ``recipes/face-analysis.py`` (∂θ/∂x, ∂θ/∂y, vorticity
and divergence through ``diff`` with ``other_component``, the 2-D vector
interpolation to the centres) on (z, face, y, x) fields, through a
``ShardedGrid`` whose face dim lies over a mesh ``{"f": 4}``: the 13 faces
are 4 a card, the last card's block 1 real face and 3 dummy ones.  Each
call launches the face-shift kernel (E) once a block, with the halo strips
of the faces on other cards gathered across the cards; the results stay
sharded.  On a card the mesh is ``cuda:0``-``cuda:3`` (one process drives
the four cards); on the CPU four logical shards.
"""

import warnings

from benchmark.roofline import stencil_work

SHARDS = 4
LAUNCHES = {"face_shift": 8 * SHARDS}


def mesh_devices(device):
    """The mesh's devices: the first four cards from ``device`` on, or four
    logical shards of the CPU."""
    import torch

    if device.type == "cuda":
        first = device.index or 0
        return [torch.device("cuda", first + i) for i in range(SHARDS)]
    return [device] * SHARDS


def setup(xtt, sizes, inputs, device):
    from xgcm_tpu_torch import parallel as par

    _, grid = xtt.grids.llc_grid(n=sizes["nx"])
    mesh = par.make_mesh({"f": SHARDS}, devices=mesh_devices(device))
    sgrid = par.ShardedGrid(grid, mesh, {"face": "f"})
    return {
        "grid": sgrid,
        "devices": [d for d in mesh.devices.flat if d.type == "cuda"],
        "theta": sgrid.shard(xtt.GriddedArray(inputs["theta"], ("z", "face", "y", "x"),
                                              name="theta")),
        "u": sgrid.shard(xtt.GriddedArray(inputs["u"], ("z", "face", "y", "xl"), name="u")),
        "v": sgrid.shard(xtt.GriddedArray(inputs["v"], ("z", "face", "yl", "x"), name="v")),
    }


def step(xtt, s, span):
    import torch

    grid, t, gu, gv = s["grid"], s["theta"], s["u"], s["v"]
    with span("grid.diff"):
        dtheta_dx = grid.diff(t, "X")  # (z, face, y, xl)
    with span("grid.diff"):
        dtheta_dy = grid.diff(t, "Y")  # (z, face, yl, x)
    with span("grid.diff"):
        a = grid.diff({"X": gv}, "X", other_component={"Y": gu})
    with span("grid.diff"):
        b = grid.diff({"Y": gu}, "Y", other_component={"X": gv})
    with span("arith"):
        zeta = a - b  # (z, face, yl, xl)
    del a, b
    with span("grid.diff"):
        a = grid.diff({"X": gu}, "X", other_component={"Y": gv})
    with span("grid.diff"):
        b = grid.diff({"Y": gv}, "Y", other_component={"X": gu})
    with span("arith"):
        div = a + b  # (z, face, y, x)
    del a, b
    with span("grid.interp_2d_vector"), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        vec = grid.interp_2d_vector({"X": gu, "Y": gv}, to="center")
    for d in s["devices"]:  # the step ends once every card has finished
        torch.cuda.synchronize(d)
    return {"dtheta_dx": dtheta_dx.data, "dtheta_dy": dtheta_dy.data, "zeta": zeta.data,
            "div": div.data, "u_c": vec["X"].data, "v_c": vec["Y"].data}


def kernel_work(shapes):
    """{kernel: [(bytes, operations) per launch]} of one step: E on every
    block of ``fpd`` face slots (the dummy ones included) and every level,
    x in, the result out and the halo line (one per face slot, level and
    row) in; 8 ops x 4 blocks."""
    nz, faces, ny, nx = shapes["theta"]
    fpd = -(-faces // SHARDS)
    block = stencil_work(nz * fpd * ny * nx, halo_points=nz * fpd * ny)
    return {"face_shift": [block] * (8 * SHARDS)}
