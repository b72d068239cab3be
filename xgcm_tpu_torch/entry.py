"""The C-grid analysis step: the port's main path.

``step(u, v, theta, targets)`` is the computation of the flagship workload
of the JAX package (``__graft_entry__.entry``): C-grid vorticity,
divergence and kinetic energy through the Grid API, then the kinetic energy
remapped onto theta surfaces per column.  On CUDA tensors it runs the shift
kernel (four diffs and two interps) and the linear-interpolation kernel.

``dryrun_multichip(n_shards)`` runs one sharded program per route of
:mod:`xgcm_tpu_torch.parallel` on tiny shapes, each against the
single-device call (the counterpart of ``__graft_entry__.dryrun_multichip``
for its routes 1, 2, 3, 4 and 6).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .core.dataarray import GriddedArray
from .core.dataset import Dataset
from .core.grid import Grid
from .ops.transform import interp_1d_linear
from .utils.profiling import span

__all__ = ["build_grid", "dryrun_multichip", "step"]


def build_grid(nx: int, ny: int) -> Grid:
    """A doubly periodic C-grid with centers xc, yc and left faces xg, yg."""
    ds = Dataset(
        coords={
            "xc": ("xc", np.arange(nx, dtype=np.float32)),
            "xg": ("xg", np.arange(nx, dtype=np.float32)),
            "yc": ("yc", np.arange(ny, dtype=np.float32)),
            "yg": ("yg", np.arange(ny, dtype=np.float32)),
        }
    )
    return Grid(
        ds,
        coords={
            "X": {"center": "xc", "left": "xg"},
            "Y": {"center": "yc", "left": "yg"},
        },
        autoparse_metadata=False,
    )


@span("xtt.grid_api.entry_step")
def step(
    u: torch.Tensor,
    v: torch.Tensor,
    theta: torch.Tensor,
    targets: torch.Tensor,
    grid: Optional[Grid] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(zeta, div, ke_on_theta) for u on (yc, xg), v on (yg, xc), both
    (ny, nx), and theta (ny, nx, nz) with a monotone column per point;
    ``targets`` (m,) are the theta levels.  ``grid`` defaults to
    :func:`build_grid` of u's shape."""
    ny, nx = u.shape
    nz = theta.shape[-1]
    if grid is None:
        grid = build_grid(nx, ny)
    uu = GriddedArray(u, ("yc", "xg"))
    vv = GriddedArray(v, ("yg", "xc"))
    zeta = grid.diff(vv, "X") - grid.diff(uu, "Y")  # corners
    div = grid.diff(uu, "X", to="center") + grid.diff(vv, "Y", to="center")
    u_c = grid.interp(uu, "X", to="center")
    v_c = grid.interp(vv, "Y", to="center")
    ke = 0.5 * (u_c * u_c + v_c * v_c)
    # vertical transform of KE onto theta surfaces (per column)
    ke_cols = ke.data[..., None].expand(ny, nx, nz)
    ke_on_theta = interp_1d_linear(ke_cols, theta, targets, mask_edges=False)
    return zeta.data, div.data, ke_on_theta


def dryrun_multichip(n_shards: int, devices=None) -> None:
    """Make an n-shard mesh and run one sharded program per route on tiny
    shapes, each checked against the single-device call: the ring-halo diff
    (kernel E per block on the card), the sharded cumsum, the face-sharded
    vector diff and the dummy-padded 13-face LLC diff (kernel E per block),
    a batch of a diff and an interp of one cubed-sphere field in one
    ``sharded_apply_many`` (the gridops ufuncs on padded blocks), and the
    per-shard ``transform_multi`` (kernel F per block).
    ``devices`` defaults to ``n_shards`` logical shards on the default
    device; raises on a mismatch."""
    from .core import gridops
    from .core.device import get_default_device
    from .grids import cubed_sphere_grid, llc_grid
    from .parallel import (
        ShardedGrid,
        make_mesh,
        shard_gridded,
        sharded_apply_many,
        sharded_cumsum,
        sharded_face_op,
        sharded_op,
    )

    if devices is None:
        devices = [get_default_device()] * n_shards
    # 2D mesh when possible: batch data-parallel axis x spatial axis
    if n_shards % 2 == 0 and n_shards > 2:
        mesh_axes = {"b": 2, "x": n_shards // 2}
    else:
        mesh_axes = {"b": 1, "x": n_shards}
    mesh = make_mesh(mesh_axes, devices=devices)
    dev = mesh.devices.flat[0]

    n_x = 8 * mesh_axes["x"]
    n_b = 4 * mesh_axes["b"]
    ny = 8
    grid = build_grid(n_x, ny)
    rng = np.random.RandomState(0)
    da = GriddedArray(rng.rand(n_b, ny, n_x).astype(np.float32), ("batch", "yc", "xc"),
                      device=dev)
    spec = {"batch": "b", "xc": "x"}
    sharded = shard_gridded(da, mesh, spec)

    def check(got, want, rtol, what):
        np.testing.assert_allclose(got.values, want.values, rtol=rtol, err_msg=what)

    # route 1: spatial domain decomposition + ring halo exchange, with the
    # batch dim data-parallel on the second mesh axis
    d = sharded_op(grid, "diff", sharded, "X", mesh, spec, boundary="periodic")
    check(d, grid.diff(da, "X", boundary="periodic"), 1e-5, "ring halo diff")

    # route 2: distributed prefix sum with position shift
    c = sharded_cumsum(grid, sharded, "X", mesh, spec, to="left", boundary="fill")
    check(c, grid.cumsum(da, "X", to="left", boundary="fill"), 1e-4, "sharded cumsum")

    # route 3: the face-sharded topology.  On 8+ shards the face x rows x
    # cols decomposition with a vector diff (cross-face halos, ring halos
    # on both in-face dims, partner strips, the rotate/flip/sign rules);
    # on fewer, faces-per-shard blocks, dummy-padded where 6 % n != 0
    if n_shards >= 8:
        face_mesh = make_mesh({"f3": 2, "r3": 2, "c3": 2}, devices=devices)
        face_spec = {"face": "f3", "y": "r3", "yl": "r3", "x": "c3", "xl": "c3"}
        shard_spec = {"face": "f3", "y": "r3", "x": "c3"}
    else:
        nf = min(6, max(1, n_shards))
        face_mesh = make_mesh({"f3": nf}, devices=devices)
        face_spec = shard_spec = {"face": "f3"}
    _, grid_cs = cubed_sphere_grid(n=8)
    sgrid_cs = ShardedGrid(grid_cs, face_mesh, face_spec)
    u4 = GriddedArray(rng.rand(6, 8, 8).astype(np.float32), ("face", "y", "x"), name="u",
                      device=dev)
    v4 = GriddedArray(rng.rand(6, 8, 8).astype(np.float32), ("face", "y", "x"), name="v",
                      device=dev)
    u4s = shard_gridded(u4, face_mesh, shard_spec, uneven_ok=("face",))
    v4s = shard_gridded(v4, face_mesh, shard_spec, uneven_ok=("face",))
    vec = sgrid_cs.diff({"X": u4s}, "X", other_component={"Y": v4s}, boundary="fill")
    check(vec, grid_cs.diff({"X": u4}, "X", other_component={"Y": v4}, boundary="fill"), 1e-5,
          "face-sharded vector diff")

    # route 4: the 13-face LLC over every shard, dummy-padded where
    # 13 % n_shards != 0
    _, grid_llc = llc_grid(n=8)
    llc_mesh = make_mesh({"f": n_shards}, devices=devices)
    llc_field = GriddedArray(rng.rand(13, 8, 8).astype(np.float32), ("face", "y", "x"),
                             device=dev)
    llc_out = sharded_face_op(grid_llc, "diff", llc_field, "Y", llc_mesh, "f", "X", "Y",
                              boundary="fill")
    check(llc_out, grid_llc.diff(llc_field, "Y", boundary="fill"), 1e-5,
          "LLC-13 dummy-padded diff")

    # route 5: a batch of ops as one shard program, one shared halo
    # exchange for a diff along X and an interp along Y of one field
    f5 = GriddedArray(rng.rand(6, 8, 8).astype(np.float32), ("face", "y", "x"), name="c",
                      device=dev)
    sh5 = shard_gridded(f5, face_mesh, shard_spec, uneven_ok=("face",))
    specs = [dict(func=op.ufunc, args=[sh5], axis=[(axis,)], signature=op.signature,
                  boundary_width=op.boundary_width, boundary="fill")
             for op, axis in ((gridops.diff_center_to_left, "X"),
                              (gridops.interp_center_to_left, "Y"))]
    b_diff, b_interp = sharded_apply_many(specs, grid=grid_cs, mesh=face_mesh,
                                          dim_to_mesh_axis=face_spec)
    check(b_diff, grid_cs.diff(f5, "X", boundary="fill"), 1e-5, "apply_many diff X")
    check(b_interp, grid_cs.interp(f5, "Y", boundary="fill"), 1e-5, "apply_many interp Y")

    # route 6: multi-variable vertical transform, per shard, the columns
    # sharded across the mesh
    ds_z = Dataset(coords={"zc": ("zc", np.arange(6, dtype=np.float32))})
    grid_z = Grid(ds_z, coords={"Z": {"center": "zc"}}, periodic=False,
                  autoparse_metadata=False)
    sgrid_z = ShardedGrid(grid_z, mesh, {"col": "x"})
    ncol = 8 * mesh_axes["x"]
    sig = GriddedArray(np.sort(rng.rand(ncol, 6).astype(np.float32), -1), ("col", "zc"),
                       name="sigma", device=dev)
    tvars = [GriddedArray(rng.rand(ncol, 6).astype(np.float32), ("col", "zc"), name=f"q{i}",
                          device=dev) for i in range(2)]
    tgt = np.linspace(0.2, 0.8, 4).astype(np.float32)
    outs = sgrid_z.transform_multi(
        [shard_gridded(t, mesh, {"col": "x"}) for t in tvars], "Z", tgt,
        target_data=shard_gridded(sig, mesh, {"col": "x"}), target_dim="sigma",
        mask_edges=False,
    )
    for o, t in zip(outs, tvars):
        check(o, grid_z.transform(t, "Z", tgt, target_data=sig, target_dim="sigma",
                                  mask_edges=False), 1e-5, "per-shard transform_multi")
