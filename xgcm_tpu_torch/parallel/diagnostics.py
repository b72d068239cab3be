"""Sharded C-grid diagnostics: one halo round for ζ, div and KE.

The counterpart of :mod:`xgcm_tpu.parallel.diagnostics`: relative
vorticity, divergence and kinetic energy of a C-grid velocity field with
each input exchanging its halo once (u: x-right + y-left, v: x-left +
y-right), where the equivalent chain of sharded ops pays six rounds:

    zeta = diff(v, X) - diff(u, Y)             # corners  (yg, xg)
    div  = diff(u, X, to=c) + diff(v, Y, to=c) # centers  (yc, xc)
    ke   = (interp(u, X, to=c)^2 + interp(v, Y, to=c)^2) / 2

The stencils are torch ops on the padded blocks, in the JAX formula's
order of operations, as JAX's are ``jnp``: kernel B wraps periodically
and takes no halo.  Results equal the sequential sharded ops and the
single-device Grid ops.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

from ..core.dataarray import GriddedArray
from ..core.grid import Grid
from .collectives import map_blocks, shard_map, unzip
from .halo import pad_axis_local_or_ring
from .mesh import Mesh, partition_spec

__all__ = ["sharded_cgrid_diagnostics"]


def sharded_cgrid_diagnostics(
    grid: Grid,
    u: GriddedArray,
    v: GriddedArray,
    mesh: Mesh,
    dim_to_mesh_axis: Mapping[str, str],
    x_axis: str = "X",
    y_axis: str = "Y",
    boundary: Optional[str] = None,
    fill_value: Optional[float] = None,
) -> Tuple[GriddedArray, GriddedArray, GriddedArray]:
    """(zeta, div, ke) of a C-grid velocity field, with one halo round.

    ``u`` must sit at (y-center, x-left) and ``v`` at (y-left, x-center),
    the standard C-grid staggering.  Returns zeta at the corners, div and
    ke at the centers, each equal to the corresponding chain of
    ShardedGrid/Grid ops.
    """
    if grid._face_connections is not None:
        raise NotImplementedError(
            "sharded_cgrid_diagnostics uses ring halos, which cannot serve "
            "face-connected boundaries; batch the ops through "
            "ShardedGrid.apply_many on face grids instead"
        )
    ax_x = grid.axes[x_axis]
    ax_y = grid.axes[y_axis]
    u_xpos, u_xdim = ax_x._get_position_name(u)
    u_ypos, u_ydim = ax_y._get_position_name(u)
    v_xpos, v_xdim = ax_x._get_position_name(v)
    v_ypos, v_ydim = ax_y._get_position_name(v)
    if (u_xpos, u_ypos) != ("left", "center") or (v_xpos, v_ypos) != ("center", "left"):
        raise ValueError(
            "sharded_cgrid_diagnostics expects C-grid staggering: u at "
            f"(y:center, x:left), v at (y:left, x:center); got u at "
            f"(y:{u_ypos}, x:{u_xpos}), v at (y:{v_ypos}, x:{v_xpos})"
        )

    bc = grid._complete_user_kwargs_using_axis_defaults(boundary, "boundary")
    fv = grid._complete_user_kwargs_using_axis_defaults(fill_value, "fill_value")
    bcx, bcy = bc[x_axis], bc[y_axis]
    fvx, fvy = float(fv[x_axis]), float(fv[y_axis])

    xc, xg = ax_x.coords["center"], ax_x.coords["left"]
    yc, yg = ax_y.coords["center"], ax_y.coords["left"]

    mesh_x = dim_to_mesh_axis.get(u_xdim) or dim_to_mesh_axis.get(v_xdim)
    mesh_y = dim_to_mesh_axis.get(u_ydim) or dim_to_mesh_axis.get(v_ydim)

    # canonical layout (..., y, x)
    rest = [d for d in u.dims if d not in (u_ydim, u_xdim)]
    u_arr = u.transpose(*rest, u_ydim, u_xdim)
    v_arr = v.transpose(*rest, v_ydim, v_xdim)
    ya, xa = u_arr.ndim - 2, u_arr.ndim - 1

    full_map = dict(dim_to_mesh_axis)
    for d_from, d_to in ((u_xdim, v_xdim), (u_ydim, v_ydim)):
        m = dim_to_mesh_axis.get(d_from) or dim_to_mesh_axis.get(d_to)
        if m is not None:
            full_map[d_from] = m
            full_map[d_to] = m

    u_spec = partition_spec(u_arr.dims, full_map)
    v_spec = partition_spec(v_arr.dims, full_map)
    zeta_dims = tuple(rest) + (yg, xg)
    cen_dims = tuple(rest) + (yc, xc)
    zeta_spec = partition_spec(zeta_dims, full_map)
    cen_spec = partition_spec(cen_dims, full_map)

    def stencils(up, vp):
        dvdx = vp[..., :-1, 1:] - vp[..., :-1, :-1]  # (yg, xg)
        dudy = up[..., 1:, :-1] - up[..., :-1, :-1]  # (yg, xg)
        zeta = dvdx - dudy
        dudx = up[..., 1:, 1:] - up[..., 1:, :-1]  # (yc, xc)
        dvdy = vp[..., 1:, 1:] - vp[..., :-1, 1:]  # (yc, xc)
        div = dudx + dvdy
        u_c = 0.5 * (up[..., 1:, 1:] + up[..., 1:, :-1])
        v_c = 0.5 * (vp[..., 1:, 1:] + vp[..., :-1, 1:])
        ke = 0.5 * (u_c * u_c + v_c * v_c)
        return zeta, div, ke

    def local(ub, vb):
        # ONE halo round: the four exchanges of both inputs
        up = pad_axis_local_or_ring(ub, xa, (0, 1), mesh, mesh_x, bcx, fvx)  # u[:, 0..nx]
        up = pad_axis_local_or_ring(up, ya, (1, 0), mesh, mesh_y, bcy, fvy)  # u[-1.., :]
        vp = pad_axis_local_or_ring(vb, xa, (1, 0), mesh, mesh_x, bcx, fvx)  # v[:, -1..nx)
        vp = pad_axis_local_or_ring(vp, ya, (0, 1), mesh, mesh_y, bcy, fvy)  # v[0..ny, :]
        return tuple(unzip(map_blocks(stencils, up, vp, mesh=mesh), 3))

    zeta, div, ke = shard_map(local, mesh, (u_spec, v_spec), (zeta_spec, cen_spec, cen_spec))(
        u_arr.data, v_arr.data
    )
    return (
        GriddedArray(zeta, zeta_dims, name="zeta"),
        GriddedArray(div, cen_dims, name="div"),
        GriddedArray(ke, cen_dims, name="ke"),
    )
