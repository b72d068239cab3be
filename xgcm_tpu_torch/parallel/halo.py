"""Explicit halo exchange over a device mesh: ring halos between blocks.

The counterpart of :mod:`xgcm_tpu.parallel.halo`: the spatial dimension is
split over a mesh axis, each step exchanges a halo of fixed width with the
ring neighbours (:func:`~.collectives.ppermute`), and the stencil runs on
the local block.  Global boundary conditions apply only where a halo
element lies outside the domain, per element:

* periodic — nothing special: the ring *is* the periodic boundary;
* fill     — the element becomes ``fill_value``;
* extend / extrapolate — from the global edge pair, gathered with two
  ``all_gather`` of one or two lines a shard.

Every shardable position shift has a halo one element wide on one side
(:data:`_SHARDABLE_WIDTHS`), so the built-in ops' local stencil is kernel
E's ``op(x, neighbour)`` with the received edge line as the halo
(:func:`ring_shift`): one read and one write of the block instead of a
concatenate and a difference.  Only length-preserving position pairs
(center/left/right) may shift along a sharded dim; inner/outer change the
array length and break the uniform-shard invariant.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.dataarray import GriddedArray
from ..core.grid import Grid
from ..ops.kernels.face_shift import face_shift
from ..ops.kernels.shift import SHIFT_DTYPES
from ..ops.stencils import _UNSIGNED_WIDE, apply_pair, cumsum, wrapping
from .collectives import all_gather, coords, first_local, map_blocks, ppermute, shard_map
from .mesh import Mesh, partition_spec

__all__ = ["ring_halo_pad", "ring_shift", "sharded_op", "sharded_cumsum"]

# position pairs that keep the array length (shardable), with their pad widths
_SHARDABLE_WIDTHS = {
    ("center", "left"): (1, 0),
    ("left", "center"): (0, 1),
    ("center", "right"): (0, 1),
    ("right", "center"): (1, 0),
}
_RING_BOUNDARIES = ("periodic", None, "fill", "extend", "extrapolate")


def _scalar(value, dtype, device) -> torch.Tensor:
    """``jnp.asarray(value, dtype)``: a Python number cast to dtype."""
    return torch.as_tensor(value, dtype=torch.float64).to(dtype=dtype, device=device)


def ring_halos(blocks: np.ndarray, axis: int, widths: Tuple[int, int], mesh: Mesh,
               mesh_axis: str, boundary: Optional[str], fill_value: float = 0.0):
    """(left halos, right halos), object arrays of the mesh's shape (None
    where the width is 0): the halo strips of ``widths`` along ``axis`` of
    every block, from the ring neighbours along ``mesh_axis``.

    Halos wider than one shard come from as many ring neighbours as they
    need, each neighbour's strip sliced first and shipped with one
    ppermute, so the traffic is exactly the halo.  Halo elements outside
    the global domain take the boundary condition."""
    lw, rw = widths
    first = first_local(blocks)
    axis = axis % first.ndim
    n_local = first.shape[axis]
    n = mesh.shape[mesh_axis]
    # on a single shard the periodic halo is a local wrap (self-permute),
    # valid at any width; multi-shard periodic halos must fit the rest of
    # the ring
    if n > 1 and max(lw, rw) > n_local * (n - 1) and boundary in ("periodic", None):
        raise ValueError(
            f"halo width {max(lw, rw)} exceeds the rest of the periodic "
            f"domain ({n_local * (n - 1)} elements on {n} shards)"
        )
    if boundary not in _RING_BOUNDARIES:
        raise ValueError(f"unknown boundary {boundary!r}")
    ax = mesh.axis_index(mesh_axis)
    n_total = n * n_local

    if boundary in ("extend", "extrapolate"):
        # the global first two and last two lines, on every shard: min(2,
        # n_local) lines a shard gathered in global order, since on
        # one-element shards the edge pair spans two shards
        k = min(2, n_local)
        firsts = all_gather(map_blocks(lambda b: b.narrow(axis, 0, k), blocks, mesh=mesh),
                            mesh, mesh_axis, axis=axis, tiled=True)
        lasts = all_gather(map_blocks(lambda b: b.narrow(axis, n_local - k, k), blocks,
                                      mesh=mesh), mesh, mesh_axis, axis=axis, tiled=True)

    def multi_hop(direction):
        w = lw if direction < 0 else rw
        hops = -(-w // n_local)
        strips = []
        for h in range(1, hops + 1):
            # the distance-h neighbour contributes w_h elements: full
            # blocks for the near hops, the remainder from the farthest
            w_h = min(n_local, w - (h - 1) * n_local)
            start = n_local - w_h if direction < 0 else 0
            part = map_blocks(lambda b, s=start, m=w_h: b.narrow(axis, s, m), blocks, mesh=mesh)
            perm = [(i, (i - direction * h) % n) for i in range(n)]
            part = ppermute(part, mesh, mesh_axis, perm)
            if direction < 0:
                strips.insert(0, part)
            else:
                strips.append(part)
        if len(strips) == 1:
            return strips[0]
        return map_blocks(lambda *s: torch.cat(s, dim=axis), *strips, mesh=mesh)

    def pos(w, c, offset):
        shape = [1] * first.ndim
        shape[axis] = w
        dev = mesh.devices[c]
        return (torch.arange(w, device=dev) + offset).reshape(shape)

    def apply_bc(halo, c, gpos, outside, side):
        if boundary == "fill":
            return torch.where(outside, _scalar(fill_value, halo.dtype, halo.device), halo)
        # uint16/32/64 select and extrapolate as the signed ints of their
        # width: the same bits, wrapping as JAX's unsigned arithmetic does
        dtype = halo.dtype
        halo, edges = wrapping(halo), wrapping((firsts if side < 0 else lasts)[c])
        size = edges.shape[axis]
        if boundary == "extrapolate" and dtype == torch.bool:
            raise TypeError("extrapolate is not defined for boolean data (as jnp.subtract)")
        if side < 0:
            x0 = edges.narrow(axis, 0, 1)
            if boundary == "extend":
                return torch.where(outside, x0, halo).view(dtype)
            x1 = edges.narrow(axis, min(1, size - 1), 1)
            return torch.where(outside, x0 + gpos.to(halo.dtype) * (x1 - x0), halo).view(dtype)
        xn = edges.narrow(axis, size - 1, 1)
        if boundary == "extend":
            return torch.where(outside, xn, halo).view(dtype)
        xm = edges.narrow(axis, max(size - 2, 0), 1)
        ks = (gpos - (n_total - 1)).to(halo.dtype)
        return torch.where(outside, xn + ks * (xn - xm), halo).view(dtype)

    # global positions of the halo elements: c*n_local - lw + j on the
    # left, (c + 1)*n_local + j on the right; only the shards whose halo
    # reaches past an edge change
    left = right = None
    if lw:
        left = multi_hop(-1)
        if boundary not in ("periodic", None):
            for c in coords(mesh):
                if c[ax] * n_local - lw < 0:
                    gpos = pos(lw, c, c[ax] * n_local - lw)
                    left[c] = apply_bc(left[c], c, gpos, gpos < 0, -1)
    if rw:
        right = multi_hop(+1)
        if boundary not in ("periodic", None):
            for c in coords(mesh):
                if (c[ax] + 1) * n_local + rw > n_total:
                    gpos = pos(rw, c, (c[ax] + 1) * n_local)
                    right[c] = apply_bc(right[c], c, gpos, gpos >= n_total, +1)
    return left, right


def ring_halo_pad(blocks: np.ndarray, axis: int, widths: Tuple[int, int], mesh: Mesh,
                  mesh_axis: str, boundary: Optional[str],
                  fill_value: float = 0.0) -> np.ndarray:
    """Every block padded with ``widths[0]`` halo elements before and
    ``widths[1]`` after along ``axis``, from the ring neighbours along
    ``mesh_axis`` (see :func:`ring_halos`)."""
    lw, rw = widths
    if lw == 0 and rw == 0:
        return blocks
    axis = axis % first_local(blocks).ndim
    left, right = ring_halos(blocks, axis, widths, mesh, mesh_axis, boundary, fill_value)
    out = np.empty(blocks.shape, dtype=object)
    for c in coords(mesh):
        out[c] = torch.cat([p[c] for p in (left, blocks, right) if p is not None], dim=axis)
    return out


def pad_axis_local_or_ring(blocks: np.ndarray, axis: int, widths: Tuple[int, int], mesh: Mesh,
                           mesh_axis: Optional[str], boundary: Optional[str],
                           fill_value: float) -> np.ndarray:
    """Halo-pad one axis of every block: ring halos when the dim is
    mesh-mapped, otherwise the local (global-edge) boundary condition."""
    from ..core.padding import BOUNDARY_TO_PAD_MODE, _pad_axis

    if widths == (0, 0):
        return blocks
    if mesh_axis is not None:
        return ring_halo_pad(blocks, axis, widths, mesh, mesh_axis, boundary, fill_value)
    mode = BOUNDARY_TO_PAD_MODE[boundary]
    fv = fill_value if mode == "constant" else 0.0
    return map_blocks(lambda b: _pad_axis(b, axis % b.ndim, widths, mode, fv), blocks, mesh=mesh)


def ring_shift(blocks: np.ndarray, axis: int, op: str, direction: str, mesh: Mesh,
               mesh_axis: str, boundary: Optional[str], fill_value: float = 0.0) -> np.ndarray:
    """``op(x, neighbour)`` along ``axis`` of every block with the
    neighbour shard's edge line as the one-wide halo: kernel E per block
    on the card, its plain version on the CPU.  ``direction`` "left" pairs
    each element with the one before it, "right" with the one after."""
    axis = axis % first_local(blocks).ndim
    widths = (1, 0) if direction == "left" else (0, 1)
    left, right = ring_halos(blocks, axis, widths, mesh, mesh_axis, boundary, fill_value)
    lines = left if direction == "left" else right
    return map_blocks(
        lambda b, h: face_shift(b.contiguous(), h.squeeze(axis).contiguous(), op, direction,
                                axis=axis),
        blocks, lines, mesh=mesh,
    )


def ring_kernel_ok(funcname: str, dtype: torch.dtype, boundary, extra_kwargs=()) -> bool:
    """True when a built-in op takes the ring route's kernel E: the four
    2-point ops on the dtypes the kernel takes, the basic boundary
    conditions and no other option."""
    from ..ops.fused import FUSABLE_OPS

    return (funcname in FUSABLE_OPS and dtype in SHIFT_DTYPES
            and boundary in _RING_BOUNDARIES and not set(extra_kwargs))


def _face_connected_axis(grid: Grid, axis_name: str) -> bool:
    return axis_name in grid._face_axes


def _face_route(grid: Grid, da: GriddedArray, axis_name: str, dim_to_mesh_axis):
    """The face-sharded roles (``face_sharded.face_axis_roles``) for an op
    along a face-connected axis with the face dim mesh-mapped, None for any
    other op.  A face-connected axis without the face dim mapped raises:
    a plain ring halo would wrap the LOCAL grid BC instead of the
    rotated/flipped cross-face strips, silently wrong."""
    from .face_sharded import face_axis_roles

    if not _face_connected_axis(grid, axis_name):
        return None
    roles = None
    if grid._facedim in da.dims:
        roles = face_axis_roles(grid, dim_to_mesh_axis, da.dims, strict=False)
    if roles is None or axis_name not in (roles.x_axis, roles.y_axis):
        raise NotImplementedError(
            f"axis {axis_name!r} is face-connected; ring halos cannot serve its "
            "cross-face boundaries: map the face dim to a mesh axis (the face-sharded "
            "route), or use ShardedGrid"
        )
    return roles


def _resolve(grid: Grid, da: GriddedArray, axis_name: str, to, boundary, fill_value):
    ax = grid.axes[axis_name]
    from_pos, dim = ax._get_position_name(da)
    to_pos = to or ax.default_shifts[from_pos]
    if (from_pos, to_pos) not in _SHARDABLE_WIDTHS:
        raise NotImplementedError(
            f"Cannot shard along a core dimension for the position shift "
            f"{from_pos}->{to_pos}; only length-preserving shifts "
            f"(center/left/right) are supported, like the reference's "
            f"map_overlap restriction (grid_ufunc.py:1069-1092)."
        )
    widths = _SHARDABLE_WIDTHS[(from_pos, to_pos)]
    bc = boundary if boundary is not None else ax.boundary
    fv = fill_value if fill_value is not None else ax.fill_value
    out_dim = ax.coords[to_pos]
    return from_pos, to_pos, dim, out_dim, widths, bc, fv


def sharded_op(
    grid: Grid,
    funcname: str,
    da: GriddedArray,
    axis_name: str,
    mesh: Mesh,
    dim_to_mesh_axis: Mapping[str, str],
    to: Optional[str] = None,
    boundary: Optional[str] = None,
    fill_value: Optional[float] = None,
) -> GriddedArray:
    """Apply a 1D grid op with the core dim sharded over the mesh.

    ``dim_to_mesh_axis`` maps array dims to mesh axes; the core dim's entry
    selects the mesh axis used for the halo ring.  Dims not in the mapping
    are replicated.  Result equals the single-device ``grid.<funcname>``.
    An op along a face-connected axis with the face dim mapped takes the
    face-sharded route (:func:`~.face_sharded.sharded_face_op`).
    """
    roles = _face_route(grid, da, axis_name, dim_to_mesh_axis)
    if roles is not None:
        from .face_sharded import sharded_face_op

        return sharded_face_op(grid, funcname, da, axis_name, mesh, *roles[:3], to=to,
                               boundary=boundary, fill_value=fill_value,
                               interior_mesh_axis=roles.interior_mesh_axis,
                               interior_mesh_axis_x=roles.interior_mesh_axis_x)
    from_pos, to_pos, dim, out_dim, widths, bc, fv = _resolve(
        grid, da, axis_name, to, boundary, fill_value
    )
    mesh_axis = dim_to_mesh_axis.get(dim)
    if mesh_axis is None:
        # core dim not sharded: the single-device op does the right thing
        return getattr(grid, funcname)(
            da, axis_name, to=to, boundary=boundary, fill_value=fill_value
        )
    axis_num = da.get_axis_num(dim)
    out_dims = tuple(out_dim if d == dim else d for d in da.dims)
    in_spec = partition_spec(da.dims, dim_to_mesh_axis)
    out_spec = partition_spec(out_dims, {**dim_to_mesh_axis, out_dim: mesh_axis})
    direction = "left" if widths == (1, 0) else "right"

    def local(blocks):
        if ring_kernel_ok(funcname, first_local(blocks).dtype, bc):
            return ring_shift(blocks, axis_num, funcname, direction, mesh, mesh_axis, bc,
                              float(fv))
        padded = ring_halo_pad(blocks, axis_num, widths, mesh, mesh_axis, bc, float(fv))
        return map_blocks(lambda p: _stencil(funcname, p, axis_num), padded, mesh=mesh)

    data = shard_map(local, mesh, (in_spec,), out_spec)(da.data)
    return GriddedArray(data, out_dims, name=da.name)


def _stencil(funcname: str, a: torch.Tensor, axis: int) -> torch.Tensor:
    """The 2-point stencil along ``axis`` of a padded block."""
    n = a.shape[axis]
    return apply_pair(funcname, a.narrow(axis, 0, n - 1), a.narrow(axis, 1, n - 1))


def _work(t: torch.Tensor) -> torch.Tensor:
    """Unsigned integers wider than a byte, which torch adds on no device,
    in int64: the same bits modulo 2^64, cast back after."""
    return t.to(torch.int64) if t.dtype in _UNSIGNED_WIDE else t


def sharded_cumsum(
    grid: Grid,
    da: GriddedArray,
    axis_name: str,
    mesh: Mesh,
    dim_to_mesh_axis: Mapping[str, str],
    to: Optional[str] = None,
    boundary: Optional[str] = None,
    fill_value: Optional[float] = None,
) -> GriddedArray:
    """Sharded position-shifting cumsum.

    The local prefix sum runs per shard; shard offsets come from an
    ``all_gather`` of block totals.  The position trim/pad (reference
    grid.py:1131-1154) becomes a one-element halo shift.  A cumsum along a
    face-connected axis with the face dim mapped takes the face-sharded
    route (:func:`~.face_sharded.sharded_face_cumsum`).
    """
    roles = _face_route(grid, da, axis_name, dim_to_mesh_axis)
    if roles is not None:
        from .face_sharded import sharded_face_cumsum

        return sharded_face_cumsum(grid, da, axis_name, mesh, *roles[:3], to=to,
                                   boundary=boundary, fill_value=fill_value,
                                   interior_mesh_axis=roles.interior_mesh_axis,
                                   interior_mesh_axis_x=roles.interior_mesh_axis_x)
    ax = grid.axes[axis_name]
    from_pos, dim = ax._get_position_name(da)
    to_pos = to or ax.default_shifts[from_pos]
    if (from_pos, to_pos) not in _SHARDABLE_WIDTHS:
        raise NotImplementedError(
            f"sharded cumsum supports only length-preserving shifts, "
            f"got {from_pos}->{to_pos}"
        )
    bc = boundary if boundary is not None else ax.boundary
    fv = fill_value if fill_value is not None else ax.fill_value
    mesh_axis = dim_to_mesh_axis.get(dim)
    if mesh_axis is None:
        return grid.cumsum(da, axis_name, to=to, boundary=boundary, fill_value=fill_value)
    axis_num = da.get_axis_num(dim)
    out_dim = ax.coords[to_pos]
    out_dims = tuple(out_dim if d == dim else d for d in da.dims)
    in_spec = partition_spec(da.dims, dim_to_mesh_axis)
    out_spec = partition_spec(out_dims, {**dim_to_mesh_axis, out_dim: mesh_axis})
    shift = (from_pos, to_pos) in (("center", "left"), ("right", "center"))
    n = mesh.shape[mesh_axis]
    ax_i = mesh.axis_index(mesh_axis)

    def local(blocks):
        local_cs = map_blocks(lambda b: cumsum(b, axis_num), blocks, mesh=mesh)
        n_local = first_local(blocks).shape[axis_num]
        totals = all_gather(
            map_blocks(lambda s: s.narrow(axis_num, n_local - 1, 1), local_cs, mesh=mesh),
            mesh, mesh_axis)  # (n, ..., 1, ...) on every shard
        data = np.empty(blocks.shape, dtype=object)
        for c in coords(mesh):
            tot = totals[c]
            # SELECT the earlier shards' totals, never multiply by a 0/1
            # mask: a NaN in a LATER shard's total would propagate backward
            # through 0*NaN, where a cumsum only carries NaN forward
            mask = (torch.arange(n, device=tot.device) < c[ax_i]).reshape(
                (n,) + (1,) * (tot.ndim - 1))
            offset = torch.sum(torch.where(mask, _work(tot), 0), dim=0).to(tot.dtype)
            # the cumsum's dtype throughout: bool input cumsums are int64,
            # and casting the summed prefix back to the input's dtype would
            # clamp every offset to 0/1
            data[c] = (_work(local_cs[c]) + _work(offset)).to(tot.dtype)
        if not shift:
            return data
        # result = [bc-element, global_cumsum[:-1]]: shift right by one
        padded = ring_halo_pad(data, axis_num, (1, 0), mesh, mesh_axis, bc, float(fv))
        if bc in ("periodic", None):
            # the reference TRIMS the last cumsum element before padding
            # (grid.py:1131-1154), so the periodic wrap is the trimmed
            # array's last value cs[N-2], not the ring halo of the untrimmed
            # data, cs[N-1]: one all_gather brings it from the shard that
            # holds it.  (The JAX package computes it as S - x_last, which
            # is NaN where x_last is infinite and cs[N-2] is not.)
            line, src = (n_local - 2, n - 1) if n_local >= 2 else (0, max(n - 2, 0))
            prev = all_gather(
                map_blocks(lambda d: d.narrow(axis_num, line, 1), data, mesh=mesh),
                mesh, mesh_axis)
            for c in coords(mesh):
                if c[ax_i] == 0:
                    p = padded[c]
                    padded[c] = torch.cat([prev[c][src], p.narrow(axis_num, 1, n_local)],
                                          dim=axis_num)
        return map_blocks(lambda p: p.narrow(axis_num, 0, p.shape[axis_num] - 1).contiguous(),
                          padded, mesh=mesh)

    data = shard_map(local, mesh, (in_spec,), out_spec)(da.data)
    return GriddedArray(data, out_dims, name=da.name)
