"""Generic sharded execution of grid ufuncs: the engine per shard.

The counterpart of :mod:`xgcm_tpu.parallel.sharded_ufunc`: the ordinary
single-device engine (:func:`xgcm_tpu_torch.apply_as_grid_ufunc`) runs once
per shard against a grid whose sharded dims carry per-shard sizes, with its
pad step swapped for the blocks padded collectively:

* face-less grids (and face grids whose face dim is local to every shard):
  ring halos (:func:`~.halo.ring_halo_pad`) on the mesh-mapped core dims,
  the normal local boundary padding on the rest, so mixed layouts (X
  sharded, Y replicated) work as they do in JAX;
* face-connected grids with the face dim mesh-mapped: the strip exchange
  of :func:`~.face_sharded.face_halo_pad_widths` at the ufunc's declared
  widths on the two in-face axes (faces over one mesh axis, optionally the
  rows over a second and the columns over a third, with dummy faces when
  the face count does not divide its axis), ring halos or local pads on
  any other axis.

A halo exchange needs every shard's block, so all shards are padded before
the engine runs on any of them; the ``_pad_fn`` hook hands each shard's
engine its padded blocks in the order it asks for them.

Restrictions mirror the reference's overlap rules
(``grid_ufunc.py:1069-1092``): positions on a sharded axis (and on both
in-face axes of a face-sharded grid, whose faces keep uniform shapes) must
be length-preserving (center/left/right), ``pad_before_func=False`` ops
(cumsum-style) are refused — :func:`~.halo.sharded_cumsum` parallelises the
prefix sum — and so are uneven shards.
"""

from __future__ import annotations

import warnings
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.dataarray import GriddedArray
from ..core.dataset import Dataset
from ..core.grid import Grid
from ..core.grid_ufunc import (
    _identify_dummy_axes_with_real_axes,
    _maybe_unpack_vector_component,
    _substitute_dummy_axis_names,
    apply_as_grid_ufunc,
)
from ..core.padding import pad
from ..core.signature import GridUFuncSignature
from .collectives import coords, first_local, shard_map
from .face_sharded import FaceSetup, face_halo_pad_widths
from .halo import ring_halo_pad
from .mesh import Mesh, partition_spec
from .sharded_tensor import ShardedTensor

__all__ = ["sharded_apply_as_grid_ufunc"]

_LENGTH_PRESERVING = {"center", "left", "right"}

def _sharded_axes_of(grid: Grid, dim_to_mesh_axis: Mapping[str, str]) -> Mapping[str, str]:
    """Map grid-axis name -> mesh axis, for axes with any mesh-mapped dim.

    All of an axis's position dims ride the same mesh axis (they are
    congruent modulo the ±1 of inner/outer); conflicting mappings error.
    """
    out = {}
    for name, ax in grid.axes.items():
        mesh_axes = {
            dim_to_mesh_axis[d]
            for d in ax.coords.values()
            if dim_to_mesh_axis.get(d) is not None
        }
        if len(mesh_axes) > 1:
            raise ValueError(
                f"dims of axis {name!r} map to multiple mesh axes: {sorted(mesh_axes)}"
            )
        if mesh_axes:
            out[name] = mesh_axes.pop()
    return out


def _local_grid(grid: Grid, mesh: Mesh, axis_to_mesh_axis, keep_face_connections=False) -> Grid:
    """A Grid whose sharded axes carry per-shard (local) dim sizes.

    Only length-preserving positions are kept on sharded axes.  Coordinate
    values are irrelevant inside the kernel; only dim sizes matter for the
    engine's bookkeeping and output checks.  ``keep_face_connections`` is
    for a face-connected grid whose face dim is not mesh-mapped: every
    shard holds whole faces, so the local pads of face-connected axes must
    assemble real cross-face halos.
    """
    coords_spec = {}
    ds_coords = {}
    boundary = {}
    fill_value = {}
    default_shifts = {}
    for name, ax in grid.axes.items():
        mesh_axis = axis_to_mesh_axis.get(name)
        pos_map = {}
        for pos, dim in ax.coords.items():
            size = grid._ds.dims[dim]
            if mesh_axis is not None:
                if pos not in _LENGTH_PRESERVING:
                    continue
                k = mesh.shape[mesh_axis]
                if size % k != 0:
                    raise ValueError(
                        f"dim {dim!r} (size {size}) does not divide evenly "
                        f"over mesh axis {mesh_axis!r} (size {k})"
                    )
                size = size // k
            pos_map[pos] = dim
            ds_coords[dim] = np.arange(size, dtype=np.float64)
        coords_spec[name] = pos_map
        boundary[name] = ax.boundary
        fill_value[name] = ax.fill_value
        default_shifts[name] = dict(ax.default_shifts)
    face_connections = None
    if keep_face_connections and grid._face_connections is not None:
        facedim = grid._facedim
        ds_coords[facedim] = np.arange(grid._ds.dims[facedim], dtype=np.float64)
        face_connections = grid._face_connections
    ds = Dataset(coords={d: (d, v) for d, v in ds_coords.items()})
    # internal reconstruction: the user never passed these kwargs here, so
    # the constructor's forward-compat DeprecationWarnings must not fire
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return Grid(
            ds,
            coords=coords_spec,
            boundary=boundary,
            fill_value=fill_value,
            default_shifts=default_shifts,
            face_connections=face_connections,
            autoparse_metadata=False,
        )


def _output_dims(arg_dims, in_core_dims, out_core_dims, sig):
    """Output dim tuples, mirroring the engine's broadcast + core-dim
    placement and input-dim-order restoration."""
    broadcast_dims = []
    for dims, cdims in zip(arg_dims, in_core_dims):
        for d in dims:
            if d not in cdims and d not in broadcast_dims:
                broadcast_dims.append(d)
    dummy_to_in = {
        ax: dim
        for arg_axes, arg_dims_ in zip(sig.in_ax_names, in_core_dims)
        for ax, dim in zip(arg_axes, arg_dims_)
    }
    dummy_to_out = {
        ax: dim
        for arg_axes, arg_dims_ in zip(sig.out_ax_names, out_core_dims)
        for ax, dim in zip(arg_axes, arg_dims_)
    }
    rename = {dummy_to_in[ax]: dummy_to_out[ax] for ax in dummy_to_in if ax in dummy_to_out}
    reference_order = []
    for dims in arg_dims:
        for d in dims:
            d = rename.get(d, d)
            if d not in reference_order:
                reference_order.append(d)
    outs = []
    for cdims in out_core_dims:
        dims = list(broadcast_dims) + list(cdims)
        order = [d for d in reference_order if d in dims] + [
            d for d in dims if d not in reference_order
        ]
        outs.append(tuple(order))
    return outs


def _pad_blocks(arr: GriddedArray, blocks: np.ndarray, widths, *, mesh: Mesh, local_grid: Grid,
                fs: Optional[FaceSetup], axis_to_mesh_axis, bc, fv, vector_axis=None,
                partner=None) -> np.ndarray:
    """Every shard's block of ``arr`` as a local GriddedArray, padded at
    ``widths`` (grid-axis name -> (left, right)): the local boundary
    padding on unsharded axes first, then ring halos on the sharded ones
    (commutative for pointwise BC modes), then on a face-sharded grid
    (``fs``) the strip exchange on the two in-face axes (``partner``: the
    other vector component's GriddedArray and blocks).  ``bc`` and ``fv``
    are resolved per axis against the real grid."""
    face_axes = () if fs is None else (fs.x_axis, fs.y_axis)
    other_bw = {n: w for n, w in widths.items() if n not in face_axes}
    local_bw = {n: w for n, w in other_bw.items() if n not in axis_to_mesh_axis}
    ring_bw = {n: w for n, w in other_bw.items()
               if n in axis_to_mesh_axis and tuple(w) != (0, 0)}
    local = np.empty(blocks.shape, dtype=object)
    for c in coords(mesh):
        da = GriddedArray(blocks[c], arr.dims, name=arr.name)
        if any(tuple(w) != (0, 0) for w in local_bw.values()):
            da = pad(da, grid=local_grid, boundary_width=local_bw, boundary=bc, fill_value=fv)
        local[c] = da
    for n, w in ring_bw.items():
        dim = local_grid.axes[n]._get_position_name(first_local(local))[1]
        num = first_local(local).get_axis_num(dim)
        data = np.empty(blocks.shape, dtype=object)
        for c in coords(mesh):
            data[c] = local[c].data
        data = ring_halo_pad(data, num, tuple(w), mesh, axis_to_mesh_axis[n], bc[n], float(fv[n]))
        for c in coords(mesh):
            local[c] = local[c].with_data(data[c])
    if fs is None:
        return local
    face_bw = (tuple(widths.get(fs.x_axis, (0, 0))), tuple(widths.get(fs.y_axis, (0, 0))))
    if face_bw == ((0, 0), (0, 0)):
        return local

    def arranged(garrs):
        first = first_local(garrs)
        ydim = local_grid.axes[fs.y_axis]._get_position_name(first)[1]
        xdim = local_grid.axes[fs.x_axis]._get_position_name(first)[1]
        rest = [d for d in first.dims if d not in (fs.facedim, ydim, xdim)]
        order = (*rest, fs.facedim, ydim, xdim)
        data = np.empty(garrs.shape, dtype=object)
        for c in coords(mesh):
            data[c] = garrs[c].transpose(*order).data
        return data, order

    data, order = arranged(local)
    partner_data = None
    vec_code = None
    if vector_axis is not None:
        if partner is None:
            raise ValueError("Padding vector components requires `other_component` input.")
        vec_code = 0 if vector_axis == fs.x_axis else 1
        p_arr, p_blocks = partner
        p_local = np.empty(p_blocks.shape, dtype=object)
        for c in coords(mesh):
            p_local[c] = GriddedArray(p_blocks[c], p_arr.dims, name=p_arr.name)
        partner_data, _ = arranged(p_local)
    padded = face_halo_pad_widths(
        data, mesh, fs.plan, face_bw[0], face_bw[1], fs.face_mesh_axis,
        bc[fs.x_axis], bc[fs.y_axis], float(fv[fs.x_axis]), float(fv[fs.y_axis]),
        fs.x_axis, fs.y_axis, interior_mesh_axis=fs.interior_mesh_axis,
        partner_blocks=partner_data, vector_axis_code=vec_code,
        interior_mesh_axis_x=fs.interior_mesh_axis_x,
    )
    for c in coords(mesh):
        local[c] = GriddedArray(padded[c], order, name=arr.name)
    return local


def sharded_apply_as_grid_ufunc(
    func: Callable,
    *args,
    axis: Sequence[Sequence[str]],
    grid: Grid,
    signature: Union[str, GridUFuncSignature],
    mesh: Mesh,
    dim_to_mesh_axis: Mapping[str, str],
    boundary_width: Optional[Mapping[str, Tuple[int, int]]] = None,
    boundary=None,
    fill_value=None,
    pad_before_func: bool = True,
    other_component=None,
    **kwargs,
):
    """Apply any grid ufunc with mesh-mapped core dims, exchanging halos
    of the declared ``boundary_width`` between the blocks.

    Equals the single-device :func:`xgcm_tpu_torch.apply_as_grid_ufunc`
    result; see the module docstring for the restrictions.
    """
    face_setup = None
    if grid._face_connections is not None:
        if dim_to_mesh_axis.get(grid._facedim) is not None:
            first = _maybe_unpack_vector_component(args[0]) if args else None
            face_setup = FaceSetup.infer(grid, mesh, dim_to_mesh_axis,
                                         first_arg_dims=tuple(getattr(first, "dims", ())))
        else:
            # face dim local on every shard: connected-axis halos stay
            # intact locally, so the ring route serves sharded NON-connected
            # axes (Z), but a sharded face-connected dim would need rotated
            # cross-face strips from other shards
            conn_dims = {
                d
                for links in grid._face_connections[grid._facedim].values()
                for a in links
                for d in grid.axes[a].coords.values()
            }
            bad = sorted(conn_dims & {d for d, m in dim_to_mesh_axis.items() if m is not None})
            if bad:
                raise NotImplementedError(
                    f"sharding the face-connected dims {bad} requires the face dim "
                    f"{grid._facedim!r} mapped to a mesh axis too (rotated cross-face "
                    "halos are not shard-local)"
                )
            if any(isinstance(a, dict) for a in args):
                raise NotImplementedError(
                    "vector components on a face-connected grid require the face dim "
                    "mesh-mapped"
                )
    if not pad_before_func:
        raise NotImplementedError(
            "pad_before_func=False (cumsum-style) ops cannot use halo exchange; "
            "use sharded_cumsum"
        )
    ocs = list(other_component) if isinstance(other_component, Sequence) else [other_component]
    if face_setup is None and any(oc is not None for oc in ocs):
        # other_component only affects face-connection sign rules, which the
        # face-less route never hits
        raise NotImplementedError("other_component is only meaningful on face-connected grids")
    if len(ocs) == 1 and len(args) > 1 and ocs[0] is None:
        ocs = ocs * len(args)
    ocs = ocs + [None] * (len(args) - len(ocs))

    sig = (
        signature
        if isinstance(signature, GridUFuncSignature)
        else GridUFuncSignature.from_string(signature)
    )
    if isinstance(axis, str):
        axis = [(axis,)]
    arg_arrays = [_maybe_unpack_vector_component(a) for a in args]

    dummy_to_real = _identify_dummy_axes_with_real_axes(sig.in_ax_names, axis)
    out_ax_names = [[dummy_to_real[ax] for ax in arg] for arg in sig.out_ax_names]

    axis_to_mesh_axis = _sharded_axes_of(grid, dim_to_mesh_axis)

    # positions on a sharded axis must be length-preserving (the analog of
    # reference grid_ufunc.py:1069-1092's DISALLOWED_OVERLAP_POSITIONS), and
    # on the two in-face axes of a face-sharded grid too (faces keep
    # uniform shapes); checked before any coords lookup so a missing
    # inner/outer coord still reports the real restriction
    restricted = set(axis_to_mesh_axis)
    if face_setup is not None:
        restricted |= {face_setup.x_axis, face_setup.y_axis}
    for arg_ns, arg_ps in zip(
        list(axis) + out_ax_names,
        list(sig.in_ax_positions) + list(sig.out_ax_positions),
    ):
        for n, p in zip(arg_ns, arg_ps):
            if n in restricted and p not in _LENGTH_PRESERVING:
                raise NotImplementedError(
                    f"cannot shard along axis {n!r}: position {p!r} changes the array "
                    f"length (only center/left/right positions are shardable, like the "
                    f"reference's map_overlap restriction)"
                )

    in_core_dims = [
        [grid.axes[n].coords[p] for n, p in zip(arg_ns, arg_ps)]
        for arg_ns, arg_ps in zip(axis, sig.in_ax_positions)
    ]
    out_core_dims = [
        [grid.axes[n].coords[p] for n, p in zip(arg_ns, arg_ps)]
        for arg_ns, arg_ps in zip(out_ax_names, sig.out_ax_positions)
    ]

    # resolve boundary / fill_value per axis once, against the REAL grid's
    # defaults, so the local grid's defaults never matter
    bc = grid._complete_user_kwargs_using_axis_defaults(boundary, "boundary")
    fv = grid._complete_user_kwargs_using_axis_defaults(fill_value, "fill_value")
    bw = _substitute_dummy_axis_names(boundary_width, dummy_to_real)

    # faces-local route: shards hold whole faces, so the local pads of
    # connected axes assemble cross-face halos; the face route pads them
    # with the strip exchange before the engine runs
    local_grid = _local_grid(grid, mesh, axis_to_mesh_axis,
                             keep_face_connections=face_setup is None)
    sharded_dims = {
        dim: axis_to_mesh_axis[name]
        for name, ax in grid.axes.items()
        if name in axis_to_mesh_axis
        for dim in ax.coords.values()
    }
    # non-core dims (e.g. batch, the face dim) keep the caller's mapping
    full_map = {**dict(dim_to_mesh_axis), **sharded_dims}

    in_specs = [partition_spec(a.dims, full_map) for a in arg_arrays]
    out_dims = _output_dims([a.dims for a in arg_arrays], in_core_dims, out_core_dims, sig)
    out_specs = tuple(partition_spec(dims, full_map) for dims in out_dims)

    fs = face_setup
    pad_context = dict(mesh=mesh, local_grid=local_grid, fs=fs,
                       axis_to_mesh_axis=axis_to_mesh_axis, bc=bc, fv=fv)

    # partner (other_component) arrays ride along as extra operands
    partners = [None if oc is None else next(iter(oc.values())) for oc in ocs]
    operands = list(arg_arrays) + [p for p in partners if p is not None]
    operand_specs = in_specs + [partition_spec(p.dims, full_map) for p in partners
                                if p is not None]
    if fs is not None:
        # dummy faces round the face dim up to the face axis; the blocks
        # go in as ShardedTensors of the padded layout
        placed = []
        for a, spec in zip(operands, operand_specs):
            placed.append(ShardedTensor(fs.blocks(a, spec), mesh, spec))
    else:
        placed = [a.data for a in operands]

    def local(*blocks):
        arg_blocks = blocks[: len(args)]
        partner_blocks = iter(blocks[len(args):])
        padded = []
        for a, arr, b, pa in zip(args, arg_arrays, arg_blocks, partners):
            partner = None if pa is None else (pa, next(partner_blocks))
            vector_axis = next(iter(a)) if isinstance(a, dict) else None
            padded.append(_pad_blocks(arr, b, bw, vector_axis=vector_axis, partner=partner,
                                      **pad_context))
        outs = [np.empty(mesh.devices.shape, dtype=object) for _ in out_dims]
        for c in coords(mesh):
            handed = iter([p[c] for p in padded])
            local_args = []
            for b, a, arr in zip(arg_blocks, args, arg_arrays):
                ga = GriddedArray(b[c], arr.dims, name=arr.name)
                local_args.append({next(iter(a)): ga} if isinstance(a, dict) else ga)
            res = apply_as_grid_ufunc(
                func,
                *local_args,
                axis=axis,
                grid=local_grid,
                signature=sig,
                boundary_width=boundary_width,
                boundary=bc,
                fill_value=fv,
                pad_before_func=True,
                _pad_fn=lambda a, **kw: next(handed),
                **kwargs,
            )
            if len(out_dims) == 1:
                res = (res,)
            for o, r, dims in zip(outs, res, out_dims):
                o[c] = r.transpose(*dims).data
        return outs[0] if len(out_dims) == 1 else tuple(outs)

    single = len(out_dims) == 1
    raw = shard_map(local, mesh, operand_specs, out_specs[0] if single else out_specs)(*placed)
    raws = (raw,) if single else raw
    name = arg_arrays[0].name
    results = []
    for r, dims, spec in zip(raws, out_dims, out_specs):
        data = r if fs is None else fs.result(r.blocks, dims, spec)
        results.append(GriddedArray(data, dims, name=name))
    return results[0] if single else tuple(results)
