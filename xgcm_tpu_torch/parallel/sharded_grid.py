"""ShardedGrid: a Grid proxy bound to a mesh.

The counterpart of :class:`xgcm_tpu.parallel.ShardedGrid`: pick a mesh and a
dim->mesh-axis mapping once, then call the usual operator methods.  Each op
takes one of four routes:

* the face route, on a face-connected grid with its face dim mesh-mapped
  and an op along an in-face axis: :func:`~.face_sharded.sharded_face_op`
  (kernel E per block for the built-in ops, the sharded engine with the
  face strip exchange for the rest) and
  :func:`~.face_sharded.sharded_face_cumsum`;
* the ring route, when its core dim is sharded and the position shift keeps
  the length: ring halos between the blocks, then kernel E per block for
  the built-in ops (:func:`~.halo.ring_shift`), the sharded engine for the
  rest, :func:`~.halo.sharded_cumsum` for cumsum;
* the batch route, when every sharded dim of the array is a batch dim: the
  plain Grid op on each block (kernel A per block on the card), with no
  collective;
* the fall-through: the plain Grid op on the assembled array, re-sharded
  by the mapping after — the gather a GSPMD partitioner makes.

Transforms run per shard over the column dims (kernels C, G, F and H per
block).  :meth:`ShardedGrid.apply_many` runs a batch of ops as one shard
program with one halo exchange per distinct input (:mod:`.apply_many`).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ..core import gridops
from ..core.dataarray import GriddedArray
from ..core.grid import Grid, _select_grid_ufunc
from ..core.signature import GridUFuncSignature
from .apply_many import sharded_apply_many
from .collectives import coords, first_local, map_blocks
from .halo import _SHARDABLE_WIDTHS, ring_kernel_ok, sharded_cumsum, sharded_op
from .mesh import Mesh, partition_spec, shard_gridded, to_sharded
from .sharded_tensor import ShardedTensor
from .sharded_ufunc import sharded_apply_as_grid_ufunc

__all__ = ["ShardedGrid"]


def _gathered(x):
    """A GriddedArray (or vector-component dict of them) with sharded data
    assembled on the mesh's first device."""
    if isinstance(x, dict):
        return {k: _gathered(v) for k, v in x.items()}
    if isinstance(x, GriddedArray) and isinstance(x.data, ShardedTensor):
        return x.with_data(x.data.full_tensor())
    return x


class ShardedGrid:
    """Binds a Grid to a Mesh and a dim->mesh-axis mapping.

    >>> sgrid = ShardedGrid(grid, mesh, {"xc": "x", "xg": "x"})
    >>> zeta = sgrid.diff(v, "X") - sgrid.diff(u, "Y")

    Keys may also name GRID AXES ("X") instead of dims; an axis-name key
    expands to every coordinate dim of that axis.  An explicit dim key
    always overrides an axis expansion regardless of mapping order, so
    ``{"X": "x", "xg": None}`` keeps ``xg`` replicated.  Keys that match
    neither an axis nor any dim of an operand are inert (they may name
    batch dims of arrays not seen yet); mesh-axis VALUES are validated
    here.
    """

    def __init__(self, grid: Grid, mesh: Mesh, dim_to_mesh_axis: Mapping[str, str]):
        self.grid = grid
        self.mesh = mesh
        bad = {
            v for v in dict(dim_to_mesh_axis).values()
            if v is not None and v not in mesh.axis_names
        }
        if bad:
            raise ValueError(
                f"mesh axis names {sorted(bad)} not in mesh {tuple(mesh.axis_names)}"
            )
        # two passes so explicit dim keys win over axis expansions
        # independent of mapping order (a key that is BOTH an axis name
        # and a dim somewhere is treated as the dim)
        mapping = dict(dim_to_mesh_axis)
        dim_names = {d for a in grid.axes.values() for d in getattr(a, "coords", {}).values()}
        axis_keys = {k for k in mapping if grid.axes.get(k) is not None and k not in dim_names}
        expanded = {}
        for key in axis_keys:
            for dim in grid.axes[key].coords.values():
                expanded[dim] = mapping[key]
        for key, mesh_ax in mapping.items():
            if key not in axis_keys:
                expanded[key] = mesh_ax
        self.dim_to_mesh_axis = expanded

    @property
    def axes(self):
        return self.grid.axes

    def shard(self, da: GriddedArray) -> GriddedArray:
        """Place an array on the mesh according to the dim mapping."""
        mapping = {d: ax for d, ax in self.dim_to_mesh_axis.items() if d in da.dims}
        return shard_gridded(da, self.mesh, mapping)

    def _shift_of(self, da: GriddedArray, axis_name: str, to):
        ax = self.grid.axes[axis_name]
        from_pos, dim = ax._get_position_name(da)
        to_pos = to or ax.default_shifts[from_pos]
        return from_pos, to_pos, dim

    def _core_dim_sharded(self, da: GriddedArray, axis_name: str, to) -> bool:
        from_pos, to_pos, dim = self._shift_of(da, axis_name, to)
        return (
            self.dim_to_mesh_axis.get(dim) is not None
            and (from_pos, to_pos) in _SHARDABLE_WIDTHS
        )

    def _conn_axes(self):
        grid = self.grid
        return {a for links in grid._face_connections[grid._facedim].values() for a in links}

    def _face_sharded_args(self, da):
        """(mesh_axis, x_axis, y_axis, interior_y, interior_x) when the
        grid's face dim is sharded and the in-face axes are resolvable,
        else None.  A vector input (single-entry dict) is judged by its
        component.  When one in-face axis is also mesh-mapped it takes the
        y (rows) role; when both are, the face x y x x decomposition
        applies."""
        from .face_sharded import face_axis_roles

        grid = self.grid
        if isinstance(da, dict):
            (da,) = da.values()
        if grid._face_connections is None or grid._facedim not in da.dims:
            return None
        roles = face_axis_roles(grid, self.dim_to_mesh_axis, da.dims, strict=False)
        if roles is None:
            return None
        return (roles.face_mesh_axis, roles.x_axis, roles.y_axis,
                roles.interior_mesh_axis, roles.interior_mesh_axis_x)

    def _ring_1d_op(self, name, da, ax_name, to, boundary, fill_value, **kw):
        """One built-in op along a sharded core dim: kernel E per block
        after a one-wide ring halo where the op, dtype and options allow
        it, else the generic sharded engine with the gridops ufunc the
        single-device dispatch selects."""
        from_pos, to_pos, _ = self._shift_of(da, ax_name, to)
        bc = self.grid._complete_user_kwargs_using_axis_defaults(boundary, "boundary")[ax_name]
        fv = self.grid._complete_user_kwargs_using_axis_defaults(
            fill_value, "fill_value")[ax_name]
        if ring_kernel_ok(name, da.dtype, bc, kw):
            return sharded_op(self.grid, name, da, ax_name, self.mesh, self.dim_to_mesh_axis,
                              to=to, boundary=bc, fill_value=fv)
        sig = GridUFuncSignature.from_string(f"({ax_name}:{from_pos})->({ax_name}:{to_pos})")
        grid_ufunc, remaining = _select_grid_ufunc(
            name, sig, module=gridops, boundary=boundary, fill_value=fill_value, **kw,
        )
        return sharded_apply_as_grid_ufunc(
            grid_ufunc.ufunc,
            da,
            axis=[(ax_name,)],
            grid=self.grid,
            signature=grid_ufunc.signature,
            mesh=self.mesh,
            dim_to_mesh_axis=self.dim_to_mesh_axis,
            boundary_width=grid_ufunc.boundary_width,
            boundary=remaining.get("boundary"),
            fill_value=remaining.get("fill_value"),
        )

    def _op(self, name, da, axis, to=None, boundary=None, fill_value=None,
            metric_weighted=None, **kw):
        from ..adapters.xarray_adapter import as_native
        from .face_sharded import sharded_face_cumsum, sharded_face_op

        da = as_native(da)
        if isinstance(da, dict):
            da = {k: as_native(v) for k, v in da.items()}
        if isinstance(kw.get("other_component"), dict):
            kw["other_component"] = {k: as_native(v) for k, v in kw["other_component"].items()}
        if isinstance(axis, str):
            axis = [axis]
        to = self.grid._map_kwargs_over_axes(to)
        if isinstance(metric_weighted, str):
            metric_weighted = (metric_weighted,)
        metric_weighted = self.grid._map_kwargs_over_axes(metric_weighted)

        out = da
        for ax_name in axis:
            ax_to = to.get(ax_name)
            mw = metric_weighted.get(ax_name)
            if mw:
                out = out * self.grid.get_metric(out, mw)

            face_args = self._face_sharded_args(out)
            if face_args is not None and ax_name in face_args[1:3]:
                mesh_axis, x_axis, y_axis, interior_y, interior_x = face_args
                if name == "cumsum":
                    out = sharded_face_cumsum(
                        self.grid, out, ax_name, self.mesh, mesh_axis, x_axis, y_axis,
                        to=ax_to, boundary=boundary, fill_value=fill_value,
                        interior_mesh_axis=interior_y, interior_mesh_axis_x=interior_x,
                    )
                else:
                    out = sharded_face_op(
                        self.grid, name, out, ax_name, self.mesh, mesh_axis, x_axis, y_axis,
                        to=ax_to, boundary=boundary, fill_value=fill_value,
                        other_component=kw.get("other_component"),
                        interior_mesh_axis=interior_y, interior_mesh_axis_x=interior_x,
                    )
            elif (
                not isinstance(out, dict)
                and self._core_dim_sharded(out, ax_name, ax_to)
                and not self._face_axis_without_face_mapping(ax_name)
            ):
                if name == "cumsum":
                    out = sharded_cumsum(
                        self.grid, out, ax_name, self.mesh, self.dim_to_mesh_axis,
                        to=ax_to, boundary=boundary, fill_value=fill_value,
                    )
                else:
                    out = self._ring_1d_op(name, out, ax_name, ax_to, boundary, fill_value, **kw)
            else:
                out = self._batch_sharded_op(
                    name, out, ax_name, to=ax_to, boundary=boundary, fill_value=fill_value, **kw,
                )

            if mw:
                out = out / self.grid.get_metric(out, mw)
        return out

    def _face_axis_without_face_mapping(self, ax_name):
        """True when ``ax_name`` is a face-connected axis but the face dim
        is NOT mesh-mapped: its rotated cross-face halos are not
        shard-local, so the ring route cannot serve a sharded core dim
        there — the fall-through stays correct instead."""
        grid = self.grid
        if grid._face_connections is None:
            return False
        if self.dim_to_mesh_axis.get(grid._facedim) is not None:
            return False
        return ax_name in self._conn_axes()

    def _batch_safe_dims(self, dims, core_dims=()):
        """True when the mesh-mapped members of ``dims`` are pure batch
        dims: none is a core dim of the op, and on a face-connected grid
        none is the face dim or a face-connected in-face dim."""
        sharded = {d for d in dims if self.dim_to_mesh_axis.get(d) is not None}
        if not sharded:
            return False
        if sharded & set(core_dims):
            return False
        grid = self.grid
        if grid._face_connections is not None:
            unsafe = {grid._facedim}
            for a in self._conn_axes():
                unsafe |= set(grid.axes[a].coords.values())
            if sharded & unsafe:
                return False
        return True

    def _batch_sharded_call(self, local_ga_fn, da):
        """``local_ga_fn(block of da) -> GriddedArray`` on every block:
        embarrassingly parallel, no collective, and on the card the plain
        Grid op's kernels launch per block."""
        spec = partition_spec(da.dims, self.dim_to_mesh_axis)
        results = map_blocks(local_ga_fn, to_sharded(da.data, self.mesh, spec).blocks,
                             mesh=self.mesh)
        ga = first_local(results)
        data = map_blocks(lambda r: r.data, results, mesh=self.mesh)
        out_spec = partition_spec(ga.dims, self.dim_to_mesh_axis)
        return GriddedArray(ShardedTensor(data, self.mesh, out_spec), ga.dims, name=ga.name)

    def _fall_through(self, fn, *args, **kwargs):
        """``fn`` on the assembled arrays, its results re-sharded by the
        mapping."""
        out = fn(*(_gathered(a) for a in args),
                 **{k: _gathered(v) for k, v in kwargs.items()})
        return self._reshard(out)

    def _reshard(self, out):
        if isinstance(out, dict):
            return {k: self._reshard(v) for k, v in out.items()}
        if isinstance(out, (tuple, list)):
            return type(out)(self._reshard(v) for v in out)
        if isinstance(out, GriddedArray) and any(
                self.dim_to_mesh_axis.get(d) is not None for d in out.dims):
            return self.shard(out)
        return out

    def _batch_sharded_op(self, name, da, ax_name, **kw):
        """Built-in op whose mesh-mapped dims are all batch dims: the plain
        Grid op on every block; otherwise the fall-through."""
        if isinstance(da, dict) or not self._batch_safe_dims(
            da.dims, self.grid.axes[ax_name].coords.values()
        ):
            return self._fall_through(getattr(self.grid, name), da, ax_name, **kw)
        grid = self.grid
        return self._batch_sharded_call(
            lambda d: getattr(grid, name)(GriddedArray(d, da.dims, name=da.name), ax_name, **kw),
            da,
        )

    def interp(self, da, axis, **kw):
        return self._op("interp", da, axis, **kw)

    def diff(self, da, axis, **kw):
        return self._op("diff", da, axis, **kw)

    def min(self, da, axis, **kw):
        return self._op("min", da, axis, **kw)

    def max(self, da, axis, **kw):
        return self._op("max", da, axis, **kw)

    def cumsum(self, da, axis, **kw):
        return self._op("cumsum", da, axis, **kw)

    # ----------------------------------------------------------- vector ops
    def diff_2d_vector(self, vector, **kwargs):
        """Difference a C-grid 2D vector with each component sharded
        (validation and the to-center restriction are the Grid's)."""
        return Grid._apply_vector_function(self, self.diff, vector, **kwargs)

    def interp_2d_vector(self, vector, **kwargs):
        """Interpolate a C-grid 2D vector with each component sharded."""
        return Grid._apply_vector_function(self, self.interp, vector, **kwargs)

    # -------------------------------------------------- metadata delegation
    def set_metrics(self, key, value, overwrite=False):
        """Register metrics on the underlying Grid."""
        return self.grid.set_metrics(key, value, overwrite=overwrite)

    def get_metric(self, array, axes):
        """Resolve a metric for ``array``; a plain metric broadcast against
        a sharded array is cut to each block."""
        return self.grid.get_metric(array, axes)

    def interp_like(self, array, like, boundary=None, fill_value=None):
        """Interpolate ``array`` onto the positions of ``like``; interps
        route through :meth:`interp` so sharded core dims take the ring
        route."""
        from ..adapters.xarray_adapter import as_native

        array = as_native(array)
        like = as_native(like)
        interp_axes = []
        for axname, ax in self.grid.axes.items():
            try:
                pos_array, _ = ax._get_position_name(array)
                pos_like, _ = ax._get_position_name(like)
            except KeyError:
                continue
            if pos_like != pos_array:
                interp_axes.append(axname)
        if not interp_axes:
            return array
        return self.interp(array, interp_axes, fill_value=fill_value, boundary=boundary)

    def coords_for(self, array):
        """Coordinate arrays for ``array``'s dims (delegates to the Grid)."""
        return self.grid.coords_for(array)

    # -------------------------------------------------- custom grid ufuncs
    def apply_as_grid_ufunc(self, func, *args, axis=None, signature="", boundary_width=None,
                            boundary=None, fill_value=None, **kwargs):
        """Apply a custom kernel, sharded over any mesh-mapped core dims at
        its declared boundary_width (on a face-connected grid with the face
        dim mapped, through the face strip exchange); per block when only
        batch dims are sharded; else on the assembled arrays."""
        sig = (
            signature
            if isinstance(signature, GridUFuncSignature)
            else GridUFuncSignature.from_string(signature)
        )
        if isinstance(axis, str):
            axis = [(axis,)]
        any_sharded = any(
            self.dim_to_mesh_axis.get(self.grid.axes[n].coords.get(p)) is not None
            for arg_ns, arg_ps in zip(axis, sig.in_ax_positions)
            for n, p in zip(arg_ns, arg_ps)
        )
        face_sharded = (
            self.grid._face_connections is not None
            and self.dim_to_mesh_axis.get(self.grid._facedim) is not None
        )
        batch_sharded = any(
            self.dim_to_mesh_axis.get(d) is not None
            for a in args
            for d in getattr(next(iter(a.values())) if isinstance(a, dict) else a, "dims", ())
        )
        # a sharded face-connected core dim WITHOUT the face dim mapped has
        # no ring route (rotated cross-face halos are not shard-local) —
        # the fall-through below stays correct
        face_unroutable = (
            not face_sharded
            and self.grid._face_connections is not None
            and any(
                self._face_axis_without_face_mapping(n)
                and self.dim_to_mesh_axis.get(self.grid.axes[n].coords.get(p)) is not None
                for arg_ns, arg_ps in zip(axis, sig.in_ax_positions)
                for n, p in zip(arg_ns, arg_ps)
            )
        )
        if not face_unroutable and (
            any_sharded or face_sharded
            or (batch_sharded and self.grid._face_connections is None)
        ):
            return sharded_apply_as_grid_ufunc(
                func, *args, axis=axis, grid=self.grid, signature=sig,
                mesh=self.mesh, dim_to_mesh_axis=self.dim_to_mesh_axis,
                boundary_width=boundary_width, boundary=boundary,
                fill_value=fill_value, **kwargs,
            )

        def call(*a):
            return self.grid.apply_as_grid_ufunc(
                func, *a, axis=axis, signature=sig, boundary_width=boundary_width,
                boundary=boundary, fill_value=fill_value, **kwargs,
            )

        if (
            batch_sharded
            and len(args) == 1
            and isinstance(args[0], GriddedArray)
            and self._batch_safe_dims(args[0].dims)
        ):
            da = args[0]
            return self._batch_sharded_call(
                lambda d: call(GriddedArray(d, da.dims, name=da.name)), da)
        return self._fall_through(call, *args)

    def apply_many(self, op_specs):
        """A batch of grid-ufunc applications as one shard program with
        shared halo exchange: each distinct input is padded once at the
        widest halo any op asks for (see
        :func:`~.apply_many.sharded_apply_many`)."""
        return sharded_apply_many(op_specs, grid=self.grid, mesh=self.mesh,
                                  dim_to_mesh_axis=self.dim_to_mesh_axis)

    # ---------------------------------------------- metric-weighted calculus
    def derivative(self, da, axis, **kwargs):
        """diff / metric with the diff sharded."""
        diff = self.diff(da, axis, **kwargs)
        dx = self.grid.get_metric(diff, (axis,))
        return diff / dx

    def integrate(self, da, axis, **kwargs):
        """sum(da * metric): the product runs per block, the sum on the
        assembled product (one assembly a sum)."""
        return self.grid.integrate(da, axis, **kwargs)

    def average(self, da, axis, **kwargs):
        """Weighted mean: as :meth:`integrate`, two sums."""
        return self.grid.average(da, axis, **kwargs)

    def cumint(self, da, axis, **kwargs):
        """cumsum(da * metric) with the cumsum sharded."""
        weight = self.grid.get_metric(da, axis)
        return self.cumsum(da * weight, axis, **kwargs)

    # ---------------------------------------------------------- transforms
    def _check_transform_dim(self, da, axis):
        ax = self.grid.axes[axis]
        _, dim = ax._get_position_name(da)
        if self.dim_to_mesh_axis.get(dim) is not None:
            raise NotImplementedError(
                f"cannot transform along the sharded dimension {dim!r}; "
                "shard the horizontal dims instead"
            )

    def _sharded_transform(self, das, axis, target, target_data, multi, **kwargs):
        """The transform on every block of the mesh-mapped column dims:
        the remap is per column, so every shard computes its own columns
        with no collective, and on the card kernels C, G, F and H launch
        per block.  A GriddedArray target is placed by the mapping (a
        per-column target rides the column sharding); any other target is
        used as it is by every shard."""
        grid = self.grid
        tgt_is_ga = isinstance(target, GriddedArray)
        operands = list(das) + ([target] if tgt_is_ga else []) + (
            [target_data] if target_data is not None else [])
        specs = [partition_spec(ga.dims, self.dim_to_mesh_axis) for ga in operands]
        blocks = [to_sharded(ga.data, self.mesh, s).blocks for ga, s in zip(operands, specs)]
        results = np.empty(self.mesh.devices.shape, dtype=object)
        for c in coords(self.mesh):
            local = [GriddedArray(b[c], ga.dims, name=ga.name) for b, ga in zip(blocks, operands)]
            arrs = local[: len(das)]
            k = len(das)
            tgt = local[k] if tgt_is_ga else target
            td = local[-1] if target_data is not None else None
            if multi:
                results[c] = grid.transform_multi(arrs, axis, tgt, target_data=td, **kwargs)
            else:
                results[c] = [grid.transform(arrs[0], axis, tgt, target_data=td, **kwargs)]
        outs = []
        for i, ga in enumerate(first_local(results)):
            part = np.empty(results.shape, dtype=object)
            for c in coords(self.mesh):
                part[c] = results[c][i].data
            spec = partition_spec(ga.dims, self.dim_to_mesh_axis)
            outs.append(GriddedArray(ShardedTensor(part, self.mesh, spec), ga.dims, name=ga.name))
        return outs if multi else outs[0]

    def transform(self, da, axis, target, target_data=None, **kwargs):
        """Vertical transform; the transform dim must not be sharded.
        Mesh-mapped column dims run per shard with no collective."""
        from ..adapters.xarray_adapter import as_native

        da = as_native(da)
        target = as_native(target)
        target_data = as_native(target_data)
        self._check_transform_dim(da, axis)
        if any(self.dim_to_mesh_axis.get(d) is not None for d in da.dims):
            return self._sharded_transform([da], axis, target, target_data, multi=False,
                                           **kwargs)
        return self.grid.transform(da, axis, target, target_data=target_data, **kwargs)

    def transform_multi(self, das, axis, target, target_data=None, **kwargs):
        """Multi-variable vertical transform (same sharding rules as
        :meth:`transform`; kernels F and H per shard)."""
        from ..adapters.xarray_adapter import as_native

        das = [as_native(d) for d in das]
        target = as_native(target)
        target_data = as_native(target_data)
        for da in das:
            self._check_transform_dim(da, axis)
        if das and any(
            self.dim_to_mesh_axis.get(d) is not None for da in das for d in da.dims
        ):
            return self._sharded_transform(das, axis, target, target_data, multi=True, **kwargs)
        return self.grid.transform_multi(das, axis, target, target_data=target_data, **kwargs)
