"""Many grid ufuncs, one halo exchange.

The counterpart of :mod:`xgcm_tpu.parallel.apply_many`.  A chain of
sharded ops pays one exchange each: ``sgrid.diff(v, "X") - sgrid.diff(u,
"Y")`` is two shard programs and two exchange rounds.
:func:`sharded_apply_many` runs any list of grid-ufunc applications as one
shard program: each distinct input is padded once, at the widest halo any
op of the batch asks for under the same boundary conditions, and every op
gets that padded block sliced down to its own widths.  So the batch makes
the collectives of one exchange per distinct (input, boundary conditions,
vector role), the generalisation of the hand-fused
:func:`~.diagnostics.sharded_cgrid_diagnostics`.

On a face-sharded grid each distinct input is also cut into its
dummy-padded face blocks once, where each separate op cuts its own.  The
ops run the ``core.gridops`` ufuncs in the engine on the padded blocks, as
JAX's do: no kernel of ``csrc/`` is launched.  Each result equals the
single-op :func:`~.sharded_ufunc.sharded_apply_as_grid_ufunc` call.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np

from ..core.dataarray import GriddedArray
from ..core.grid import Grid
from ..core.grid_ufunc import (
    _identify_dummy_axes_with_real_axes,
    _maybe_unpack_vector_component,
    apply_as_grid_ufunc,
)
from ..core.signature import GridUFuncSignature
from .collectives import coords, shard_map
from .face_sharded import FaceSetup
from .mesh import Mesh, partition_spec
from .sharded_tensor import ShardedTensor
from .sharded_ufunc import (
    _LENGTH_PRESERVING,
    _local_grid,
    _output_dims,
    _pad_blocks,
    _sharded_axes_of,
)

__all__ = ["sharded_apply_many"]


def _convert_spec_arrays(spec: Mapping[str, Any]) -> Mapping[str, Any]:
    """A spec with the xarray DataArrays of its ``args`` and
    ``other_component`` as GriddedArrays (the Grid ops' bridge)."""
    from ..adapters.xarray_adapter import as_native

    def conv(a):
        if isinstance(a, dict):
            return {k: as_native(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(conv(x) for x in a)
        return as_native(a)

    out = dict(spec)
    for key in ("args", "other_component"):
        if out.get(key) is not None:
            out[key] = conv(out[key])
    return out


def _normalize_spec(spec: Mapping[str, Any], grid: Grid) -> Mapping[str, Any]:
    """A spec by name (``op="diff", axis="X", to=...``) in the full
    func/signature/boundary_width form, with the ``core.gridops`` ufunc
    that the Grid op of that name selects."""
    if "func" in spec:
        return spec
    from ..core import gridops
    from ..core.grid import _select_grid_ufunc

    name = spec["op"]
    if name == "cumsum":
        raise ValueError(
            "cumsum is not batchable (prefix sums need their own collective "
            "plan); use ShardedGrid.cumsum / sharded_cumsum directly"
        )
    args = spec["args"]
    da = args[0] if isinstance(args, (list, tuple)) else args
    comp = next(iter(da.values())) if isinstance(da, dict) else da
    ax_name = spec["axis"]
    if not isinstance(ax_name, str):
        raise ValueError(
            "name-based specs take a single axis name (got "
            f"{ax_name!r}); pass explicit func/signature for multi-axis ops"
        )
    ax = grid.axes[ax_name]
    from_pos, _ = ax._get_position_name(comp)
    to_pos = spec.get("to") or ax.default_shifts[from_pos]
    sig = GridUFuncSignature.from_string(f"({ax_name}:{from_pos})->({ax_name}:{to_pos})")
    grid_ufunc, remaining = _select_grid_ufunc(
        name, sig, module=gridops, boundary=spec.get("boundary"),
        fill_value=spec.get("fill_value"),
    )
    new = {k: v for k, v in spec.items() if k not in ("op", "to", "boundary", "fill_value")}
    new["func"] = grid_ufunc.ufunc
    new["signature"] = grid_ufunc.signature
    new["boundary_width"] = grid_ufunc.boundary_width
    new["axis"] = [(ax_name,)]
    new["boundary"] = remaining.get("boundary")
    new["fill_value"] = remaining.get("fill_value")
    return new


class _OpPlan:
    """One op of the batch, resolved: its signature, its real axis widths
    and core dims, and ``boundary``/``fill_value`` per axis against the
    real grid's defaults."""

    def __init__(self, spec: Mapping[str, Any], grid: Grid):
        self.func = spec["func"]
        args = spec["args"]
        if not isinstance(args, (list, tuple)):
            args = [args]
        self.args = list(args)
        axis = spec["axis"]
        if isinstance(axis, str):
            axis = [(axis,)]
        self.axis = [tuple(a) for a in axis]
        sig = spec["signature"]
        self.sig = (sig if isinstance(sig, GridUFuncSignature)
                    else GridUFuncSignature.from_string(sig))
        self.boundary_width = dict(spec.get("boundary_width") or {})
        self.kwargs = dict(spec.get("kwargs") or {})

        ocs = spec.get("other_component")
        if ocs is None or isinstance(ocs, dict):
            ocs = [ocs]
        ocs = list(ocs)
        self.ocs = ocs + [None] * (len(self.args) - len(ocs))

        self.bc = grid._complete_user_kwargs_using_axis_defaults(spec.get("boundary"), "boundary")
        self.fv = grid._complete_user_kwargs_using_axis_defaults(spec.get("fill_value"),
                                                                 "fill_value")

        dummy_to_real = _identify_dummy_axes_with_real_axes(self.sig.in_ax_names, self.axis)
        self.out_ax_names = [[dummy_to_real[ax] for ax in arg] for arg in self.sig.out_ax_names]
        self.real_widths = {dummy_to_real[ax]: tuple(w) for ax, w in self.boundary_width.items()}
        self.in_core_dims = [
            [grid.axes[n].coords[p] for n, p in zip(arg_ns, arg_ps)]
            for arg_ns, arg_ps in zip(self.axis, self.sig.in_ax_positions)
        ]
        self.out_core_dims = [
            [grid.axes[n].coords[p] for n, p in zip(arg_ns, arg_ps)]
            for arg_ns, arg_ps in zip(self.out_ax_names, self.sig.out_ax_positions)
        ]
        self.single_out = len(self.out_core_dims) == 1

    def bc_key(self, slot: int, vec_axis, partner_slot) -> tuple:
        """The pad's cache key: the same input under the same resolved
        boundary conditions in the same vector role pads to the same
        values at any width."""
        return (slot, vec_axis, partner_slot,
                tuple(sorted((a, self.bc[a], float(self.fv[a])) for a in self.bc)))


def _cut(padded: GriddedArray, widths, boundary_width, local_grid: Grid) -> GriddedArray:
    """A block padded at ``widths`` sliced down to ``boundary_width``: the
    halo's values sit at fixed offsets from the interior, so the narrower
    pad is a view of the wider one."""
    for axname, (mlw, mrw) in widths.items():
        lw, rw = boundary_width.get(axname, (0, 0))
        if (mlw, mrw) == (lw, rw):
            continue
        dim = local_grid.axes[axname]._get_position_name(padded)[1]
        n = padded.sizes[dim] - mlw - mrw
        padded = padded.isel({dim: slice(mlw - lw, mlw + n + rw)})
    return padded


def sharded_apply_many(
    op_specs: Sequence[Mapping[str, Any]],
    *,
    grid: Grid,
    mesh: Mesh,
    dim_to_mesh_axis: Mapping[str, str],
):
    """Apply a batch of grid ufuncs as one shard program with shared halos.

    Each entry of ``op_specs`` is a dict with keys ``func``, ``args`` (an
    array or a list; single-entry dicts mark vector components), ``axis``,
    ``signature``, ``boundary_width``, and optionally ``boundary``,
    ``fill_value``, ``other_component``, ``kwargs``.  Built-in ops can be
    named instead: ``dict(op="diff", args=v, axis="X", to="left",
    boundary="fill")`` selects the gridops ufunc that ``ShardedGrid.diff``
    would (cumsum excepted: prefix sums have their own collective plan).
    Returns a list with one entry per op (a GriddedArray, or a tuple for a
    ufunc with several outputs), each equal to the single-op
    :func:`~.sharded_ufunc.sharded_apply_as_grid_ufunc` call.
    """
    op_specs = [_normalize_spec(_convert_spec_arrays(spec), grid) for spec in op_specs]
    if not op_specs:
        return []
    face_setup = None
    a0 = op_specs[0]["args"]
    first = _maybe_unpack_vector_component(a0[0] if isinstance(a0, (list, tuple)) else a0)
    if grid._face_connections is not None:
        if dim_to_mesh_axis.get(grid._facedim) is not None:
            face_setup = FaceSetup.infer(grid, mesh, dim_to_mesh_axis,
                                         first_arg_dims=tuple(getattr(first, "dims", ())))
        else:
            # face dim local on every shard: the ring route serves sharded
            # non-connected axes; a sharded face-connected dim has no
            # shard-local halo (the single-op engine's rule)
            conn_dims = {
                d
                for links in grid._face_connections[grid._facedim].values()
                for a in links
                for d in grid.axes[a].coords.values()
            }
            bad = sorted(conn_dims & set(dim_to_mesh_axis))
            if bad:
                raise NotImplementedError(
                    f"sharding the face-connected dims {bad} requires the "
                    f"face dim {grid._facedim!r} mapped to a mesh axis too"
                )
            if any(isinstance(s["args"][0] if isinstance(s["args"], (list, tuple))
                              else s["args"], dict) for s in op_specs):
                raise NotImplementedError(
                    "vector components on a face-connected grid require "
                    "the face dim mesh-mapped"
                )

    plans = [_OpPlan(spec, grid) for spec in op_specs]
    axis_to_mesh_axis = _sharded_axes_of(grid, dim_to_mesh_axis)

    restricted = set(axis_to_mesh_axis)
    if face_setup is not None:
        restricted |= {face_setup.x_axis, face_setup.y_axis}
    for plan in plans:
        for arg_ns, arg_ps in zip(list(plan.axis) + plan.out_ax_names,
                                  list(plan.sig.in_ax_positions)
                                  + list(plan.sig.out_ax_positions)):
            for n, p in zip(arg_ns, arg_ps):
                if n in restricted and p not in _LENGTH_PRESERVING:
                    raise NotImplementedError(
                        f"cannot shard along axis {n!r}: position {p!r} "
                        f"changes the array length"
                    )

    # faces-local route: shards hold whole faces, so the local pads of
    # connected axes assemble cross-face halos
    local_grid = _local_grid(grid, mesh, axis_to_mesh_axis,
                             keep_face_connections=face_setup is None)
    sharded_dims = {
        dim: axis_to_mesh_axis[name]
        for name, ax in grid.axes.items()
        if name in axis_to_mesh_axis
        for dim in ax.coords.values()
    }
    full_map = {**dict(dim_to_mesh_axis), **sharded_dims}

    # the distinct inputs, by the identity of their data
    slots: list = []
    slot_of: dict = {}

    def _slot(ga: GriddedArray) -> int:
        if id(ga.data) not in slot_of:
            slot_of[id(ga.data)] = len(slots)
            slots.append(ga)
        return slot_of[id(ga.data)]

    op_arg_slots = []  # per op: [(slot, vec_axis or None, (partner axis, slot) or None)]
    for plan in plans:
        entries = []
        for a, oc in zip(plan.args, plan.ocs):
            vec_axis = partner_slot = None
            if isinstance(a, dict):
                [vec_axis] = list(a)
                if oc is not None:
                    [pk] = list(oc)
                    partner_slot = (pk, _slot(oc[pk]))
            entries.append((_slot(_maybe_unpack_vector_component(a)), vec_axis, partner_slot))
        op_arg_slots.append(entries)

    # per pad key: the widest halo any op asks for, and the first op's
    # resolved boundary conditions (equal for every op of the key)
    max_widths: dict = {}
    key_plan: dict = {}
    for plan, entries in zip(plans, op_arg_slots):
        for entry in entries:
            key = plan.bc_key(*entry)
            key_plan.setdefault(key, (plan, entry))
            cur = max_widths.setdefault(key, {})
            for axname, (lw, rw) in plan.real_widths.items():
                clw, crw = cur.get(axname, (0, 0))
                cur[axname] = (max(clw, lw), max(crw, rw))

    in_specs = [partition_spec(s.dims, full_map) for s in slots]
    per_op_out_dims = []
    out_specs = []
    for plan, entries in zip(plans, op_arg_slots):
        odims = _output_dims([slots[e[0]].dims for e in entries], plan.in_core_dims,
                             plan.out_core_dims, plan.sig)
        per_op_out_dims.append(odims)
        out_specs.extend(partition_spec(d, full_map) for d in odims)

    if face_setup is not None:
        # each distinct input cut into its dummy-padded face blocks once
        placed = [ShardedTensor(face_setup.blocks(s, spec), mesh, spec)
                  for s, spec in zip(slots, in_specs)]
    else:
        placed = [s.data for s in slots]

    def local(*slot_blocks):
        # a halo exchange needs every shard's block: each key's pad runs on
        # all shards before the engine runs on any
        padded = {}
        for key, (plan, (slot, vec_axis, partner_slot)) in key_plan.items():
            partner = None
            if partner_slot is not None:
                ps = partner_slot[1]
                partner = (slots[ps], slot_blocks[ps])
            padded[key] = _pad_blocks(
                slots[slot], slot_blocks[slot], max_widths[key], mesh=mesh,
                local_grid=local_grid, fs=face_setup, axis_to_mesh_axis=axis_to_mesh_axis,
                bc=plan.bc, fv=plan.fv, vector_axis=vec_axis, partner=partner)
        outs = [np.empty(mesh.devices.shape, dtype=object) for _ in out_specs]
        for c in coords(mesh):
            local_slots = [GriddedArray(b[c], s.dims, name=s.name)
                           for b, s in zip(slot_blocks, slots)]
            i = 0
            for plan, entries, odims in zip(plans, op_arg_slots, per_op_out_dims):
                local_args, local_ocs, keys = [], [], []
                for slot, vec_axis, partner_slot in entries:
                    ga = local_slots[slot]
                    local_args.append(ga if vec_axis is None else {vec_axis: ga})
                    local_ocs.append(None if partner_slot is None
                                     else {partner_slot[0]: local_slots[partner_slot[1]]})
                    keys.append(plan.bc_key(slot, vec_axis, partner_slot))
                # the engine pads its arguments in order: hand it each one's
                # cached block, cut to this op's widths
                handed = iter(keys)

                def pad_fn(a, boundary_width, **kw):
                    key = next(handed)
                    return _cut(padded[key][c], max_widths[key], boundary_width, local_grid)

                res = apply_as_grid_ufunc(
                    plan.func, *local_args, axis=plan.axis, grid=local_grid, signature=plan.sig,
                    boundary_width=plan.boundary_width, boundary=plan.bc, fill_value=plan.fv,
                    other_component=local_ocs, _pad_fn=pad_fn, **plan.kwargs,
                )
                if plan.single_out:
                    res = (res,)
                for r, dims in zip(res, odims):
                    outs[i][c] = r.transpose(*dims).data
                    i += 1
        return tuple(outs)

    raw = shard_map(local, mesh, in_specs, tuple(out_specs))(*placed)

    results = []
    i = 0
    for plan, entries, odims in zip(plans, op_arg_slots, per_op_out_dims):
        name = slots[entries[0][0]].name
        rs = []
        for dims in odims:
            data = raw[i] if face_setup is None else face_setup.result(raw[i].blocks, dims,
                                                                       out_specs[i])
            rs.append(GriddedArray(data, dims, name=name))
            i += 1
        results.append(rs[0] if plan.single_out else tuple(rs))
    return results
