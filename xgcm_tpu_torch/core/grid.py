"""The Grid: user-facing API over multiple staggered axes.

The counterpart of :class:`xgcm_tpu.core.grid.Grid` on torch tensors.  This
slice ports construction (with metadata auto-parsing), the 1D grid-ufunc
dispatch, the fused shift fast path, ``interp``/``diff``/``min``/``max``,
and ``transform``/``transform_multi``.  Face connections, metrics, cumsum,
the metric-weighted calculus, vector ops and the xarray bridge are not
ported yet; asking for them raises ``NotImplementedError`` (ROADMAP
Queue 1).
"""

from __future__ import annotations

import inspect
import warnings
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Union

import numpy as np
import torch

from . import gridops
from .axis import Axis
from .dataarray import GriddedArray
from .dataset import Dataset
from .grid_ufunc import (
    GridUFunc,
    GridUFuncSignature,
    _check_data_input,
    _maybe_unpack_vector_component,
    apply_as_grid_ufunc,
)

__all__ = ["Grid"]


def _maybe_promote_str_to_list(a):
    if isinstance(a, str):
        return [a]
    return a


class Grid:
    """An object with multiple :class:`~xgcm_tpu_torch.core.axis.Axis`
    objects representing different independent staggered directions."""

    def __init__(
        self,
        ds: Dataset,
        coords: Optional[Mapping[str, Mapping[str, str]]] = None,
        periodic: Union[bool, List[str], None] = None,
        fill_value: Optional[Union[float, Mapping[str, float]]] = None,
        default_shifts: Optional[Mapping[str, Any]] = None,
        boundary: Optional[Union[str, Mapping[str, str]]] = None,
        face_connections: Optional[Dict[str, Any]] = None,
        metrics: Optional[Mapping] = None,
        autoparse_metadata: bool = True,
    ):
        """Create a Grid from a Dataset.

        ``coords`` maps axis name -> {position: dim name};
        ``periodic``/``boundary``/``fill_value`` take scalars or per-axis
        dicts.  ``face_connections`` and ``metrics`` are not ported yet.
        """
        if not isinstance(ds, Dataset):
            raise TypeError(
                f"ds argument to Grid must be an xgcm_tpu_torch.Dataset, but "
                f"is of type {type(ds)}"
            )
        self._ds = ds

        if autoparse_metadata:
            from ..parsers import metadata

            ds, parsed_kwargs = metadata.parse_metadata(ds)
            self._ds = ds
            user_kwargs = {
                "coords": coords,
                "fill_value": fill_value,
                "default_shifts": default_shifts,
                "boundary": boundary,
                "face_connections": face_connections,
                "metrics": metrics,
            }
            duplicates = [
                key
                for key in parsed_kwargs
                if key in user_kwargs and user_kwargs[key] is not None
            ]
            if "coords" in parsed_kwargs and coords is None:
                coords = parsed_kwargs["coords"]
            if duplicates:
                raise ValueError(
                    f"Autoparsed Grid kwargs: '{', '.join(duplicates)}' conflict "
                    f"with user-supplied kwargs. Run with "
                    f"'autoparse_metadata=False', or autoparse and amend kwargs "
                    f"before calling Grid constructer."
                )

        if face_connections:
            raise NotImplementedError(
                "face-connected grids are not ported yet (ROADMAP Queue 1, item 10)"
            )
        if metrics is not None:
            raise NotImplementedError(
                "grid metrics are not ported yet (ROADMAP Queue 1, item 8)"
            )

        if boundary:
            warnings.warn(
                "The `boundary` argument will be renamed "
                "to `padding` to better reflect the process "
                "of array padding and avoid confusion with "
                "physical boundary conditions (e.g. ocean land boundary).",
                category=DeprecationWarning,
            )
        if periodic:
            warnings.warn(
                "The `periodic` argument will be deprecated. "
                "To preserve previous behavior supply `boundary = 'periodic'.",
                category=DeprecationWarning,
            )
        if fill_value:
            warnings.warn(
                "The default fill_value will be changed to nan (from 0.0 "
                "previously) in future versions. Provide `fill_value=0.0` to "
                "preserve previous behavior.",
                category=DeprecationWarning,
            )

        if coords is None:
            raise ValueError(
                "Could not determine Axis names - please provide them in the "
                "coords kwarg or provide a dataset from which they can be parsed"
            )

        all_axes = list(coords.keys())
        boundary_dict = self._map_kwargs_over_axes(boundary, axes=all_axes)

        # `periodic` survives for backwards compatibility; None = legacy
        # default True without triggering the deprecation path
        effective_periodic = True if periodic is None else periodic
        if isinstance(effective_periodic, list):
            periodic_dict: Dict[str, Any] = {ax: True for ax in effective_periodic}
            for ax in all_axes:
                periodic_dict.setdefault(ax, False)
        else:
            periodic_dict = self._map_kwargs_over_axes(effective_periodic, axes=all_axes)
        for ax in all_axes:
            if boundary_dict.get(ax) is None:
                boundary_dict[ax] = "periodic" if periodic_dict.get(ax, False) else "fill"

        default_shifts_dict = self._map_kwargs_over_axes(default_shifts, axes=all_axes)
        fill_value_dict = self._map_kwargs_over_axes(fill_value, axes=all_axes)

        # a dimension may serve exactly one (axis, position)
        seen_dims: Dict[str, Any] = {}
        for axis_name in all_axes:
            for pos, dim in coords[axis_name].items():
                if dim in seen_dims:
                    p_ax, p_pos = seen_dims[dim]
                    raise ValueError(
                        f"Dimension {dim!r} is assigned to more than one "
                        f"axis position: ({p_ax!r}, {p_pos!r}) and "
                        f"({axis_name!r}, {pos!r})"
                    )
                seen_dims[dim] = (axis_name, pos)

        self.axes: "OrderedDict[str, Axis]" = OrderedDict()
        for axis_name in all_axes:
            self.axes[axis_name] = Axis(
                ds,
                axis_name,
                coords=coords[axis_name],
                default_shifts=default_shifts_dict.get(axis_name, None),
                boundary=boundary_dict.get(axis_name, None),
                fill_value=fill_value_dict.get(axis_name, None),
            )

    # ------------------------------------------------------------------ kwargs
    def _map_kwargs_over_axes(
        self, kwargs: Union[Any, Dict[str, Any]], axes: Optional[Iterable[str]] = None
    ) -> Dict[str, Any]:
        """Promote a scalar kwarg to a per-axis dict."""
        if axes is None:
            axes = self.axes
        if isinstance(kwargs, dict):
            return dict(kwargs)
        return {ax: kwargs for ax in axes}

    def _complete_user_kwargs_using_axis_defaults(
        self, user_kwargs: Union[Any, Dict[str, Any]], property: str
    ) -> Dict[str, Any]:
        """Per-call kwarg > per-axis default resolution."""
        defaults = {ax: getattr(self.axes[ax], property) for ax in self.axes}
        if user_kwargs is None:
            return defaults
        return {**defaults, **self._map_kwargs_over_axes(user_kwargs)}

    def _get_dims_from_axis(self, da, axis) -> List[str]:
        da = _maybe_unpack_vector_component(da)
        dims = []
        for ax in _maybe_promote_str_to_list(axis):
            if ax not in self.axes:
                raise KeyError(f"Did not find axis {ax} from data array {da.name}")
            matching = [d for d in self.axes[ax].coords.values() if d in da.dims]
            if len(matching) != 1:
                raise ValueError(
                    f"Did not find single matching dimension {da.dims} from "
                    f"{da.name} corresponding to axis {ax}, got {matching}."
                )
            dims.append(matching[0])
        return dims

    def coords_for(self, array: GriddedArray) -> Dict[str, GriddedArray]:
        """Coordinate variables from the grid dataset whose dims all appear
        in ``array.dims``."""
        return {
            name: c
            for name, c in self._ds.coords.items()
            if all(d in array.dims for d in c.dims)
        }

    def __repr__(self):
        lines = ["<xgcm_tpu_torch.Grid>"]
        for name, axis in self.axes.items():
            state = "periodic" if axis.periodic else "not periodic"
            lines.append(f"{name} Axis ({state}, boundary={axis.boundary!r}):")
            lines += axis._coord_desc()
        return "\n".join(lines)

    # --------------------------------------------------------------- dispatch
    def _1d_grid_ufunc_dispatch(
        self,
        funcname: str,
        data: Union[GriddedArray, Dict[str, GriddedArray]],
        axis,
        to=None,
        keep_coords: bool = False,
        metric_weighted=None,
        other_component: Optional[Dict[str, GriddedArray]] = None,
        **kwargs,
    ):
        """Select and apply the right 1D grid ufunc per axis, sequentially;
        the fused shift path serves what it can."""
        if metric_weighted:
            raise NotImplementedError(
                "metric-weighted ops are not ported yet (ROADMAP Queue 1, item 8)"
            )
        if isinstance(axis, str):
            axis = [axis]

        data = _check_data_input(data, self)
        data_unpacked = _maybe_unpack_vector_component(data)
        to = self._map_kwargs_over_axes(to)
        signatures = self._create_1d_grid_ufunc_signatures(
            data_unpacked, axis=axis, to=to
        )

        array: Any = dict(data) if isinstance(data, dict) else data
        for signature_1d, ax_name in zip(signatures, axis):
            grid_ufunc, remaining_kwargs = _select_grid_ufunc(
                funcname, signature_1d, module=gridops, **kwargs
            )
            fused = self._maybe_fused_1d_op(
                funcname, array, ax_name, signature_1d, remaining_kwargs
            )
            if fused is not None:
                array = fused
            else:
                array = grid_ufunc(
                    self,
                    array,
                    axis=[(ax_name,)],
                    keep_coords=keep_coords,
                    other_component=other_component,
                    **remaining_kwargs,
                )
        return array

    def _maybe_fused_1d_op(
        self, funcname, array, ax_name, signature_1d, call_kwargs
    ) -> Optional[GriddedArray]:
        """Fused fast path for the hot 1D stencils: float inputs, the four
        length-preserving position pairs and the standard boundary kwargs.
        Bit-identical to the generic pad-then-stencil path (see
        ops/fused.py); ``None`` sends the call to the generic engine."""
        from ..ops.fused import FUSABLE_OPS, FUSABLE_PAIRS, fused_shift_op

        if funcname not in FUSABLE_OPS:
            return None
        if isinstance(array, dict):
            # face-less grids: basic BCs ignore the partner, so a vector
            # component behaves exactly like a scalar
            ((_, array),) = array.items()
        data = array.data
        if not (data.is_floating_point() if isinstance(data, torch.Tensor)
                else np.issubdtype(data.dtype, np.floating)):
            return None  # integer and bool inputs take the generic engine
        if set(call_kwargs) - {"boundary", "fill_value"}:
            return None
        from_pos = signature_1d.in_ax_positions[0][0]
        to_pos = signature_1d.out_ax_positions[0][0]
        if (from_pos, to_pos) not in FUSABLE_PAIRS:
            return None

        ax = self.axes[ax_name]
        boundary = self._complete_user_kwargs_using_axis_defaults(
            call_kwargs.get("boundary"), "boundary"
        )[ax_name]
        fill_value = self._complete_user_kwargs_using_axis_defaults(
            call_kwargs.get("fill_value"), "fill_value"
        )[ax_name]
        if boundary not in ("periodic", "fill", "extend", "extrapolate", None):
            return None

        dim = ax.coords[from_pos]
        out_dim = ax.coords[to_pos]
        data = fused_shift_op(
            array.data,
            array.get_axis_num(dim),
            funcname,
            FUSABLE_PAIRS[(from_pos, to_pos)],
            boundary,
            float(fill_value),
        )
        dims = tuple(out_dim if d == dim else d for d in array.dims)
        return GriddedArray(data, dims, name=array.name)

    def _create_1d_grid_ufunc_signatures(
        self, da: GriddedArray, axis, to
    ) -> List[GridUFuncSignature]:
        """One "(ax:from)->(ax:to)" signature per requested axis."""
        signatures = []
        for ax_name in axis:
            self._get_dims_from_axis(da, ax_name)
            ax = self.axes[ax_name]
            from_pos, _ = ax._get_position_name(da)
            to_pos = to.get(ax_name)
            if to_pos is None:
                to_pos = ax.default_shifts[from_pos]
            signatures.append(
                GridUFuncSignature.from_string(
                    f"({ax_name}:{from_pos})->({ax_name}:{to_pos})"
                )
            )
        return signatures

    def apply_as_grid_ufunc(
        self,
        func: Callable,
        *args,
        axis=None,
        signature="",
        boundary_width=None,
        boundary=None,
        fill_value=None,
        **kwargs,
    ):
        """Apply a custom kernel in a grid-aware manner (see
        :func:`xgcm_tpu_torch.apply_as_grid_ufunc`)."""
        return apply_as_grid_ufunc(
            func,
            *args,
            axis=axis,
            grid=self,
            signature=signature,
            boundary_width=boundary_width,
            boundary=boundary,
            fill_value=fill_value,
            **kwargs,
        )

    # ------------------------------------------------------------ op methods
    def interp(self, da, axis, **kwargs):
        """Interpolate neighbouring points to the intermediate position."""
        return self._1d_grid_ufunc_dispatch("interp", da, axis, **kwargs)

    def diff(self, da, axis, **kwargs):
        """Difference neighbouring points onto the intermediate position."""
        return self._1d_grid_ufunc_dispatch("diff", da, axis, **kwargs)

    def min(self, da, axis, **kwargs):
        """Minimum of neighbouring points."""
        return self._1d_grid_ufunc_dispatch("min", da, axis, **kwargs)

    def max(self, da, axis, **kwargs):
        """Maximum of neighbouring points."""
        return self._1d_grid_ufunc_dispatch("max", da, axis, **kwargs)

    def transform(self, da, axis, target, **kwargs):
        """Convert ``da`` to new 1D coordinates along ``axis``.

        ``method="linear"`` (the default; ``target`` holds the new cell
        centres, ``target_data`` must be monotonic per column and is
        flipped where it decreases), ``"log"`` (linear in log space) or
        ``"conservative"`` (``target`` holds cell bounds; the column
        integral is conserved; the axis needs ``outer`` coordinates, and
        ``target_data`` not on them is interpolated there with a warning).
        ``target_data`` defaults to the axis coordinate of ``da``.  Other
        keywords: ``target_dim``, ``mask_edges``, ``bypass_checks``,
        ``suffix`` and, for the conservative method, ``reassociate`` (see
        :func:`xgcm_tpu_torch.ops.transform.transform`).  On CUDA
        tensors the remap runs the linear (C) or conservative (G) kernel.
        """
        from ..ops.transform import transform

        return transform(self, axis, da, target, **kwargs)

    def transform_multi(self, das, axis, target, **kwargs):
        """Transform several arrays onto the same target coordinate:
        exactly ``[self.transform(da, axis, target, **kwargs) for da in
        das]``.  On the card, 2 to 8 float32/bfloat16 arrays of equal dims
        share one kernel pass (F for linear/log, H for conservative) that
        reads ``target_data`` once; everywhere else the list is built by
        that loop."""
        from ..ops.transform import transform_multi

        return transform_multi(self, axis, das, target, **kwargs)


def _select_grid_ufunc(funcname, signature: GridUFuncSignature, module, **kwargs):
    """Pick the predefined GridUFunc by name prefix + signature equivalence."""

    def is_grid_ufunc(obj):
        return isinstance(obj, GridUFunc)

    all_predefined = inspect.getmembers(module, is_grid_ufunc)
    name_matching = [f for name, f in all_predefined if name.startswith(funcname)]
    if not name_matching:
        raise NotImplementedError(
            f"Could not find any pre-defined {funcname} grid ufuncs"
        )
    sig_matching = [f for f in name_matching if f.signature.equivalent(signature)]
    if not sig_matching:
        raise NotImplementedError(
            f"Could not find any pre-defined {funcname} grid ufuncs with "
            f"signature {signature}"
        )
    if len(sig_matching) > 1:
        raise ValueError(
            f"Function {funcname} with signature='{signature}' and "
            f"kwargs={kwargs} is an ambiguous selection"
        )
    return sig_matching[0], kwargs
