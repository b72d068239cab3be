"""The Grid: user-facing API over multiple staggered axes.

The counterpart of :class:`xgcm_tpu.core.grid.Grid` on torch tensors:
construction (with metadata auto-parsing and face connections), the metric
registry with its find-or-derive resolution, the 1D grid-ufunc dispatch
with its fused shift fast paths (face-less and face-connected),
``interp``/``diff``/``min``/``max`` on scalars and vector components,
``cumsum``, the metric-weighted calculus (``derivative``, ``integrate``,
``cumint``, ``average`` and ``metric_weighted=``),
``diff_2d_vector``/``interp_2d_vector``, and ``transform``/
``transform_multi``.  Inputs are GriddedArrays or, with xarray installed,
``xr.DataArray``s: the entry points take either, and give xarray back for
xarray in, with the coordinates reattached by xgcm's rules
(:mod:`xgcm_tpu_torch.adapters.xarray_adapter`).
"""

from __future__ import annotations

import functools
import inspect
import itertools
import operator
import warnings
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Union

import numpy as np
import torch

from ..ops.kernels.weighted_sum import MAX_DIMS, MAX_FACTORS, weighted_sum
from ..utils.profiling import span
from . import gridops
from .axis import Axis
from .dataarray import GriddedArray, _broadcast_align, _expand_to, as_tensor
from .dataset import Dataset
from .device import get_default_device
from .grid_ufunc import (
    GridUFunc,
    GridUFuncSignature,
    _check_data_input,
    _maybe_unpack_vector_component,
    apply_as_grid_ufunc,
)
from .metrics import iterate_axis_combinations
from .padding import pad

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
        """Create a Grid from a Dataset (or an ``xr.Dataset``, with xarray
        installed).

        ``coords`` maps axis name -> {position: dim name};
        ``periodic``/``boundary``/``fill_value`` take scalars or per-axis
        dicts.  ``face_connections`` maps one face dim to the per-face
        links ``{face: {axis: (left, right)}}``, each link ``None`` or
        ``(face, axis, reverse)``.  ``metrics`` maps axis tuples to the
        names of metric variables in ``ds``.
        """
        if not isinstance(ds, Dataset):
            from ..adapters.xarray_adapter import maybe_from_xarray

            converted = maybe_from_xarray(ds)
            if converted is None:
                raise TypeError(
                    f"ds argument to Grid must be an xgcm_tpu_torch.Dataset (or "
                    f"xarray.Dataset), but is of type {type(ds)}"
                )
            ds = converted
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
            if "metrics" in parsed_kwargs and metrics is None:
                metrics = parsed_kwargs["metrics"]
            if duplicates:
                raise ValueError(
                    f"Autoparsed Grid kwargs: '{', '.join(duplicates)}' conflict "
                    f"with user-supplied kwargs. Run with "
                    f"'autoparse_metadata=False', or autoparse and amend kwargs "
                    f"before calling Grid constructer."
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

        if face_connections:
            self._facedim = list(face_connections.keys())[0]
            self._face_connections = face_connections
        else:
            self._facedim = None
            self._face_connections = None
        # the axes that the face connections name, sorted
        self._face_axes: List[str] = sorted(
            {a for links in face_connections[self._facedim].values() for a in links}
        ) if face_connections else []
        # device copies of the compiled face plans, by (x axis, y axis, device,
        # rows)
        self._face_plans: Dict[Any, Any] = {}

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

        if face_connections is not None:
            self._assign_face_connections(face_connections)

        self._metrics: Dict[frozenset, List[GriddedArray]] = {}
        # tensor copies of the registered metrics, by (id, device)
        self._metric_tensors: Dict[Any, Any] = {}
        if metrics is not None:
            for key, value in metrics.items():
                self.set_metrics(key, value)

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

    # -------------------------------------------------------- face connections
    def _assign_face_connections(self, fc):
        """Check that every face link is linked back by its neighbour, and
        attach the links to the axes."""
        if len(fc) > 1:
            raise ValueError(
                "Only one face dimension is supported for now. "
                f"Instead found {list(fc.keys())!r}"
            )
        facedim = list(fc.keys())[0]
        if facedim not in self._ds.dims:
            raise ValueError(
                f"Face dimension {facedim} does not exist in the dataset. "
                f"Found {list(self._ds.dims)} instead"
            )

        face_links = fc[facedim]
        n_faces = self._ds.dims[facedim]
        valid_face_ids = set(range(n_faces))
        axis_connections: Dict[str, Dict[int, tuple]] = {}

        for fidx, face_axis_links in face_links.items():
            for axis, axis_links in face_axis_links.items():
                axis_connections.setdefault(axis, {})
                link_left, link_right = axis_links

                def check_neighbor(link, position):
                    if link is None:
                        return None
                    idx, ax, rev = link
                    correct_position = int(not position) if rev else position
                    try:
                        neighbor_link = face_links[idx][ax][correct_position]
                    except (KeyError, IndexError):
                        raise KeyError(
                            f"Couldn't find a face link for face {idx!r}"
                            f"in axis {ax!r} at position {correct_position!r}"
                        )
                    idx_n, ax_n, rev_n = neighbor_link
                    if ax not in self.axes:
                        raise KeyError(f"axis {ax!r} is not a valid axis")
                    if ax_n not in self.axes:
                        raise KeyError(f"axis {ax_n!r} is not a valid axis")
                    if idx not in valid_face_ids:
                        raise IndexError(
                            f"{idx!r} is not a valid index for face"
                            f"dimension {facedim!r}"
                        )
                    if idx_n not in valid_face_ids:
                        raise IndexError(
                            f"{idx!r} is not a valid index for face"
                            f"dimension {facedim!r}"
                        )
                    if (idx_n != fidx) or (ax_n != axis) or (rev_n != rev):
                        raise ValueError(
                            "Face link mismatch: neighbor doesn't"
                            " correctly link back to this face. "
                            f"face: {fidx!r}, axis: {axis!r}, "
                            f"position: {position!r}, rev: {rev!r}, "
                            f"link: {link!r}, neighbor_link: {neighbor_link!r}"
                        )
                    return idx, self.axes[ax], rev

                left = check_neighbor(link_left, 1)
                right = check_neighbor(link_right, 0)
                axis_connections[axis][fidx] = (left, right)

        for axis, links in axis_connections.items():
            self.axes[axis]._facedim = facedim
            self.axes[axis]._face_connections = links

    # ----------------------------------------------------------------- metrics
    def set_metrics(self, key, value, overwrite=False):
        """Register metric variables (names in the dataset) for a set of
        axes; a variable with the dims of one already registered for these
        axes replaces it only with ``overwrite=True``."""
        metric_axes = frozenset(_maybe_promote_str_to_list(key))
        not_found = [ma for ma in metric_axes if ma not in self.axes]
        if not_found:
            raise KeyError(
                f"Metric axes {not_found!r} not compatible with grid axes "
                f"{tuple(self.axes)!r}"
            )

        metric_values = _maybe_promote_str_to_list(value)
        for name in metric_values:
            if name not in self._ds:
                raise KeyError(f"Metric variable {name} not found in dataset.")

        if metric_axes in self._metrics:
            existing = self._metrics[metric_axes]
            for name in metric_values:
                new_var = self._ds[name]
                did_overwrite = False
                for idx, ve in enumerate(existing):
                    if set(new_var.dims) == set(ve.dims):
                        if overwrite:
                            existing[idx] = new_var
                            did_overwrite = True
                        else:
                            raise ValueError(
                                f"Metric variable {ve.name} with dimensions "
                                f"{ve.dims} already assigned in metrics. "
                                f"Overwrite {ve.name} with {name} by setting "
                                f"overwrite=True."
                            )
                if not did_overwrite:
                    existing.append(new_var)
        else:
            self._metrics[metric_axes] = [self._ds[name] for name in metric_values]

    def _metric_on(self, var: GriddedArray, device) -> GriddedArray:
        """A registered metric as a tensor on ``device``.  Dataset
        coordinates are host arrays; each is copied to a device once and
        kept, so no op copies a metric from the host again."""
        key = (id(var), torch.device(device))
        hit = self._metric_tensors.get(key)
        if hit is None or hit[0] is not var:
            hit = (var, GriddedArray(var.data, var.dims, name=var.name,
                                     attrs=var.attrs, device=device))
            self._metric_tensors[key] = hit
        return hit[1]

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

    @span("xtt.arith.get_metric")
    def get_metric(self, array: GriddedArray, axes) -> GriddedArray:
        """Find or derive the metric for ``axes`` that broadcasts against
        ``array``, as a tensor on ``array``'s device:

        1. a metric registered for exactly these axes whose dims ``array``
           has;
        2. one registered for these axes at other positions, interpolated
           to ``array``'s (``boundary="extend"``, with a warning);
        3. the product of metrics of fewer axes whose dims ``array`` has;
        4. that product, interpolated (with a warning).

        Conditions 3 and 4 scan in two phases: every product is tried for
        matching dims before any is interpolated.
        """
        metric, _ = self._find_metric(array, axes)
        if isinstance(metric, GriddedArray):
            return metric
        return _metric_product(metric, array)

    def _find_metric(self, array, axes):
        """``(metric, interpolated)``: what :meth:`get_metric` resolves
        before it multiplies, either one metric (conditions 1 and 2) or the
        tuple of factors whose :func:`_metric_product` is the metric
        (conditions 3 and 4), in the order it multiplies them; and whether
        it was interpolated (conditions 2 and 4, which warn)."""
        metric_vars = None
        interpolated = False
        array_dims = set(array.dims)
        # an xarray array (derivative's host result) takes the metric on
        # the device its op ran on
        device = array.device if isinstance(array, GriddedArray) else get_default_device()

        self._get_dims_from_axis(array, frozenset(axes))

        possible_metric_keys = set(tuple(k) for k in self._metrics)
        possible_combos = set(itertools.permutations(tuple(axes)))
        overlap = possible_metric_keys & possible_combos

        if overlap:
            key = frozenset(*overlap)
            mv = None
            for mv in self._metrics[key]:
                if set(mv.dims).issubset(array_dims):
                    metric_vars = self._metric_on(mv, device)
                    break
            if metric_vars is None:
                warnings.warn(
                    f"Metric at {array.dims} being interpolated from metrics at "
                    f"dimensions {mv.dims}. Boundary value set to 'extend'."
                )
                metric_vars = self.interp_like(
                    self._metric_on(mv, device), array, "extend", None
                )
                interpolated = True
        else:
            for axis_combinations in iterate_axis_combinations(axes):
                try:
                    possible_sets = [self._metrics[ac] for ac in axis_combinations]
                    last_combo = None
                    for combo in itertools.product(*possible_sets):
                        last_combo = combo
                        metric_dims = set(d for mv in combo for d in mv.dims)
                        if metric_dims.issubset(array_dims):
                            metric_vars = tuple(self._metric_on(mv, device) for mv in combo)
                            break
                    if metric_vars is None and last_combo is not None:
                        possible_dims = [mv.dims for mv in last_combo]
                        warnings.warn(
                            f"Metric at {array.dims} being interpolated from "
                            f"metrics at dimensions {possible_dims}. Boundary "
                            f"value set to 'extend'."
                        )
                        metric_vars = tuple(
                            self.interp_like(self._metric_on(mv, device), array,
                                             "extend", None)
                            for mv in last_combo
                        )
                        interpolated = True
                    if metric_vars is not None:
                        break
                except KeyError:
                    pass
        if metric_vars is None:
            raise KeyError(
                f"Unable to find any combinations of metrics for array dims "
                f"{array_dims!r} and axes {axes!r}"
            )
        return metric_vars, interpolated

    @span("xtt.grid_api.interp_like")
    def interp_like(self, array, like, boundary=None, fill_value=None):
        """Interpolate ``array`` to the grid positions of ``like`` along
        every axis where they differ.  An ``xr.DataArray`` ``array`` is
        converted and the result is a GriddedArray, as in the JAX package;
        only the dims of ``like`` are read."""
        from ..adapters.xarray_adapter import as_native

        array = as_native(array)
        interp_axes = []
        for axname, axis in self.axes.items():
            try:
                pos_array, _ = axis._get_position_name(array)
                pos_like, _ = axis._get_position_name(like)
            except KeyError:
                continue
            if pos_like != pos_array:
                interp_axes.append(axname)
        if not interp_axes:
            return array
        return self.interp(
            array, interp_axes, fill_value=fill_value, boundary=boundary
        )

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
        the fused shift path serves what it can.  ``metric_weighted`` (axes,
        or a per-axis dict of axes) multiplies by that metric before each
        axis's op and divides by the metric at the result's position
        after it.  xarray in gives xarray out: grid coordinates on the
        position-shifted dims, the inputs' coordinates on the others."""
        from ..adapters.xarray_adapter import as_native, collect_xr_inputs

        if isinstance(axis, str):
            axis = [axis]

        return_xr, xr_args = collect_xr_inputs([data])
        data = _check_data_input(data, self)
        if isinstance(other_component, dict):
            other_component = {k: as_native(v) for k, v in other_component.items()}
        data_unpacked = _maybe_unpack_vector_component(data)
        to = self._map_kwargs_over_axes(to)
        if isinstance(metric_weighted, str):
            metric_weighted = (metric_weighted,)
        metric_weighted = self._map_kwargs_over_axes(metric_weighted)
        signatures = self._create_1d_grid_ufunc_signatures(
            data_unpacked, axis=axis, to=to
        )

        array: Any = dict(data) if isinstance(data, dict) else data
        for signature_1d, ax_name in zip(signatures, axis):
            grid_ufunc, remaining_kwargs = _select_grid_ufunc(
                funcname, signature_1d, module=gridops, **kwargs
            )
            ax_metric_weighted = metric_weighted.get(ax_name)
            if ax_metric_weighted:
                array = array * self.get_metric(array, ax_metric_weighted)

            fused = self._maybe_fused_1d_op(
                funcname, array, ax_name, signature_1d, remaining_kwargs,
                other_component=other_component,
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

            if ax_metric_weighted:
                array = array / self.get_metric(array, ax_metric_weighted)

        if return_xr:
            from ..adapters.xarray_adapter import reattach_coords

            out_core_dim_names = {
                self.axes[ax_name].coords[sig.out_ax_positions[0][0]]
                for sig, ax_name in zip(signatures, axis)
            }
            array = reattach_coords(array, self, xr_args, out_core_dim_names, keep_coords)
        return array

    def _maybe_fused_1d_op(
        self, funcname, array, ax_name, signature_1d, call_kwargs,
        other_component=None,
    ) -> Optional[GriddedArray]:
        """Fused fast path for the hot 1D stencils: float inputs, the four
        length-preserving position pairs and the standard boundary kwargs,
        on scalars and (on face-connected grids, with their
        ``other_component`` partner) vector components.  Bit-identical to
        the generic pad-then-stencil path (see ops/fused.py); ``None``
        sends the call to the generic engine."""
        from ..ops.fused import FUSABLE_OPS, FUSABLE_PAIRS, fused_shift_op

        if funcname not in FUSABLE_OPS:
            return None
        vector_axis = None
        partner = None
        if isinstance(array, dict):
            ((vector_axis, array),) = array.items()
            if self._face_connections is not None:
                # cross-face vector halos need the partner component
                if not isinstance(other_component, dict):
                    return None
                ((_, partner),) = other_component.items()
            # face-less grids: basic BCs ignore the partner, so the
            # component behaves exactly like a scalar
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
        data = as_tensor(array.data)
        if not (data.is_floating_point() or data.is_complex()):
            if boundary != "extrapolate":
                return None  # integer and bool inputs take the generic engine
            # the JAX package's fused path extrapolates as 2.0 * x - inward,
            # so integer and bool data come out float64 (x64): the same
            # values as the float64 path on the converted data
            array = array.with_data(data.to(torch.float64))
            if partner is not None:
                partner = partner.with_data(as_tensor(partner.data).to(torch.float64))

        dim = ax.coords[from_pos]
        out_dim = ax.coords[to_pos]
        direction = FUSABLE_PAIRS[(from_pos, to_pos)]

        if self._face_connections is not None:
            if ax_name in self._face_axes or self._facedim not in array.dims:
                fused = self._maybe_fused_face_op(
                    funcname, array, ax_name, dim, direction, boundary,
                    float(fill_value), vector_axis=vector_axis, partner=partner,
                )
                if fused is None:
                    return None
                data, arranged_dims = fused
                dims = tuple(out_dim if d == dim else d for d in arranged_dims)
                return GriddedArray(data, dims, name=array.name).transpose(
                    *(out_dim if d == dim else d for d in array.dims)
                )
            if boundary == "extrapolate":
                # the generic engine extrapolates as x0 - (x1 - x0), kernel
                # A as 2 x0 - x1: the two round apart
                return None

        # a face-less grid, or faces and an axis that no face connection
        # names (Z, T): the generic engine pads such an axis with its
        # boundary condition alone, as kernel A does
        data = fused_shift_op(
            array.data,
            array.get_axis_num(dim),
            funcname,
            direction,
            boundary,
            float(fill_value),
        )
        dims = tuple(out_dim if d == dim else d for d in array.dims)
        return GriddedArray(data, dims, name=array.name)

    def _maybe_fused_face_op(
        self, funcname, array, ax_name, dim, direction, boundary, fill_value,
        vector_axis=None, partner=None,
    ):
        """Fused face-connected fast path: a per-face shift whose one
        wrapped edge line per face comes from the compiled plan (see
        ops/fused.fused_face_shift_op).  Returns (data, arranged_dims), or
        ``None`` for the generic engine: a face dim or axis it cannot place,
        a plan it cannot compile, faces that are not square, a partner of
        another shape."""
        from ..ops.fused import fused_face_shift_op

        facedim = self._facedim
        if facedim not in array.dims:
            return None
        # the two face-spanning axes: those the connections name, the op
        # axis among them
        axes2 = self._face_axes
        if len(axes2) == 1:
            # a second spatial axis defines the strips: any other axis the
            # array spans
            others = [
                a for a in self.axes
                if a != ax_name
                and any(d in array.dims for d in self.axes[a].coords.values())
            ]
            if not others:
                return None
            axes2 = sorted([ax_name] + [others[0]])
        if len(axes2) != 2:
            return None
        try:
            dims_of = {a: self.axes[a]._get_position_name(array)[1] for a in axes2}
        except KeyError:
            return None
        # the "x" role goes to the axis later in the array's dim order, so
        # the canonical (face, y, x) arrangement is the identity
        a0, a1 = axes2
        if array.get_axis_num(dims_of[a0]) > array.get_axis_num(dims_of[a1]):
            x_axis, y_axis = a0, a1
        else:
            x_axis, y_axis = a1, a0
        xdim, ydim = dims_of[x_axis], dims_of[y_axis]

        rest = [d for d in array.dims if d not in (facedim, ydim, xdim)]
        arranged = array.transpose(*rest, facedim, ydim, xdim)
        ny, nx = arranged.shape[-2:]
        if ny != nx:
            # the (..., face, 4, L) strip table needs one strip length
            return None
        partner_data = None
        vector_axis_code = None
        if vector_axis is not None:
            if vector_axis not in (x_axis, y_axis):
                return None
            vector_axis_code = 0 if vector_axis == x_axis else 1
            if partner is not None:
                try:
                    p_ydim = self.axes[y_axis]._get_position_name(partner)[1]
                    p_xdim = self.axes[x_axis]._get_position_name(partner)[1]
                except KeyError:
                    return None
                p_rest = [d for d in partner.dims if d not in (facedim, p_ydim, p_xdim)]
                arranged_p = partner.transpose(*p_rest, facedim, p_ydim, p_xdim)
                if arranged_p.shape != arranged.shape:
                    return None  # staggered sizes differ: generic path
                partner_data = arranged_p.data

        plan = self._face_plan(x_axis, y_axis, arranged.device)
        if plan is None:
            return None
        data = fused_face_shift_op(
            arranged.data,
            plan,
            axis_is_x=(dim == xdim),
            op=funcname,
            direction=direction,
            boundary=boundary,
            fill_value=fill_value,
            partner=partner_data,
            vector_axis_code=vector_axis_code,
        )
        return data, arranged.dims

    def _face_plan(self, x_axis: str, y_axis: str, device, n_faces_total: Optional[int] = None):
        """The face plan for (x_axis, y_axis) as tensors on ``device``,
        compiled and copied there once (``None`` when a connection runs
        along neither axis); ``n_faces_total`` rows as
        :func:`~.topology.compile_face_plan` sizes them."""
        from .topology import DeviceFacePlan, compile_face_plan

        rows = max(self._ds.dims[self._facedim], n_faces_total or 0)
        key = (x_axis, y_axis, torch.device(device), rows)
        if key not in self._face_plans:
            try:
                plan = compile_face_plan(self, x_axis, y_axis, n_faces_total=rows)
            except KeyError:
                plan = None
            self._face_plans[key] = (
                None if plan is None else DeviceFacePlan.from_plan(plan, device)
            )
        return self._face_plans[key]

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

    @span("xtt.grid_api.apply_as_grid_ufunc")
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
    @span("xtt.grid_api.interp")
    def interp(self, da, axis, **kwargs):
        """Interpolate neighbouring points to the intermediate position."""
        return self._1d_grid_ufunc_dispatch("interp", da, axis, **kwargs)

    @span("xtt.grid_api.diff")
    def diff(self, da, axis, **kwargs):
        """Difference neighbouring points onto the intermediate position."""
        return self._1d_grid_ufunc_dispatch("diff", da, axis, **kwargs)

    @span("xtt.grid_api.min")
    def min(self, da, axis, **kwargs):
        """Minimum of neighbouring points."""
        return self._1d_grid_ufunc_dispatch("min", da, axis, **kwargs)

    @span("xtt.grid_api.max")
    def max(self, da, axis, **kwargs):
        """Maximum of neighbouring points."""
        return self._1d_grid_ufunc_dispatch("max", da, axis, **kwargs)

    @span("xtt.grid_api.cumsum")
    def cumsum(
        self,
        da: GriddedArray,
        axis,
        to=None,
        boundary=None,
        fill_value=None,
        metric_weighted=None,
        keep_coords: bool = False,
    ) -> GriddedArray:
        """Cumulative sum along each axis in turn, onto the position ``to``
        (by default the axis's default shift): the prefix sum, then the
        position pair's trim and pad (through the face-connection halos on
        a face-connected grid).  ``keep_coords`` applies to xarray results
        only."""
        from ..adapters.xarray_adapter import as_native, collect_xr_inputs

        return_xr, xr_args = collect_xr_inputs([da])
        da = as_native(da)
        if isinstance(axis, str):
            axis = [axis]
        to = self._map_kwargs_over_axes(to)
        if isinstance(metric_weighted, str):
            metric_weighted = (metric_weighted,)
        metric_weighted = self._map_kwargs_over_axes(metric_weighted)

        data = da
        new_dims = set()
        for ax_name in axis:
            # the typed unknown-axis and missing-dim errors
            self._get_dims_from_axis(data, ax_name)
            ax = self.axes[ax_name]
            pos, dim = ax._get_position_name(data)

            ax_metric_weighted = metric_weighted.get(ax_name)
            if ax_metric_weighted:
                data = data * self.get_metric(data, ax_metric_weighted)

            data = data.cumsum(dim)

            ax_to = to.get(ax_name)
            if ax_to is None:
                ax_to = ax.default_shifts[pos]

            if (pos == "center" and ax_to == "right") or (
                pos == "left" and ax_to == "center"
            ):
                bw = {ax_name: (0, 0)}
            elif (pos == "center" and ax_to == "left") or (
                pos == "right" and ax_to == "center"
            ):
                data = data.isel({dim: slice(0, -1)})
                bw = {ax_name: (1, 0)}
            elif (pos == "center" and ax_to == "inner") or (
                pos == "outer" and ax_to == "center"
            ):
                data = data.isel({dim: slice(0, -1)})
                bw = {ax_name: (0, 0)}
            elif (pos == "center" and ax_to == "outer") or (
                pos == "inner" and ax_to == "center"
            ):
                bw = {ax_name: (1, 0)}
            else:
                raise ValueError(
                    f"From `{pos}` to `{ax_to}` is not a valid position "
                    f"shift for cumsum operation along axis {ax}."
                )

            padded = pad(
                data=data,
                grid=self,
                boundary_width=bw,
                boundary=boundary,
                fill_value=fill_value,
            )
            new_dims.add(ax.coords[ax_to])
            data = padded.rename_dims({dim: ax.coords[ax_to]})

            if ax_metric_weighted:
                data = data / self.get_metric(data, ax_metric_weighted)

        if return_xr:
            from ..adapters.xarray_adapter import reattach_coords

            data = reattach_coords(data, self, xr_args, new_dims, keep_coords)
        return data

    # ----------------------------------------------------------- vector ops
    def _apply_vector_function(self, function, vector, **kwargs):
        """Apply ``function`` to each component of a 2D C-grid vector along
        its own axis, with the other component as its partner."""
        if not (len(vector) == 2 and isinstance(vector, dict)):
            raise ValueError(
                "Input is expected to be a dictionary with two key/value pairs "
                "which map grid axis to the vector component parallel to that axis"
            )
        warnings.warn(
            "`interp_2d_vector` and `diff_2d_vector` will be removed from future "
            "releases. The same functionality will be accessible under the "
            "`Grid.diff` and `Grid.interp` methods.",
            category=DeprecationWarning,
        )
        to = kwargs.get("to", "center")
        if to != "center":
            raise NotImplementedError(
                "Only vector interpolation to cell center is implemented, "
                f"but got to={to!r}"
            )
        for axis_name, component in vector.items():
            position, _ = self.axes[axis_name]._get_position_name(component)
            if position == "center":
                raise NotImplementedError(
                    "Only vector interpolation to cell center is implemented, "
                    f"but vector {axis_name} component is defined at center "
                    f"(dims: {component.dims!r})"
                )

        x_axis_name, y_axis_name = list(vector)
        x_component = function(
            {x_axis_name: vector[x_axis_name]},
            x_axis_name,
            other_component={y_axis_name: vector[y_axis_name]},
            **kwargs,
        )
        y_component = function(
            {y_axis_name: vector[y_axis_name]},
            y_axis_name,
            other_component={x_axis_name: vector[x_axis_name]},
            **kwargs,
        )
        return {x_axis_name: x_component, y_axis_name: y_component}

    @span("xtt.grid_api.diff_2d_vector")
    def diff_2d_vector(self, vector, **kwargs):
        """Difference a 2D C-grid vector ``{axis: component}`` onto cell
        centres, each component along its own axis."""
        return self._apply_vector_function(self.diff, vector, **kwargs)

    @span("xtt.grid_api.interp_2d_vector")
    def interp_2d_vector(self, vector, **kwargs):
        """Interpolate a 2D C-grid vector ``{axis: component}`` onto cell
        centres, each component along its own axis."""
        return self._apply_vector_function(self.interp, vector, **kwargs)

    # ----------------------------------------------- metric-weighted calculus
    @span("xtt.arith.derivative")
    def derivative(self, da, axis, **kwargs):
        """``diff`` along ``axis`` divided by the axis's metric at the
        result's position.  For xarray input the division is xarray's, on
        the host, as in the JAX package."""
        from ..adapters.xarray_adapter import is_dataarray, to_xarray

        diff = self.diff(da, axis, **kwargs)
        dx = self.get_metric(diff, (axis,))
        if is_dataarray(diff):
            dx = to_xarray(dx)  # xarray broadcasts the two by dim name
        return diff / dx

    @span("xtt.arith.integrate")
    def integrate(self, da, axis, **kwargs):
        """The sum of ``da`` times the metric of ``axis`` over the axes'
        dims.  NaN in floating data is skipped (taken as 0; as in
        ``jnp.nan_to_num``, infinities become the largest finite values).
        Keywords go to :meth:`GriddedArray.sum`.  A float32 CUDA tensor
        summed over trailing dims with an uninterpolated float32 metric
        takes one pass of the weighted-sum kernel, which builds the metric
        per element from its factors and sums in float64
        (:func:`_fused_factors`); anything else multiplies, cleans and sums
        in PyTorch."""
        from ..adapters.xarray_adapter import as_native, collect_xr_inputs

        return_xr, xr_args = collect_xr_inputs([da])
        da = as_native(da)
        metric, interpolated = self._find_metric(da, axis)
        dim = self._get_dims_from_axis(da, axis)
        factors = _fused_factors(da, metric, interpolated, dim, kwargs)
        if factors is not None:
            out = GriddedArray(weighted_sum(da.data, factors, len(dim)),
                               da.dims[:da.ndim - len(dim)], name=da.name)
        else:
            if not isinstance(metric, GriddedArray):
                metric = _metric_product(metric, da)
            weighted = da * metric
            if weighted.dtype.is_floating_point:
                weighted = weighted.with_data(torch.nan_to_num(weighted.data, nan=0.0))
            out = weighted.sum(dim, **kwargs)
        if return_xr:
            from ..adapters.xarray_adapter import reattach_coords

            # reductions shift no dim and keep the inputs' coordinates
            out = reattach_coords(out, self, xr_args, set(), True)
        return out

    @span("xtt.arith.cumint")
    def cumint(self, da, axis, **kwargs):
        """:meth:`cumsum` of ``da`` times the metric of ``axis``."""
        from ..adapters.xarray_adapter import as_native, collect_xr_inputs

        return_xr, xr_args = collect_xr_inputs([da])
        da = as_native(da)
        out = self.cumsum(da * self.get_metric(da, axis), axis, **kwargs)
        if return_xr:
            from ..adapters.xarray_adapter import reattach_coords

            new_dims = {d for d in out.dims if d not in da.dims}
            out = reattach_coords(out, self, xr_args, new_dims, kwargs.get("keep_coords", False))
        return out

    @span("xtt.arith.average")
    def average(self, da, axis, **kwargs):
        """The metric-weighted mean over the axes' dims, NaN cells left out
        of both sums (xarray's ``weighted.mean``).  Keywords go to
        :meth:`GriddedArray.sum`."""
        from ..adapters.xarray_adapter import as_native, collect_xr_inputs

        return_xr, xr_args = collect_xr_inputs([da])
        da = as_native(da)
        weight = self.get_metric(da, axis)
        dims = self._get_dims_from_axis(da, axis)
        x, w, out_dims = _broadcast_align(da, weight)
        if not w.is_floating_point():
            w = w.to(torch.float64)
        if not x.is_floating_point():
            x = x.to(w.dtype)  # the weakly typed 0.0 that JAX fills with
        nan_mask = torch.isnan(x)
        num = GriddedArray(torch.where(nan_mask, 0.0, x) * w, out_dims, name=da.name)
        den = GriddedArray(torch.where(nan_mask, 0.0, w), out_dims, name=da.name)
        out = num.sum(dims, **kwargs) / den.sum(dims, **kwargs)
        if return_xr:
            from ..adapters.xarray_adapter import reattach_coords

            out = reattach_coords(out, self, xr_args, set(), True)
        return out

    @span("xtt.grid_api.transform")
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
        An ``xr.DataArray`` ``da`` gives one back, with the target values
        (bin midpoints for the conservative method) on the new dim and the
        coordinates of ``da``, then of an xarray ``target_data``, on the
        others.
        """
        from ..adapters.xarray_adapter import as_native, collect_xr_inputs
        from ..ops.transform import transform

        return_xr, xr_args = collect_xr_inputs([da, kwargs.get("target_data")])
        orig_target = target
        da = as_native(da)
        target = as_native(target)
        if "target_data" in kwargs:
            kwargs["target_data"] = as_native(kwargs["target_data"])
        out = transform(self, axis, da, target, **kwargs)
        if return_xr:
            out = self._transform_to_xarray(
                out, da, xr_args, orig_target, kwargs.get("method", "linear"), axis
            )
        return out

    @span("xtt.grid_api.transform_multi")
    def transform_multi(self, das, axis, target, **kwargs):
        """Transform several arrays onto the same target coordinate:
        exactly ``[self.transform(da, axis, target, **kwargs) for da in
        das]``.  On the card, 2 to 8 float32/bfloat16 arrays of equal dims
        share one kernel pass (F for linear/log, H for conservative) that
        reads ``target_data`` once; everywhere else the list is built by
        that loop.  Each ``xr.DataArray`` in ``das`` gives one back, its own
        coordinates winning over ``target_data``'s."""
        from ..adapters.xarray_adapter import as_native, is_dataarray
        from ..ops.transform import transform_multi

        orig_das = list(das)
        orig_target = target
        orig_target_data = kwargs.get("target_data")
        das = [as_native(d) for d in orig_das]
        target = as_native(target)
        if "target_data" in kwargs:
            kwargs["target_data"] = as_native(kwargs["target_data"])
        outs = transform_multi(self, axis, das, target, **kwargs)
        method = kwargs.get("method", "linear")
        return [
            self._transform_to_xarray(
                o, d, [a for a in (orig, orig_target_data) if is_dataarray(a)],
                orig_target, method, axis,
            )
            if is_dataarray(orig) else o
            for o, d, orig in zip(outs, das, orig_das)
        ]

    def _transform_to_xarray(self, out, da_native, xr_args, target, method, axis):
        """A transform's result as xarray: the target values (bin midpoints
        for the conservative method) on the new dim, the inputs'
        coordinates on the dims left as they were."""
        from ..adapters.xarray_adapter import host_array, is_dataarray, reattach_coords

        # the new dim is named after the target or target_data, or, with
        # neither named, it is the source dim's name reused at the target's
        # size: resolved from the axis, so that a target as long as the
        # source still gets its own values as the coordinate
        new_dims = {d for d in out.dims if d not in da_native.dims}
        if not new_dims:
            _, src_dim = self.axes[axis]._get_position_name(da_native)
            if src_dim in out.dims:
                new_dims = {src_dim}
        extra = {}
        if len(new_dims) == 1:
            (tdim,) = new_dims
            tvals = host_array(target.values if is_dataarray(target) else
                               target.data if isinstance(target, GriddedArray) else target)
            if tvals.ndim == 1:
                if method == "conservative":
                    tvals = 0.5 * (tvals[:-1] + tvals[1:])
                if tvals.shape[0] == out.sizes[tdim]:
                    extra[tdim] = (tdim, tvals)
        return reattach_coords(out, self, xr_args, new_dims, True, extra_coords=extra,
                               skip_conflicting_sizes=True)


def raw_interp_function(data_left, data_right):
    """Legacy two-point interpolation helper: the mean of the two."""
    return 0.5 * (data_left + data_right)


def raw_diff_function(data_left, data_right):
    """Legacy two-point difference helper: right minus left."""
    return data_right - data_left


def raw_min_function(data_left, data_right):
    """Legacy pairwise minimum helper (NaN propagates)."""
    return torch.minimum(as_tensor(data_right), as_tensor(data_left))


def raw_max_function(data_left, data_right):
    """Legacy pairwise maximum helper (NaN propagates)."""
    return torch.maximum(as_tensor(data_right), as_tensor(data_left))


def _metric_product(factors, array) -> GriddedArray:
    """``1 * f0 * f1 * ...`` with the values, dtype and dims of that
    product of GriddedArrays, laid out in memory in ``array``'s dim order.
    The dims follow the factors' order, which follows the iteration order
    of frozensets of axis names and so changes from process to process;
    a product laid out in that order would cost every op that broadcasts
    it against ``array`` a transposing copy."""
    dims: tuple = ()
    for f in factors:
        dims += tuple(d for d in f.dims if d not in dims)
    order = [d for d in array.dims if d in dims] + [d for d in dims if d not in array.dims]
    data = functools.reduce(operator.mul, (_expand_to(f, order) for f in factors), 1)
    return GriddedArray(data.permute([order.index(d) for d in dims]), dims,
                        name=factors[0].name)


def _fused_factors(da, metric, interpolated, dims, kwargs):
    """The factors of ``metric`` as tensors in ``da``'s dim order (size 1
    where a factor lacks a dim) when :meth:`Grid.integrate` can take the
    weighted-sum kernel, else None.  It can when ``da`` holds a plain
    contiguous float32 tensor on the card that needs no gradient,
    no keyword goes to the sum, the metric was not interpolated and each
    factor is a plain float32 tensor over some of ``da``'s dims (of their
    sizes, or 1), and ``dims`` are ``da``'s trailing dims.  A
    ``ShardedTensor`` (a subclass) keeps the product and the sum that
    ``ShardedGrid.integrate`` relies on."""
    factors = (metric,) if isinstance(metric, GriddedArray) else metric
    x = da.data
    if (interpolated or kwargs or type(x) is not torch.Tensor
            or not x.is_cuda or x.dtype != torch.float32
            or not x.is_contiguous() or not 1 <= x.ndim <= MAX_DIMS
            or len(factors) > MAX_FACTORS
            or not dims or len(set(dims)) != len(dims)
            or set(dims) != set(da.dims[da.ndim - len(dims):])):
        return None
    tensors = [x]
    for f in factors:
        if (type(f.data) is not torch.Tensor or f.dtype != torch.float32
                or f.data.device != x.device or not set(f.dims) <= set(da.dims)
                or any(n not in (1, da.sizes[d]) for d, n in f.sizes.items())):
            return None
        tensors.append(_expand_to(f, da.dims))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return None
    return tensors[1:]


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
