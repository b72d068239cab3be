"""The grid-ufunc engine.

The counterpart of :mod:`xgcm_tpu.core.grid_ufunc` on torch tensors:

    signature -> dummy-axis binding -> core-dim resolution -> pad ->
    transpose-core-dims-last -> kernel -> relabel dims -> restore dim order

It serves every position pair and dtype the fused shift path does not
(inner/outer pairs, integer and bool inputs, custom kernels).  Inputs are
:class:`GriddedArray` or single-entry vector-component dicts of them; with
xarray installed, ``xr.DataArray`` inputs convert on entry and the results
go back to xarray (:mod:`xgcm_tpu_torch.adapters.xarray_adapter`).
"""

from __future__ import annotations

from typing import (
    TYPE_CHECKING,
    Any,
    Callable,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Union,
    get_type_hints,
)

from .dataarray import GriddedArray
from .padding import pad
from .signature import GridUFuncSignature

if TYPE_CHECKING:
    from .grid import Grid

__all__ = [
    "GridUFunc",
    "as_grid_ufunc",
    "apply_as_grid_ufunc",
]

DataInput = Union[GriddedArray, Dict[str, GriddedArray]]


def _maybe_unpack_vector_component(data: DataInput) -> GriddedArray:
    if isinstance(data, dict):
        [da] = list(data.values())
        return da
    return data


def _check_data_input(data: DataInput, grid: "Grid") -> DataInput:
    """Validate a scalar or single-component-vector input, converting
    ``xr.DataArray`` inputs to GriddedArrays when xarray is installed."""
    if data is None:
        return data
    if not isinstance(data, (GriddedArray, dict)):
        from ..adapters.xarray_adapter import as_native

        data = as_native(data)
    if not isinstance(data, (GriddedArray, dict)):
        raise TypeError(
            "All data arguments must be either a GriddedArray or Dictionary. "
            f"Got {type(data)}."
        )
    if isinstance(data, dict):
        from ..adapters.xarray_adapter import as_native

        data = {k: as_native(v) for k, v in data.items()}
        if len(data) != 1:
            raise ValueError(
                "Vector components provided as dictionaries should contain "
                f"exactly one key/value pair. Found {len(data)}. "
                f"Full input:{data}"
            )
        [key] = list(data.keys())
        value = data[key]
        if key not in grid.axes:
            raise ValueError(
                f"Vector component with unknown axis provided. Grid has axes "
                f"({list(grid.axes)}), got ({key})"
            )
        if not isinstance(value, GriddedArray):
            raise TypeError(
                f"Dictionary inputs must have a GriddedArray as value. "
                f"Got {type(value)}."
            )
    return data


def _promote_to_sequence_and_check(data, grid) -> Sequence:
    if not isinstance(data, Sequence):
        data = [data]
    return [_check_data_input(d, grid) for d in data]


def _identify_dummy_axes_with_real_axes(
    sig_in_dummy_ax_names: List[Tuple[str, ...]], axis: Sequence[Sequence[str]]
) -> Mapping[str, str]:
    """Bind signature dummy axis names to real grid axes by order of
    appearance."""
    if len(axis) != len(sig_in_dummy_ax_names):
        raise ValueError(
            "Number of entries in `axis` does not match the number of "
            "variables in the input signature"
        )
    for i, (arg_axes, dummy_axes) in enumerate(zip(axis, sig_in_dummy_ax_names)):
        if len(arg_axes) != len(dummy_axes):
            raise ValueError(
                f"Number of Axes in `axis` entry number {i} does not match "
                f"the number of Axes in that entry in the input signature"
            )
    unique_dummy = list(dict.fromkeys(ax for arg in sig_in_dummy_ax_names for ax in arg))
    unique_real = list(dict.fromkeys(ax for arg in axis for ax in arg))
    if len(unique_dummy) != len(unique_real):
        raise ValueError(
            f"Found {len(unique_dummy)} unique input axes in signature but "
            f"{len(unique_real)} real unique input axes were supplied to the "
            f"grid ufunc when called"
        )
    return dict(zip(unique_dummy, unique_real))


def _substitute_dummy_axis_names(boundary_width, mapping):
    if boundary_width:
        return {mapping[ax]: w for ax, w in boundary_width.items()}
    return {real: (0, 0) for real in mapping.values()}


def _apply(
    func: Callable,
    args: Sequence[GriddedArray],
    in_core_dims: List[List[str]],
    out_core_dims: List[List[str]],
    **kwargs,
) -> Tuple[GriddedArray, ...]:
    """Move core dims last, call the kernel on raw tensors, and relabel
    outputs: core dims go to the end in signature order, outputs come back
    with new core dims at the end, named from the output signature."""
    broadcast_dims: List[str] = []
    for arg, cdims in zip(args, in_core_dims):
        for d in arg.dims:
            if d not in cdims and d not in broadcast_dims:
                broadcast_dims.append(d)

    raw_args = []
    for arg, cdims in zip(args, in_core_dims):
        arranged = arg.move_dims_last(cdims)
        # missing broadcast dims become size-1 leading axes, in the common
        # order, so the raw tensors broadcast correctly inside the kernel
        lead = [d for d in arranged.dims if d not in cdims]
        full_lead_shape = [arranged.sizes[d] if d in lead else 1 for d in broadcast_dims]
        data = _transpose_lead(arranged, broadcast_dims, cdims)
        raw_args.append(
            data.reshape(full_lead_shape + list(arranged.shape)[len(lead):])
        )

    raw_results = func(*raw_args, **kwargs)
    if not isinstance(raw_results, tuple):
        raw_results = (raw_results,)
    if len(raw_results) != len(out_core_dims):
        raise ValueError(
            f"grid ufunc returned {len(raw_results)} outputs but signature "
            f"specifies {len(out_core_dims)}"
        )

    results = []
    for res, cdims in zip(raw_results, out_core_dims):
        n_core = len(cdims)
        if res.ndim - n_core != len(broadcast_dims):
            raise ValueError(
                f"grid ufunc output has {res.ndim} dims; expected "
                f"{len(broadcast_dims)} broadcast + {n_core} core dims"
            )
        results.append(GriddedArray(res, list(broadcast_dims) + list(cdims)))
    return tuple(results)


def _transpose_lead(arranged: GriddedArray, broadcast_dims, cdims):
    """Reorder an array's leading (non-core) dims into the common broadcast
    order, leaving core dims in place at the end."""
    lead = [d for d in arranged.dims if d not in cdims]
    desired = [d for d in broadcast_dims if d in lead] + list(cdims)
    return arranged.transpose(*desired).data


def _check_output_core_sizes(results, out_core_dims, grid, boundary_width):
    """Loudly catch ufuncs that fail to trim padding."""
    for res, cdims in zip(results, out_core_dims):
        for d in cdims:
            expected = grid._ds.dims.get(d)
            if expected is not None and res.sizes[d] != expected:
                raise ValueError(
                    f"conflicting sizes for dimension {d!r}: grid expects "
                    f"{expected}, ufunc returned {res.sizes[d]} - does your "
                    f"grid ufunc correctly trim off the same number of "
                    f"elements which were added by padding using "
                    f"boundary_width={boundary_width}?"
                )


def _restore_input_dim_order(results, args, sig, in_core_dims, out_core_dims):
    """Transpose outputs to follow the input arrays' dim order, accounting for
    core dims renamed by the position shift."""
    dummy_to_in = {
        ax: dim
        for arg_axes, arg_dims in zip(sig.in_ax_names, in_core_dims)
        for ax, dim in zip(arg_axes, arg_dims)
    }
    dummy_to_out = {
        ax: dim
        for arg_axes, arg_dims in zip(sig.out_ax_names, out_core_dims)
        for ax, dim in zip(arg_axes, arg_dims)
    }
    rename = {
        dummy_to_in[ax]: dummy_to_out[ax] for ax in dummy_to_in if ax in dummy_to_out
    }

    reference_order: List[str] = []
    for arg in args:
        for d in _maybe_unpack_vector_component(arg).dims:
            d = rename.get(d, d)
            if d not in reference_order:
                reference_order.append(d)

    out = []
    for res in results:
        order = [d for d in reference_order if d in res.dims] + [
            d for d in res.dims if d not in reference_order
        ]
        out.append(res.transpose(*order))
    return tuple(out)


def apply_as_grid_ufunc(
    func: Callable,
    *args: DataInput,
    axis: Optional[Sequence[Sequence[str]]] = None,
    grid: Optional["Grid"] = None,
    signature: Union[str, GridUFuncSignature] = "",
    boundary_width: Optional[Mapping[str, Tuple[int, int]]] = None,
    boundary: Optional[Union[str, Mapping[str, str]]] = None,
    fill_value: Optional[Union[float, Mapping[str, float]]] = None,
    keep_coords: bool = True,
    pad_before_func: bool = True,
    other_component: Optional[
        Union[Dict[str, GriddedArray], Sequence[Dict[str, GriddedArray]]]
    ] = None,
    dask: Optional[str] = None,
    map_overlap: bool = False,
    _pad_fn: Callable = pad,
    **kwargs,
) -> Any:
    """Apply a kernel to GriddedArrays in a grid-position-aware manner.

    The axis positions of inputs and outputs are specified by ``signature``
    (e.g. ``"(X:center)->(X:left)"``); axis names therein are dummy variables
    bound to the real axes named in ``axis``.  When the first input is an
    ``xr.DataArray`` the results are too, with their coordinates reattached
    (``keep_coords=False`` drops the non-dimension ones); native results
    carry no coordinates.  ``dask`` and ``map_overlap`` are accepted for API
    parity and ignored: there are no dask chunks.  Passed to a Grid op,
    either of them sends the call to this engine.  ``_pad_fn`` is the pad
    step, :func:`~xgcm_tpu_torch.core.padding.pad` by default, with pad's
    signature; the sharded engine swaps in the blocks it padded with ring
    halos (:mod:`xgcm_tpu_torch.parallel.sharded_ufunc`).
    """
    if grid is None:
        raise ValueError("Must provide a grid object to describe the Axes")

    from ..adapters.xarray_adapter import collect_xr_inputs

    return_xr, xr_args = collect_xr_inputs(args)
    args = _promote_to_sequence_and_check(args, grid)
    other_component = _promote_to_sequence_and_check(other_component, grid)
    if len(other_component) == 1 and other_component[0] is None:
        other_component = list(other_component) * len(args)
    if len(args) != len(other_component):
        raise ValueError(
            "When providing multiple input arguments, `other_component` "
            "needs to provide one dictionary per input."
        )

    if axis is None:
        raise ValueError("Must provide an axis along which to apply the grid ufunc")
    if len(args) != len(axis):
        raise ValueError(
            "Number of entries in `axis` does not match the number of data "
            "arguments supplied"
        )

    sig = (
        signature
        if isinstance(signature, GridUFuncSignature)
        else GridUFuncSignature.from_string(signature)
    )

    dummy_to_real = _identify_dummy_axes_with_real_axes(sig.in_ax_names, axis)
    out_ax_names = [[dummy_to_real[ax] for ax in arg] for arg in sig.out_ax_names]

    # Validate that inputs actually lie at the signature's input positions.
    for i, (arg_ns, arg_ps, arg) in enumerate(zip(axis, sig.in_ax_positions, args)):
        for n, p in zip(arg_ns, arg_ps):
            try:
                ax_dim = grid.axes[n].coords[p]
            except KeyError:
                raise ValueError(f"Axis position ({n}:{p}) does not exist in grid")
            da = _maybe_unpack_vector_component(arg)
            if ax_dim not in da.dims:
                raise ValueError(
                    f"Mismatch between signature and input argument {i}: "
                    f"Signature specified data to lie at Axis Position "
                    f"({n}:{p}), but the corresponding grid coordinate "
                    f"{ax_dim} does not appear in argument {da}"
                )

    in_core_dims = [
        [grid.axes[n].coords[p] for n, p in zip(arg_ns, arg_ps)]
        for arg_ns, arg_ps in zip(axis, sig.in_ax_positions)
    ]
    out_core_dims = [
        [grid.axes[n].coords[p] for n, p in zip(arg_ns, arg_ps)]
        for arg_ns, arg_ps in zip(out_ax_names, sig.out_ax_positions)
    ]

    boundary_width_real = _substitute_dummy_axis_names(boundary_width, dummy_to_real)

    def _pad_args(seq):
        # the output count can exceed the input count, so pad the
        # other_component list rather than letting zip truncate silently
        ocs = list(other_component) + [None] * (len(seq) - len(other_component))
        return [
            _pad_fn(
                a,
                grid=grid,
                boundary_width=boundary_width_real,
                boundary=boundary,
                fill_value=fill_value,
                other_component=oc,
            )
            for a, oc in zip(seq, ocs)
        ]

    if pad_before_func:
        padded = [
            _maybe_unpack_vector_component(p) if isinstance(p, dict) else p
            for p in _pad_args(args)
        ]
        results = _apply(func, padded, in_core_dims, out_core_dims, **kwargs)
    else:
        unpadded_args = [_maybe_unpack_vector_component(a) for a in args]
        unpadded = _apply(func, unpadded_args, in_core_dims, out_core_dims, **kwargs)
        results = tuple(_pad_args(list(unpadded)))

    _check_output_core_sizes(results, out_core_dims, grid, boundary_width)
    results = _restore_input_dim_order(results, args, sig, in_core_dims, out_core_dims)

    # Name outputs after the (first) input, like xarray propagates names.
    first = _maybe_unpack_vector_component(args[0])
    results = tuple(r.rename(first.name) for r in results)

    if return_xr:
        from ..adapters.xarray_adapter import reattach_coords

        # the output core dims take their coordinates from the grid
        out_core_names = {d for dims in out_core_dims for d in dims}
        results = tuple(
            reattach_coords(r, grid, xr_args, out_core_names, keep_coords, boundary_width)
            for r in results
        )
    if len(results) == 1:
        return results[0]
    return results


class GridUFunc:
    """Binds a kernel into a grid-aware ufunc.

    Calling instance: ``gu(grid, *args, axis=[("X",)], **kwargs)``.
    """

    def __init__(self, ufunc: Callable, **kwargs):
        self.ufunc = ufunc
        str_sig = kwargs.pop("signature", "")
        self.signature = self._signature_from_str_or_hints(ufunc, str_sig)
        self.boundary_width = kwargs.pop("boundary_width", None)
        self.boundary = kwargs.pop("boundary", None)
        self.fill_value = kwargs.pop("fill_value", None)
        self.pad_before_func = kwargs.pop("pad_before_func", True)
        if kwargs:
            raise TypeError(
                f"Unsupported keyword argument(s) provided: {list(kwargs.keys())}"
            )

    @staticmethod
    def _signature_from_str_or_hints(ufunc, str_sig):
        hints = get_type_hints(ufunc, include_extras=True)

        def _has_annotations():
            ret = hints.get("return")
            if ret is not None:
                from .signature import _unpack_return_hints

                if any(hasattr(h, "__metadata__") for h in _unpack_return_hints(ret)):
                    return True
            return any(hasattr(h, "__metadata__") for h in hints.values())

        if str_sig:
            if _has_annotations():
                raise ValueError(
                    "Must specify axis positions through only one of either "
                    "type hints or signature kwarg, not both."
                )
            return GridUFuncSignature.from_string(str_sig)
        if not _has_annotations():
            raise ValueError(
                "Must specify axis positions through either type hints or "
                "signature kwarg"
            )
        return GridUFuncSignature.from_type_hints(hints)

    def __repr__(self):
        return (
            f"GridUFunc(ufunc={self.ufunc}, signature='{self.signature}', "
            f"boundary_width='{self.boundary_width}', "
            f"pad_before_func={self.pad_before_func})"
        )

    def __call__(self, grid=None, *args, axis, **kwargs):
        boundary = kwargs.pop("boundary", self.boundary)
        fill_value = kwargs.pop("fill_value", self.fill_value)
        pad_before_func = kwargs.pop("pad_before_func", self.pad_before_func)
        return apply_as_grid_ufunc(
            self.ufunc,
            *args,
            axis=axis,
            grid=grid,
            signature=self.signature,
            boundary_width=self.boundary_width,
            boundary=boundary,
            fill_value=fill_value,
            pad_before_func=pad_before_func,
            **kwargs,
        )


def as_grid_ufunc(
    signature: str = "",
    boundary_width: Optional[Mapping[str, Tuple[int, int]]] = None,
    **kwargs,
) -> Callable:
    """Decorator turning a kernel into a GridUFunc."""
    allowed = {"boundary", "fill_value", "pad_before_func"}
    forbidden = list(kwargs.keys() - allowed)
    if forbidden:
        raise TypeError(f"Unsupported keyword argument(s) provided: {forbidden}")

    def _wrap(ufunc):
        return GridUFunc(ufunc, signature=signature, boundary_width=boundary_width, **kwargs)

    return _wrap
