"""Optional xarray bridge.

The counterpart of :mod:`xgcm_tpu.adapters.xarray_adapter`.  The core is
xarray-free (xarray is not a dependency), but when xarray is installed this
module converts ``xr.Dataset``/``xr.DataArray`` to and from the native
containers, with the coordinate-reattachment rules of xgcm (grid
coordinates on position-shifted dims; input coordinates kept on the other
dims, the first input winning).

Converted data lives where the native containers keep it: a Dataset's
coordinates stay host numpy arrays, its data variables and every op input
go to the default device (:mod:`xgcm_tpu_torch.core.device`).  Results come
back to the host as numpy arrays.  Torch has no numpy bfloat16, so a
bfloat16 tensor does not convert: :func:`host_array` raises ``TypeError``
(where the JAX package gives an ``ml_dtypes`` array), as torch itself does
for a numpy ``ml_dtypes.bfloat16`` input.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..core.dataarray import GriddedArray
from ..core.dataset import Dataset
from ..core.device import to_device, to_host

try:
    import xarray as xr

    HAS_XARRAY = True
except ImportError:  # xarray is optional
    xr = None
    HAS_XARRAY = False

__all__ = [
    "HAS_XARRAY",
    "maybe_from_xarray",
    "as_native",
    "host_array",
    "is_dataarray",
    "collect_xr_inputs",
    "reattach_coords",
    "dataset_from_xarray",
    "dataarray_from_xarray",
    "to_xarray",
    "dataset_to_xarray",
]


def host_array(x) -> np.ndarray:
    """``x`` as a host numpy array: a tensor is copied from its device by
    :func:`~xgcm_tpu_torch.core.device.to_host`, a host array stays as it
    is.  A bfloat16 tensor raises ``TypeError``: numpy has no bfloat16 of
    its own."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError(
                "a torch.bfloat16 result has no numpy dtype to go to xarray "
                "with; cast it (e.g. to float32) on the native path first"
            )
        return to_host(x)
    return np.asarray(x)


def is_dataarray(obj: Any) -> bool:
    """True iff ``obj`` is an ``xr.DataArray`` (False when xarray is absent)."""
    return HAS_XARRAY and isinstance(obj, xr.DataArray)


def collect_xr_inputs(args) -> tuple:
    """Scan raw op inputs (scalars or ``{axis: component}`` dicts) for
    xarray DataArrays.

    Returns ``(return_xr, xr_args)``: whether the op should go back to
    xarray (the first input is one: xarray in, xarray out), and the
    DataArrays in argument order, for the first-input-wins precedence of
    their coordinates."""
    if not HAS_XARRAY:
        return False, []
    xr_args = []
    return_xr = False
    for i, a in enumerate(args):
        vals = list(a.values()) if isinstance(a, dict) else [a]
        for v in vals:
            if isinstance(v, xr.DataArray):
                xr_args.append(v)
                if i == 0:
                    return_xr = True
    return return_xr, xr_args


def _grid_coord_to_xr(c) -> "xr.DataArray":
    return xr.DataArray(host_array(c.data), dims=c.dims, name=c.name, attrs=dict(c.attrs))


def reattach_coords(
    result,
    grid,
    input_args=(),
    out_core_dim_names=frozenset(),
    keep_coords: bool = True,
    boundary_width=None,
    extra_coords: Optional[Dict[str, Any]] = None,
    skip_conflicting_sizes: bool = False,
):
    """Convert a native result to an ``xr.DataArray`` on the host, with
    xgcm's coordinate-reattachment rules:

    - every grid-dataset coordinate whose dims are all in the result is
      attached;
    - coordinates of the xarray inputs that lie entirely on dims outside
      ``out_core_dim_names`` (the position-shifted dims) override those,
      the first input winning;
    - ``keep_coords=False`` warns its deprecation and drops the
      non-dimension coordinates.

    ``extra_coords`` (name -> DataArray or values) are assigned last
    (``transform``'s target coordinate).  With ``skip_conflicting_sizes``
    (the transform path) a coordinate whose size no longer matches its dim
    is left out; otherwise a mismatch raises, with a hint about trimming
    the padding when ``boundary_width`` is given.  Dict results (vector
    ops) convert per component.
    """
    if not HAS_XARRAY:
        raise ImportError("xarray is not installed")
    if isinstance(result, dict):
        return {
            k: reattach_coords(
                v, grid, input_args, out_core_dim_names, keep_coords,
                boundary_width, extra_coords, skip_conflicting_sizes,
            )
            for k, v in result.items()
        }

    res = xr.DataArray(host_array(result.data), dims=result.dims, name=result.name)

    # transform's auto-naming reuses the source dim name at the target's
    # size: the stale full-length grid coordinate must not go onto it
    def _sizes_ok(dims, shape):
        return not skip_conflicting_sizes or all(
            res.sizes[d] == s for d, s in zip(dims, shape)
        )

    all_matching = {
        name: _grid_coord_to_xr(c)
        for name, c in grid._ds.coords.items()
        if all(d in res.dims for d in c.dims) and _sizes_ok(c.dims, c.shape)
    }

    input_coords: Dict[str, Any] = {}
    for arg in input_args:
        for coord, da_coord in arg.coords.items():
            if any(d in out_core_dim_names for d in da_coord.dims):
                continue
            input_coords.setdefault(coord, da_coord)
    for coord, da_coord in input_coords.items():
        if all(d in res.dims for d in da_coord.dims) and _sizes_ok(
            da_coord.dims, np.shape(da_coord.data)
        ):
            all_matching[coord] = da_coord

    try:
        res = res.assign_coords(all_matching)
    except ValueError as err:
        if boundary_width and str(err).startswith("conflicting sizes"):
            raise ValueError(
                f"{err} - does your grid ufunc correctly trim off the same "
                f"number of elements which were added by padding using "
                f"boundary_width={boundary_width}?"
            ) from err
        raise

    if extra_coords:
        res = res.assign_coords(extra_coords)

    if not keep_coords:
        warnings.warn(
            "The keep_coords keyword argument is being deprecated - in "
            "future it will be removed entirely, and the behaviour will "
            "always be that currently given by keep_coords=True.",
            category=DeprecationWarning,
        )
        res = res.drop_vars([c for c in res.coords if c not in res.dims])
    return res


def maybe_from_xarray(obj: Any) -> Optional[Dataset]:
    """Convert an ``xr.Dataset`` if that is what was given; else None."""
    if HAS_XARRAY and isinstance(obj, xr.Dataset):
        return dataset_from_xarray(obj)
    return None


def as_native(obj: Any) -> Any:
    """An ``xr.DataArray`` as a :class:`GriddedArray` on the default
    device; anything else unchanged."""
    if HAS_XARRAY and isinstance(obj, xr.DataArray):
        return dataarray_from_xarray(obj)
    return obj


def dataarray_from_xarray(da: "xr.DataArray") -> GriddedArray:
    """The DataArray's data as a tensor on the default device, with its
    dims, name and attrs."""
    return GriddedArray(to_device(da.data), tuple(da.dims), name=da.name, attrs=dict(da.attrs))


def dataset_from_xarray(ds: "xr.Dataset") -> Dataset:
    """The port's Dataset: coordinates stay host numpy arrays, data
    variables go to the default device."""
    coords = {
        name: GriddedArray.on_host(np.asarray(c.data), tuple(c.dims), name=name,
                                   attrs=dict(c.attrs))
        for name, c in ds.coords.items()
    }
    data_vars = {name: dataarray_from_xarray(ds[name]) for name in ds.data_vars}
    return Dataset(coords=coords, data_vars=data_vars, dims=dict(ds.sizes), attrs=dict(ds.attrs))


def to_xarray(garr, grid=None) -> "Union[xr.DataArray, Dict[str, xr.DataArray]]":
    """A GriddedArray as an ``xr.DataArray`` on the host, with every grid
    dataset coordinate whose dims are all in it.  Dicts (vector-op results)
    convert per component."""
    if not HAS_XARRAY:
        raise ImportError("xarray is not installed")
    if isinstance(garr, dict):
        return {k: to_xarray(v, grid) for k, v in garr.items()}
    out = xr.DataArray(host_array(garr.data), dims=garr.dims, name=garr.name)
    if grid is not None:
        out = out.assign_coords({
            name: xr.DataArray(host_array(c.data), dims=c.dims)
            for name, c in grid._ds.coords.items()
            if all(d in out.dims for d in c.dims)
        })
    return out


def dataset_to_xarray(ds: Dataset) -> "xr.Dataset":
    """A native Dataset as an ``xr.Dataset`` (the inverse of
    :func:`dataset_from_xarray`; variable and coordinate attrs go along)."""
    if not HAS_XARRAY:
        raise ImportError("xarray is not installed")

    def tup(v):
        return (v.dims, host_array(v.data), dict(v.attrs))

    return xr.Dataset(
        {k: tup(v) for k, v in ds.data_vars.items()},
        coords={k: tup(v) for k, v in ds.coords.items()},
        attrs=dict(ds.attrs),
    )
