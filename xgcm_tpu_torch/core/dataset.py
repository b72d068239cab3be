"""A minimal Dataset container for grid construction.

Holds dimension sizes, coordinate variables with their COMODO/SGRID/CF
attrs, and data variables, as :class:`xgcm_tpu.core.dataset.Dataset` does.
Coordinates stay host numpy arrays: they are grid metadata, read on the host
by the parsers.  Data variables are tensors; host data given for one goes to
the default device (:mod:`xgcm_tpu_torch.core.device`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from .dataarray import GriddedArray
from .device import to_device

__all__ = ["Dataset"]


class Dataset:
    """Holds dimension sizes, coordinate variables, and data variables.

    Parameters
    ----------
    coords : mapping name -> GriddedArray | (dims, data) | 1-d array
        Coordinate variables.  A bare 1-d array is taken as a dimension
        coordinate for the dimension of the same name.
    data_vars : mapping name -> GriddedArray | (dims, data)
        Data variables (e.g. metrics).
    dims : mapping str -> int, optional
        Extra dimensions not spanned by any variable.
    attrs : dict, optional
        Global attributes (used for convention detection, e.g. SGRID
        ``Conventions`` attr — reference ``sgrid.py:6-26``).
    """

    def __init__(
        self,
        coords: Optional[Mapping[str, Any]] = None,
        data_vars: Optional[Mapping[str, Any]] = None,
        dims: Optional[Mapping[str, int]] = None,
        attrs: Optional[Mapping[str, Any]] = None,
    ):
        self.coords: Dict[str, GriddedArray] = {}
        self.data_vars: Dict[str, GriddedArray] = {}
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self._dims: Dict[str, int] = dict(dims) if dims else {}

        for name, v in (coords or {}).items():
            self.coords[name] = self._coerce(name, v, is_coord=True)
        for name, v in (data_vars or {}).items():
            self.data_vars[name] = self._coerce(name, v, is_coord=False)

        for var in list(self.coords.values()) + list(self.data_vars.values()):
            for d, s in var.sizes.items():
                if d in self._dims and self._dims[d] != s:
                    raise ValueError(
                        f"conflicting sizes for dimension {d!r}: "
                        f"{self._dims[d]} vs {s}"
                    )
                self._dims.setdefault(d, s)

    @staticmethod
    def _coerce(name: str, v: Any, is_coord: bool) -> GriddedArray:
        if isinstance(v, GriddedArray):
            return v.rename(name) if v.name != name else v
        if isinstance(v, tuple) and len(v) in (2, 3):
            dims, data = v[0], v[1]
            attrs = v[2] if len(v) == 3 else None
            if isinstance(dims, str):
                dims = (dims,)
            make = GriddedArray.on_host if is_coord else GriddedArray
            return make(data, dims, name=name, attrs=attrs)
        arr = np.asarray(v)
        if is_coord and arr.ndim == 1:
            return GriddedArray.on_host(arr, (name,), name=name)
        raise TypeError(
            f"Cannot interpret variable {name!r}: pass a GriddedArray or a "
            f"(dims, data) tuple"
        )

    # -- mapping-ish access ------------------------------------------------
    @property
    def dims(self) -> Dict[str, int]:
        return dict(self._dims)

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(self._dims)

    @property
    def variables(self) -> Dict[str, GriddedArray]:
        out = dict(self.coords)
        out.update(self.data_vars)
        return out

    def __contains__(self, name: str) -> bool:
        return name in self.coords or name in self.data_vars

    def __getitem__(self, name: str) -> GriddedArray:
        if name in self.data_vars:
            return self.data_vars[name]
        if name in self.coords:
            return self.coords[name]
        raise KeyError(name)

    def __setitem__(self, name: str, value) -> None:
        """Add or replace a data variable (GriddedArray or (dims, data))."""
        var = self._coerce(name, value, is_coord=False)
        for d, s in var.sizes.items():
            if d in self._dims and self._dims[d] != s:
                raise ValueError(
                    f"conflicting sizes for dimension {d!r}: "
                    f"{self._dims[d]} vs {s}"
                )
        for d, s in var.sizes.items():
            self._dims.setdefault(d, s)
        self.data_vars[name] = var

    def assign(self, **variables) -> "Dataset":
        """Return a new Dataset with additional/replaced data variables."""
        out = Dataset(
            coords=self.coords,
            data_vars={**self.data_vars},
            dims=self._dims,
            attrs=self.attrs,
        )
        for name, value in variables.items():
            out[name] = value
        return out

    def assign_coords(self, coords=None, **coordinates) -> "Dataset":
        """Return a new Dataset with additional/replaced coordinates.
        Accepts a positional mapping or keyword args (xarray-style)."""
        if coords is not None:
            coordinates = {**coords, **coordinates}
        new_coords = {**self.coords}
        for name, value in coordinates.items():
            new_coords[name] = self._coerce(name, value, is_coord=True)
        return Dataset(
            coords=new_coords,
            data_vars=self.data_vars,
            # keep dims declared only via the dims kwarg (e.g. a
            # coordinate-less face dim), matching assign()
            dims=self._dims,
            attrs=self.attrs,
        )

    def __repr__(self):
        return (
            f"<xgcm_tpu_torch.Dataset dims={self._dims} coords={list(self.coords)} "
            f"data_vars={list(self.data_vars)}>"
        )

    # -- persistence -------------------------------------------------------
    # The reference delegates persistence to xarray/netCDF (SURVEY.md §5
    # "Checkpoint / resume: none").  The native container round-trips
    # through a single .npz with a small JSON header.

    def save(self, path: str) -> None:
        """Serialise the dataset (data + dims + attrs) to a ``.npz`` file."""
        import json

        header = {
            "dims": self._dims,
            "attrs": self.attrs,
            "coords": {
                k: {"dims": v.dims, "attrs": v.attrs} for k, v in self.coords.items()
            },
            "data_vars": {
                k: {"dims": v.dims, "attrs": v.attrs}
                for k, v in self.data_vars.items()
            },
        }
        arrays = {f"coord__{k}": v.values for k, v in self.coords.items()}
        arrays.update(
            {f"var__{k}": v.values for k, v in self.data_vars.items()}
        )
        np.savez(path, __header__=json.dumps(header), **arrays)

    @classmethod
    def load(cls, path: str) -> "Dataset":
        """Load a dataset written by :meth:`save`."""
        import json

        with np.load(path, allow_pickle=False) as f:
            header = json.loads(str(f["__header__"]))
            coords = {
                k: (tuple(meta["dims"]), f[f"coord__{k}"], meta["attrs"])
                for k, meta in header["coords"].items()
            }
            data_vars = {
                k: (tuple(meta["dims"]), f[f"var__{k}"], meta["attrs"])
                for k, meta in header["data_vars"].items()
            }
            return cls(
                coords=coords,
                data_vars=data_vars,
                dims=header["dims"],
                attrs=header["attrs"],
            )


def from_numpy_dataset(ds, device=None) -> Dataset:
    """The port's Dataset built from another package's Dataset (such as
    ``xgcm_tpu.Dataset``) by duck typing: its dims, attrs, and the dims,
    data and attrs of every variable.  Coordinates stay host numpy; data
    variables become tensors on ``device``, else on the default device."""

    def _coord(v):
        return GriddedArray.on_host(np.asarray(v.data), v.dims, name=v.name, attrs=v.attrs)

    def _var(v):
        return GriddedArray(to_device(v.data, device), v.dims, name=v.name, attrs=v.attrs)

    return Dataset(
        coords={k: _coord(v) for k, v in ds.coords.items()},
        data_vars={k: _var(v) for k, v in ds.data_vars.items()},
        dims=dict(ds.dims),
        attrs=dict(ds.attrs),
    )
