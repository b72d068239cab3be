"""Labeled array container on torch tensors.

The port's data model: a thin holder of a ``torch.Tensor`` together with a
tuple of dimension *names*, keeping the ``(data, dims, name, attrs)``
contract of :class:`xgcm_tpu.core.dataarray.GriddedArray`.  It is not a
pytree; PyTorch runs eagerly and needs none.

Coordinate variables of a :class:`~xgcm_tpu_torch.core.dataset.Dataset`
stay numpy arrays, so the container also holds an ``np.ndarray`` as given;
arithmetic and every grid operation turn numpy data into a CPU tensor with
:func:`as_tensor`.  Operations run on the device of their input tensor.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["GriddedArray", "as_tensor"]


def as_tensor(x) -> torch.Tensor:
    """``x`` as a tensor: tensors pass through, numpy data becomes a CPU
    tensor sharing its memory where numpy allows it."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x))


class GriddedArray:
    """An n-dimensional array with named dimensions.

    Parameters
    ----------
    data : torch.Tensor, numpy array, or nested sequence
        The underlying array.  Tensors and numpy arrays are kept as given;
        anything else goes through ``np.asarray``.
    dims : sequence of str
        One name per axis of ``data``.
    name : str, optional
        Label used when attaching the result to a Dataset or naming outputs.
    attrs : dict, optional
        Arbitrary metadata (used by the COMODO/SGRID parsers).
    device : torch.device or str, optional
        When given, the data becomes a tensor on this device.
    """

    __slots__ = ("data", "dims", "name", "attrs")

    def __init__(
        self,
        data: Any,
        dims: Sequence[str],
        name: Optional[str] = None,
        attrs: Optional[Mapping[str, Any]] = None,
        device=None,
    ):
        if isinstance(data, GriddedArray):
            data = data.data
        if device is not None:
            data = torch.as_tensor(as_tensor(data), device=device)
        elif not isinstance(data, (torch.Tensor, np.ndarray)):
            data = np.asarray(data)
        dims = tuple(dims)
        if len(dims) != data.ndim:
            raise ValueError(
                f"dims {dims} has {len(dims)} entries but data has "
                f"{data.ndim} dimensions"
            )
        if len(set(dims)) != len(dims):
            raise ValueError(f"duplicate dimension names in {dims}")
        self.data = data
        self.dims = dims
        self.name = name
        self.attrs = dict(attrs) if attrs else {}

    # -- basic introspection ----------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        if isinstance(self.data, torch.Tensor):
            return self.data.device
        return torch.device("cpu")

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.dims, self.data.shape))

    @property
    def size(self) -> int:
        out = 1
        for n in self.data.shape:
            out *= int(n)
        return out

    @property
    def values(self) -> np.ndarray:
        """Data as a numpy array (copies device tensors to the host)."""
        if isinstance(self.data, torch.Tensor):
            return self.data.detach().cpu().numpy()
        return np.asarray(self.data)

    def get_axis_num(self, dim: str) -> int:
        try:
            return self.dims.index(dim)
        except ValueError:
            raise KeyError(f"dimension {dim!r} not found in {self.dims}")

    # -- label-preserving ops ---------------------------------------------
    def with_data(self, data, dims: Optional[Sequence[str]] = None) -> "GriddedArray":
        return GriddedArray(
            data, self.dims if dims is None else dims, name=self.name, attrs=self.attrs
        )

    def rename_dims(self, mapping: Mapping[str, str]) -> "GriddedArray":
        return self.with_data(
            self.data, dims=tuple(mapping.get(d, d) for d in self.dims)
        )

    def rename(self, name: Optional[str]) -> "GriddedArray":
        return GriddedArray(self.data, self.dims, name=name, attrs=self.attrs)

    def isel(self, indexers: Mapping[str, Any]) -> "GriddedArray":
        """Positional selection by dimension name (slices keep the dim,
        integers drop it) — the analog of ``xr.DataArray.isel``."""
        index: list = [slice(None)] * self.ndim
        dropped = []
        for dim, idx in indexers.items():
            index[self.get_axis_num(dim)] = idx
            if isinstance(idx, int):
                dropped.append(dim)
        out_dims = [d for d in self.dims if d not in dropped]
        return GriddedArray(
            self.data[tuple(index)], out_dims, name=self.name, attrs=self.attrs
        )

    def transpose(self, *dims: str) -> "GriddedArray":
        if set(dims) != set(self.dims):
            raise ValueError(f"transpose dims {dims} do not match {self.dims}")
        perm = [self.dims.index(d) for d in dims]
        return GriddedArray(
            as_tensor(self.data).permute(perm), dims, name=self.name, attrs=self.attrs
        )

    def expand_dims(self, dim: str, axis: int = 0) -> "GriddedArray":
        new_dims = list(self.dims)
        new_dims.insert(axis, dim)
        return GriddedArray(
            as_tensor(self.data).unsqueeze(axis), new_dims, name=self.name,
            attrs=self.attrs,
        )

    def flip(self, dim: str) -> "GriddedArray":
        return self.with_data(torch.flip(as_tensor(self.data), (self.get_axis_num(dim),)))

    def move_dims_last(self, dims: Sequence[str]) -> "GriddedArray":
        """Transpose so that `dims` appear, in order, as the trailing axes."""
        rest = [d for d in self.dims if d not in dims]
        return self.transpose(*rest, *dims)

    # -- arithmetic --------------------------------------------------------
    def _binop(self, other, op):
        if isinstance(other, GriddedArray):
            a, b, dims = _broadcast_align(self, other)
            return GriddedArray(op(a, b), dims, name=self.name)
        return self.with_data(op(as_tensor(self.data), _operand(other)))

    def _rbinop(self, other, op):
        return self.with_data(op(_operand(other), as_tensor(self.data)))

    def __add__(self, other):
        return self._binop(other, torch.add)

    def __radd__(self, other):
        return self._rbinop(other, torch.add)

    def __sub__(self, other):
        return self._binop(other, torch.sub)

    def __rsub__(self, other):
        return self._rbinop(other, torch.sub)

    def __mul__(self, other):
        return self._binop(other, torch.mul)

    def __rmul__(self, other):
        return self._rbinop(other, torch.mul)

    def __truediv__(self, other):
        return self._binop(other, torch.true_divide)

    def __rtruediv__(self, other):
        return self._rbinop(other, torch.true_divide)

    def __neg__(self):
        return self.with_data(-as_tensor(self.data))

    def __abs__(self):
        return self.with_data(torch.abs(as_tensor(self.data)))

    def __pow__(self, other):
        return self._binop(other, torch.pow)

    def __rpow__(self, other):
        return self._rbinop(other, torch.pow)

    def __mod__(self, other):
        return self._binop(other, torch.remainder)

    def __floordiv__(self, other):
        return self._binop(other, torch.floor_divide)

    # comparisons return boolean masks with xarray-style broadcast
    # alignment — the everyday `da > 0` masking idiom
    def __lt__(self, other):
        return self._binop(other, torch.lt)

    def __le__(self, other):
        return self._binop(other, torch.le)

    def __gt__(self, other):
        return self._binop(other, torch.gt)

    def __ge__(self, other):
        return self._binop(other, torch.ge)

    def __eq__(self, other):  # noqa: D105 — mask semantics, like xarray
        return self._binop(other, torch.eq)

    def __ne__(self, other):
        return self._binop(other, torch.ne)

    # mask semantics for == / != make GriddedArray unhashable, as in xarray
    __hash__ = None

    def where(self, cond, other=float("nan")) -> "GriddedArray":
        """Elementwise select: keep self where ``cond`` else ``other``
        (xarray ``DataArray.where`` semantics, NaN default)."""
        if isinstance(cond, GriddedArray):
            a, c, dims = _broadcast_align(self, cond)
        else:
            a, c, dims = as_tensor(self.data), _operand(cond), self.dims
        o = _operand(other.data if isinstance(other, GriddedArray) else other)
        if not isinstance(o, torch.Tensor):
            o = torch.tensor(o, dtype=torch.result_type(a, o), device=a.device)
        return GriddedArray(
            torch.where(c, a, o), dims, name=self.name, attrs=self.attrs
        )

    def clip(self, min=None, max=None) -> "GriddedArray":
        return self.with_data(torch.clamp(as_tensor(self.data), min, max))

    def isnan(self) -> "GriddedArray":
        return self.with_data(torch.isnan(as_tensor(self.data)))

    def fillna(self, value) -> "GriddedArray":
        """Replace NaNs (xarray ``DataArray.fillna``)."""
        x = as_tensor(self.data)
        fill = torch.as_tensor(value, dtype=x.dtype, device=x.device)
        return self.with_data(torch.where(torch.isnan(x), fill, x))

    def sum(self, dims: Union[str, Sequence[str], None] = None):
        return self._reduce(torch.sum, dims)

    def mean(self, dims: Union[str, Sequence[str], None] = None):
        return self._reduce(torch.mean, dims)

    def _reduce(self, fn, dims):
        x = as_tensor(self.data)
        if dims is None:
            return GriddedArray(fn(x), (), name=self.name)
        if isinstance(dims, str):
            dims = [dims]
        axes = tuple(self.get_axis_num(d) for d in dims)
        out_dims = tuple(d for d in self.dims if d not in dims)
        return GriddedArray(fn(x, dim=axes), out_dims, name=self.name)

    def astype(self, dtype) -> "GriddedArray":
        return self.with_data(as_tensor(self.data).to(dtype))

    def __repr__(self):
        return (
            f"<GriddedArray {self.name or ''}{dict(zip(self.dims, self.shape))} "
            f"dtype={self.dtype}>"
        )


def _operand(x):
    """A scalar stays a Python number (so torch keeps the tensor's dtype,
    like a weakly typed JAX scalar); arrays become tensors."""
    if isinstance(x, (int, float, bool, complex, torch.Tensor)):
        return x
    return as_tensor(x)


def _broadcast_align(a: GriddedArray, b: GriddedArray):
    """Align two GriddedArrays by dimension name for broadcasting.

    Output dims are a's dims followed by b's extra dims (order of first
    appearance, matching xarray's broadcasting convention).
    """
    out_dims = list(a.dims) + [d for d in b.dims if d not in a.dims]
    return _expand_to(a, out_dims), _expand_to(b, out_dims), tuple(out_dims)


def _expand_to(x: GriddedArray, out_dims: Sequence[str]) -> torch.Tensor:
    """Reshape x.data so its dims line up with out_dims (size-1 for missing)."""
    shape = [1] * len(out_dims)
    for d in x.dims:
        if d not in out_dims:
            raise ValueError(f"dim {d} missing from target dims {out_dims}")
    ordered = [d for d in out_dims if d in x.dims]
    x = x.transpose(*ordered)
    for i, d in enumerate(out_dims):
        if d in x.dims:
            shape[i] = x.sizes[d]
    return x.data.reshape(shape)
