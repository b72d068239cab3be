"""Labeled array container on torch tensors.

The port's data model: a thin holder of a ``torch.Tensor`` together with a
tuple of dimension *names*, keeping the ``(data, dims, name, attrs)``
contract of :class:`xgcm_tpu.core.dataarray.GriddedArray`.  It is not a
pytree; PyTorch runs eagerly and needs none.

Host data given to the container (numpy arrays, lists, scalars) becomes a
tensor on the default device, the CUDA card unless the caller asks for the
CPU (:mod:`xgcm_tpu_torch.core.device`).  Coordinate variables of a
:class:`~xgcm_tpu_torch.core.dataset.Dataset` stay host numpy arrays
(:meth:`GriddedArray.on_host`); an operation on one turns it into a tensor
with :func:`as_tensor`.  Operations run on the device of their input
tensor, and host operands join that device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.profiling import span
from .device import resolve_device

__all__ = ["GriddedArray", "as_tensor"]


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor.  A tensor keeps its device unless ``device`` is
    given; host data goes to ``device``, else to the default device (on
    the CPU it shares numpy's memory where numpy allows it)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


class GriddedArray:
    """An n-dimensional array with named dimensions.

    Parameters
    ----------
    data : torch.Tensor, numpy array, or nested sequence
        The underlying array.  A tensor is kept as given; host data becomes
        a tensor on ``device``, else on the default device.
    dims : sequence of str
        One name per axis of ``data``.
    name : str, optional
        Label used when attaching the result to a Dataset or naming outputs.
    attrs : dict, optional
        Arbitrary metadata (used by the COMODO/SGRID parsers).
    device : torch.device or str, optional
        When given, the data becomes a tensor on this device.

    :meth:`on_host` builds one that keeps host numpy data, as the
    coordinate variables of a Dataset are kept.
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
        self._set(as_tensor(data, device), dims, name, attrs)

    @classmethod
    def on_host(cls, data, dims, name=None, attrs=None) -> "GriddedArray":
        """A GriddedArray holding ``data`` as a host numpy array (a tensor
        stays a tensor)."""
        obj = cls.__new__(cls)
        if not isinstance(data, torch.Tensor):
            data = np.asarray(data)
        obj._set(data, dims, name, attrs)
        return obj

    def _set(self, data, dims, name, attrs) -> None:
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
        return self._like(data, self.dims if dims is None else dims, self.name)

    def _like(self, data, dims, name) -> "GriddedArray":
        """A GriddedArray of ``data`` with this one's attrs; host numpy
        data taken from this array stays on the host."""
        make = GriddedArray.on_host if isinstance(data, np.ndarray) else GriddedArray
        return make(data, dims, name=name, attrs=self.attrs)

    def rename_dims(self, mapping: Mapping[str, str]) -> "GriddedArray":
        return self.with_data(
            self.data, dims=tuple(mapping.get(d, d) for d in self.dims)
        )

    def rename(self, name: Optional[str]) -> "GriddedArray":
        return self._like(self.data, self.dims, name)

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
        return self._like(self.data[tuple(index)], out_dims, self.name)

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
        from ..ops.stencils import wrapping

        # torch flips no uint16/32/64: move their bits as signed ints
        data = as_tensor(self.data)
        return self.with_data(torch.flip(wrapping(data), (self.get_axis_num(dim),)).view(data.dtype))

    def move_dims_last(self, dims: Sequence[str]) -> "GriddedArray":
        """Transpose so that `dims` appear, in order, as the trailing axes."""
        rest = [d for d in self.dims if d not in dims]
        return self.transpose(*rest, *dims)

    # -- arithmetic --------------------------------------------------------
    @span("xtt.arith.binop")
    def _binop(self, other, op):
        if isinstance(other, GriddedArray):
            a, b, dims = _broadcast_align(self, other)
            a, b = _promoted(a, b, op)
            return GriddedArray(op(a, b), dims, name=self.name)
        a, b = _promoted(as_tensor(self.data), other, op)
        return self.with_data(op(a, _operand(b, a.device)))

    @span("xtt.arith.binop")
    def _rbinop(self, other, op):
        a, b = _promoted(as_tensor(self.data), other, op)
        return self.with_data(op(_operand(b, a.device), a))

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

    @span("xtt.arith.unary")
    def __neg__(self):
        return self.with_data(-as_tensor(self.data))

    @span("xtt.arith.unary")
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
            a = as_tensor(self.data)
            c, dims = _operand(cond, a.device), self.dims
        a, other = _promoted(a, other.data if isinstance(other, GriddedArray) else other)
        o = _operand(other, a.device)
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

    def sum(self, dims: Union[str, Sequence[str], None] = None, **kwargs):
        """Sum over ``dims`` (all when None) with the result dtype of
        ``jnp.sum`` under x64: bool and the signed integers give int64, the
        unsigned ones uint64, floats keep theirs.  Takes jnp's ``keepdims``
        and ``dtype``."""
        return self._reduce("sum", dims, **kwargs)

    def mean(self, dims: Union[str, Sequence[str], None] = None, **kwargs):
        """Mean over ``dims`` (all when None) with the result dtype of
        ``jnp.mean`` under x64: float32 for bool and the integers below 64
        bits, float64 for 64-bit integers; 16-bit floats are averaged in
        float32 and rounded once.  Takes jnp's ``keepdims`` and ``dtype``."""
        return self._reduce("mean", dims, **kwargs)

    @span("xtt.arith.reduce")
    def _reduce(self, how, dims, keepdims=False, dtype=None, **kwargs):
        if kwargs:
            raise TypeError(f"{how}() got unexpected keyword arguments {sorted(kwargs)}")
        x = as_tensor(self.data)
        out_dtype = _torch_dtype(dtype) if dtype is not None else _reduced_dtype(how, x.dtype)
        if dims is None:
            axes, out_dims = tuple(range(x.ndim)), ()
        else:
            dims = [dims] if isinstance(dims, str) else list(dims)
            axes = tuple(self.get_axis_num(d) for d in dims)
            out_dims = tuple(d for d in self.dims if d not in dims)
        if not (out_dtype.is_floating_point or out_dtype.is_complex):
            # integers sum in int64 (uint64 results wrap as JAX's do); an
            # integer mean divides with truncation, as lax.div does
            out = torch.sum(x.to(torch.int64), dim=axes, keepdim=keepdims)
            if how == "mean":
                count = math.prod(x.shape[a] for a in axes)
                out = torch.div(out, count, rounding_mode="trunc")
        else:
            # 16-bit floats are reduced in float32 and rounded once
            work = torch.float32 if out_dtype in (torch.float16, torch.bfloat16) else out_dtype
            fn = torch.sum if how == "sum" else torch.mean
            out = fn(x.to(work), dim=axes, keepdim=keepdims)
        return GriddedArray(out.to(out_dtype), out_dims, name=self.name)

    def cumsum(self, dim: str) -> "GriddedArray":
        """Inclusive prefix sum along a named dimension, with the dtype and
        the float sums of ``jnp.cumsum`` under x64 (see
        :func:`xgcm_tpu_torch.ops.stencils.cumsum`)."""
        from ..ops.stencils import cumsum

        return self.with_data(cumsum(as_tensor(self.data), self.get_axis_num(dim)))

    def astype(self, dtype) -> "GriddedArray":
        return self.with_data(as_tensor(self.data).to(dtype))

    def __repr__(self):
        return (
            f"<GriddedArray {self.name or ''}{dict(zip(self.dims, self.shape))} "
            f"dtype={self.dtype}>"
        )


def _reduced_dtype(how: str, dt: torch.dtype) -> torch.dtype:
    """The dtype of ``jnp.sum``/``jnp.mean`` (``how``) of dt under x64."""
    if dt.is_floating_point or dt.is_complex:
        return dt
    if how == "mean":
        return torch.float64 if dt in (torch.int64, torch.uint64) else torch.float32
    unsigned = dt in (torch.uint8, torch.uint16, torch.uint32, torch.uint64)
    return torch.uint64 if unsigned else torch.int64


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, or the torch dtype of a NumPy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _promoted(a, b, op=None):
    """(a, b) with the integer or bool tensor among them in float64 where
    JAX (x64) computes in float64 and torch would take its default dtype,
    float32: against a Python float (complex128 against a Python complex),
    and in a true division of integer or bool operands that promote to a
    64-bit integer (narrower ones divide in float32 in both).  A float
    tensor keeps its dtype against a Python float, as against a weakly
    typed JAX scalar."""

    def exact(x):
        return isinstance(x, torch.Tensor) and not (x.is_floating_point() or x.is_complex())

    scalar = b if isinstance(b, (float, complex)) and not isinstance(b, bool) else None
    if scalar is not None:
        wide = torch.complex128 if isinstance(scalar, complex) else torch.float64
        return (a.to(wide) if exact(a) else a), b
    if (op is torch.true_divide and exact(a) and (exact(b) or isinstance(b, (bool, int)))
            and torch.result_type(a, b) in (torch.int64, torch.uint64)):
        return a.to(torch.float64), b
    return a, b


def _operand(x, device):
    """A scalar stays a Python number (so torch keeps the tensor's dtype,
    like a weakly typed JAX scalar); a tensor stays as it is; host arrays
    become tensors on ``device``, the other operand's."""
    if isinstance(x, (int, float, bool, complex, torch.Tensor)):
        return x
    return as_tensor(x, device)


def _broadcast_align(a: GriddedArray, b: GriddedArray):
    """Align two GriddedArrays by dimension name for broadcasting; host
    data joins the device of the operand that holds a tensor.

    Output dims are a's dims followed by b's extra dims (order of first
    appearance, matching xarray's broadcasting convention).
    """
    out_dims = list(a.dims) + [d for d in b.dims if d not in a.dims]
    device = next((x.data.device for x in (a, b) if isinstance(x.data, torch.Tensor)), None)
    return (_expand_to(a, out_dims, device), _expand_to(b, out_dims, device),
            tuple(out_dims))


def _expand_to(x: GriddedArray, out_dims: Sequence[str], device=None) -> torch.Tensor:
    """Reshape x.data so its dims line up with out_dims (size-1 for missing)."""
    for d in x.dims:
        if d not in out_dims:
            raise ValueError(f"dim {d} missing from target dims {out_dims}")
    data = x.data if isinstance(x.data, torch.Tensor) else as_tensor(x.data, device)
    ordered = [d for d in out_dims if d in x.dims]
    data = data.permute([x.dims.index(d) for d in ordered])
    shape = [x.sizes[d] if d in x.dims else 1 for d in out_dims]
    return data.reshape(shape)
