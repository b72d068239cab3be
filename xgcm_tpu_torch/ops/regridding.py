"""Legacy vertical binning regridder.

The counterpart of :mod:`xgcm_tpu.ops.regridding` (xgcm's pre-``transform``
vertical binner): values of ``q`` are summed into the tracer bins of their
cells, column by column.  The JAX package sums a one-hot selection of shape
``(..., nz, nbins)``, which XLA fuses away; eager torch would materialise it
(130 GB for one LLC4320 face of 50 levels into 35 bins).  Here each level
adds its values into their bins with one ``scatter_add_``, levels in
ascending order: a column writes one bin a level, so no two writes of a
launch meet, the memory is that of the inputs and the output, and the sum
order is the one-hot sum's.  The same torch code runs on the CPU and on the
card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dataarray import GriddedArray, as_tensor

__all__ = ["regrid_vertical"]


def _regrid_vertical(q, tr, trlevs, axis=0):
    """Bin ``q`` by the values of the co-located tracer ``tr`` along
    ``axis``.

    A tracer value below the first edge goes into bin 0, one at or above the
    last edge (or NaN) into the last bin; a NaN in ``q`` reaches only its own
    bin.  The result has ``q``'s dtype, with ``len(trlevs) - 1`` bins along
    ``axis``.
    """
    q = as_tensor(q)
    tr = as_tensor(tr, q.device)
    levs = as_tensor(trlevs, q.device)
    if q.shape != tr.shape:
        raise ValueError("q and tr must have the same shape")
    nbins = levs.shape[0] - 1
    axis = axis % q.ndim
    common = torch.promote_types(tr.dtype, levs.dtype)  # as jnp.searchsorted promotes
    levs = levs.to(common)

    shape = list(q.shape)
    shape[axis] = nbins
    out = torch.zeros(shape, dtype=q.dtype, device=q.device)
    for k in range(q.shape[axis]):
        idx = torch.searchsorted(levs, tr.select(axis, k).contiguous().to(common), right=True) - 1
        idx = idx.clamp_(0, nbins - 1).unsqueeze(axis)
        out.scatter_add_(axis, idx, q.select(axis, k).unsqueeze(axis))
    return out


def regrid_vertical(q: GriddedArray, tr: GriddedArray, trlevs, dim: str):
    """Regrid ``q`` (co-located with tracer ``tr``) onto tracer bins.

    Returns a GriddedArray whose ``dim`` is replaced by ``<tr.name>_coord``
    with ``len(trlevs) - 1`` cells (centres at bin midpoints, as a numpy
    array in the result's ``attrs["bin_centers"]``).
    """
    levs = trlevs.detach().cpu().numpy() if isinstance(trlevs, torch.Tensor) else np.asarray(trlevs)
    data = _regrid_vertical(q.data, tr.data, trlevs, axis=q.get_axis_num(dim))
    new_dim = (tr.name or "tracer") + "_coord"
    dims = tuple(new_dim if d == dim else d for d in q.dims)
    centers = 0.5 * (levs[1:] + levs[:-1])
    return GriddedArray(data, dims, name=q.name, attrs={"bin_centers": centers})
