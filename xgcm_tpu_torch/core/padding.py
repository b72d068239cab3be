"""Padding / halo construction on one device.

The counterpart of :mod:`xgcm_tpu.core.padding` for the basic boundary
conditions, built from slices and ``torch.cat``:

===========  =================  ===========================================
xgcm flag    pad mode           meaning
===========  =================  ===========================================
periodic     wrap               wrap around the axis
fill         constant           Dirichlet: constant ``fill_value`` outside
extend       edge               limited Neumann: repeat edge value
extrapolate  extrapolate        linear from the two edge cells
None         wrap               default resolves to periodic
===========  =================  ===========================================

Face-connection halo assembly is not ported yet (ROADMAP Queue 1, item 10):
a grid with face connections never reaches this module, because the port's
Grid refuses ``face_connections`` at construction.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Mapping, Optional, Tuple, Union

import torch

from .dataarray import GriddedArray, as_tensor

if TYPE_CHECKING:
    from .grid import Grid

__all__ = ["pad", "BOUNDARY_TO_PAD_MODE"]

BOUNDARY_TO_PAD_MODE = {
    "periodic": "wrap",
    "fill": "constant",
    "extend": "edge",
    "extrapolate": "extrapolate",
    None: "wrap",
}


def _extrapolate_pad(data: torch.Tensor, axnum: int, widths: Tuple[int, int]):
    """Linear extrapolation padding: value at k cells beyond an edge is
    edge + k * (edge - next-inward)."""
    lw, rw = widths
    shape = [1] * data.ndim
    parts = []
    if lw:
        x0 = data.narrow(axnum, 0, 1)
        x1 = data.narrow(axnum, 1, 1)
        shape[axnum] = lw
        ks = torch.arange(lw, 0, -1, device=data.device).to(data.dtype).reshape(shape)
        parts.append(x0 - ks * (x1 - x0))
    parts.append(data)
    if rw:
        n = data.shape[axnum]
        xn = data.narrow(axnum, n - 1, 1)
        xm = data.narrow(axnum, n - 2, 1)
        shape[axnum] = rw
        ks = torch.arange(1, rw + 1, device=data.device).to(data.dtype).reshape(shape)
        parts.append(xn + ks * (xn - xm))
    return torch.cat(parts, dim=axnum)


def _pad_axis(data: torch.Tensor, axnum: int, widths, mode: str, fv: float):
    """Pad one axis by ``widths`` in ``mode`` (the one-axis analog of
    ``jnp.pad``'s wrap/constant/edge modes)."""
    lw, rw = widths
    n = data.shape[axnum]
    if mode == "extrapolate":
        return _extrapolate_pad(data, axnum, widths)
    parts = []
    for width, side in ((lw, "lo"), (rw, "hi")):
        if not width:
            parts.append(None)
            continue
        if mode == "wrap":
            # widths beyond n wrap more than once, as jnp.pad's wrap mode
            span = range(n - width, n) if side == "lo" else range(width)
            index = torch.tensor([i % n for i in span], device=data.device)
            reps = data.index_select(axnum, index)
        elif mode == "constant":
            shape = list(data.shape)
            shape[axnum] = width
            reps = torch.full(shape, fv, dtype=data.dtype, device=data.device)
        elif mode == "edge":
            edge = data.narrow(axnum, 0 if side == "lo" else n - 1, 1)
            shape = list(data.shape)
            shape[axnum] = width
            reps = edge.expand(shape)
        else:
            raise ValueError(f"unknown pad mode {mode!r}")
        parts.append(reps)
    lo, hi = parts
    return torch.cat([p for p in (lo, data, hi) if p is not None], dim=axnum)


def _pad_basic(
    da: GriddedArray,
    grid: "Grid",
    padding_width: Dict[str, Tuple[int, int]],
    padding: Dict[str, Optional[str]],
    fill_value: Dict[str, float],
) -> GriddedArray:
    """Apply simple per-axis boundary padding, grouped by mode in the same
    order as the JAX package so multi-axis corners round identically."""
    data = as_tensor(da.data)
    by_mode: Dict[Tuple[str, float], list] = {}
    for ax_name, widths in padding_width.items():
        if widths == (0, 0):
            continue
        _, dim = grid.axes[ax_name]._get_position_name(da)
        mode = BOUNDARY_TO_PAD_MODE[padding[ax_name]]
        fv = float(fill_value[ax_name]) if mode == "constant" else 0.0
        by_mode.setdefault((mode, fv), []).append((da.get_axis_num(dim), widths))

    for (mode, fv), axes_widths in by_mode.items():
        for axnum, widths in axes_widths:
            data = _pad_axis(data, axnum, widths, mode, fv)
    return da.with_data(data)


def pad(
    data: Union[GriddedArray, Dict[str, GriddedArray]],
    grid: "Grid",
    boundary_width: Optional[Dict[str, Tuple[int, int]]],
    boundary: Optional[Union[str, Mapping[str, str]]] = None,
    fill_value: Optional[Union[float, Mapping[str, float]]] = None,
    other_component: Optional[Dict[str, GriddedArray]] = None,
) -> Union[GriddedArray, Dict[str, GriddedArray]]:
    """Pad array boundaries along grid axes.

    ``boundary_width`` is ``{axis_name: (lower, upper)}``; ``boundary`` and
    ``fill_value`` override the per-axis defaults (scalar or per-axis dict).
    A single-entry dict ``{axis_name: array}`` marks a vector component;
    without face connections it pads like a scalar.
    """
    padding = grid._complete_user_kwargs_using_axis_defaults(boundary, "boundary")
    fill_values = grid._complete_user_kwargs_using_axis_defaults(
        fill_value, "fill_value"
    )
    if boundary_width is None or all(w == (0, 0) for w in boundary_width.values()):
        return data
    if isinstance(data, dict):
        (data,) = list(data.values())
    return _pad_basic(data, grid, boundary_width, padding, fill_values)
