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

On a face-connected grid every face is pre-padded with the basic boundary
condition and its connected halos are then replaced by the neighbour faces'
edge strips (:func:`_pad_face_connections`): the generic engine behind every
case the fused face path (``ops/fused.py``) declines, built from slices,
``flip`` and ``torch.cat`` as the JAX package's is from ``jnp.concatenate``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Mapping, Optional, Tuple, Union

import torch

from ..ops.stencils import wrapping
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
    edge + k * (edge - next-inward), in the data's dtype (uint16/32/64
    wrap as JAX's do, through :func:`~xgcm_tpu_torch.ops.stencils.wrapping`)."""
    dtype = data.dtype
    if dtype == torch.bool:
        raise TypeError("extrapolate is not defined for boolean data (as jnp.subtract)")
    data = wrapping(data)
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
    return torch.cat(parts, dim=axnum).view(dtype)


def _pad_axis(data: torch.Tensor, axnum: int, widths, mode: str, fv: float):
    """Pad one axis by ``widths`` in ``mode`` (the one-axis analog of
    ``jnp.pad``'s wrap/constant/edge modes)."""
    lw, rw = widths
    n = data.shape[axnum]
    if mode == "extrapolate":
        return _extrapolate_pad(data, axnum, widths)
    dtype = data.dtype
    if mode == "wrap":
        # index_select takes no uint16/32/64: move their bits as signed ints
        data = wrapping(data)
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
    return torch.cat([p for p in (lo, data, hi) if p is not None], dim=axnum).view(dtype)


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


# ---------------------------------------------------------------------------
# Face-connection halo assembly.
#
# Per connected edge, given connection = (source_face, source_axis, reverse):
#   * the halo strip is taken from the opposite edge of the source face
#     (the same edge when reverse);
#   * if the connection crosses axes (source_axis != axis) the strip's dims
#     are swapped so that its long direction lies along the target's
#     tangential dim;
#   * reverse => flip along the orthogonal (halo-width) dim; if the padded
#     array is the vector component parallel to the padding axis, negate;
#   * axis swap without reverse => flip along the tangential dim; if the
#     padded array is the vector component NOT parallel to the padding axis,
#     negate.
# ---------------------------------------------------------------------------


def _swap_dim_names(da: GriddedArray, from_name: str, to_name: str) -> GriddedArray:
    """Swap two dim names (a plain rename if ``to_name`` is absent)."""
    if to_name in da.dims:
        da = da.rename_dims({to_name: to_name + "__tmp"})
        if from_name in da.dims:
            da = da.rename_dims({from_name: to_name})
        da = da.rename_dims({to_name + "__tmp": from_name})
    else:
        da = da.rename_dims({from_name: to_name})
    return da


def _rename_positions_like(
    grid: "Grid", source: GriddedArray, target: GriddedArray
) -> GriddedArray:
    """Rename source dims so that grid positions line up with the target's
    dims (padding with the partner vector component across a swapped-axis
    connection)."""
    rename = {}
    for di in target.dims:
        if di in source.dims:
            continue
        for axis in grid.axes.values():
            all_dims = list(axis.coords.values())
            if di in all_dims:
                src_matches = [d for d in all_dims if d in source.dims]
                if src_matches:
                    rename[src_matches[0]] = di
    return source.rename_dims(rename)


def _pad_face_connections(
    da: Union[GriddedArray, Dict[str, GriddedArray]],
    grid: "Grid",
    padding_width: Dict[str, Tuple[int, int]],
    padding: Dict[str, Optional[str]],
    fill_value: Dict[str, float],
    other_component: Optional[Dict[str, GriddedArray]] = None,
) -> GriddedArray:
    """Pad every face with the basic boundary condition to the widest
    requested width, replace the connected halos with the source faces'
    strips (in sorted-axis order, so corner cells match the JAX package),
    then trim back to the requested widths."""
    facedim = grid._facedim
    connections = grid._face_connections
    if connections is None or facedim is None:
        raise ValueError("Grid has no face connections")

    if isinstance(da, dict):
        isvector = True
        ((vectoraxis, da),) = da.items()
        if other_component is None:
            raise ValueError(
                "Padding vector components requires `other_component` input."
            )
        ((_, da_partner),) = other_component.items()
    else:
        isvector = False
        da_partner = None

    conn_axes = sorted(
        {ax for face_links in connections[facedim].values() for ax in face_links}
    )
    pad_axes = sorted(set(conn_axes) | set(padding_width))
    padding_width = {ax: padding_width.get(ax, (0, 0)) for ax in pad_axes}

    width = max(w for ws in padding_width.values() for w in ws)
    max_padding_width = {ax: (width, width) for ax in padding_width}

    da_prepadded = _pad_basic(da, grid, max_padding_width, padding, fill_value)
    partner_prepadded = (
        _pad_basic(da_partner, grid, max_padding_width, padding, fill_value)
        if isvector
        else None
    )

    n_faces = da.sizes[facedim]
    faces = []
    for i in range(n_faces):
        target_da = da_prepadded.isel({facedim: i})
        face_links = connections[facedim].get(i, {})
        for axname in pad_axes:
            left_conn, right_conn = face_links.get(axname, (None, None))
            _, target_dim = grid.axes[axname]._get_position_name(target_da)
            for connection, is_right in ((left_conn, False), (right_conn, True)):
                if width == 0 or not connection:
                    continue
                source_face, source_axis, reverse = connection
                swap_axis = axname != source_axis

                source_da = da_prepadded.isel({facedim: source_face})
                if isvector and swap_axis:
                    source_da = partner_prepadded.isel({facedim: source_face})
                    source_da = _rename_positions_like(grid, source_da, target_da)

                _, source_dim = grid.axes[source_axis]._get_position_name(source_da)

                # the `width` interior lines next to the relevant edge of the
                # source, skipping its own pre-padding
                if is_right:
                    src_slc = (
                        slice(-2 * width, -width) if reverse else slice(width, 2 * width)
                    )
                    tgt_slc = slice(0, -width)
                else:
                    src_slc = (
                        slice(width, 2 * width) if reverse else slice(-2 * width, -width)
                    )
                    tgt_slc = slice(width, None)

                source_slice = source_da.isel({source_dim: src_slc})
                target_slice = target_da.isel({target_dim: tgt_slc})

                if swap_axis:
                    source_slice = _swap_dim_names(source_slice, source_dim, target_dim)
                ortho_dim = target_dim
                tangential_dim = source_dim

                if reverse:
                    source_slice = source_slice.flip(ortho_dim)
                    if isvector and vectoraxis == axname:
                        source_slice = -source_slice
                if swap_axis and not reverse:
                    source_slice = source_slice.flip(tangential_dim)
                    if isvector and vectoraxis != axname:
                        source_slice = -source_slice

                source_slice = source_slice.transpose(*target_slice.dims)

                parts = [target_slice, source_slice] if is_right else [source_slice, target_slice]
                ax_num = target_slice.get_axis_num(target_dim)
                target_da = target_slice.with_data(
                    torch.cat([as_tensor(p.data) for p in parts], dim=ax_num)
                )
        faces.append(target_da)

    face_axis = da.get_axis_num(facedim)
    stacked = torch.stack([as_tensor(f.data) for f in faces], dim=face_axis)
    dims = list(faces[0].dims)
    dims.insert(face_axis, facedim)
    da_padded = GriddedArray(stacked, dims, name=da.name)

    # trim the uniformly pre-padded array back to the requested widths
    for axname in padding_width:
        _, dim = grid.axes[axname]._get_position_name(da_padded)
        start = max_padding_width[axname][0] - padding_width[axname][0]
        stop = max_padding_width[axname][1] - padding_width[axname][1]
        da_padded = da_padded.isel({dim: slice(start, -stop if stop else None)})
    return da_padded


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
    without face connections it pads like a scalar, across face
    connections its halos come from ``other_component``, the orthogonal
    component, where a connection swaps axes.
    """
    padding = grid._complete_user_kwargs_using_axis_defaults(boundary, "boundary")
    fill_values = grid._complete_user_kwargs_using_axis_defaults(
        fill_value, "fill_value"
    )
    if boundary_width is None or all(w == (0, 0) for w in boundary_width.values()):
        return data
    if grid._face_connections is not None:
        return _pad_face_connections(
            data, grid, boundary_width, padding, fill_values,
            other_component=other_component,
        )
    if isinstance(data, dict):
        (data,) = list(data.values())
    return _pad_basic(data, grid, boundary_width, padding, fill_values)
