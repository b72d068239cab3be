"""COMODO convention parser.

Infers axis names and staggered positions from ``axis`` and
``c_grid_axis_shift`` attributes on dimension-coordinate variables, plus
coordinate lengths (reference ``comodo.py:23-144``): the unshifted coordinate
is ``center``; length+1 -> ``outer``; length-1 -> ``inner``; shift -0.5 ->
``left``; shift +0.5 -> ``right``.
"""

from __future__ import annotations

from collections import OrderedDict

from ..core.dataset import Dataset

AXIS_SHIFT_LEFT = -0.5
AXIS_SHIFT_RIGHT = 0.5
AXIS_SHIFT_CENTER = 0
VALID_AXIS_SHIFTS = [AXIS_SHIFT_LEFT, AXIS_SHIFT_RIGHT, AXIS_SHIFT_CENTER]


def assert_valid_comodo(ds: Dataset):
    """Verify that the dataset meets COMODO conventions.

    Mirrors the reference's placeholder (comodo.py:11-19, an unimplemented
    TODO there as well): COMODO has no formal validator; parsing errors
    surface from the position/coord extraction below.
    """
    # parity with the reference: intentionally a no-op


def get_all_axes(ds: Dataset):
    axes = set()
    for d in ds.dims:
        if d in ds.coords and "axis" in ds.coords[d].attrs:
            axes.add(ds.coords[d].attrs["axis"])
    return axes


def get_axis_coords(ds: Dataset, axis_name: str):
    """Names of the dimension coordinates tagged with this axis."""
    names = []
    for d in ds.dims:
        if d in ds.coords and ds.coords[d].attrs.get("axis") == axis_name:
            names.append(d)
    return names


def _maybe_fix_type(attr):
    # tolerate malformed c_grid_axis_shift attrs (reference comodo.py:65-75)
    if attr is not None:
        try:
            return float(attr)
        except TypeError:
            return True


def get_axis_positions_and_coords(ds: Dataset, axis_name: str):
    coord_names = get_axis_coords(ds, axis_name)
    if not coord_names:
        raise ValueError(f"Couldn't find any coordinates for axis {axis_name}")

    coords = {name: ds.coords[name] for name in coord_names}
    axis_shift = {
        name: _maybe_fix_type(coord.attrs.get("c_grid_axis_shift"))
        for name, coord in coords.items()
    }
    coord_len = {name: coord.shape[0] for name, coord in coords.items()}

    unshifted = {
        name: coord_len[name] for name, shift in axis_shift.items() if not shift
    }
    if len(unshifted) == 0:
        raise ValueError(f"Couldn't find a center coordinate for axis {axis_name}")
    if len(unshifted) > 1:
        raise ValueError(
            "Found two coordinates without `c_grid_axis_shift` attribute for "
            f"axis {axis_name}"
        )
    center_coord_name = list(unshifted)[0]
    axis_len = coord_len[center_coord_name]

    axis_coords = OrderedDict()
    axis_coords["center"] = center_coord_name

    coord_names.remove(center_coord_name)
    for name in coord_names:
        shift = axis_shift[name]
        clen = coord_len[name]
        if clen == axis_len + 1:
            axis_coords["outer"] = name
        elif clen == axis_len - 1:
            axis_coords["inner"] = name
        elif shift == AXIS_SHIFT_LEFT:
            if clen == axis_len:
                axis_coords["left"] = name
            else:
                raise ValueError(
                    f"Left coordinate {name} has incompatible length {clen} "
                    f"(axis_len={axis_len})"
                )
        elif shift == AXIS_SHIFT_RIGHT:
            if clen == axis_len:
                axis_coords["right"] = name
            else:
                raise ValueError(
                    f"Right coordinate {name} has incompatible length {clen} "
                    f"(axis_len={axis_len})"
                )
        else:
            if shift not in VALID_AXIS_SHIFTS:
                valids = str(VALID_AXIS_SHIFTS)[1:-1]
                raise ValueError(
                    f"Coordinate {name} has invalid `c_grid_axis_shift` "
                    f"attribute `{shift!r}`. `c_grid_axis_shift` must be one "
                    f"of: {valids}"
                )
            raise ValueError(
                f"Coordinate {name} has missing `c_grid_axis_shift` "
                f"attribute `{shift!r}`"
            )
    return axis_coords
