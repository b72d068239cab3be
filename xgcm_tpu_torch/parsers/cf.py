"""CF-conventions fallback parser (beyond reference).

The reference stubs a ``cf_parser`` hook and never implements it
(``metadata_parsers.py:100-119``, upstream GH #568 TODO).  This module
completes it: datasets that carry only CF metadata — ``standard_name`` /
``units`` / ``positive`` on their coordinate variables, as written by
CMIP-archived output, NEMO, and most CF-compliant post-processing — get
their axes inferred without the user spelling out ``coords=``.

Detection is deliberately conservative so COMODO/SGRID datasets are
untouched:

- only 1-D **dimension coordinates** are considered, and any coordinate
  that carries a COMODO attribute (``axis`` or ``c_grid_axis_shift``)
  is left to the COMODO parser entirely;
- the CF axis of a coordinate is inferred from (in order)
  ``standard_name`` (longitude/latitude/vertical/time tables below),
  the GFDL/MOM ``cartesian_axis`` attribute, ``units``
  (``degrees_east``-family → X, ``degrees_north``-family → Y, ``...
  since ...`` timestamps → T), and the CF ``positive: up|down``
  vertical marker;
- staggered positions are assigned from coordinate lengths only when
  unambiguous: a single coordinate is ``center``; a pair (n, n+1) is
  ``center``/``outer`` unless the longer one is a data-variable
  dimension (then ``inner``/``center``); a pair (n, n-1) mirrors that.
  Anything else (e.g. two same-length coordinates, which COMODO would
  need a shift attribute to orient) makes the axis undecidable and it
  is skipped — CF has no staggering vocabulary, so guessing left/right
  would be wrong half the time.

``parse_metadata`` runs this parser strictly as a fallback: SGRID wins
outright, COMODO-parsed axes win per axis name, and CF may only add
axes whose dimensions no COMODO axis already claimed.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..core.dataset import Dataset

#: CF standard names that pin a coordinate to an axis (CF conventions
#: sec. 4: latitude/longitude/vertical/time coordinate identification).
STANDARD_NAME_AXES = {
    "longitude": "X",
    "grid_longitude": "X",
    "projection_x_coordinate": "X",
    "latitude": "Y",
    "grid_latitude": "Y",
    "projection_y_coordinate": "Y",
    "depth": "Z",
    "height": "Z",
    "altitude": "Z",
    "air_pressure": "Z",
    "geopotential_height": "Z",
    "height_above_geopotential_datum": "Z",
    "atmosphere_sigma_coordinate": "Z",
    "atmosphere_hybrid_sigma_pressure_coordinate": "Z",
    "atmosphere_hybrid_height_coordinate": "Z",
    "ocean_sigma_coordinate": "Z",
    "ocean_s_coordinate": "Z",
    "ocean_s_coordinate_g1": "Z",
    "ocean_s_coordinate_g2": "Z",
    "ocean_sigma_z_coordinate": "Z",
    "ocean_double_sigma_coordinate": "Z",
    "time": "T",
}

#: CF sec. 4.1/4.2 unit spellings for horizontal coordinates.
LON_UNITS = {"degrees_east", "degree_east", "degree_e", "degrees_e",
             "degreee", "degreese"}
LAT_UNITS = {"degrees_north", "degree_north", "degree_n", "degrees_n",
             "degreen", "degreesn"}


def infer_axis(attrs) -> "str | None":
    """CF axis letter (X/Y/Z/T) for a coordinate's attrs, or None."""
    sn = str(attrs.get("standard_name", "")).lower()
    if sn in STANDARD_NAME_AXES:
        return STANDARD_NAME_AXES[sn]
    ca = str(attrs.get("cartesian_axis", "")).upper()
    if ca in ("X", "Y", "Z", "T"):
        return ca
    units = str(attrs.get("units", "")).lower()
    if units in LON_UNITS:
        return "X"
    if units in LAT_UNITS:
        return "Y"
    if " since " in units:  # CF time: "<units> since <timestamp>"
        return "T"
    if str(attrs.get("positive", "")).lower() in ("up", "down"):
        return "Z"
    return None


def _is_comodo(attrs) -> bool:
    return "axis" in attrs or "c_grid_axis_shift" in attrs


def get_all_axes(ds: Dataset):
    """CF axes present among unclaimed 1-D dimension coordinates."""
    axes = set()
    for d in ds.dims:
        if d in ds.coords and not _is_comodo(ds.coords[d].attrs):
            ax = infer_axis(ds.coords[d].attrs)
            if ax is not None:
                axes.add(ax)
    return axes


def get_axis_coords(ds: Dataset, axis_name: str):
    """Names of unclaimed dimension coordinates on this CF axis, in
    deterministic (dataset dim) order."""
    names = []
    for d in ds.dims:
        if d in ds.coords and not _is_comodo(ds.coords[d].attrs):
            if infer_axis(ds.coords[d].attrs) == axis_name:
                names.append(d)
    return names


def get_axis_positions_and_coords(ds: Dataset, axis_name: str):
    """Map CF coordinates of one axis to staggered positions by length.

    Raises ValueError when the staggering is ambiguous (see module
    docstring); ``cf_parser`` catches that and skips the axis.
    """
    coord_names = get_axis_coords(ds, axis_name)
    if not coord_names:
        raise ValueError(
            f"Couldn't find any CF coordinates for axis {axis_name}"
        )
    if len(coord_names) == 1:
        return OrderedDict(center=coord_names[0])
    if len(coord_names) > 2:
        raise ValueError(
            f"CF metadata cannot orient {len(coord_names)} staggered "
            f"coordinates on axis {axis_name}; pass coords= explicitly"
        )
    a, b = coord_names
    la, lb = ds.coords[a].shape[0], ds.coords[b].shape[0]
    if la == lb:
        raise ValueError(
            f"Two same-length CF coordinates on axis {axis_name} "
            f"({a!r}, {b!r}): left/right staggering is not expressible "
            "in CF metadata; pass coords= explicitly"
        )
    if abs(la - lb) != 1:
        raise ValueError(
            f"CF coordinates {a!r} (len {la}) and {b!r} (len {lb}) on "
            f"axis {axis_name} differ by more than one point"
        )
    short, long_ = (a, b) if la < lb else (b, a)
    # (n, n+1) is center/outer OR inner/center; data-variable dims break
    # the tie (model output lives on centers), else prefer center/outer —
    # an n+1 coordinate is almost always a cell-bounds (outer) coordinate
    data_dims = set()
    for var in ds.data_vars.values():
        data_dims.update(var.dims)
    if long_ in data_dims and short not in data_dims:
        return OrderedDict(center=long_, inner=short)
    return OrderedDict(center=short, outer=long_)


def synthesize_outer_from_bounds(ds: Dataset, center_name: str):
    """(n, 2) CF cell-bounds variable -> (n+1,) outer-coordinate values.

    CMIP-archived output expresses staggering through the CF ``bounds``
    attribute: a center coordinate ``lev`` points at a ``lev_bnds``
    variable of shape (n, 2).  When those bounds are CONTIGUOUS
    (``bnds[k, 1] == bnds[k+1, 0]``) and monotonic they are exactly an
    ``outer`` coordinate, which is what conservative transforms and
    outer-position ops need.  Returns the (n+1,) edge values, or None
    when there is no usable bounds variable (missing, wrong shape,
    non-contiguous — e.g. overlapping or gappy cells — or non-monotonic).
    """
    attrs = ds.coords[center_name].attrs
    bname = attrs.get("bounds")
    if not bname or bname not in ds:
        return None
    bvar = ds[bname]
    n = ds.coords[center_name].shape[0]
    if tuple(bvar.shape) != (n, 2):
        return None
    vals = np.asarray(bvar.data)
    # only NUMERIC bounds are usable as a coordinate for grid ops;
    # datetime64 / cftime-object time bounds (the other common CMIP
    # bounds) must not crash autoparse — the axis simply stays
    # center-only
    if not np.issubdtype(vals.dtype, np.number):
        return None
    if not np.allclose(vals[1:, 0], vals[:-1, 1]):
        return None
    edges = np.concatenate([vals[:, 0], vals[-1:, 1]])
    d = np.diff(edges)
    if not (np.all(d > 0) or np.all(d < 0)):
        return None
    return edges


def cf_parser(ds: Dataset):
    """Extract CF grid metadata: (ds, {"coords": {axis: {pos: dim}}}).

    Completes the reference's placeholder (metadata_parsers.py:100-119).
    Undecidable axes are skipped — this parser is a fallback, so a
    dataset that merely *contains* CF-ish attributes must never error
    during autoparse.

    A center-only axis whose coordinate carries a usable CF ``bounds``
    variable gains a synthesized ``outer`` coordinate named
    ``<center>_outer`` (the returned dataset carries the new (n+1,)
    dimension coordinate; the original (n, 2) bounds variable is left
    untouched) — this is how CMIP output becomes conservative-transform
    ready without explicit ``coords=``.
    """
    parsed_coords, proposed = _cf_parse(ds)
    new_coords = {}
    for ax_coords in proposed.values():
        new_coords.update(ax_coords)
    if new_coords:
        ds = ds.assign_coords(**new_coords)
    return ds, {"coords": parsed_coords}


def _cf_parse(ds: Dataset):
    """Parse without mutating ``ds``: (parsed_coords, proposed_new_coords).

    ``proposed_new_coords`` maps axis name -> {coord_name: (dim, values)}
    for the synthesized outer coordinates, so :func:`..metadata.parse_metadata`
    can assign only the coordinates of axes it actually ACCEPTS — a CF axis
    rejected there (name or dims already claimed by COMODO) must not leave
    stray ``<center>_outer`` coordinates in the returned dataset.
    """
    parsed_coords = {}
    proposed = {}
    for ax_name in sorted(get_all_axes(ds)):
        try:
            positions = get_axis_positions_and_coords(ds, ax_name)
        except ValueError:
            continue
        if list(positions) == ["center"]:
            center = positions["center"]
            try:
                edges = synthesize_outer_from_bounds(ds, center)
            except (TypeError, ValueError):
                # exotic bounds contents must never break autoparse
                # (this parser's "never error" fallback contract)
                edges = None
            # the (n, 2) bounds variable keeps its name; the synthesized
            # (n+1,) dimension coordinate gets a collision-free one
            oname = f"{center}_outer"
            if edges is not None and oname not in ds.dims and oname not in ds:
                proposed[ax_name] = {oname: (oname, edges)}
                positions = OrderedDict(center=center, outer=oname)
        parsed_coords[ax_name] = positions
    return parsed_coords, proposed
