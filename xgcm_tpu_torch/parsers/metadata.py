"""Convention-dispatch for automatic grid construction.

Hierarchy (reference ``metadata_parsers.py:4-45``): SGRID when the dataset
declares it, otherwise COMODO — plus a CF-conventions FALLBACK that the
reference only stubbed (``metadata_parsers.py:100-119``, upstream #568):
axes COMODO could not find may be added from CF ``standard_name`` /
``units`` / ``positive`` metadata (see :mod:`.cf`), but never override a
COMODO axis or touch a dimension one already claimed.
"""

from __future__ import annotations

from ..core.dataset import Dataset
from . import cf, comodo, sgrid
from .cf import cf_parser  # noqa: F401  (re-exported; reference parity name)


def parse_metadata(ds: Dataset):
    """Returns (ds, grid_kwargs) extracted from dataset metadata."""
    if sgrid.assert_valid_sgrid(ds):
        return parse_sgrid(ds)
    ds, grid_kwargs = parse_comodo(ds)
    cf_coords, cf_proposed = cf._cf_parse(ds)
    claimed = {
        dim
        for positions in grid_kwargs["coords"].values()
        for dim in positions.values()
    }
    accepted_new_coords = {}
    for ax_name, positions in cf_coords.items():
        if ax_name in grid_kwargs["coords"]:
            continue
        if any(d in claimed for d in positions.values()):
            continue
        grid_kwargs["coords"][ax_name] = positions
        # synthesized outer coordinates are assigned only for ACCEPTED
        # axes — a rejected CF axis must not leave stray coords in ds
        accepted_new_coords.update(cf_proposed.get(ax_name, {}))
    if accepted_new_coords:
        ds = ds.assign_coords(**accepted_new_coords)
    return ds, grid_kwargs


def parse_sgrid(ds: Dataset):
    parsed_coords = {}
    for ax_name in sgrid.get_all_axes(ds):
        parsed_coords[ax_name] = sgrid.get_axis_positions_and_coords(ds, ax_name)
    return ds, {"coords": parsed_coords}


def parse_comodo(ds: Dataset):
    # NOTE: like the reference (metadata_parsers.py:74-97), a "coords" key is
    # returned even when no axes were found, so passing explicit `coords`
    # together with autoparse_metadata=True raises a conflict error.
    parsed_coords = {}
    for ax_name in comodo.get_all_axes(ds):
        parsed_coords[ax_name] = comodo.get_axis_positions_and_coords(ds, ax_name)
    return ds, {"coords": parsed_coords}


