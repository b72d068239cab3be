"""SGRID convention parser (reference ``sgrid.py:6-238``).

Detects the SGRID convention from the global ``Conventions`` attribute, finds
the ``grid_topology`` variable via its ``cf_role``, and maps node/face/volume
dimensions plus the padding attribute to xgcm positions::

    padding low  -> right      padding high -> left
    padding both -> inner      padding none -> outer
"""

from __future__ import annotations

from collections import OrderedDict

from ..core.dataset import Dataset

PAD2POS = {
    "high": "left",
    "low": "right",
    "both": "inner",
    "none": "outer",
}


def assert_valid_sgrid(ds: Dataset) -> bool:
    conventions_attr = next(
        (x for x in ("Conventions", "conventions") if x in ds.attrs), False
    )
    if conventions_attr:
        if any(x in ds.attrs[conventions_attr] for x in ("SGRID", "sgrid", "Sgrid")):
            return True
    return False


def get_sgrid_grid(ds: Dataset) -> str:
    for var_name, var in ds.variables.items():
        if var.attrs.get("cf_role") == "grid_topology":
            return var_name
    raise ValueError("Could not find identify SGRID grid in input dataset.")


def get_all_axes(ds: Dataset):
    axes = set()
    grid_var = get_sgrid_grid(ds)
    ndims = ds[grid_var].attrs["topology_dimension"]
    if ndims == 1:
        axes.update(["X"])
    elif ndims == 2:
        axes.update(["X", "Y"])
        if "vertical_dimensions" in ds[grid_var].attrs:
            axes.update(["Z"])
    elif ndims == 3:
        axes.update(["X", "Y", "Z"])
    else:
        raise ValueError(
            f"SGRID expected dataset with 1-3 spatial dimensions but "
            f"got {ndims} in variable '{grid_var}'."
        )
    return axes


def get_axis_positions_and_coords(ds: Dataset, axis_name: str):
    grid_var = get_sgrid_grid(ds)
    topo_dim = ds[grid_var].attrs["topology_dimension"]

    axis_coords: "OrderedDict[str, str]" = OrderedDict()

    if axis_name == "X":
        i_select = 0
    elif axis_name == "Y":
        i_select = 1
    elif axis_name == "Z":
        i_select = 2
    else:
        raise ValueError(
            f"Axis name '{axis_name}' not recognised as one of the default "
            f"SGRID values 'X', 'Y', 'Z'."
        )

    attrs = ds[grid_var].attrs

    # 2D dataset with a vertical axis declared via `vertical_dimensions`
    if (axis_name == "Z") and ("vertical_dimensions" in attrs):
        vert = attrs["vertical_dimensions"].replace(":", " ").split()
        node_dim_name = vert[1]
        cell_dim_name = vert[0]
        cell_pad = vert[3].replace(")", "")
    else:
        if "node_dimensions" not in attrs:
            raise ValueError(
                f"'node_dimensions' attribute not found in grid variable "
                f"'{grid_var}''."
            )
        node_dims = attrs["node_dimensions"].split()
        try:
            node_dim_name = node_dims[i_select]
        except IndexError:
            raise IndexError(
                f"Not enough 'node_dimensions'. Expecting {i_select} got "
                f"{len(node_dims)}."
            )

        if topo_dim in (1, 2):
            cell_attr = "face_dimensions"
        elif topo_dim == 3:
            cell_attr = "volume_dimensions"
        else:
            raise ValueError(
                f"SGRID expected dataset with 1-3 spatial dimensions but "
                f"got {topo_dim} in variable '{grid_var}'."
            )

        cell_dim = attrs[cell_attr].replace(":", " ").split()
        matches = [i for i, tok in enumerate(cell_dim) if node_dim_name in tok]
        if len(matches) != 1:
            raise IndexError(
                f"Found {len(matches)} face_dimensions corresponding to "
                f"node_dimension '{node_dim_name}'. Expecting 1."
            )
        j = matches[0]
        cell_dim_name = cell_dim[j - 1]
        cell_pad = cell_dim[j + 2].replace(")", "")

    axis_coords["center"] = cell_dim_name
    try:
        axis_coords[PAD2POS[cell_pad]] = node_dim_name
    except KeyError:
        raise KeyError(f"Unexpected padding type '{cell_pad}' in SGRID data.")

    return axis_coords
