"""Grid constructors for the major model families.

The port's counterparts of :mod:`xgcm_tpu.grids.families`:

* **MITgcm** (C-grid): velocity points sit at the *left* (western/southern)
  cell edges; dims XC/XG, YC/YG; X periodic for global runs.
* **NEMO** (C-grid): velocity points sit at the *right* (eastern/northern)
  edges (NEMO's U/V points are at i+1/2); vertical W on the left (above T).
* **MOM6 symmetric mode**: corner/edge arrays carry one extra point —
  ``outer`` positions relative to the tracer cells.
* **Cubed sphere**: six square faces with the standard connection table.
* **LLC** (MITgcm lat-lon-cap): thirteen faces, the topology of the
  LLC4320 simulation.
* **ECCO v4r4**: the LLC90 grid under the native dimension names of the
  ECCO version 4 release 4 files, with its vertical and time axes.

Each factory returns ``(ds, grid)``; the C-grid datasets carry spherical
metric coordinates, registered with the grid, so the metric-weighted ops
work out of the box.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np

from ..core.dataset import Dataset
from ..core.grid import Grid

__all__ = [
    "CUBED_SPHERE_CONNECTIONS",
    "LLC_CONNECTIONS",
    "cubed_sphere_grid",
    "ecco_llc_grid",
    "llc_grid",
    "mitgcm_c_grid",
    "mom6_symmetric_grid",
    "nemo_c_grid",
]

_R_EARTH = 6.371e6
_DEG = np.pi / 180.0


def _quiet_grid(*args, **kwargs) -> Grid:
    """Grid construction on the factory's own boundary choices: the
    constructor's forward-compatibility DeprecationWarnings are not the
    caller's to see."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return Grid(*args, **kwargs)


def _latlon(nx: int, ny: int):
    dlon = 360.0 / nx
    dlat = 160.0 / ny
    lon_c = (np.arange(nx) + 0.5) * dlon
    lon_g = np.arange(nx) * dlon
    lat_c = -80.0 + (np.arange(ny) + 0.5) * dlat
    lat_g = -80.0 + np.arange(ny) * dlat
    return lon_c, lon_g, lat_c, lat_g, dlon, dlat


def mitgcm_c_grid(
    nx: int = 90, ny: int = 40, nz: int = 15
) -> Tuple[Dataset, Grid]:
    """Global MITgcm-style C-grid: left-staggered, X periodic, full metric
    set (dxC/dyC/rA/drF)."""
    lon_c, lon_g, lat_c, lat_g, dlon, dlat = _latlon(nx, ny)
    z_c = -(np.arange(nz) + 0.5) * 50.0
    z_f = -np.arange(nz + 1) * 50.0

    dx_c = (_R_EARTH * _DEG * dlon * np.cos(lat_c * _DEG)).astype(np.float64)
    dy_c = np.full(ny, _R_EARTH * _DEG * dlat)
    ra = dx_c[:, None] * dy_c[:, None] * np.ones((ny, nx))
    drf = np.full(nz, 50.0)

    ds = Dataset(
        coords={
            "XC": ("XC", lon_c, {"axis": "X"}),
            "XG": ("XG", lon_g, {"axis": "X", "c_grid_axis_shift": -0.5}),
            "YC": ("YC", lat_c, {"axis": "Y"}),
            "YG": ("YG", lat_g, {"axis": "Y", "c_grid_axis_shift": -0.5}),
            "Z": ("Z", z_c, {"axis": "Z"}),
            "Zl": ("Zl", z_f[:-1], {"axis": "Z", "c_grid_axis_shift": -0.5}),
            "Zp1": ("Zp1", z_f, {"axis": "Z", "c_grid_axis_shift": -0.5}),
            "dxC": (("YC",), dx_c),
            "dyC": (("YC",), dy_c),
            "rA": (("YC", "XC"), ra),
            "drF": (("Z",), drf),
        }
    )
    grid = _quiet_grid(
        ds,
        coords={
            "X": {"center": "XC", "left": "XG"},
            "Y": {"center": "YC", "left": "YG"},
            "Z": {"center": "Z", "left": "Zl", "outer": "Zp1"},
        },
        boundary={"X": "periodic", "Y": "extend", "Z": "extend"},
        metrics={
            ("X",): ["dxC"],
            ("Y",): ["dyC"],
            ("X", "Y"): ["rA"],
            ("Z",): ["drF"],
        },
        autoparse_metadata=False,
    )
    return ds, grid


def nemo_c_grid(nx: int = 90, ny: int = 40, nz: int = 15) -> Tuple[Dataset, Grid]:
    """NEMO-style C-grid: U/V at the right (i+1/2) edges, W above T."""
    lon_c, _, lat_c, _, dlon, dlat = _latlon(nx, ny)
    lon_u = lon_c + dlon / 2
    lat_v = lat_c + dlat / 2
    z_c = (np.arange(nz) + 0.5) * 50.0
    z_w = np.arange(nz) * 50.0

    e1t = (_R_EARTH * _DEG * dlon * np.cos(lat_c * _DEG)).astype(np.float64)
    e2t = np.full(ny, _R_EARTH * _DEG * dlat)
    e3t = np.full(nz, 50.0)

    ds = Dataset(
        coords={
            "x_c": ("x_c", lon_c, {"axis": "X"}),
            "x_r": ("x_r", lon_u, {"axis": "X", "c_grid_axis_shift": 0.5}),
            "y_c": ("y_c", lat_c, {"axis": "Y"}),
            "y_r": ("y_r", lat_v, {"axis": "Y", "c_grid_axis_shift": 0.5}),
            "z_c": ("z_c", z_c, {"axis": "Z"}),
            "z_l": ("z_l", z_w, {"axis": "Z", "c_grid_axis_shift": -0.5}),
            "e1t": (("y_c",), e1t),  # zonal spacing varies with latitude
            "e2t": (("y_c",), e2t),
            "e3t": (("z_c",), e3t),
        }
    )
    grid = _quiet_grid(
        ds,
        coords={
            "X": {"center": "x_c", "right": "x_r"},
            "Y": {"center": "y_c", "right": "y_r"},
            "Z": {"center": "z_c", "left": "z_l"},
        },
        boundary={"X": "periodic", "Y": "extend", "Z": "extend"},
        metrics={("X",): ["e1t"], ("Y",): ["e2t"], ("Z",): ["e3t"]},
        autoparse_metadata=False,
    )
    return ds, grid


def mom6_symmetric_grid(nx: int = 90, ny: int = 40) -> Tuple[Dataset, Grid]:
    """MOM6 symmetric-mode grid: corner (q) points are ``outer`` — one more
    point than the tracer cells along each axis."""
    lon_c, _, lat_c, _, dlon, dlat = _latlon(nx, ny)
    lon_q = np.concatenate([[lon_c[0] - dlon], lon_c]) + dlon / 2
    lat_q = np.concatenate([[lat_c[0] - dlat], lat_c]) + dlat / 2

    ds = Dataset(
        coords={
            "xh": ("xh", lon_c, {"axis": "X"}),
            "xq": ("xq", lon_q, {"axis": "X", "c_grid_axis_shift": -0.5}),
            "yh": ("yh", lat_c, {"axis": "Y"}),
            "yq": ("yq", lat_q, {"axis": "Y", "c_grid_axis_shift": -0.5}),
        }
    )
    grid = _quiet_grid(
        ds,
        coords={
            "X": {"center": "xh", "outer": "xq"},
            "Y": {"center": "yh", "outer": "yq"},
        },
        boundary="extend",
        autoparse_metadata=False,
    )
    return ds, grid


CUBED_SPHERE_CONNECTIONS = {
    "face": {
        0: {
            "X": ((3, "X", False), (1, "X", False)),
            "Y": ((4, "Y", False), (5, "Y", False)),
        },
        1: {
            "X": ((0, "X", False), (2, "X", False)),
            "Y": ((4, "X", False), (5, "X", True)),
        },
        2: {
            "X": ((1, "X", False), (3, "X", False)),
            "Y": ((4, "Y", True), (5, "Y", True)),
        },
        3: {
            "X": ((2, "X", False), (0, "X", False)),
            "Y": ((4, "X", True), (5, "X", False)),
        },
        4: {
            "X": ((3, "Y", True), (1, "Y", False)),
            "Y": ((2, "Y", True), (0, "Y", False)),
        },
        5: {
            "X": ((3, "Y", False), (1, "Y", True)),
            "Y": ((0, "Y", False), (2, "Y", True)),
        },
    }
}


def cubed_sphere_grid(n: int = 48) -> Tuple[Dataset, Grid]:
    """Six-face cubed sphere with the standard face-connection table."""
    ds = Dataset(
        coords={
            "x": ("x", np.arange(n) + 0.5, {"axis": "X"}),
            "xl": ("xl", np.arange(n) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
            "y": ("y", np.arange(n) + 0.5, {"axis": "Y"}),
            "yl": ("yl", np.arange(n) * 1.0, {"axis": "Y", "c_grid_axis_shift": -0.5}),
            "face": ("face", np.arange(6)),
        }
    )
    grid = _quiet_grid(
        ds,
        face_connections=CUBED_SPHERE_CONNECTIONS,
        periodic=False,
        autoparse_metadata=True,
    )
    return ds, grid


# The MITgcm LLC (lat-lon-cap) topology: faces 0-5 are the southern/
# equatorial lat-lon part, face 6 the Arctic cap, faces 7-12 the rotated
# half, in the published xmitgcm/ECCOv4 face-connection convention.
LLC_CONNECTIONS = {
    "face": {
        0: {"X": ((12, "Y", False), (3, "X", False)),
            "Y": (None, (1, "Y", False))},
        1: {"X": ((11, "Y", False), (4, "X", False)),
            "Y": ((0, "Y", False), (2, "Y", False))},
        2: {"X": ((10, "Y", False), (5, "X", False)),
            "Y": ((1, "Y", False), (6, "X", False))},
        3: {"X": ((0, "X", False), (9, "Y", False)),
            "Y": (None, (4, "Y", False))},
        4: {"X": ((1, "X", False), (8, "Y", False)),
            "Y": ((3, "Y", False), (5, "Y", False))},
        5: {"X": ((2, "X", False), (7, "Y", False)),
            "Y": ((4, "Y", False), (6, "Y", False))},
        6: {"X": ((2, "Y", False), (7, "X", False)),
            "Y": ((5, "Y", False), (10, "X", False))},
        7: {"X": ((6, "X", False), (8, "X", False)),
            "Y": ((5, "X", False), (10, "Y", False))},
        8: {"X": ((7, "X", False), (9, "X", False)),
            "Y": ((4, "X", False), (11, "Y", False))},
        9: {"X": ((8, "X", False), None),
            "Y": ((3, "X", False), (12, "Y", False))},
        10: {"X": ((6, "Y", False), (11, "X", False)),
             "Y": ((7, "Y", False), (2, "X", False))},
        11: {"X": ((10, "X", False), (12, "X", False)),
             "Y": ((8, "Y", False), (1, "X", False))},
        12: {"X": ((11, "X", False), None),
             "Y": ((9, "Y", False), (0, "X", False))},
    }
}


def llc_grid(n: int = 48) -> Tuple[Dataset, Grid]:
    """13-face MITgcm lat-lon-cap (LLC) grid, the topology of the LLC4320
    simulation; ``n`` cells per face side (4320 for LLC4320)."""
    ds = Dataset(
        coords={
            "x": ("x", np.arange(n) + 0.5, {"axis": "X"}),
            "xl": ("xl", np.arange(n) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
            "y": ("y", np.arange(n) + 0.5, {"axis": "Y"}),
            "yl": ("yl", np.arange(n) * 1.0, {"axis": "Y", "c_grid_axis_shift": -0.5}),
            "face": ("face", np.arange(13)),
        }
    )
    grid = _quiet_grid(
        ds,
        face_connections=LLC_CONNECTIONS,
        periodic=False,
        autoparse_metadata=True,
    )
    return ds, grid


def ecco_llc_grid(
    n: int = 90,
    nz: int = 50,
    nt: int = 12,
    rA=None,
    drF=None,
    hFacC=None,
    Depth=None,
) -> Tuple[Dataset, Grid]:
    """The LLC grid of ECCO version 4 release 4 under its native names.

    The ECCOv4-py tutorial "ECCO v4 heat budget closure"
    (https://ecco-v4-python-tutorial.readthedocs.io/ECCO_v4_Heat_budget_closure.html)
    runs its budget with xgcm on this grid.  The v4r4 native files lay a
    tracer out as ``(time, k, tile, j, i)``: 13 tiles of ``n`` x ``n``
    columns (90 for LLC90), ``nz`` levels (50) and ``nt`` monthly means
    between ``nt + 1`` snapshots.  The axes:

    * X: ``i`` (center), ``i_g`` (left); Y: ``j``, ``j_g``;
    * Z: ``k`` (center), ``k_l`` (left, the top face of each level),
      ``k_u`` (right, its bottom face), ``k_p1`` (outer, every face);
    * T: ``time`` (center, the monthly means), ``time_snp`` (outer, the
      snapshots between them);

    with the LLC face connections (:data:`LLC_CONNECTIONS`) on ``tile`` and
    no periodic axis.  The static fields given (``rA`` on (tile, j, i),
    ``drF`` on (k,), ``hFacC`` on (k, tile, j, i), ``Depth`` on (tile, j,
    i)) are attached as coordinates of the dataset, so that a user's own
    grid files travel with the grid.
    """
    coords = {
        "i": ("i", np.arange(n)), "i_g": ("i_g", np.arange(n)),
        "j": ("j", np.arange(n)), "j_g": ("j_g", np.arange(n)),
        "k": ("k", np.arange(nz)), "k_l": ("k_l", np.arange(nz)), "k_u": ("k_u", np.arange(nz)),
        "k_p1": ("k_p1", np.arange(nz + 1)),
        "time": ("time", np.arange(nt) + 0.5), "time_snp": ("time_snp", np.arange(nt + 1) * 1.0),
        "tile": ("tile", np.arange(13)),
    }
    for name, dims, value in (
        ("rA", ("tile", "j", "i"), rA), ("drF", ("k",), drF),
        ("hFacC", ("k", "tile", "j", "i"), hFacC), ("Depth", ("tile", "j", "i"), Depth),
    ):
        if value is not None:
            coords[name] = (dims, np.asarray(value))
    ds = Dataset(coords=coords)
    grid = _quiet_grid(
        ds,
        coords={
            "X": {"center": "i", "left": "i_g"},
            "Y": {"center": "j", "left": "j_g"},
            "Z": {"center": "k", "left": "k_l", "right": "k_u", "outer": "k_p1"},
            "T": {"center": "time", "outer": "time_snp"},
        },
        face_connections={"tile": LLC_CONNECTIONS["face"]},
        periodic=False,
        autoparse_metadata=False,
    )
    return ds, grid
