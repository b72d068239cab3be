"""Model-grid-family constructors: synthetic grids with the right staggering
convention, the metric set for the MITgcm and NEMO C-grids and, for the
cubed sphere and LLC, face topology."""

from .families import (  # noqa: F401
    CUBED_SPHERE_CONNECTIONS,
    LLC_CONNECTIONS,
    cubed_sphere_grid,
    llc_grid,
    mitgcm_c_grid,
    mom6_symmetric_grid,
    nemo_c_grid,
)

__all__ = [
    "mitgcm_c_grid",
    "nemo_c_grid",
    "mom6_symmetric_grid",
    "cubed_sphere_grid",
    "llc_grid",
    "CUBED_SPHERE_CONNECTIONS",
    "LLC_CONNECTIONS",
]
