"""Model-grid-family constructors: synthetic grids with the right staggering
convention and, for the cubed sphere and LLC, face topology."""

from .families import (  # noqa: F401
    CUBED_SPHERE_CONNECTIONS,
    LLC_CONNECTIONS,
    cubed_sphere_grid,
    llc_grid,
    mom6_symmetric_grid,
)

__all__ = [
    "mom6_symmetric_grid",
    "cubed_sphere_grid",
    "llc_grid",
    "CUBED_SPHERE_CONNECTIONS",
    "LLC_CONNECTIONS",
]
