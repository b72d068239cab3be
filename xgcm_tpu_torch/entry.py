"""The C-grid analysis step: the port's main path.

``step(u, v, theta, targets)`` is the computation of the flagship workload
of the JAX package (``__graft_entry__.entry``): C-grid vorticity,
divergence and kinetic energy through the Grid API, then the kinetic energy
remapped onto theta surfaces per column.  On CUDA tensors it runs the shift
kernel (four diffs and two interps) and the linear-interpolation kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .core.dataarray import GriddedArray
from .core.dataset import Dataset
from .core.grid import Grid
from .ops.transform import interp_1d_linear

__all__ = ["build_grid", "step"]


def build_grid(nx: int, ny: int) -> Grid:
    """A doubly periodic C-grid with centers xc, yc and left faces xg, yg."""
    ds = Dataset(
        coords={
            "xc": ("xc", np.arange(nx, dtype=np.float32)),
            "xg": ("xg", np.arange(nx, dtype=np.float32)),
            "yc": ("yc", np.arange(ny, dtype=np.float32)),
            "yg": ("yg", np.arange(ny, dtype=np.float32)),
        }
    )
    return Grid(
        ds,
        coords={
            "X": {"center": "xc", "left": "xg"},
            "Y": {"center": "yc", "left": "yg"},
        },
        autoparse_metadata=False,
    )


def step(
    u: torch.Tensor,
    v: torch.Tensor,
    theta: torch.Tensor,
    targets: torch.Tensor,
    grid: Optional[Grid] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(zeta, div, ke_on_theta) for u on (yc, xg), v on (yg, xc), both
    (ny, nx), and theta (ny, nx, nz) with a monotone column per point;
    ``targets`` (m,) are the theta levels.  ``grid`` defaults to
    :func:`build_grid` of u's shape."""
    ny, nx = u.shape
    nz = theta.shape[-1]
    if grid is None:
        grid = build_grid(nx, ny)
    uu = GriddedArray(u, ("yc", "xg"))
    vv = GriddedArray(v, ("yg", "xc"))
    zeta = grid.diff(vv, "X") - grid.diff(uu, "Y")  # corners
    div = grid.diff(uu, "X", to="center") + grid.diff(vv, "Y", to="center")
    u_c = grid.interp(uu, "X", to="center")
    v_c = grid.interp(vv, "Y", to="center")
    ke = 0.5 * (u_c * u_c + v_c * v_c)
    # vertical transform of KE onto theta surfaces (per column)
    ke_cols = ke.data[..., None].expand(ny, nx, nz)
    ke_on_theta = interp_1d_linear(ke_cols, theta, targets, mask_edges=False)
    return zeta.data, div.data, ke_on_theta
