"""High-level fused C-grid diagnostics.

``cgrid_diagnostics`` computes relative vorticity, divergence and kinetic
energy of a C-grid velocity pair in one call: through the single-pass CUDA
kernel (``csrc/cgrid_diagnostics.cu``) when both axes are periodic and the
inputs qualify, otherwise through the roll formulation, exactly as
:func:`xgcm_tpu.ops.diagnostics.cgrid_diagnostics` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.dataarray import GriddedArray, as_tensor
from ..core.grid import Grid
from .kernels import cgrid_diagnostics as kb

__all__ = ["cgrid_diagnostics"]


def cgrid_diagnostics(
    grid: Grid,
    u: GriddedArray,
    v: GriddedArray,
    x_axis: str = "X",
    y_axis: str = "Y",
    inv_dx: Optional[GriddedArray] = None,
    inv_dy: Optional[GriddedArray] = None,
) -> Tuple[GriddedArray, GriddedArray, GriddedArray]:
    """(zeta, div, ke) for C-grid velocities u on (yc, xg), v on (yg, xc).

    ``inv_dx``/``inv_dy`` are optional 1D inverse grid spacings (default 1,
    i.e. index-space derivatives).  The result wraps periodically in both
    directions, whatever the axes' boundaries: like the JAX package, the
    non-periodic branch is the same roll formulation.
    """
    xax, yax = grid.axes[x_axis], grid.axes[y_axis]
    _, u_xdim = xax._get_position_name(u)
    _, u_ydim = yax._get_position_name(u)
    _, v_xdim = xax._get_position_name(v)
    _, v_ydim = yax._get_position_name(v)

    corner_dims = (v_ydim, u_xdim)  # (yg, xg)
    center_dims = (u_ydim, v_xdim)  # (yc, xc)

    u2 = u.transpose(u_ydim, u_xdim).data
    v2 = as_tensor(v.transpose(v_ydim, v_xdim).data).to(u2.device)
    ny, nx = u2.shape
    ix = (
        torch.ones(nx, dtype=u2.dtype, device=u2.device)
        if inv_dx is None else as_tensor(inv_dx.data).to(u2.device)
    )
    iy = (
        torch.ones(ny, dtype=u2.dtype, device=u2.device)
        if inv_dy is None else as_tensor(inv_dy.data).to(u2.device)
    )

    use_kernel = (
        xax.boundary == "periodic"
        and yax.boundary == "periodic"
        and u2.dtype in kb.DIAGNOSTICS_DTYPES
        and v2.dtype == u2.dtype
        and ny >= 2
        and nx >= 2
    )
    if use_kernel:
        zeta, div, ke = kb.cgrid_diagnostics(u2.contiguous(), v2.contiguous(), ix, iy)
    else:
        zeta, div, ke = kb.cgrid_diagnostics_plain(u2, v2, ix, iy)

    return (
        GriddedArray(zeta, corner_dims, name="vorticity"),
        GriddedArray(div, center_dims, name="divergence"),
        GriddedArray(ke, center_dims, name="kinetic_energy"),
    )
