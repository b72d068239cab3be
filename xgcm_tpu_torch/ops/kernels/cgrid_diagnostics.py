"""Kernel B: periodic C-grid vorticity, divergence and kinetic energy in one
pass (``csrc/cgrid_diagnostics.cu``), and its plain PyTorch version.

A CPU tensor takes :func:`cgrid_diagnostics_plain`, the roll formulation of
``xgcm_tpu/ops/diagnostics.py``; a CUDA tensor launches the kernel or
raises.  Gradients run through the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...utils.profiling import span
from . import build

__all__ = ["cgrid_diagnostics", "cgrid_diagnostics_plain", "DIAGNOSTICS_DTYPES"]

DIAGNOSTICS_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def cgrid_diagnostics_plain(
    u: torch.Tensor, v: torch.Tensor, inv_dx: torch.Tensor, inv_dy: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(zeta, div, ke) of u on (yc, xg) and v on (yg, xc), both (ny, nx),
    wrapping periodically in both directions."""
    ix = inv_dx[None, :]
    iy = inv_dy[:, None]
    zeta = (v - torch.roll(v, 1, 1)) * ix - (u - torch.roll(u, 1, 0)) * iy
    div = (torch.roll(u, -1, 1) - u) * ix + (torch.roll(v, -1, 0) - v) * iy
    u_c = 0.5 * (u + torch.roll(u, -1, 1))
    v_c = 0.5 * (v + torch.roll(v, -1, 0))
    ke = 0.5 * (u_c * u_c + v_c * v_c)
    return zeta, div, ke


@span("xtt.kernels.cgrid_diagnostics")
def cgrid_diagnostics(
    u: torch.Tensor, v: torch.Tensor, inv_dx: torch.Tensor, inv_dy: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(zeta, div, ke) on a doubly periodic C-grid: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors (float32, bfloat16 or
    float64, ny and nx at least 2; bfloat16 computes in float32 and rounds
    once at the store)."""
    if u.device.type == "cpu":
        return cgrid_diagnostics_plain(u, v, inv_dx, inv_dy)

    build.require_cuda(u, v, inv_dx, inv_dy)
    if u.dtype not in DIAGNOSTICS_DTYPES or v.dtype != u.dtype:
        raise TypeError(
            f"diagnostics kernel takes u, v of one dtype in {DIAGNOSTICS_DTYPES}, "
            f"got {u.dtype}, {v.dtype}"
        )
    if u.ndim != 2 or u.shape != v.shape:
        raise ValueError(f"u and v must be (ny, nx) of one shape, got {u.shape}, {v.shape}")
    ny, nx = u.shape
    if ny < 2 or nx < 2 or ny > 8 * 65535:
        raise ValueError(f"diagnostics kernel needs 2 <= ny <= 524280 and nx >= 2, got {u.shape}")
    if inv_dx.shape != (nx,) or inv_dy.shape != (ny,):
        raise ValueError("inv_dx must be (nx,) and inv_dy (ny,)")
    if not (u.is_contiguous() and v.is_contiguous()):
        raise ValueError("diagnostics kernel needs contiguous u and v")

    def launch(u, v, inv_dx, inv_dy):
        compute = torch.float64 if u.dtype == torch.float64 else torch.float32
        ix = inv_dx.to(compute).contiguous()
        iy = inv_dy.to(compute).contiguous()
        zeta = torch.empty_like(u)
        div = torch.empty_like(u)
        ke = torch.empty_like(u)
        build.launch(
            "xt_cgrid_diagnostics", u.device,
            u.data_ptr(), v.data_ptr(), ix.data_ptr(), iy.data_ptr(),
            zeta.data_ptr(), div.data_ptr(), ke.data_ptr(),
            build.DTYPE_CODES[u.dtype], ny, nx,
        )
        build.LAUNCHES["cgrid_diagnostics"] += 1
        return zeta, div, ke

    return build.autograd_launch(launch, cgrid_diagnostics_plain, u, v, inv_dx, inv_dy)
