"""Kernel D: periodic C-grid relative vorticity alone
(``csrc/vorticity.cu``), and its plain PyTorch version.

``vorticity`` is the port's ``xgcm_tpu.ops.pallas_stencils.fused_vorticity``.
As in the JAX package, no Grid method calls it: it is the single-pass
kernel of the vorticity benchmark configuration, beside the Grid API's two
shifts and kernel B's full diagnostic set.  A CPU tensor takes
:func:`vorticity_plain`, the roll formulation; a CUDA tensor launches the
kernel or raises.  Gradients run through the plain version.
"""

from __future__ import annotations

import torch

from ...utils.profiling import span
from . import build

__all__ = ["vorticity", "vorticity_plain", "VORTICITY_DTYPES"]

VORTICITY_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def vorticity_plain(
    u: torch.Tensor, v: torch.Tensor, inv_dx: torch.Tensor, inv_dy: torch.Tensor
) -> torch.Tensor:
    """zeta[j,i] = (v[j,i]-v[j,i-1])*inv_dx[i] - (u[j,i]-u[j-1,i])*inv_dy[j]
    of u on (yc, xg) and v on (yg, xc), both (ny, nx), wrapping
    periodically; 16-bit inputs compute in float32 and round once."""
    c = _compute_dtype(u.dtype)
    uc, vc = u.to(c), v.to(c)
    ix, iy = inv_dx.to(c)[None, :], inv_dy.to(c)[:, None]
    zeta = (vc - torch.roll(vc, 1, 1)) * ix - (uc - torch.roll(uc, 1, 0)) * iy
    return zeta.to(u.dtype)


@span("xtt.kernels.vorticity")
def vorticity(
    u: torch.Tensor, v: torch.Tensor, inv_dx: torch.Tensor, inv_dy: torch.Tensor
) -> torch.Tensor:
    """zeta on a doubly periodic C-grid: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (u, v of one dtype, float32, bfloat16
    or float64, (ny, nx) with ny and nx at least 2)."""
    if u.device.type == "cpu":
        return vorticity_plain(u, v, inv_dx, inv_dy)

    build.require_cuda(u, v, inv_dx, inv_dy)
    if u.dtype not in VORTICITY_DTYPES or v.dtype != u.dtype:
        raise TypeError(f"vorticity kernel takes u, v of one dtype in {VORTICITY_DTYPES}, "
                        f"got {u.dtype}, {v.dtype}")
    if u.ndim != 2 or u.shape != v.shape:
        raise ValueError(f"u and v must be (ny, nx) of one shape, got {u.shape}, {v.shape}")
    ny, nx = u.shape
    if ny < 2 or nx < 2 or ny > 8 * 65535:
        raise ValueError(f"vorticity kernel needs 2 <= ny <= 524280 and nx >= 2, got {u.shape}")
    if inv_dx.shape != (nx,) or inv_dy.shape != (ny,):
        raise ValueError("inv_dx must be (nx,) and inv_dy (ny,)")
    if not (u.is_contiguous() and v.is_contiguous()):
        raise ValueError("vorticity kernel needs contiguous u and v")

    def launch(u, v, inv_dx, inv_dy):
        c = _compute_dtype(u.dtype)
        ix, iy = inv_dx.to(c).contiguous(), inv_dy.to(c).contiguous()
        zeta = torch.empty_like(u)
        build.launch(
            "xt_vorticity", u.device,
            u.data_ptr(), v.data_ptr(), ix.data_ptr(), iy.data_ptr(), zeta.data_ptr(),
            build.DTYPE_CODES[u.dtype], ny, nx,
        )
        build.LAUNCHES["vorticity"] += 1
        return zeta

    return build.autograd_launch(launch, vorticity_plain, u, v, inv_dx, inv_dy)
