"""Kernel C: linear interpolation of raw columns onto target levels
(``csrc/interp_linear.cu``), and its plain PyTorch version.

Columns are 2-D (cols, n) views of theta and phi, any strides; targets are
shared (m,) or per-column (cols, m); the result is (cols, m).  A CPU tensor
takes :func:`_fused_ref_torch`, the port of
``xgcm_tpu.ops.pallas_transform._fused_ref_jnp``; a CUDA tensor launches the
kernel or raises.  :func:`interp_linear` is differentiable: its forward is
the kernel and its backward runs autograd through the plain version, as the
JAX package's custom VJP does.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build

__all__ = ["interp_linear", "interp_linear_launch", "_fused_ref_torch", "INTERP_DTYPES"]

INTERP_DTYPES = (torch.float32, torch.bfloat16)


def _shifted(x: torch.Tensor, fill: float) -> torch.Tensor:
    """x shifted left by one along the last axis, padded with `fill`."""
    pad = torch.full_like(x[..., :1], fill)
    return torch.cat([x[..., 1:], pad], dim=-1)


def _fused_ref_torch(theta, phi, target, mask_edges=False, check_flip=True):
    """Plain version: np.interp of raw (cols, n) columns onto (m,) shared or
    (cols, m) per-column targets by dense interval membership, with the
    direction flip by negation, NaN handling and edge clamps of the
    kernel.  Differentiable."""
    f32 = torch.promote_types(phi.dtype, torch.float32)
    th = theta.to(f32)
    ph_raw = phi.to(f32)
    ph_nan = torch.isnan(ph_raw)
    ph = torch.where(ph_nan, 0.0, ph_raw)
    t = target.to(f32)
    if t.ndim == 1:
        t = t[None, :]  # (1, m) shared; (cols, m) stays per-column
    n = th.shape[-1]
    valid = ~torch.isnan(th)
    iota = torch.arange(n, device=th.device)
    first_idx = valid.to(torch.uint8).argmax(-1)
    last_idx = n - 1 - valid.flip(-1).to(torch.uint8).argmax(-1)
    th0 = torch.nan_to_num(th)

    def _at(x, idx):
        return torch.where(iota == idx[..., None], x, 0.0).sum(-1, keepdim=True)

    first_th, first_ph = _at(th0, first_idx), _at(ph_raw, first_idx)
    last_th, last_ph = _at(th0, last_idx), _at(ph_raw, last_idx)
    if check_flip:
        desc = last_th < first_th
        dsign = torch.where(desc, -1.0, 1.0).to(f32)
    else:
        desc = torch.zeros_like(first_th, dtype=torch.bool)
        dsign = torch.ones_like(first_th)
    th_e = torch.where(valid, th * dsign, torch.inf)
    t_eff = t * dsign  # (cols, m)
    th_e_n = _shifted(th_e, torch.inf)
    ph_n = _shifted(ph, 0.0)
    dth = th_e_n - th_e
    ok = (dth > 0) & (dth < torch.inf)
    slope = torch.where(ok, (ph_n - ph) / torch.where(ok, dth, 1.0), 0.0)
    memb = (th_e[..., None, :] <= t_eff[..., :, None]) & ~(
        th_e_n[..., None, :] <= t_eff[..., :, None]
    )

    def sel(x):
        return torch.where(memb, x[..., None, :], 0.0).sum(-1)

    out = sel(ph) + (t_eff - sel(th_e)) * sel(slope)
    # NaN data at a valid theta knot propagates into bracketing targets
    nan_f = (ph_nan & valid).to(f32)
    npair = torch.maximum(_shifted(nan_f, 0.0), nan_f)
    out = torch.where(sel(npair) > 0, torch.nan, out)
    th_min = torch.where(valid, th, torch.inf).amin(-1, keepdim=True)
    th_max = torch.where(valid, th, -torch.inf).amax(-1, keepdim=True)
    lo_ph = torch.where(desc, last_ph, first_ph)
    hi_ph = torch.where(desc, first_ph, last_ph)
    out = torch.where(t < th_min, lo_ph, out)
    out = torch.where(t >= th_max, hi_ph, out)
    out = torch.where(valid.any(-1, keepdim=True), out, torch.nan)
    if mask_edges:
        out = torch.where((t < th_min) | (t > th_max), torch.nan, out)
    return out.to(phi.dtype)


def interp_linear_launch(
    theta: torch.Tensor,
    phi: torch.Tensor,
    target: torch.Tensor,
    mask_edges: bool = False,
    check_flip: bool = True,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: theta, phi (cols, n) of float32 or
    bfloat16 with any strides, target (m,) or (cols, m).  Writes ``out``
    ((cols, m), any strides, phi's dtype) when given, else a new
    contiguous tensor."""
    build.require_cuda(theta, phi, target)
    for name, a in (("theta", theta), ("phi", phi), ("target", target)):
        if a.dtype not in INTERP_DTYPES:
            raise TypeError(f"interp kernel takes {name} in {INTERP_DTYPES}, got {a.dtype}")
    if theta.ndim != 2 or theta.shape != phi.shape:
        raise ValueError(
            f"theta and phi must be (cols, n) of one shape, got {theta.shape}, {phi.shape}"
        )
    cols, n = theta.shape
    if n < 2:
        raise ValueError(f"interp kernel needs n >= 2 knots, got {n}")
    if target.ndim == 1:
        m = target.shape[0]
        t = target.float()
        t_cs, t_ms = 0, t.stride(0)
    elif target.ndim == 2 and target.shape[0] == cols:
        m = target.shape[1]
        t = target.float()
        t_cs, t_ms = t.stride()
    else:
        raise ValueError(f"target must be (m,) or ({cols}, m), got {tuple(target.shape)}")
    if out is None:
        out = torch.empty((cols, m), dtype=phi.dtype, device=phi.device)
    elif out.shape != (cols, m) or out.dtype != phi.dtype or out.device != phi.device:
        raise ValueError("out must be (cols, m) in phi's dtype on phi's device")
    lib = build.load_library()
    status = lib.xt_interp_linear(
        theta.data_ptr(), phi.data_ptr(), t.data_ptr(), out.data_ptr(),
        build.DTYPE_CODES[theta.dtype], build.DTYPE_CODES[phi.dtype],
        cols, n, m, *theta.stride(), *phi.stride(), t_cs, t_ms, *out.stride(),
        int(bool(mask_edges)), int(bool(check_flip)), build.stream_ptr(phi.device),
    )
    build.check_status("xt_interp_linear", status)
    build.LAUNCHES["interp_linear"] += 1
    return out


class _InterpLinear(torch.autograd.Function):
    """Forward: the kernel.  Backward: autograd through the plain version
    (the JAX package's custom-VJP rule, which has no backward kernel)."""

    @staticmethod
    def forward(ctx, theta, phi, target, mask_edges, check_flip, out_T):
        ctx.save_for_backward(theta, phi, target)
        ctx.flags = (mask_edges, check_flip, out_T)
        if out_T:
            cols, m = theta.shape[0], target.shape[-1]
            out = torch.empty((m, cols), dtype=phi.dtype, device=phi.device)
            interp_linear_launch(theta, phi, target, mask_edges, check_flip, out=out.T)
            return out
        return interp_linear_launch(theta, phi, target, mask_edges, check_flip)

    @staticmethod
    def backward(ctx, grad):
        theta, phi, target = ctx.saved_tensors
        mask_edges, check_flip, out_T = ctx.flags
        inputs = [x.detach().requires_grad_(need) for x, need in zip(
            (theta, phi, target), ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            ref = _fused_ref_torch(*inputs, mask_edges=mask_edges, check_flip=check_flip)
            if out_T:
                ref = ref.T
            wanted = [x for x in inputs if x.requires_grad]
            grads = iter(torch.autograd.grad(ref, wanted, grad, allow_unused=True))
        return (*(next(grads) if x.requires_grad else None for x in inputs), None, None, None)


def interp_linear(
    theta: torch.Tensor,
    phi: torch.Tensor,
    target: torch.Tensor,
    mask_edges: bool = False,
    check_flip: bool = True,
    out_T: bool = False,
) -> torch.Tensor:
    """np.interp of raw (cols, n) columns onto (m,) shared or (cols, m)
    targets; returns (cols, m), or (m, cols) with ``out_T``.  The plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if theta.device.type == "cpu":
        out = _fused_ref_torch(theta, phi, target, mask_edges, check_flip)
        return out.T if out_T else out
    return _InterpLinear.apply(theta, phi, target, mask_edges, check_flip, out_T)
