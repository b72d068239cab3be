"""Kernels C and F: linear interpolation of raw columns onto target levels
(``csrc/interp_linear.cu``), for one variable (C) or for up to eight that
share theta and the targets (F), and their plain PyTorch version.

Columns are 2-D (cols, n) views of theta and phi, any strides; targets are
shared (m,) or per-column (cols, m); each result is (cols, m).  A CPU tensor
takes :func:`_fused_multi_ref_torch`, the port of
``xgcm_tpu.ops.pallas_transform._fused_ref_jnp`` with the theta-only part
computed once for all variables; a CUDA tensor launches the kernel or
raises.  :func:`interp_linear` and :func:`interp_linear_multi` are
differentiable: the forward is the kernel and the backward runs autograd
through the plain version, as the JAX package's custom VJPs do.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch

from ...utils.profiling import span
from . import build

__all__ = [
    "interp_linear",
    "interp_linear_launch",
    "interp_linear_multi",
    "interp_linear_multi_launch",
    "_fused_ref_torch",
    "_fused_multi_ref_torch",
    "INTERP_DTYPES",
]

INTERP_DTYPES = (torch.float32, torch.bfloat16)


def _shifted(x: torch.Tensor, fill: float) -> torch.Tensor:
    """x shifted left by one along the last axis, padded with `fill`."""
    pad = torch.full_like(x[..., :1], fill)
    return torch.cat([x[..., 1:], pad], dim=-1)


def _fused_ref_torch(theta, phi, target, mask_edges=False, check_flip=True):
    """Plain version of kernel C: np.interp of raw (cols, n) columns onto
    (m,) shared or (cols, m) per-column targets by dense interval
    membership, with the direction flip by negation, NaN handling and edge
    clamps of the kernel.  Differentiable."""
    return _fused_multi_ref_torch(theta, (phi,), target, mask_edges, check_flip)[0]


def _fused_multi_ref_torch(theta, phis, target, mask_edges=False, check_flip=True):
    """Plain version of kernel F: :func:`_fused_ref_torch` of each phi, the
    theta-only part (direction, membership, interval knots) computed once
    and shared, as the kernel shares it.  Returns a tuple."""
    f32 = functools.reduce(torch.promote_types, (p.dtype for p in phis), torch.float32)
    th = theta.to(f32)
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

    first_th, last_th = _at(th0, first_idx), _at(th0, last_idx)
    if check_flip:
        desc = last_th < first_th
        dsign = torch.where(desc, -1.0, 1.0).to(f32)
    else:
        desc = torch.zeros_like(first_th, dtype=torch.bool)
        dsign = torch.ones_like(first_th)
    th_e = torch.where(valid, th * dsign, torch.inf)
    t_eff = t * dsign  # (cols, m)
    th_e_n = _shifted(th_e, torch.inf)
    dth = th_e_n - th_e
    ok = (dth > 0) & (dth < torch.inf)
    memb = (th_e[..., None, :] <= t_eff[..., :, None]) & ~(
        th_e_n[..., None, :] <= t_eff[..., :, None]
    )

    def sel(x):
        return torch.where(memb, x[..., None, :], 0.0).sum(-1)

    sel_th = sel(th_e)
    th_min = torch.where(valid, th, torch.inf).amin(-1, keepdim=True)
    th_max = torch.where(valid, th, -torch.inf).amax(-1, keepdim=True)
    outs = []
    for phi in phis:
        ph_raw = phi.to(f32)
        ph_nan = torch.isnan(ph_raw)
        ph = torch.where(ph_nan, 0.0, ph_raw)
        first_ph, last_ph = _at(ph_raw, first_idx), _at(ph_raw, last_idx)
        ph_n = _shifted(ph, 0.0)
        slope = torch.where(ok, (ph_n - ph) / torch.where(ok, dth, 1.0), 0.0)
        out = sel(ph) + (t_eff - sel_th) * sel(slope)
        # NaN data at a valid theta knot propagates into bracketing targets
        nan_f = (ph_nan & valid).to(f32)
        npair = torch.maximum(_shifted(nan_f, 0.0), nan_f)
        out = torch.where(sel(npair) > 0, torch.nan, out)
        lo_ph = torch.where(desc, last_ph, first_ph)
        hi_ph = torch.where(desc, first_ph, last_ph)
        out = torch.where(t < th_min, lo_ph, out)
        out = torch.where(t >= th_max, hi_ph, out)
        out = torch.where(valid.any(-1, keepdim=True), out, torch.nan)
        if mask_edges:
            out = torch.where((t < th_min) | (t > th_max), torch.nan, out)
        outs.append(out.to(phi.dtype))
    return tuple(outs)


def _check_columns(theta, phis, target):
    """(cols, n, m, target as float32, target strides) after checking the
    shapes and dtypes the kernels take."""
    for name, a in (("theta", theta), ("target", target), *(("phi", p) for p in phis)):
        if a.dtype not in INTERP_DTYPES:
            raise TypeError(f"interp kernel takes {name} in {INTERP_DTYPES}, got {a.dtype}")
    if len({p.dtype for p in phis}) != 1:
        raise TypeError("interp kernel takes phis of one dtype")
    if theta.ndim != 2 or any(p.shape != theta.shape for p in phis):
        raise ValueError(
            f"theta and phi must be (cols, n) of one shape, got {theta.shape}, "
            f"{[tuple(p.shape) for p in phis]}"
        )
    cols, n = theta.shape
    if n < 2:
        raise ValueError(f"interp kernel needs n >= 2 knots, got {n}")
    t = target.float()
    if target.ndim == 1:
        return cols, n, target.shape[0], t, (0, t.stride(0))
    if target.ndim == 2 and target.shape[0] == cols:
        return cols, n, target.shape[1], t, t.stride()
    raise ValueError(f"target must be (m,) or ({cols}, m), got {tuple(target.shape)}")


def interp_linear_launch(
    theta: torch.Tensor,
    phi: torch.Tensor,
    target: torch.Tensor,
    mask_edges: bool = False,
    check_flip: bool = True,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch kernel C on CUDA tensors: theta, phi (cols, n) of float32 or
    bfloat16 with any strides, target (m,) or (cols, m).  Writes ``out``
    ((cols, m), any strides, phi's dtype) when given, else a new
    contiguous tensor."""
    build.require_cuda(theta, phi, target)
    cols, n, m, t, (t_cs, t_ms) = _check_columns(theta, (phi,), target)
    (out,) = build.outputs(None if out is None else [out], 1, (cols, m), phi.dtype,
                           phi.device)
    build.launch(
        "xt_interp_linear", phi.device,
        theta.data_ptr(), phi.data_ptr(), t.data_ptr(), out.data_ptr(),
        build.DTYPE_CODES[theta.dtype], build.DTYPE_CODES[phi.dtype],
        cols, n, m, *theta.stride(), *phi.stride(), t_cs, t_ms, *out.stride(),
        int(bool(mask_edges)), int(bool(check_flip)),
    )
    build.LAUNCHES["interp_linear"] += 1
    return out


def interp_linear_multi_launch(
    theta: torch.Tensor,
    phis: Sequence[torch.Tensor],
    target: torch.Tensor,
    mask_edges: bool = False,
    check_flip: bool = True,
    outs: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """Launch kernel F on CUDA tensors: theta and 2 to 8 phis (cols, n), the
    phis of one dtype, any strides each; target (m,) or (cols, m).  Writes
    ``outs`` ((cols, m) each, one layout) when given, else new contiguous
    tensors."""
    if not 2 <= len(phis) <= build.MAX_VARS:
        raise ValueError(f"kernel F takes 2 to {build.MAX_VARS} variables, got {len(phis)}")
    build.require_cuda(theta, target, *phis)
    cols, n, m, t, (t_cs, t_ms) = _check_columns(theta, phis, target)
    outs = build.outputs(outs, len(phis), (cols, m), phis[0].dtype, phis[0].device)
    ptrs, cs, ks, optrs = build.var_set(phis, outs)
    build.launch(
        "xt_interp_linear_multi", theta.device,
        theta.data_ptr(), ptrs, cs, ks, optrs, t.data_ptr(), len(phis),
        build.DTYPE_CODES[theta.dtype], build.DTYPE_CODES[phis[0].dtype],
        cols, n, m, *theta.stride(), t_cs, t_ms, *outs[0].stride(),
        int(bool(mask_edges)), int(bool(check_flip)),
    )
    build.LAUNCHES["interp_linear_multi"] += 1
    return outs


def _new_T(theta, target, like, count):
    """``count`` (m, cols) tensors in ``like``'s dtype, for kernels that
    write the lanes-major layout through a transposed view."""
    cols, m = theta.shape[0], target.shape[-1]
    return [torch.empty((m, cols), dtype=like.dtype, device=like.device) for _ in range(count)]


@span("xtt.kernels.interp_linear")
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
    version for CPU tensors, kernel C for CUDA tensors."""
    def plain(th, ph, tg):
        out = _fused_ref_torch(th, ph, tg, mask_edges, check_flip)
        return out.T if out_T else out

    if theta.device.type == "cpu":
        return plain(theta, phi, target)

    def launch(th, ph, tg):
        if not out_T:
            return interp_linear_launch(th, ph, tg, mask_edges, check_flip)
        (out,) = _new_T(th, tg, ph, 1)
        interp_linear_launch(th, ph, tg, mask_edges, check_flip, out=out.T)
        return out

    return build.autograd_launch(launch, plain, theta, phi, target)


@span("xtt.kernels.interp_linear_multi")
def interp_linear_multi(
    theta: torch.Tensor,
    phis: Sequence[torch.Tensor],
    target: torch.Tensor,
    mask_edges: bool = False,
    check_flip: bool = True,
    out_T: bool = False,
) -> List[torch.Tensor]:
    """:func:`interp_linear` of 2 to 8 phis that share theta and the
    targets, in one pass; returns a list of (cols, m), or (m, cols) with
    ``out_T``.  The plain version for CPU tensors, kernel F for CUDA
    tensors."""
    def plain(th, tg, *phs):
        outs = _fused_multi_ref_torch(th, phs, tg, mask_edges, check_flip)
        return tuple(o.T if out_T else o for o in outs)

    if theta.device.type == "cpu":
        return list(plain(theta, target, *phis))

    def launch(th, tg, *phs):
        if not out_T:
            return tuple(interp_linear_multi_launch(th, phs, tg, mask_edges, check_flip))
        outs = _new_T(th, tg, phs[0], len(phs))
        interp_linear_multi_launch(th, phs, tg, mask_edges, check_flip,
                                   outs=[o.T for o in outs])
        return tuple(outs)

    return list(build.autograd_launch(launch, plain, theta, target, *phis))
