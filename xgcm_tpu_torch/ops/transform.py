"""Vertical coordinate transformation (depth -> density etc.), linear and log.

The counterpart of :mod:`xgcm_tpu.ops.transform` for ``method="linear"`` and
``"log"``:

* on CUDA, float32/bfloat16 columns with at least two knots go through the
  linear-interpolation kernel (``csrc/interp_linear.cu``), which does the
  monotonicity flip, NaN handling, interval selection and np.interp edge
  clamps in one pass;
* everything else (the CPU, float64) takes the generic membership path, the
  same formulation the JAX package runs on the CPU and in x64.

``method="conservative"`` is not ported yet (ROADMAP Queue 1, item 9).
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np
import torch

from ..core.dataarray import GriddedArray, as_tensor
from .kernels import interp_linear as kc

__all__ = ["interp_1d_linear", "linear_interpolation", "transform"]

# largest (cols * m * n) membership tensor the dense linear formulation may
# materialise; deeper columns loop over knots instead
_DENSE_MEMB_BUDGET = 2**27


def _on(x, device) -> torch.Tensor:
    return as_tensor(x).to(device)


def _first_last_valid(valid: torch.Tensor):
    """Index of the first and the last True along the last axis (0 and
    n - 1 where a row has none, like ``jnp.argmax`` on an all-False row)."""
    n = valid.shape[-1]
    first = valid.to(torch.uint8).argmax(-1)
    last = n - 1 - valid.flip(-1).to(torch.uint8).argmax(-1)
    return first, last


def _pick(x: torch.Tensor, idx: torch.Tensor, keepdim: bool = False):
    """x[..., idx] as a one-term select-and-sum (values elsewhere, NaN
    included, are replaced by zero, never multiplied)."""
    iota = torch.arange(x.shape[-1], device=x.device)
    return torch.where(iota == idx[..., None], x, 0.0).sum(-1, keepdim=keepdim)


def _column_flip(phi, theta):
    """Flip columns whose theta decreases (first vs last non-NaN value)."""
    valid = ~torch.isnan(theta)
    first_idx, last_idx = _first_last_valid(valid)
    theta_sane = torch.nan_to_num(theta)
    first_val = _pick(theta_sane, first_idx)
    last_val = _pick(theta_sane, last_idx)
    flip = (last_val < first_val)[..., None]
    theta = torch.where(flip, theta.flip(-1), theta)
    phi = torch.where(flip, phi.flip(-1), phi)
    return phi, theta


def _nan_extreme(x: torch.Tensor, largest: bool) -> torch.Tensor:
    """``jnp.nanmax``/``nanmin`` along the last axis, keepdims (NaN for an
    all-NaN row)."""
    nan = torch.isnan(x)
    fill = -torch.inf if largest else torch.inf
    filled = torch.where(nan, fill, x)
    ext = filled.amax(-1, keepdim=True) if largest else filled.amin(-1, keepdim=True)
    return torch.where((~nan).any(-1, keepdim=True), ext, torch.nan)


def _kernel_serves(phi, theta, target) -> bool:
    """The CUDA kernel takes float32/bfloat16 columns of >= 2 knots; the
    TPU kernel's VMEM caps do not apply on the card."""
    return (
        phi.device.type == "cuda"
        and all(a.dtype in kc.INTERP_DTYPES for a in (phi, theta, target))
        and phi.shape[-1] >= 2
    )


def interp_1d_linear(
    phi,
    theta,
    target_theta_levels,
    mask_edges: bool = False,
    bypass_checks: bool = False,
    logarithmic: bool = False,
):
    """Vectorized interpolation of phi onto isosurfaces of theta along the
    last axis.  phi, theta : (..., n); target_theta_levels : (m,) or
    (..., m).  Returns (..., m), on phi's device."""
    phi = as_tensor(phi)
    theta = _on(theta, phi.device)
    target = _on(target_theta_levels, phi.device)

    if logarithmic:
        theta = torch.log(theta)
        target = torch.log(target)

    lead = torch.broadcast_shapes(phi.shape[:-1], theta.shape[:-1], target.shape[:-1])
    n = phi.shape[-1]
    m = target.shape[-1]
    if _kernel_serves(phi, theta, target):
        cols = math.prod(lead)
        ph2 = phi.expand(lead + (n,)).reshape(cols, n)
        th2 = theta.expand(lead + (n,)).reshape(cols, n)
        if all(s == 1 for s in target.shape[:-1]):
            tg2 = target.reshape(-1)
        else:
            tg2 = target.expand(lead + (m,)).reshape(cols, m)
        out = kc.interp_linear(th2, ph2, tg2, mask_edges, not bypass_checks)
        return out.reshape(lead + (m,))

    if not bypass_checks:
        phi, theta = _column_flip(phi, theta)

    lead = torch.broadcast_shapes(phi.shape[:-1], theta.shape[:-1], target.shape[:-1])
    phi_b = phi.expand(lead + (n,))
    theta_b = theta.expand(lead + (n,))
    target_b = target.expand(lead + (m,))

    # Exact interval-membership interpolation: each target matches exactly
    # ONE half-open interval [theta_k, theta_{k+1}) with theta_{k+1} > t
    # (duplicate knots match only the last; NaN knots sanitise to +inf so
    # the trailing interval has zero slope and the edge clamps below
    # overwrite it).  phi is selected raw through where(): NaN data at a
    # valid knot propagates into the targets bracketing it.
    t = target_b
    theta_s = torch.where(torch.isnan(theta_b), torch.inf, theta_b)

    if math.prod(lead) * n * m <= _DENSE_MEMB_BUDGET:
        th_next = kc._shifted(theta_s, torch.inf)
        ph_next = kc._shifted(phi_b, 0.0)
        t_ = t[..., :, None]
        memb = (theta_s[..., None, :] <= t_) & (th_next[..., None, :] > t_)

        def _sel(x):
            return torch.where(memb, x[..., None, :], 0.0).sum(-1)

        th_lo, th_hi = _sel(theta_s), _sel(th_next)
        ph_lo, ph_hi = _sel(phi_b), _sel(ph_next)
    else:
        # deep columns: the same one-hot selection one knot at a time, so
        # peak memory is O(cols * m) instead of the (cols, m, n) tensor
        th_next = kc._shifted(theta_s, torch.inf)
        ph_next = kc._shifted(phi_b, 0.0)
        th_lo = th_hi = ph_lo = ph_hi = torch.zeros(t.shape, dtype=t.dtype, device=t.device)
        for k in range(n):
            c = (theta_s[..., k, None] <= t) & (th_next[..., k, None] > t)
            th_lo = th_lo + torch.where(c, theta_s[..., k, None], 0.0)
            th_hi = th_hi + torch.where(c, th_next[..., k, None], 0.0)
            ph_lo = ph_lo + torch.where(c, phi_b[..., k, None], 0.0)
            ph_hi = ph_hi + torch.where(c, ph_next[..., k, None], 0.0)
    w = (t - th_lo) / (th_hi - th_lo)
    w = torch.where(torch.isfinite(w), w, 0.0)
    out = (ph_lo + w * (ph_hi - ph_lo)).to(phi_b.dtype)

    # np.interp edge clamping: below the first valid knot -> its value, at
    # or above the last valid knot -> its value; all-NaN columns -> NaN.
    valid = ~torch.isnan(theta_b)
    first_idx, last_idx = _first_last_valid(valid)
    first_phi = _pick(phi_b, first_idx, keepdim=True)
    last_phi = _pick(phi_b, last_idx, keepdim=True)
    th_min = _nan_extreme(theta_b, largest=False)
    th_max = _nan_extreme(theta_b, largest=True)
    out = torch.where(target_b < th_min, first_phi, out)
    out = torch.where(target_b >= th_max, last_phi, out)
    out = torch.where(valid.any(-1, keepdim=True), out, torch.nan)
    # NaN targets -> NaN, like np.interp
    out = torch.where(torch.isnan(target_b), torch.nan, out)

    if mask_edges:
        out = torch.where((target_b < th_min) | (target_b > th_max), torch.nan, out)
    return out


# ---------------------------------------------------------------------------
# Mid level: named-dimension wrappers
# ---------------------------------------------------------------------------


def _broadcast_columns(grid, da: GriddedArray, theta: GriddedArray, dim, theta_dim):
    """Align phi and theta over their shared non-core dims; core dim last."""
    phi = da.move_dims_last([dim])
    th = theta.move_dims_last([theta_dim])
    lead = [d for d in phi.dims if d != dim]
    th_lead = [d for d in th.dims if d != theta_dim]
    shape = [th.sizes[d] if d in th_lead else 1 for d in lead]
    ordered = [d for d in lead if d in th_lead] + [theta_dim]
    theta_data = th.transpose(*ordered).data.reshape(shape + [th.sizes[theta_dim]])
    return phi, lead, theta_data


def _columns_first_2d(phi, theta, target, phi_dim, theta_dim):
    """True when phi/theta are 2-D with the TRANSFORM dim leading and the
    target is a shared 1-D vector."""
    return (
        len(phi.dims) == 2
        and phi.dims[0] == phi_dim
        and len(theta.dims) == 2
        and theta.dims[0] == theta_dim
        and phi.dims[1] == theta.dims[1]
        and len(target.dims) == 1
    )


def _fused_linear_T(phi_T, theta_T, target, mask_edges=False,
                    bypass_checks=False, logarithmic=False):
    """Transform-dim-first linear remap: (n, cols) columns, (m,) targets ->
    (m, cols) through the kernel, without a transpose (the kernel reads the
    (n, cols) layout through strides, coalesced).  ``None`` when the kernel
    does not serve the inputs, so callers take the generic layout."""
    phi_T = as_tensor(phi_T)
    theta_T = _on(theta_T, phi_T.device)
    target = _on(target, phi_T.device)
    if not _kernel_serves(phi_T.T, theta_T.T, target):
        return None
    if logarithmic:
        theta_T = torch.log(theta_T)
        target = torch.log(target)
    return kc.interp_linear(
        theta_T.T, phi_T.T, target, mask_edges, not bypass_checks, out_T=True
    )


def _require_gridded(name: str, obj) -> None:
    if not isinstance(obj, GriddedArray):
        raise ValueError(
            f"`{name}` needs to be a GriddedArray with named dims, "
            f"but is of type {type(obj)}. Use Grid.transform for raw "
            "numpy targets."
        )


def linear_interpolation(
    phi: GriddedArray,
    theta: GriddedArray,
    target: GriddedArray,
    phi_dim: str,
    theta_dim: str,
    target_dim: str,
    grid=None,
    suffix: str = "",
    **kwargs,
) -> GriddedArray:
    """Named-dim wrapper for linear/log remap.

    Lead dims of ``target`` that phi does not carry (a spatially varying
    vertical target coordinate) broadcast into the output after phi's own
    lead dims.  A 2-D input whose transform dim leads returns
    ``(target_dim, col)``; all other inputs return phi's lead dims followed
    by ``target_dim``."""
    for nm, obj in (("phi", phi), ("theta", theta), ("target", target)):
        _require_gridded(nm, obj)
    name = (phi.name + suffix) if phi.name else None
    columns_first = _columns_first_2d(phi, theta, target, phi_dim, theta_dim)
    if columns_first:
        out = _fused_linear_T(phi.data, theta.data, target.data, **kwargs)
        if out is not None:
            return GriddedArray(out, [target_dim, phi.dims[1]], name=name)
    phi_t, lead, theta_data = _broadcast_columns(grid, phi, theta, phi_dim, theta_dim)

    tgt = target.move_dims_last([target_dim])
    tgt_lead = [d for d in tgt.dims if d != target_dim]
    extra = [d for d in tgt_lead if d not in lead]
    full_lead = lead + extra

    # phi/theta: insert singleton axes for the target-only lead dims
    n = phi_t.data.shape[-1]
    pad1 = (1,) * len(extra)
    phi_data = phi_t.data.reshape(tuple(phi_t.data.shape[:-1]) + pad1 + (n,))
    theta_data = theta_data.reshape(tuple(theta_data.shape[:-1]) + pad1 + (n,))

    shape = [tgt.sizes[d] if d in tgt_lead else 1 for d in full_lead]
    ordered = [d for d in full_lead if d in tgt_lead] + [target_dim]
    tgt_data = tgt.transpose(*ordered).data.reshape(shape + [tgt.sizes[target_dim]])

    out = interp_1d_linear(phi_data, theta_data, tgt_data, **kwargs)
    res = GriddedArray(out, full_lead + [target_dim], name=name)
    if columns_first:
        # a columns-first 2-D input yields (target_dim, col) whichever path
        # served it
        res = res.transpose(target_dim, phi.dims[1])
    return res


# ---------------------------------------------------------------------------
# High level: Grid.transform implementation
# ---------------------------------------------------------------------------


def _handle_nameless_target_data(td):
    if td.name is None:
        warnings.warn(
            "Input `target_data` has no name, but we need a name for the "
            "transformed dimension. The name `TRANSFORMED_DIMENSION` will "
            "be used. To avoid this warning, rename `target_data` before "
            "calling `transform`."
        )
        return td.rename("TRANSFORMED_DIMENSION")
    return td


def _check_other_dims(axis, da, target_da):
    da_other = set(da.dims) - set(axis.coords.values())
    target_other = set(target_da.dims) - set(axis.coords.values())
    if not target_other.issubset(da_other):
        raise ValueError(
            f"Found additional dimensions [{target_other - da_other}]"
            "in `target_data` not found in `da`. This could mean that the "
            "target array is not on the same position along other axes. "
            "If the additional dimensions are associated with a staggered "
            "axis, use grid.interp() to move values to other grid "
            "position. If additional dimensions are not related to the "
            "grid (e.g. climate model ensemble members or similar), "
            "broadcast arrays before using transform."
        )


def _parse_transform_target(
    grid, axis, da, target, target_dim, target_data_dim, target_data
):
    if target_data is None:
        target_data = grid._ds.coords.get(target_data_dim) or grid._ds[target_data_dim]
    if target_dim is None:
        if isinstance(target, GriddedArray):
            if len(target.dims) == 1:
                target_dim = target.dims[0]
        else:
            target_data = _handle_nameless_target_data(target_data)
            target_dim = target_data.name
    if not isinstance(target, GriddedArray):
        target = GriddedArray(as_tensor(target), (target_dim,), name=target_dim)
    if target_dim is None:
        raise ValueError(
            "`target_dim` must be given explicitly for multi-dimensional "
            "targets."
        )
    _check_other_dims(axis, da, target_data)
    return target, target_dim, target_data


def transform(
    grid,
    axis_name: str,
    da: GriddedArray,
    target,
    target_data: Optional[GriddedArray] = None,
    target_dim: Optional[str] = None,
    method: str = "linear",
    mask_edges: bool = True,
    bypass_checks: bool = False,
    suffix: str = "_transformed",
) -> GriddedArray:
    """Convert an array of data to new 1D coordinates along `axis_name`.

    Methods: ``linear`` (target = new cell centres; monotonic target_data,
    auto-flipped) and ``log`` (linear in log space).
    """
    axis = grid.axes[axis_name]
    if axis.boundary == "periodic":
        raise ValueError(
            "`transform` can only be used on axes that are non-periodic. Pass "
            "`periodic=False` to `xgcm_tpu_torch.Grid`."
        )
    for var_name, variable, allowed in [
        ("da", da, (GriddedArray,)),
        ("target", target, (GriddedArray, np.ndarray, torch.Tensor)),
        ("target_data", target_data, (GriddedArray,)),
    ]:
        if not (isinstance(variable, allowed) or variable is None):
            raise ValueError(
                f"`{var_name}` needs to be a "
                f"{' or '.join(str(a) for a in allowed)}. "
                f"Found {type(variable)}"
            )
    if method == "conservative":
        raise NotImplementedError(
            "method='conservative' is not ported yet (ROADMAP Queue 1, item 9)"
        )
    if method not in ("linear", "log"):
        raise ValueError(f"Unknown transform method {method!r}")

    _, dim = axis._get_position_name(da)
    target, target_dim, target_data = _parse_transform_target(
        grid, axis, da, target, target_dim, dim, target_data
    )
    return linear_interpolation(
        da,
        target_data,
        target,
        dim,
        axis._get_position_name(target_data)[1],
        target_dim,
        grid=grid,
        suffix=suffix,
        mask_edges=mask_edges,
        bypass_checks=bypass_checks,
        logarithmic=(method == "log"),
    )
