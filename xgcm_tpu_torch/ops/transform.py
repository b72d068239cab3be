"""Vertical coordinate transformation (depth -> density etc.): linear, log
and conservative.

The counterpart of :mod:`xgcm_tpu.ops.transform`:

* on CUDA, float32/bfloat16 columns go through the hand-written kernels:
  linear/log through kernel C (``csrc/interp_linear.cu``), which does the
  monotonicity flip, NaN handling, interval selection and np.interp edge
  clamps in one pass, and conservative through kernel G
  (``csrc/conservative.cu``), the cumulative-mass rebin with the NaN-cell
  rules and the untouched-bin -> NaN mask;
* :func:`transform_multi` runs kernels F and H, the multi-variable forms of
  C and G, for 2 to 8 such arrays on the card;
* everything else (the CPU, float64) takes the generic formulations the JAX
  package runs on the CPU and in x64.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np
import torch

from ..core.dataarray import GriddedArray, as_tensor
from ..core.device import get_default_device
from ..utils.profiling import span
from .kernels import build
from .kernels import conservative as kg
from .kernels import interp_linear as kc

__all__ = [
    "conservative_interpolation",
    "interp_1d_conservative",
    "interp_1d_linear",
    "linear_interpolation",
    "transform",
    "transform_multi",
]

# largest (cols * m * n) membership tensor the dense linear formulation may
# materialise; deeper columns loop over knots instead
_DENSE_MEMB_BUDGET = 2**27

# the device type whose tensors take the kernel routes; the CPU tests set it
# to "cpu" to drive those routes through the wrappers' plain versions
_KERNEL_DEVICE = "cuda"


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
        phi.device.type == _KERNEL_DEVICE
        and all(a.dtype in kc.INTERP_DTYPES for a in (phi, theta, target))
        and phi.shape[-1] >= 2
    )


@span("xtt.transform.interp_1d_linear")
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
    theta = as_tensor(theta, phi.device)
    target = as_tensor(target_theta_levels, phi.device)

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

    out_dtype = phi.dtype
    if not (phi.is_floating_point() or phi.is_complex()):
        # integer and bool data are selected in float64, as the JAX
        # package's where(memb, phi, 0.0) promotes them under x64: the lerp
        # rounds back to their dtype, and the edge clamps make it float64
        phi = phi.to(torch.float64)
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
    out = (ph_lo + w * (ph_hi - ph_lo)).to(out_dtype)

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
    theta_T = as_tensor(theta_T, phi_T.device)
    target = as_tensor(target, phi_T.device)
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


def _bin_edges(bins, device):
    """(increasing edges on ``device``, flip): bins must be 1-D and
    strictly monotonic, checked on the host; decreasing bins are reversed,
    and ``flip`` says the result must be reversed back."""
    if isinstance(bins, torch.Tensor):
        with span("xtt.transform.host_sync"):
            host = bins.detach().to("cpu", torch.float64).numpy()  # for the checks only
        edges = bins.to(device)
    else:
        host = np.asarray(bins)
        edges = None
    if host.ndim != 1:
        raise ValueError("target_theta_bins must be 1D")
    diff = np.diff(host)
    if np.all(diff < 0):
        flip = True
    elif np.all(diff > 0):
        flip = False
    else:
        raise ValueError("Target values are not monotonic")
    if edges is None:
        edges = torch.as_tensor(np.ascontiguousarray(host[::-1] if flip else host),
                                device=device)
    elif flip:
        edges = edges.flip(0)
    return edges, flip


def _conservative_serves(phi, theta, edges) -> bool:
    """Kernels G/H take float32/bfloat16 cells, bounds and bin edges on the
    card, at least one cell and one bin; float64 takes the generic path, as
    the JAX package routes it away from Pallas."""
    return (
        phi.device.type == _KERNEL_DEVICE
        and all(a.dtype in kg.CONSERVATIVE_DTYPES for a in (phi, theta, edges))
        and phi.shape[-1] >= 1
        and edges.shape[0] >= 2
    )


@span("xtt.transform.interp_1d_conservative")
def interp_1d_conservative(phi, theta, target_theta_bins, reassociate: bool = False):
    """Conservatively rebin extensive quantity phi into theta bins along the
    last axis.

    phi : (..., n); theta : (..., n+1) on cell bounds;
    target_theta_bins : (m,) monotonic bin edges (decreasing bins are
    flipped).  Returns (..., m-1), on phi's device, with the bins no valid
    cell overlaps NaN.

    ``reassociate=True`` telescopes the mass sums of kernel G on the card
    (results differ from the default by float summation order only); the
    generic path has one summation order and ignores it.
    """
    phi = as_tensor(phi)
    theta = as_tensor(theta, phi.device)
    if phi.shape[-1] != theta.shape[-1] - 1:
        raise ValueError(
            "theta must be given on cell bounds: expected "
            f"theta.shape[-1] == phi.shape[-1] + 1, got {theta.shape[-1]} "
            f"vs {phi.shape[-1]}"
        )
    edges, flip = _bin_edges(target_theta_bins, phi.device)
    n = phi.shape[-1]
    if _conservative_serves(phi, theta, edges):
        lead = torch.broadcast_shapes(phi.shape[:-1], theta.shape[:-1])
        cols = math.prod(lead)
        ph2 = phi.expand(lead + (n,)).reshape(cols, n)
        th2 = theta.expand(lead + (n + 1,)).reshape(cols, n + 1)
        out = kg.conservative_rebin(th2, ph2, edges, reassociate)
        out = out.reshape(lead + (edges.shape[0] - 1,))
    else:
        out, count = kg._conservative_rebin_torch(phi, theta[..., :-1], theta[..., 1:], edges)
        out = torch.where(count > 0, out, torch.nan)
    return out.flip(-1) if flip else out


def _fused_conservative_T(phi_T, theta_T, target_bins, reassociate=False):
    """Transform-dim-first conservative rebin: (n, cols) cells and
    (n+1, cols) raw bounds into shared increasing-or-decreasing bins ->
    (m-1, cols) through kernel G, without a transpose.  ``None`` when the
    kernel does not serve the inputs, so callers take the generic
    layout."""
    phi_T = as_tensor(phi_T)
    theta_T = as_tensor(theta_T, phi_T.device)
    n, cols = phi_T.shape
    if theta_T.shape != (n + 1, cols):
        return None
    edges, flip = _bin_edges(target_bins, phi_T.device)
    if not _conservative_serves(phi_T.T, theta_T.T, edges):
        return None
    out = kg.conservative_rebin(theta_T.T, phi_T.T, edges, reassociate, out_T=True)
    return out.flip(0) if flip else out


def conservative_interpolation(
    phi: GriddedArray,
    theta: GriddedArray,
    target: GriddedArray,
    phi_dim: str,
    theta_dim: str,
    target_dim: str,
    grid=None,
    suffix: str = "",
    reassociate: bool = False,
) -> GriddedArray:
    """Named-dim wrapper for the conservative remap.  The output has
    ``len(target) - 1`` cells along ``target_dim``.  A 2-D input whose
    transform dim leads returns ``(target_dim, col)``; all other inputs
    return phi's lead dims followed by ``target_dim``."""
    for nm, obj in (("phi", phi), ("theta", theta), ("target", target)):
        _require_gridded(nm, obj)
    name = (phi.name + suffix) if phi.name else None
    columns_first = _columns_first_2d(phi, theta, target, phi_dim, theta_dim)
    if columns_first:
        out = _fused_conservative_T(phi.data, theta.data, target.data, reassociate=reassociate)
        if out is not None:
            return GriddedArray(out, [target_dim, phi.dims[1]], name=name)
    phi_t, lead, theta_data = _broadcast_columns(grid, phi, theta, phi_dim, theta_dim)
    out = interp_1d_conservative(phi_t.data, theta_data, target.data, reassociate=reassociate)
    res = GriddedArray(out, lead + [target_dim], name=name)
    if columns_first:
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
    device = _device_of(da)
    if not isinstance(target, GriddedArray):
        target = GriddedArray(as_tensor(target, device), (target_dim,), name=target_dim)
    if target_dim is None:
        raise ValueError(
            "`target_dim` must be given explicitly for multi-dimensional "
            "targets."
        )
    _check_other_dims(axis, da, target_data)
    return _joined(target, device), target_dim, _joined(target_data, device)


def _device_of(da: GriddedArray) -> torch.device:
    """The device of da's tensor (the default device for host data)."""
    return da.data.device if isinstance(da.data, torch.Tensor) else get_default_device()


def _joined(arr: GriddedArray, device) -> GriddedArray:
    """``arr`` with host data (a coordinate variable) put on ``device``;
    tensors keep their device."""
    if isinstance(arr.data, torch.Tensor):
        return arr
    return GriddedArray(arr.data, arr.dims, name=arr.name, attrs=arr.attrs, device=device)


def _check_reassociate(method, reassociate):
    if reassociate and method != "conservative":
        raise ValueError(
            "`reassociate=True` only applies to method='conservative' "
            f"(got method={method!r}); the linear/log kernels are already "
            "at their exact-semantics ceiling."
        )


@span("xtt.transform.transform")
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
    reassociate: bool = False,
) -> GriddedArray:
    """Convert an array of data to new 1D coordinates along `axis_name`.

    Methods: ``linear`` (target = new cell centres; monotonic target_data,
    auto-flipped), ``log`` (linear in log space) and ``conservative``
    (target = cell bounds, integral-conserving; requires ``outer``
    coordinates on the axis).

    ``reassociate=True`` (conservative only) telescopes the mass sums of
    kernel G on the card: results differ from the default by float
    summation order only.
    """
    axis = grid.axes[axis_name]
    _check_reassociate(method, reassociate)
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

    _, dim = axis._get_position_name(da)
    if method in ("linear", "log"):
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
    if method != "conservative":
        raise ValueError(f"Unknown transform method {method!r}")
    if isinstance(target, GriddedArray) and len(target.dims) > 1:
        raise NotImplementedError(
            "Conservative transformation is not yet supported for "
            "multi-dimensional targets."
        )
    try:
        target_data_dim = axis.coords["outer"]
    except KeyError:
        raise RuntimeError(
            "In order to use the method `conservative` the grid object "
            "needs to have `outer` coordinates."
        ) from None
    target, target_dim, target_data = _parse_transform_target(
        grid, axis, da, target, target_dim, target_data_dim, target_data
    )
    if target_data_dim not in target_data.dims:
        warnings.warn(
            "The `target data` input is not located on the cell bounds. "
            "This method will continue with linear interpolation with "
            "repeated boundary values. For most accurate results provide "
            "values on cell bounds.",
            UserWarning,
        )
        # interp explicitly TO the outer position: on an axis with both
        # `left` and `outer` the default shift of a center would land on
        # `left` and leave the bounds mismatched
        target_data = grid.interp(target_data, axis_name, to="outer", boundary="extend")
    return conservative_interpolation(
        da,
        target_data,
        target,
        dim,
        target_data_dim,
        target_dim,
        grid=grid,
        suffix=suffix,
        reassociate=reassociate,
    )


@span("xtt.transform.transform_multi")
def transform_multi(
    grid,
    axis_name: str,
    das,
    target,
    target_data: Optional[GriddedArray] = None,
    target_dim: Optional[str] = None,
    method: str = "linear",
    mask_edges: bool = True,
    bypass_checks: bool = False,
    suffix: str = "_transformed",
    reassociate: bool = False,
):
    """Transform several arrays onto the same target coordinate at once:
    exactly ``[transform(grid, axis_name, da, target, ...) for da in das]``.

    The density-space analysis pattern (remap T, S, u, v, ... onto the same
    sigma surfaces): on the card, 2 to 8 float32/bfloat16 arrays of equal
    dims with a 1-D target go through one pass of kernel F (linear/log) or
    H (conservative, with ``target_data`` on the ``outer`` bounds), which
    computes the selection that depends only on ``target_data`` and
    ``target`` once and reads ``target_data`` once.  Everything else takes
    the per-array loop.  Returns a list of GriddedArrays in input order.
    """
    das = list(das)
    if not das:
        return []

    def _loop():
        return [
            transform(
                grid, axis_name, da, target,
                target_data=target_data, target_dim=target_dim,
                method=method, mask_edges=mask_edges,
                bypass_checks=bypass_checks, suffix=suffix,
                reassociate=reassociate,
            )
            for da in das
        ]

    _check_reassociate(method, reassociate)
    # V <= MAX_VARS: the multi kernels hold the variables' pointers in a
    # fixed array of that size (VarSet, csrc/common.cuh)
    if method not in ("linear", "log", "conservative") or not 2 <= len(das) <= build.MAX_VARS:
        return _loop()
    if not all(isinstance(da, GriddedArray) and isinstance(da.data, torch.Tensor)
               for da in das):
        return _loop()
    if any(da.dims != das[0].dims for da in das[1:]):
        return _loop()
    datas = [da.data for da in das]
    if (datas[0].device.type != _KERNEL_DEVICE or any(d.device != datas[0].device for d in datas)
            or len({d.dtype for d in datas}) != 1 or datas[0].dtype not in kc.INTERP_DTYPES):
        return _loop()  # the kernels serve one float32/bfloat16 dtype on one card
    axis = grid.axes[axis_name]
    if axis.boundary == "periodic":
        return _loop()  # the per-array path raises the parity error
    if method == "conservative":
        if isinstance(target, GriddedArray) and len(target.dims) > 1:
            return _loop()  # the per-array path raises NotImplementedError
        theta_dim = axis.coords.get("outer")
        if theta_dim is None:
            return _loop()  # the per-array path raises the parity RuntimeError
    else:
        theta_dim = axis._get_position_name(das[0])[1]
    try:
        tgt, tgt_dim, tdata = _parse_transform_target(
            grid, axis, das[0], target, target_dim, theta_dim, target_data
        )
    except (ValueError, KeyError, AttributeError):
        return _loop()  # the per-array path raises the documented errors
    if len(tgt.dims) != 1:
        return _loop()  # multi-dimensional targets take the per-array path
    _, dim = axis._get_position_name(das[0])
    if method == "conservative":
        if theta_dim not in tdata.dims:
            return _loop()  # the per-array path interpolates to the bounds
        outs = _multi_conservative(grid, das, tdata, tgt, dim, theta_dim, reassociate)
    else:
        outs = _multi_linear(grid, das, tdata, tgt, dim, axis._get_position_name(tdata)[1],
                             mask_edges, bypass_checks, method == "log")
    if outs is None:
        return _loop()
    data, out_dims = outs
    return [
        GriddedArray(o, dims, name=(da.name + suffix) if da.name else None)
        for da, o, dims in zip(das, data, out_dims)
    ]


def _multi_columns(grid, das, tdata, dim, theta_dim, extra_levels):
    """The columns kernels F/H read: theta (cols, n + extra_levels) and each
    phi (cols, n) as strided views, with the output layout.  Returns
    (theta, phis, out_T, lead_shape, out_lead_dims), or None when the
    arrays do not share their lead dims."""
    datas = [da.data for da in das]
    columns_first = len(tdata.dims) == 2 and tdata.dims[0] == theta_dim and all(
        len(da.dims) == 2 and da.dims[0] == dim and da.dims[1] == tdata.dims[1]
        for da in das
    )
    if columns_first:
        # (zc, col) inputs give (target_dim, col) outputs through strides
        return tdata.data.T, [d.T for d in datas], True, None, [[da.dims[1]] for da in das]
    phi_ts, lead, theta_arr = [], None, None
    for da in das:
        phi_t, lead_i, theta_i = _broadcast_columns(grid, da, tdata, dim, theta_dim)
        if lead is None:
            lead, theta_arr = lead_i, theta_i
        elif lead_i != lead:
            return None
        phi_ts.append(phi_t.data)
    n = phi_ts[0].shape[-1]
    if theta_arr.shape[-1] != n + extra_levels:
        return None  # the per-array path raises the shape error
    lead_shape = torch.broadcast_shapes(phi_ts[0].shape[:-1], theta_arr.shape[:-1])
    if any(torch.broadcast_shapes(p.shape[:-1], theta_arr.shape[:-1]) != lead_shape
           for p in phi_ts):
        return None
    cols = math.prod(lead_shape)
    theta = theta_arr.expand(lead_shape + (n + extra_levels,)).reshape(cols, n + extra_levels)
    phis = [p.expand(lead_shape + (n,)).reshape(cols, n) for p in phi_ts]
    return theta, phis, False, lead_shape, [lead for _ in das]


def _multi_linear(grid, das, tdata, tgt, dim, theta_dim, mask_edges, bypass_checks,
                  logarithmic):
    """Kernel F over the arrays: (outputs, their dims), or None when the
    kernel does not serve them."""
    cols_ = _multi_columns(grid, das, tdata, dim, theta_dim, 0)
    if cols_ is None:
        return None
    theta, phis, out_T, lead_shape, lead_dims = cols_
    t = tgt.data.reshape(-1)
    if not _kernel_serves(phis[0], theta, t):
        return None
    if logarithmic:
        theta, t = torch.log(theta), torch.log(t)
    outs = kc.interp_linear_multi(theta, phis, t, mask_edges, not bypass_checks, out_T=out_T)
    return _place(outs, out_T, lead_shape, lead_dims, tgt.dims[0])


def _multi_conservative(grid, das, tdata, tgt, dim, theta_dim, reassociate):
    """Kernel H over the arrays: (outputs, their dims), or None when the
    kernel does not serve them."""
    cols_ = _multi_columns(grid, das, tdata, dim, theta_dim, 1)
    if cols_ is None:
        return None
    theta, phis, out_T, lead_shape, lead_dims = cols_
    if theta.shape[-1] != phis[0].shape[-1] + 1:
        return None  # the per-array path raises the bounds ValueError (columns-first)
    edges, flip = _bin_edges(tgt.data, theta.device)
    if not _conservative_serves(phis[0], theta, edges):
        return None
    outs = kg.conservative_rebin_multi(theta, phis, edges, reassociate, out_T=out_T)
    if flip:
        outs = [o.flip(0 if out_T else -1) for o in outs]
    return _place(outs, out_T, lead_shape, lead_dims, tgt.dims[0])


def _place(outs, out_T, lead_shape, lead_dims, tgt_dim):
    """Kernel outputs with their dims: (target_dim, col) for columns-first
    inputs, else phi's lead dims followed by target_dim."""
    if out_T:
        return outs, [[tgt_dim] + d for d in lead_dims]
    return ([o.reshape(lead_shape + (o.shape[-1],)) for o in outs],
            [d + [tgt_dim] for d in lead_dims])
