"""Kernels G and H: conservative rebin of raw cell columns into shared bins
(``csrc/conservative.cu``), for one variable (G) or for up to eight that
share the cell geometry (H), and their plain PyTorch version.

Columns are (cols, n + 1) raw bounds and (cols, n) cells, any strides;
``edges`` are shared increasing (m,) bin edges; each result is (cols, m - 1)
with the bins no valid cell touches NaN.  A CPU tensor takes the plain
version, :func:`_conservative_rebin_torch` (the port of
``xgcm_tpu.ops.transform._conservative_rebin``) and the NaN rule; a CUDA
tensor launches the kernel or raises.  :func:`conservative_rebin` and
:func:`conservative_rebin_multi` are differentiable: the forward is the
kernel and the backward runs autograd through the plain version, as the
JAX package's custom VJPs do.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from ...utils.profiling import span
from . import build

__all__ = [
    "CONSERVATIVE_DTYPES",
    "conservative_launch",
    "conservative_rebin",
    "conservative_rebin_multi",
    "_conservative_multi_plain",
    "_conservative_plain",
    "_conservative_rebin_torch",
]

CONSERVATIVE_DTYPES = (torch.float32, torch.bfloat16)

# largest (cols * m * n) per-(bin, cell) tensor the dense plain formulation
# may materialise; deeper columns loop over cells instead
_DENSE_MEMB_BUDGET = 2**27


def _clip01(x):
    """``jnp.clip(x, 0, 1)``: maximum, then minimum (and their gradients)."""
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)), torch.ones_like(x))


def _geometry(theta_1, theta_2, keep):
    """Per-cell (tmin, tmax, degenerate, 1 / thickness) of the raw bounds:
    a single NaN bound makes the cell homogeneous at the other bound;
    cells outside ``keep`` get the bounds 0 so that NaN never enters the
    sums."""
    t1n = torch.isnan(theta_1)
    t2n = torch.isnan(theta_2)
    tmin = torch.where(t1n, theta_2, torch.where(t2n, theta_1, torch.minimum(theta_1, theta_2)))
    tmax = torch.where(t1n, theta_2, torch.where(t2n, theta_1, torch.maximum(theta_1, theta_2)))
    tmin = torch.where(keep, tmin, 0.0)
    tmax = torch.where(keep, tmax, 0.0)
    thick = tmax - tmin
    degenerate = thick == 0.0
    inv_thick = torch.where(degenerate, 0.0, 1.0 / torch.where(degenerate, 1.0, thick))
    return tmin, tmax, degenerate, inv_thick


def _accumulate(geometry, w, vf, edges):
    """(out, count) over the bins: the deposited mass w * (frac_up(e_hi) -
    frac_lo(e_lo)) and the number of overlapping valid cells, summed over
    the cells; dense when it fits the budget, else one cell at a time
    (O(cols * m) memory)."""
    tmin, tmax, deg, inv = geometry

    def _terms(lo, hi, tmin_c, tmax_c, deg_c, inv_c, w_c, vf_c):
        def _frac(x):
            return _clip01((x - tmin_c) * inv_c)

        frac_up = torch.where(deg_c, (hi >= tmin_c).to(w.dtype), _frac(hi))
        frac_lo = torch.where(deg_c, (lo > tmin_c).to(w.dtype), _frac(lo))
        # a cell overlaps bin j iff tmin <= e_{j+1} and tmax >= e_j
        overlap = ((tmin_c <= hi) & ~(tmax_c < lo)).to(w.dtype)
        return w_c * (frac_up - frac_lo), vf_c * overlap

    n = w.shape[-1]
    m = edges.shape[-1]
    lead = torch.broadcast_shapes(tmin.shape[:-1], w.shape[:-1])
    if math.prod(lead) * n * m <= _DENSE_MEMB_BUDGET:
        mass, hits = _terms(
            edges[..., :-1, None], edges[..., 1:, None],  # (m-1, 1) vs cells (..., 1, n)
            *(x[..., None, :] for x in (tmin, tmax, deg, inv, w, vf)),
        )
        return mass.sum(-1), hits.sum(-1)
    e_lo, e_hi = edges[..., :-1], edges[..., 1:]
    cells = [x.expand(lead + (n,)) for x in (tmin, tmax, deg, inv, w, vf)]
    out = count = torch.zeros(lead + (m - 1,), dtype=w.dtype, device=w.device)
    for k in range(n):
        mass, hits = _terms(e_lo, e_hi, *(x[..., k, None] for x in cells))
        out = out + mass
        count = count + hits
    return out, count


def _conservative_rebin_torch(phi, theta_1, theta_2, edges):
    """Conservative rebinning of phi (..., n) with cell bounds theta_1,
    theta_2 (..., n) into bins ``edges`` (m,) as a difference of
    cumulative-mass fractions, the port of
    ``xgcm_tpu.ops.transform._conservative_rebin``.  Degenerate cells step
    at both edges inclusively, so a cell exactly on an interior edge
    deposits its full mass into both bins, as the reference does.
    bfloat16/float16 data accumulate in float32 and cast back.  Returns
    (out, count), count the contributing cells per bin."""
    out_dtype = None
    if phi.dtype in (torch.bfloat16, torch.float16):
        out_dtype = phi.dtype
        phi, theta_1, theta_2, edges = (x.float() for x in (phi, theta_1, theta_2, edges))
    cell_empty = torch.isnan(theta_1) & torch.isnan(theta_2)
    valid = ~torch.isnan(phi) & ~cell_empty
    w = torch.where(valid, torch.nan_to_num(phi), 0.0)
    out, count = _accumulate(_geometry(theta_1, theta_2, valid), w, valid.to(w.dtype), edges)
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out, count


def _conservative_plain(theta, phi, edges):
    """Plain version of kernel G: (cols, n + 1) raw bounds and (cols, n)
    cells into (cols, m - 1) bins, untouched bins NaN."""
    out, count = _conservative_rebin_torch(phi, theta[..., :-1], theta[..., 1:], edges)
    return torch.where(count > 0, out, torch.nan)


def _conservative_multi_plain(theta, phis, edges):
    """Plain version of kernel H: :func:`_conservative_plain` of each phi,
    the cell geometry computed once from the bounds alone (a cell is kept
    unless both its bounds are NaN); each variable's validity enters only
    through its weight and its count.  Returns a tuple."""
    low = phis[0].dtype in (torch.bfloat16, torch.float16)
    if low:
        theta, edges = theta.float(), edges.float()
    theta_1, theta_2 = theta[..., :-1], theta[..., 1:]
    kept = ~(torch.isnan(theta_1) & torch.isnan(theta_2))
    geometry = _geometry(theta_1, theta_2, kept)
    outs = []
    for phi in phis:
        ph = phi.float() if low else phi
        valid = ~torch.isnan(ph) & kept
        w = torch.where(valid, torch.nan_to_num(ph), 0.0)
        out, count = _accumulate(geometry, w, valid.to(w.dtype), edges)
        outs.append(torch.where(count > 0, out, torch.nan).to(phi.dtype if low else out.dtype))
    return tuple(outs)


def conservative_launch(
    theta: torch.Tensor,
    phis: Sequence[torch.Tensor],
    edges: torch.Tensor,
    reassociate: bool = False,
    outs: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """Launch kernel G (one phi) or H (2 to 8 phis) on CUDA tensors: theta
    (cols, n + 1) and phis (cols, n) of float32 or bfloat16, the phis of
    one dtype, any strides each; edges (m,) increasing, m >= 2.  Writes
    ``outs`` ((cols, m - 1) each, one layout, phi's dtype) when given, else
    new contiguous tensors."""
    if not 1 <= len(phis) <= build.MAX_VARS:
        raise ValueError(f"kernels G/H take 1 to {build.MAX_VARS} variables, got {len(phis)}")
    build.require_cuda(theta, edges, *phis)
    for name, a in (("theta", theta), ("edges", edges), *(("phi", p) for p in phis)):
        if a.dtype not in CONSERVATIVE_DTYPES:
            raise TypeError(f"conservative kernel takes {name} in {CONSERVATIVE_DTYPES}, "
                            f"got {a.dtype}")
    if len({p.dtype for p in phis}) != 1:
        raise TypeError("conservative kernel takes phis of one dtype")
    if theta.ndim != 2 or any(p.shape != (theta.shape[0], theta.shape[1] - 1) for p in phis):
        raise ValueError(f"theta must be (cols, n + 1) and phi (cols, n), got "
                         f"{tuple(theta.shape)}, {[tuple(p.shape) for p in phis]}")
    if edges.ndim != 1 or edges.shape[0] < 2:
        raise ValueError(f"edges must be (m,) with m >= 2, got {tuple(edges.shape)}")
    cols, n1 = theta.shape
    nb = edges.shape[0] - 1
    e = edges.float().contiguous()
    outs = build.outputs(outs, len(phis), (cols, nb), phis[0].dtype, theta.device)
    ptrs, cs, ks, optrs = build.var_set(phis, outs)
    build.launch(
        "xt_conservative", theta.device,
        theta.data_ptr(), ptrs, cs, ks, optrs, e.data_ptr(), len(phis),
        build.DTYPE_CODES[theta.dtype], build.DTYPE_CODES[phis[0].dtype],
        cols, n1 - 1, nb, *theta.stride(), *outs[0].stride(), int(bool(reassociate)),
    )
    build.LAUNCHES["conservative" if len(phis) == 1 else "conservative_multi"] += 1
    return outs


def _launch_maybe_T(theta, phis, edges, reassociate, out_T):
    """The kernel's outputs, written through transposed views of new
    (m - 1, cols) tensors with ``out_T``."""
    if not out_T:
        return conservative_launch(theta, phis, edges, reassociate)
    outs = [torch.empty((edges.shape[0] - 1, theta.shape[0]), dtype=p.dtype,
                        device=theta.device) for p in phis]
    conservative_launch(theta, phis, edges, reassociate, outs=[o.T for o in outs])
    return outs


@span("xtt.kernels.conservative")
def conservative_rebin(
    theta: torch.Tensor,
    phi: torch.Tensor,
    edges: torch.Tensor,
    reassociate: bool = False,
    out_T: bool = False,
) -> torch.Tensor:
    """Conservative rebin of (cols, n) cells with (cols, n + 1) raw bounds
    into shared increasing bins; returns (cols, m - 1), or (m - 1, cols)
    with ``out_T``.  The plain version for CPU tensors (which sums in one
    order, so ``reassociate`` changes nothing there), kernel G for CUDA
    tensors (``reassociate=True`` telescopes its mass sums)."""
    def plain(th, ph, ed):
        out = _conservative_plain(th, ph, ed)
        return out.T if out_T else out

    if theta.device.type == "cpu":
        return plain(theta, phi, edges)

    def launch(th, ph, ed):
        return _launch_maybe_T(th, (ph,), ed, reassociate, out_T)[0]

    return build.autograd_launch(launch, plain, theta, phi, edges)


@span("xtt.kernels.conservative_multi")
def conservative_rebin_multi(
    theta: torch.Tensor,
    phis: Sequence[torch.Tensor],
    edges: torch.Tensor,
    reassociate: bool = False,
    out_T: bool = False,
) -> List[torch.Tensor]:
    """:func:`conservative_rebin` of 2 to 8 phis that share the bounds, in
    one pass; returns a list.  The plain version for CPU tensors, kernel H
    for CUDA tensors."""
    def plain(th, ed, *phs):
        return tuple(o.T if out_T else o for o in _conservative_multi_plain(th, phs, ed))

    if theta.device.type == "cpu":
        return list(plain(theta, edges, *phis))
    if len(phis) < 2:
        raise ValueError("kernel H takes 2 to 8 variables; use conservative_rebin for one")

    def launch(th, ed, *phs):
        return tuple(_launch_maybe_T(th, phs, ed, reassociate, out_T))

    return list(build.autograd_launch(launch, plain, theta, edges, *phis))
