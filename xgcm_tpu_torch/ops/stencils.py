"""Last-axis stencil kernel bodies for the generic grid-ufunc engine.

The operator cores that grid ufuncs wrap, acting along the **last** array
axis (the engine transposes core dims to the end first).  Each body is plain
torch, the counterpart of :mod:`xgcm_tpu.ops.stencils`, with the same operand
order so results stay bitwise equal to the JAX package.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "PAIR_OPS",
    "apply_pair",
    "cumsum",
    "cumsum_full",
    "cumsum_trim_last",
    "diff_forward",
    "interp_forward",
    "pairwise_min",
    "pairwise_max",
    "wrapping",
]

# THE single home for the 2-point stencil semantics.  ``lo`` is the
# lower-index neighbour, ``hi`` the higher-index one; the engine kernels
# below and the fused shift path (ops/fused.py and the shift kernel's plain
# version) phrase their operands in those terms.
#
# Torch adds, subtracts and orders uint16, uint32 and uint64 on no device,
# where JAX takes every unsigned width.  Those dtypes compute in the signed
# integers of their width (the same bits, see :func:`wrapping`): sums and
# differences wrap modulo 2^bits as the unsigned ones do, and min/max order
# them with the sign bit flipped, so values at or above 2^(bits-1) keep
# their unsigned order.
_UNSIGNED_WIDE = (torch.uint16, torch.uint32, torch.uint64)
_SIGNED_OF = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def wrapping(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as the signed integers of its width when it is a
    uint16/32/64 tensor (the same bits: adds, subtracts and multiplies
    wrap as the unsigned ones do), else ``t`` itself.  ``.view(dtype)``
    of the result's original dtype undoes it."""
    signed = _SIGNED_OF.get(t.dtype)
    return t if signed is None else t.view(signed)


def _wide_unsigned(lo, hi) -> bool:
    return lo.dtype in _UNSIGNED_WIDE and hi.dtype == lo.dtype


def _diff(lo, hi):
    """hi - lo; unsigned differences wrap modulo 2^bits, as in JAX, and a
    difference of two boolean arrays raises TypeError, as ``jnp.subtract``
    does."""
    if lo.dtype == torch.bool and hi.dtype == torch.bool:
        raise TypeError("diff is not defined for boolean data (as jnp.subtract)")
    if _wide_unsigned(lo, hi):
        return (wrapping(hi) - wrapping(lo)).view(lo.dtype)
    return hi - lo


def _interp(lo, hi):
    """(hi + lo) * 0.5.  An integer or bool sum (wrapped in its own dtype,
    as JAX adds) is halved in float64, as JAX (x64) promotes it against
    the weakly typed 0.5; torch would take its default dtype, float32.
    Float sums keep their dtype."""
    s = (wrapping(hi) + wrapping(lo)).view(lo.dtype) if _wide_unsigned(lo, hi) else hi + lo
    if not (s.is_floating_point() or s.is_complex()):
        s = s.to(torch.float64)
    return s * 0.5


def _ordered(fn):
    """torch.minimum/maximum, taking uint16/32/64 through the signed
    integers of their width with the sign bit flipped (an order-preserving
    map of the unsigned range onto the signed one)."""

    def op(lo, hi):
        if not _wide_unsigned(lo, hi):
            return fn(lo, hi)
        bits = torch.iinfo(_SIGNED_OF[lo.dtype]).min
        return (fn(wrapping(lo) ^ bits, wrapping(hi) ^ bits) ^ bits).view(lo.dtype)

    return op


PAIR_OPS = {
    "diff": _diff,
    "interp": _interp,
    "min": _ordered(torch.minimum),
    "max": _ordered(torch.maximum),
}


def apply_pair(op: str, lo, hi):
    """Apply a named 2-point op to (lower-index, higher-index) operands."""
    try:
        return PAIR_OPS[op](lo, hi)
    except KeyError:
        raise ValueError(f"unknown op {op!r}") from None


def diff_forward(a):
    """a[..., i+1] - a[..., i]."""
    return PAIR_OPS["diff"](a[..., :-1], a[..., 1:])


def interp_forward(a):
    """Two-point average."""
    return PAIR_OPS["interp"](a[..., :-1], a[..., 1:])


def pairwise_min(a):
    """Minimum of adjacent points."""
    return PAIR_OPS["min"](a[..., :-1], a[..., 1:])


def pairwise_max(a):
    """Maximum of adjacent points."""
    return PAIR_OPS["max"](a[..., :-1], a[..., 1:])


# -- cumsum -----------------------------------------------------------------
# ``jnp.cumsum`` is a reduce-window that XLA rewrites into a blocked scan: a
# running sum within blocks of 16, the block totals scanned the same way,
# and each block's result added to the scan of the totals before it.  Float
# sums here take that order, so they equal the JAX package's bit for bit,
# on the card as on the CPU.
_SCAN_BLOCK = 16


def cumsum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Inclusive prefix sum along ``axis`` with the dtype of ``jnp.cumsum``
    under x64: bool gives int64, every other dtype keeps its own (torch
    alone would widen the integers to int64)."""
    axis = axis % x.ndim
    if x.dtype == torch.bool:
        return torch.cumsum(x, axis, dtype=torch.int64)
    if x.dtype in _UNSIGNED_WIDE:
        # they wrap modulo 2^bits, so an int64 cumsum cast back is the same
        return torch.cumsum(x.to(torch.int64), axis).to(x.dtype)
    if not (x.is_floating_point() or x.is_complex()):
        return torch.cumsum(x, axis, dtype=x.dtype)
    n = x.shape[axis]
    if n <= 1:
        # XLA drops a window of one (-0.0 stays -0.0), except in bfloat16,
        # which it sums in float32 from zero
        return x + 0.0 if x.dtype == torch.bfloat16 else x.clone()
    pre = math.prod(x.shape[:axis])
    post = math.prod(x.shape[axis + 1:])
    if post >= 32 or pre == 1:
        return _blocked_scan(x.reshape(pre, n, post)).reshape(x.shape)
    # a scan along a short inner stride: move the axis to the front, so
    # that each step of the running sum adds contiguous slabs
    moved = x.movedim(axis, 0).contiguous()
    out = _blocked_scan(moved.reshape(1, n, -1)).reshape(moved.shape)
    return out.movedim(0, axis).contiguous()


def _blocked_scan(v: torch.Tensor) -> torch.Tensor:
    """The blocked scan of a (pre, n, post) float tensor along dim 1, as a
    new contiguous tensor.  A last block shorter than the others is the
    zero-padded block of XLA's rewrite: its running sum is the same."""
    pre, n, post = v.shape
    out = torch.empty((pre, n, post), dtype=v.dtype, device=v.device)
    width = min(n, _SCAN_BLOCK)
    nb = n // width
    full = nb * width
    vb = v[:, :full].reshape(pre, nb, width, post)
    ob = out[:, :full].view(pre, nb, width, post)
    torch.add(vb[:, :, 0], 0.0, out=ob[:, :, 0])  # from zero, as XLA: -0.0 + 0 = 0
    for i in range(1, width):
        torch.add(ob[:, :, i - 1], vb[:, :, i], out=ob[:, :, i])
    if full < n:
        torch.add(v[:, full], 0.0, out=out[:, full])
        for i in range(full + 1, n):
            torch.add(out[:, i - 1], v[:, i], out=out[:, i])
    if nb > 1 or full < n:
        # the scan of a block's total depends on the totals before it only
        totals = _blocked_scan(ob[:, :, -1])  # (pre, nb, post)
        ob[:, 1:] += totals[:, :-1, None]
        out[:, full:] += totals[:, -1:]
    return out


def cumsum_full(a):
    """Inclusive scan along the last axis."""
    return cumsum(a, -1)


def cumsum_trim_last(a):
    """Inclusive scan along the last axis, dropping the final element."""
    return cumsum(a, -1)[..., :-1]
