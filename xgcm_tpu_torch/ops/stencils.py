"""Last-axis stencil kernel bodies for the generic grid-ufunc engine.

The operator cores that grid ufuncs wrap, acting along the **last** array
axis (the engine transposes core dims to the end first).  Each body is plain
torch, the counterpart of :mod:`xgcm_tpu.ops.stencils`, with the same operand
order so results stay bitwise equal to the JAX package.
"""

from __future__ import annotations

import torch

__all__ = [
    "PAIR_OPS",
    "apply_pair",
    "diff_forward",
    "interp_forward",
    "pairwise_min",
    "pairwise_max",
]

# THE single home for the 2-point stencil semantics.  ``lo`` is the
# lower-index neighbour, ``hi`` the higher-index one; the engine kernels
# below and the fused shift path (ops/fused.py and the shift kernel's plain
# version) phrase their operands in those terms.
def _interp(lo, hi):
    """(hi + lo) * 0.5.  An integer or bool sum is halved in float64, as
    JAX (x64) promotes it against the weakly typed 0.5; torch would take
    its default dtype, float32.  Float sums keep their dtype."""
    s = hi + lo
    if not (s.is_floating_point() or s.is_complex()):
        s = s.to(torch.float64)
    return s * 0.5


PAIR_OPS = {
    "diff": lambda lo, hi: hi - lo,
    "interp": _interp,
    "min": torch.minimum,
    "max": torch.maximum,
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
