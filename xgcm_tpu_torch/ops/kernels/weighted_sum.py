"""The weighted sum (``csrc/weighted_sum.cu``), the one pass of
``Grid.integrate`` on the card, and its plain PyTorch version.

``weighted_sum(x, factors, ndims)`` sums ``nan_to_num(x * ((f0 * f1) *
...))`` over the trailing ``ndims`` dims of ``x``: each factor has ``x``'s
number of dims, each of ``x``'s size or 1, and the metric is their product
in the order given, in float32, as ``Grid.get_metric`` multiplies it.  NaN
becomes 0 and ±inf the largest finite float32 (``torch.nan_to_num``), so
each weighted value equals the one PyTorch computes.  The sum is taken in
float64 and rounded once to the float32 result: in a fixed order, so that
a call repeats to the bit.  A CPU tensor takes :func:`weighted_sum_plain`;
a CUDA tensor launches the kernel or raises, also where a gradient is
needed: ``Grid.integrate`` keeps those in PyTorch.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence

import torch

from ...utils.profiling import span
from . import build

__all__ = ["weighted_sum", "weighted_sum_plain", "plan", "MAX_DIMS", "MAX_FACTORS"]

# the kernel's fixed sizes (kept equal to csrc/weighted_sum.cu)
MAX_DIMS = 7
MAX_FACTORS = 4
THREADS = 256
MAX_VECTORS = 5  # vectors a thread of a row
# blocks a call aims at: enough that a wave's ragged end costs little,
# few enough that the partial sums are a small second pass
TARGET_BLOCKS = 16384


class Plan(NamedTuple):
    """How a launch cuts ``x``: ``segments`` results, each the sum of
    ``rows`` rows of the last dim; a row in ``tiles`` tiles of ``vpt``
    vectors of ``vw`` values a thread; a segment's rows in ``chunks`` of
    ``chunk_rows`` (the last may be shorter).  Each (segment, chunk, tile)
    is one block and one partial sum."""

    segments: int
    rows: int
    vw: int
    tiles: int
    vpt: int
    chunk_rows: int
    chunks: int


def plan(shape: Sequence[int], ndims: int, vw: int) -> Plan:
    """The launch for a contiguous ``shape`` summed over its trailing
    ``ndims`` dims with vectors of ``vw`` values (4, or 1 on the scalar
    route).  It depends on the shape alone, so the order of the sum does
    too."""
    kept = len(shape) - ndims
    segments = math.prod(shape[:kept])
    rows = math.prod(shape[kept:-1])
    nv = shape[-1] // vw
    tiles = max(1, -(-nv // (THREADS * MAX_VECTORS)))
    vpt = max(1, -(-nv // (tiles * THREADS)))
    chunks = min(rows, max(1, -(-TARGET_BLOCKS // (segments * tiles))))
    chunk_rows = max(1, -(-rows // chunks))
    return Plan(segments, rows, vw, tiles, vpt, chunk_rows, -(-rows // chunk_rows))


def weighted_sum_plain(x: torch.Tensor, factors: Sequence[torch.Tensor],
                       ndims: int) -> torch.Tensor:
    """The product, the weighting and ``nan_to_num`` in float32, the sum
    in float64, rounded once."""
    metric = factors[0]
    for f in factors[1:]:
        metric = metric * f
    w = torch.nan_to_num(x * metric, nan=0.0)
    dims = tuple(range(x.ndim - ndims, x.ndim))
    return w.sum(dims, dtype=torch.float64).to(torch.float32)


@span("xtt.kernels.weighted_sum")
def weighted_sum(x: torch.Tensor, factors: Sequence[torch.Tensor], ndims: int) -> torch.Tensor:
    """The weighted sum: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor (``x`` contiguous float32 of at most
    ``MAX_DIMS`` dims, 1 to ``MAX_FACTORS`` float32 factors)."""
    factors = list(factors)
    if not 1 <= len(factors) <= MAX_FACTORS:
        raise ValueError(f"weighted_sum takes 1 to {MAX_FACTORS} factors, got {len(factors)}")
    if not 1 <= ndims <= x.ndim or any(
            f.ndim != x.ndim or any(n not in (1, m) for n, m in zip(f.shape, x.shape))
            for f in factors):
        raise ValueError(f"weighted_sum: factors must broadcast to x {tuple(x.shape)} in its "
                         f"dims, and 1 <= ndims <= {x.ndim} (got {ndims})")
    if x.device.type == "cpu":
        return weighted_sum_plain(x, factors, ndims)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *factors)):
        raise ValueError("weighted_sum kernel computes no gradient")

    build.require_cuda(x, *factors)
    if x.dtype != torch.float32 or any(f.dtype != torch.float32 for f in factors):
        raise TypeError("weighted_sum kernel takes float32 x and factors")
    if not x.is_contiguous() or x.ndim > MAX_DIMS:
        raise ValueError(f"weighted_sum kernel needs a contiguous x of at most {MAX_DIMS} dims")
    return _launch(x, factors, ndims)


def _launch(x: torch.Tensor, factors: Sequence[torch.Tensor], ndims: int) -> torch.Tensor:
    """One launch on a contiguous float32 CUDA ``x`` that
    :func:`weighted_sum` has checked."""
    shape = tuple(x.shape)
    factors = [f.contiguous() for f in factors]
    out = torch.empty(shape[:x.ndim - ndims], dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if math.prod(shape[x.ndim - ndims:]) == 0:
        return out.zero_()
    # a factor's stride along each of x's dims, right-aligned to MAX_DIMS;
    # 0 where it is broadcast
    pad = MAX_DIMS - x.ndim
    strides = []
    for f in factors:
        strides += [0] * pad + [0 if n == 1 else s for n, s in zip(f.shape, f.stride())]
    along_row = [f for f in factors if f.shape[-1] != 1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *along_row))
    p = plan(shape, ndims, 4 if shape[-1] % 4 == 0 and aligned else 1)
    blocks = p.segments * p.chunks * p.tiles
    if blocks >= 2**31:
        raise ValueError(f"weighted_sum kernel: {blocks} blocks for {shape} exceed a launch")
    partial = torch.empty(blocks, dtype=torch.float64, device=x.device)
    nf = len(factors)
    args = (
        x.data_ptr(),
        (ctypes.c_void_p * nf)(*(f.data_ptr() for f in factors)),
        (ctypes.c_longlong * (nf * MAX_DIMS))(*strides), nf,
        (ctypes.c_longlong * MAX_DIMS)(*([1] * pad + list(shape))),
        p.segments, p.rows, p.vw, p.vpt, p.tiles, p.chunk_rows, p.chunks,
        partial.data_ptr(), out.data_ptr(),
    )
    build.launch("xt_weighted_sum", x.device, *args)
    build.LAUNCHES["weighted_sum"] += 1
    return out
