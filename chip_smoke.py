#!/usr/bin/env python3
"""Smoke run of xgcm_tpu_torch on one CUDA card.

Builds the eight hand-written CUDA kernels from ``xgcm_tpu_torch/csrc``,
holds each against its plain PyTorch version at the shapes of the main
paths, and drives eight paths at the width of LLC4320 (4320 x 4320 columns a
face, 50 levels, float32):

* the C-grid analysis step (``xgcm_tpu_torch.entry.step``, kernels A and C)
  and the fused diagnostics (kernel B), onto 36 theta targets, at one face;
* the vorticity benchmark configuration at one face: the single-pass
  vorticity kernel D, beside the Grid API's two shifts and kernel B;
* the density-space analysis through ``Grid.transform`` and
  ``Grid.transform_multi`` at one face: one field into 35 density classes
  (conservative, kernel G), four fields (T, S, u, v) into the same classes
  (kernel H), and the four onto 36 density levels (linear, kernel F);
* the face analysis of a whole LLC4320 level (13 faces, ``grids.llc_grid``):
  cross-face tracer gradients, vorticity and divergence with the vector
  halo rules, and the 2-D vector interpolation, eight launches of the
  per-face shift kernel E, each result equal to the generic halo engine's;
* the metric path at one face of 50 levels: the tracer budget of
  examples/tracer_budget.py (six launches of kernel A, closed to 1e-4 in
  float32) and the metric-weighted calculus of a MITgcm C-grid
  (``grids.mitgcm_c_grid``: derivative, integrate, average, cumint, cumsum
  and ``metric_weighted=``, each with the launches of A its route implies),
  the identities of the calculus at full width, and both on a small grid
  against the CPU;
* the xarray path at one face, in a process of its own: Grid(xr.Dataset)
  of the repo's xarray stub (tests/fake_xarray.py), diff, derivative,
  integrate and the linear and conservative transforms of one field and of
  four from host numpy to host numpy, each against the native call on the
  card (the same launches of A, C, G, F, H, the same values bit for bit,
  xgcm's coordinates, the time and the profiler's split into copies,
  kernels and idle); ``regrid_vertical`` at the face and against the CPU;
  ``utils.device_time`` and ``utils.trace``;
* the sharded layer at one face, in a process of its own, on four logical
  shards of the card (on the visible cards in turn where there are
  several): the ring route's diff, interp, min and max (kernel E a block),
  the sharded cumsum, derivative and integrate, the batch route (kernel A
  a block), the sharded C-grid diagnostics on a 2 x 2 mesh and the
  per-shard transforms (C, G, F, H a block), each against the
  single-device call, with its collectives held to the JAX package's
  budget, its time beside the single-device time and the profiler's split;
  then the face-sharded route at one LLC4320 level: the face analysis
  (tracer gradients, vorticity, divergence through ``diff_2d_vector``, the
  2-D vector interpolation) with the 13 faces over four shards (16
  with the dummy faces, kernel E a block an op), and a vector diff and a
  Y cumsum on a face x rows mesh of 2 x 2;
* the multi-process runtime at one face: two processes on the card
  (``init_distributed(backend="gloo")``, CUDA blocks staged through host
  memory; and one process a card over NCCL where there are two cards), each
  holding its blocks of meshes the two share (``make_multihost_mesh``): the
  ring route, the cumsum, the derivative, the batch route (kernel A once a
  process), the diagnostics, the per-shard linear transform (kernel C once a
  block) and the face analysis as eight ops (kernel E once a block an op) and
  as one apply_many, each process holding its blocks against the
  single-device result it computes, with phase 11's budgets of collectives,
  the bytes that crossed between the processes, each process's peak memory,
  and the wall time between barriers beside phase 11's one-process time.

Each path runs with the launch counts set to 0 just before it and read just
after; the script checks that every kernel of the path launched and that
the results are right, and times each kernel beside its plain version
(kernel A also beside ``torch.profiler``'s kernel time, and on a 3-D
face of 50 levels).  Kernel A is also held bit for bit against its plain
version on shapes that break its index arithmetic (``SHIFT_SHAPES``: odd
widths, n = 1 and 2 on each axis, a 4-D middle axis, each aligned and
misaligned, in every dtype) and on two bf16 views of more than 2^31
elements, each aligned and misaligned (its 64-bit routes).  Kernels C and
F are also held against their plain versions on columns built to break an
interval search (``INTERP_CASES``), and F against V single calls of C bit
for bit; kernels G and H likewise on columns built to break the walk over
a column's cells (``CONSERVATIVE_CASES``, infinite bounds among them), and
H against V single calls of G bit for bit.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --sharded-phase       # phase 11 alone
    python3 chip_smoke.py --multiprocess-phase  # phase 12 alone

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
describing the kernels, then ``{"ok": true, "device": {...}}`` as the last
line.  Exits non-zero, printing no result, when there is no CUDA card, when
the package is not beside this script, or when any check fails.  Imports
torch and numpy only.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import io
import itertools
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

NY = NX = 4320  # one LLC4320 face
N_FACES = 13  # an LLC grid's faces
NZ = 50
N_TARGETS = 36
N_EDGES = 36  # 35 density classes
NV = 4  # T, S, u, v
N_SHARDS = 4  # logical shards on the one card (phase 11)
SAMPLE = 65536  # columns of the main path held against the plain version
TOL_F32 = dict(rtol=1e-6, atol=1e-6)  # nvcc contracts a*b+c into FMAs
TOL_BF16 = dict(rtol=1e-2, atol=1e-5)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at 700 W
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores, data sheet
KERNELS = {
    "shift": ("xgcm_tpu_torch/csrc/shift.cu", "xgcm_tpu/ops/pallas_stencils.py:290"),
    "cgrid_diagnostics": (
        "xgcm_tpu_torch/csrc/cgrid_diagnostics.cu", "xgcm_tpu/ops/pallas_stencils.py:205"),
    "interp_linear": (
        "xgcm_tpu_torch/csrc/interp_linear.cu", "xgcm_tpu/ops/pallas_transform.py:239"),
    "interp_linear_multi": (
        "xgcm_tpu_torch/csrc/interp_linear.cu", "xgcm_tpu/ops/pallas_transform.py:494"),
    "conservative": (
        "xgcm_tpu_torch/csrc/conservative.cu", "xgcm_tpu/ops/pallas_transform.py:731"),
    "conservative_multi": (
        "xgcm_tpu_torch/csrc/conservative.cu", "xgcm_tpu/ops/pallas_transform.py:873"),
    "vorticity": ("xgcm_tpu_torch/csrc/vorticity.cu", "xgcm_tpu/ops/pallas_stencils.py:111"),
    "face_shift": ("xgcm_tpu_torch/csrc/face_shift.cu", "xgcm_tpu/ops/pallas_stencils.py:415"),
    # Grid.integrate's product, nan_to_num and sum, which XLA fuses
    "weighted_sum": ("xgcm_tpu_torch/csrc/weighted_sum.cu", "none"),
}


def bound(nbytes: float, flops: float):
    """(least ms on the card, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the float32 operations over the peak
    rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def log(msg: str) -> None:
    print(msg, flush=True)


def import_port():
    """The package from this script's checkout, never one installed
    elsewhere."""
    sys.path.insert(0, str(ROOT))
    import xgcm_tpu_torch

    where = pathlib.Path(xgcm_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        raise RuntimeError(f"xgcm_tpu_torch imported from {where}, not from {ROOT}")
    return xgcm_tpu_torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Checker:
    """Kernel-vs-plain comparisons; keeps the largest error per kernel."""

    def __init__(self):
        self.max_err = {name: 0.0 for name in KERNELS}

    def compare(self, name, label, got, want, rtol=0.0, atol=0.0, exact=False):
        got_f, want_f = got.double(), want.double()
        if not torch.equal(torch.isnan(got_f), torch.isnan(want_f)):
            raise AssertionError(f"{name} [{label}]: NaN footprints differ")
        finite = torch.isfinite(want_f)
        if not torch.equal(got_f[~finite].nan_to_num(0.0), want_f[~finite].nan_to_num(0.0)):
            raise AssertionError(f"{name} [{label}]: infinities differ")
        diff = torch.where(finite, (got_f - want_f).abs(), 0.0)
        err = float(diff.max()) if diff.numel() else 0.0
        self.max_err[name] = max(self.max_err[name], err)
        if exact:
            ok = err == 0.0
        else:
            ok = bool((diff <= atol + rtol * want_f.abs().nan_to_num(0.0)).all())
        if not ok:
            raise AssertionError(f"{name} [{label}]: max abs err {err:.3e} beyond tolerance")


def same_values(a, b):
    """Equal values with NaN in the same places."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(), b.nan_to_num()))


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 unit in the last place of each value of x."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def time_pair(kernel_fn, plain_fn=None, reps=10):
    """(kernel ms, plain ms or None) per call from CUDA events, measured in
    turns plain, kernel, kernel, plain, each after a warm-up call."""

    def one(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    p1 = one(plain_fn) if plain_fn else None
    k1, k2 = one(kernel_fn), one(kernel_fn)
    p2 = one(plain_fn) if plain_fn else None
    return (k1 + k2) / 2, (None if plain_fn is None else (p1 + p2) / 2)


def columns(gen, dev, cols, n):
    """(theta, phi) test columns: monotone, ~10 % descending, NaN-masked
    ends, some NaN phi at valid knots, a few all-NaN columns."""
    th = torch.cumsum(torch.rand((cols, n), generator=gen, device=dev) + 0.01, -1)
    ph = torch.rand((cols, n), generator=gen, device=dev)
    r = torch.rand((cols,), generator=gen, device=dev)
    k = torch.arange(n, device=dev)
    th = torch.where((r < 0.1)[:, None], th.flip(-1), th)
    th = torch.where(((r >= 0.1) & (r < 0.2))[:, None] & (k >= n - 7), float("nan"), th)
    th = torch.where(((r >= 0.2) & (r < 0.25))[:, None] & (k < 5), float("nan"), th)
    ph = torch.where(((r >= 0.25) & (r < 0.27))[:, None] & (k == n // 2), float("nan"), ph)
    th = torch.where((r >= 0.995)[:, None], float("nan"), th)
    return th.contiguous(), ph.contiguous()


SHIFT_OPS = ("diff", "interp", "min", "max")
SHIFT_BCS = ("periodic", "fill", "extend", "extrapolate")
SHIFT_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16)
# (label, shape, axes): shapes that break kernel A's index arithmetic (odd
# and vector-width widths, n = 1 and 2 on each axis, a 4-D middle axis);
# each also runs as a view 4 bytes off 16-byte alignment, "misaligned"
SHIFT_SHAPES = (
    *((f"width{w}", (300, w), (0, 1)) for w in (1, 2, 3, 5, 4319, 4321)),
    *((f"n{n}/axis{a}", tuple(n if i == a else (300, 256, 200)[i] for i in range(3)), (a,))
      for n in (1, 2) for a in range(3)),
    ("4d-middle", (6, 50, 70, 64), (1, 2)),
    ("face-rows", (1000, NX), (0, 1)),
)
# a row (1-D) and a plane (axis 0 of (3, 2^30 + 2048), whose row 1 crosses
# the offset 2^31 at column 2^30 - 2048) of more than 2^31 bf16 elements:
# kernel A's 64-bit routes (vector, and scalar on a misaligned view),
# checked around the offset 2^31
OFFSET_64 = 2 ** 31
SHIFT_64BIT = ((OFFSET_64 + 4096,), (3, OFFSET_64 // 2 + 2048))


def shift_reference(k, x, axis, op, direction, bc, fill):
    """What kernel A is held to bit for bit: the plain version, run in
    float32 and rounded once for 16-bit types, as the kernel computes."""
    if x.dtype in (torch.float32, torch.float64):
        return k.shift_plain(x, axis, op, direction, bc, fill)
    return k.shift_plain(x.float(), axis, op, direction, bc, fill).to(x.dtype)


def shift_every_way(check, k, label, x, axes, fill=1.5):
    """Kernel A against its reference on x, every op x direction x boundary
    along each of ``axes``, bitwise."""
    for axis, op, direction, bc in itertools.product(axes, SHIFT_OPS, ("left", "right"),
                                                     SHIFT_BCS):
        check.compare("shift", f"{label}/{x.dtype}/{op}/{direction}/{bc}/axis{axis}",
                      k.shift(x, axis, op, direction, bc, fill),
                      shift_reference(k, x, axis, op, direction, bc, fill), exact=True)


def sprinkled(gen, dev, shape, dtype, misaligned=False):
    """N(0, 9) values with NaN, inf and -0.0 at a few places; ``misaligned``
    puts the data one element off 16-byte alignment (4 bytes; 8 for f64, 4
    for 16-bit types, which are 2 elements)."""
    n = int(np.prod(shape))
    off = max(1, 4 // torch.tensor([], dtype=dtype).element_size())
    x = torch.randn((n + off,), generator=gen, device=dev).mul_(3).to(dtype)
    x = x[off:] if misaligned else x[:n]
    x[[3, 11]] = float("nan")
    x[7] = float("inf")
    x[5] = -0.0
    return x.view(shape)


def check_shift_64bit(check, k, gen, dev):
    """Kernel A's 64-bit routes on bf16 views of more than 2^31 elements,
    each aligned (16-byte vectors) and one element off (one element a
    thread), compared on the edge rows and around the 2^31 offset."""
    half = 512
    for shape, misaligned in itertools.product(SHIFT_64BIT, (False, True)):
        numel = int(np.prod(shape))
        x = torch.randn((numel + 1,), generator=gen, device=dev, dtype=torch.bfloat16)
        x = (x[1:] if misaligned else x[:numel]).view(shape)
        if misaligned != (x.data_ptr() % 16 != 0):
            raise AssertionError(f"shift [64bit{shape}]: the view is not as misaligned as asked")
        axis = 0
        for op, direction, bc in itertools.product(SHIFT_OPS, ("left", "right"), SHIFT_BCS):
            got = k.shift(x, axis, op, direction, bc, 1.5)
            label = f"64bit{shape}{'/misaligned' if misaligned else ''}/{op}/{direction}/{bc}"
            if len(shape) == 1:
                # the edge elements: the plain version on the first and last
                # `half` elements side by side wraps as the whole row does;
                # the junction element between them is left out
                ends = torch.cat([x[:half], x[-half:]])
                want = shift_reference(k, ends, 0, op, direction, bc, 1.5)
                keep = torch.ones(2 * half, dtype=torch.bool, device=dev)
                keep[half if direction == "left" else half - 1] = False
                check.compare("shift", f"{label}/ends", torch.cat([got[:half], got[-half:]])[keep],
                              want[keep], exact=True)
                # around the 2^31 offset, the window's inner elements
                m = OFFSET_64
                want = shift_reference(k, x[m - half - 1:m + half + 1], 0, op, direction, bc, 1.5)
                check.compare("shift", f"{label}/2^31", got[m - half:m + half], want[1:-1],
                              exact=True)
            else:
                # along axis 0 each column stands alone: the first and last
                # columns, and those of row 1 around the 2^31 offset
                inner = shape[1]
                c = OFFSET_64 - inner
                for name, cols in (("ends", torch.cat([torch.arange(half), torch.arange(
                        inner - half, inner)])), ("2^31", torch.arange(c - half, c + half))):
                    cols = cols.to(dev)
                    check.compare("shift", f"{label}/{name}", got[:, cols],
                                  shift_reference(k, x[:, cols], 0, op, direction, bc, 1.5),
                                  exact=True)
            del got
        del x
        torch.cuda.empty_cache()


def check_shift(check, gen, dev):
    """Kernel A: every op x direction x boundary on one face, both axes,
    bitwise; axis 0 of a 3-D field; a bf16 case within one ulp; then the
    shapes of ``SHIFT_SHAPES``, aligned and misaligned, in every dtype, and
    the 64-bit route."""
    from xgcm_tpu_torch.ops.kernels import shift as k

    x = torch.randn((NY, NX), generator=gen, device=dev)
    for op in ("diff", "interp", "min", "max"):
        for direction in ("left", "right"):
            for bc in ("periodic", "fill", "extend", "extrapolate"):
                for axis in (0, 1):
                    check.compare(
                        "shift", f"{op}/{direction}/{bc}/axis{axis}",
                        k.shift(x, axis, op, direction, bc, 1.5),
                        k.shift_plain(x, axis, op, direction, bc, 1.5), exact=True)
    x3 = torch.randn((NZ, 512, 512), generator=gen, device=dev)
    for op in ("diff", "interp"):
        for bc in ("periodic", "fill", "extrapolate"):
            check.compare("shift", f"3d/{op}/{bc}/axis0",
                          k.shift(x3, 0, op, "left", bc, 0.0),
                          k.shift_plain(x3, 0, op, "left", bc, 0.0), exact=True)
    xb = x.to(torch.bfloat16)
    got = k.shift(xb, 1, "interp", "left", "periodic")
    want = k.shift_plain(xb, 1, "interp", "left", "periodic")
    err = (got.float() - want.float()).abs()
    check.max_err["shift"] = max(check.max_err["shift"], float(err.max()))
    if not bool((err <= bf16_ulp(want)).all()):
        raise AssertionError("shift [bf16]: more than one bf16 ulp from the plain version")
    cases = 0
    for (label, shape, axes), dtype, misaligned in itertools.product(
            SHIFT_SHAPES, SHIFT_DTYPES, (False, True)):
        xs = sprinkled(gen, dev, shape, dtype, misaligned)
        if misaligned != (xs.data_ptr() % 16 != 0):
            raise AssertionError(f"shift [{label}]: the view is not as misaligned as asked")
        shift_every_way(check, k, f"{label}{'/misaligned' if misaligned else ''}", xs, axes)
        cases += 1
    check_shift_64bit(check, k, gen, dev)
    log(f"phase 3: shift kernel matches its plain version (bitwise f32/f64 and 16-bit against "
        f"float32 rounded once, 1 ulp bf16 against bf16) on the face, {cases} shape/dtype/"
        f"alignment cases x 32 op/direction/boundary, and the 64-bit routes on "
        f"{len(SHIFT_64BIT)} bf16 views of more than 2^31 elements, aligned and misaligned")


def profile_window(fn, reps, warmup=True, raw=False):
    """(``torch.profiler`` key averages, or with ``raw`` its events, and
    CUDA-event ms per call) of ``reps`` calls of fn, after a warm-up call
    unless ``warmup`` is false.  fn and
    the synchronize raise as they do outside the window; only a failure of
    the profiler itself is logged, and gives None for the averages (the
    profiler is a measurement aid, not a check)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    try:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    except Exception as exc:
        log(f"torch.profiler failed to start: {exc!r}")
        prof = None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    except BaseException:
        if prof is not None:
            with contextlib.suppress(Exception):
                prof.stop()
        raise
    ms = start.elapsed_time(end) / reps
    if prof is None:
        return None, ms
    try:
        prof.stop()
        return (prof.events() if raw else prof.key_averages()), ms
    except Exception as exc:
        log(f"torch.profiler failed: {exc!r}")
        return None, ms


def profiled_ms(fn, names, reps=20):
    """(device ms per call of the kernels whose names hold one of ``names``,
    their launches per call) from ``torch.profiler`` kernel events over
    ``reps`` calls; (None, 0) when the trace holds no device time for
    them."""
    averages, _ = profile_window(fn, reps)
    events = [e for e in averages or () if any(n in e.key for n in names)]
    total_us = sum(e.self_device_time_total for e in events)
    count = sum(e.count for e in events)
    return (total_us / 1e3 / reps if total_us > 0 else None), count / reps


def device_breakdown(fn, reps=3, top=6):
    """(wall ms per call by CUDA events, kernel ms per call, [(kernel, ms per
    call)] of the ``top`` kernels) from one ``torch.profiler`` window of
    ``reps`` calls; the kernels run on one stream, so wall minus kernel time
    is the device's idle time.  None when the profiler gives no device
    time."""
    averages, wall = profile_window(fn, reps)
    events = sorted(averages or (), key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / reps
    if busy <= 0:
        return None
    names = [(e.key.replace("(anonymous namespace)::", "").split("(")[0][-60:],
              e.self_device_time_total / 1e3 / reps)
             for e in events[:top]]
    return wall, busy, names


SHIFT_KERNELS = ("shift_rows", "shift_planes")


def time_shift(check, card, ug):
    """Kernel A's timing: the four 4320^2 f32 configurations beside the
    plain version, the one-call PyTorch equivalent where there is one and
    the profiler's kernel time.  Returns ((ms of the slowest configuration,
    plain ms of diff/left/axis 1), library ms of diff/left/axis 1): the four
    kernel times lie within a few tenths of a microsecond, so which one is
    slowest changes from run to run; the plain and library times come from
    one fixed configuration, where ``torch.diff`` computes the same
    function, whichever that is."""
    from xgcm_tpu_torch.ops.kernels.shift import shift, shift_plain

    # the one PyTorch call for a periodic diff: torch.diff with the wrapped
    # line prepended (left) or appended (right), equal bit for bit
    def torch_diff(x, axis, direction):
        edge = x.narrow(axis, x.shape[axis] - 1 if direction == "left" else 0, 1)
        if direction == "left":
            return lambda: torch.diff(x, dim=axis, prepend=edge)
        return lambda: torch.diff(x, dim=axis, append=edge)

    configs = []
    for op, direction, axis in (("diff", "left", 1), ("diff", "left", 0),
                                ("diff", "right", 1), ("interp", "right", 0)):
        k_ms, p_ms = time_pair(lambda: shift(ug, axis, op, direction, "periodic"),
                               lambda: shift_plain(ug, axis, op, direction, "periodic"), reps=50)
        lib_ms = None
        if op == "diff":
            call = torch_diff(ug, axis, direction)
            check.compare("shift", f"torch.diff/{direction}/axis{axis}", call(),
                          shift(ug, axis, op, direction, "periodic"), exact=True)
            lib_ms, _ = time_pair(call, reps=50)
        prof_ms, per_call = profiled_ms(lambda: shift(ug, axis, op, direction, "periodic"),
                                        SHIFT_KERNELS)
        prof = "not measured" if prof_ms is None else f"{prof_ms:.4f} ms ({per_call:g} a call)"
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"time shift {op}/{direction}/axis{axis} {NY}x{NX} f32: kernel {k_ms:.4f} ms "
            f"(profiler kernel time {prof}), plain {p_ms:.4f} ms, torch.diff {lib} [{card}]")
        configs.append((k_ms, p_ms, lib_ms))
    slowest = max(c[0] for c in configs)
    _, p_ms, lib_ms = configs[0]
    log(f"time shift: slowest of the four {NY}x{NX} configurations {slowest:.4f} ms; "
        f"diff/left/axis1 plain {p_ms:.4f} ms and torch.diff {lib_ms:.4f} ms; bound "
        f"{bound(2 * NY * NX * 4, NY * NX)[0]:.4f} ms [{card}]")
    return (slowest, p_ms), lib_ms


def time_shift_3d(check, card, gen, dev):
    """Kernel A on one face of 50 levels, (50, 4320, 4320) f32, along each
    axis beside the plain version and the bound."""
    from xgcm_tpu_torch.ops.kernels.shift import shift, shift_plain

    # a 3-D tracer gradient on one face, each axis against the plain version
    x3 = torch.randn((NZ, NY, NX), generator=gen, device=dev)
    b3 = bound(2 * x3.numel() * 4, x3.numel())
    for axis in range(3):
        for op, direction, bc in (("diff", "left", "periodic"), ("interp", "right", "extrapolate")):
            got = shift(x3, axis, op, direction, bc)
            want = shift_plain(x3, axis, op, direction, bc)
            for z in range(0, NZ, 10):  # in slices, to bound the comparison's memory
                check.compare("shift", f"3d-face/{op}/{direction}/{bc}/axis{axis}",
                              got[z:z + 10], want[z:z + 10], exact=True)
            del got, want
        k_ms, p_ms = time_pair(lambda: shift(x3, axis, "diff", "left", "periodic"),
                               lambda: shift_plain(x3, axis, "diff", "left", "periodic"), reps=5)
        log(f"time shift diff/left/axis{axis} {NZ}x{NY}x{NX} f32: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {b3[0]:.4f} ms ({b3[1]}) [{card}]")
    del x3
    torch.cuda.empty_cache()


def check_diagnostics(check, u, v, ix, iy):
    """Kernel B at one face in f32, and in bf16 against the plain version
    run in f32 on the same bf16 inputs and rounded once, as the kernel
    does."""
    from xgcm_tpu_torch.ops.kernels import cgrid_diagnostics as k

    for label, got, want in zip(("zeta", "div", "ke"), k.cgrid_diagnostics(u, v, ix, iy),
                                k.cgrid_diagnostics_plain(u, v, ix, iy)):
        check.compare("cgrid_diagnostics", f"f32/{label}", got, want, **TOL_F32)
    bf = [a.to(torch.bfloat16) for a in (u, v, ix, iy)]
    plain = k.cgrid_diagnostics_plain(*(a.float() for a in bf))
    for label, got, want in zip(("zeta", "div", "ke"), k.cgrid_diagnostics(*bf), plain):
        check.compare("cgrid_diagnostics", f"bf16/{label}", got.float(),
                      want.to(torch.bfloat16).float(), **TOL_BF16)
    log("phase 3: cgrid_diagnostics kernel matches its plain version")


def check_interp(check, gen, dev, th, ph, t):
    """Kernel C on 512^2 test columns: shared targets with and without
    edge masking, per-column targets, bf16."""
    from xgcm_tpu_torch.ops.kernels import interp_linear as k

    for mask_edges in (False, True):
        check.compare("interp_linear", f"shared/mask={mask_edges}",
                      k.interp_linear(th, ph, t, mask_edges),
                      k._fused_ref_torch(th, ph, t, mask_edges), **TOL_F32)
    t_cols = torch.sort(
        torch.rand((th.shape[0], N_TARGETS), generator=gen, device=dev) * 28 - 1, -1).values
    check.compare("interp_linear", "per-column targets", k.interp_linear(th, ph, t_cols),
                  k._fused_ref_torch(th, ph, t_cols), **TOL_F32)
    th_b, ph_b, t_b = (a.to(torch.bfloat16) for a in (th, ph, t))
    check.compare("interp_linear", "bf16", k.interp_linear(th_b, ph_b, t_b).float(),
                  k._fused_ref_torch(th_b, ph_b, t_b).float(), **TOL_BF16)
    log("phase 3: interp_linear kernel matches its plain version")


INTERP_CASES = (
    "non-sorted", "nan-knots-inside", "duplicate-knots", "special-targets",
    "descending-nan-ends", "no-flip-check", "all-nan-columns", "n2", "cols15", "cols16",
    "cols17", "cols31", "cols32", "cols33", "cols63", "cols64", "cols65", "lanes-major",
    "sliced-view", "broadcast-phi", "per-column-unsorted-targets", "shared-unsorted-targets",
    "masked-edges",
)


def interp_case(label, gen, dev):
    """Columns built to break an interval search, for kernels C and F: a
    dict of theta (cols, n), four phis (cols, n) (phi 0 with NaN at some
    valid knots), the target ((m,) or (cols, m)), mask_edges, check_flip and
    out_T.  Column counts 15-17, 31-33 and 63-65 straddle the tile sizes
    (16, 32, 64 columns) of ``csrc/interp_linear.cu``."""
    nan, inf = float("nan"), float("inf")

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def mono(cols, n, desc_every=10):
        th = torch.cumsum(rand(cols, n) * (25.0 / n) + 0.01, -1)  # 0 .. ~13
        th[::desc_every] = th[::desc_every].flip(-1)
        return th

    t = torch.linspace(-1.0, 14.0, 36, device=dev)
    mask_edges, check_flip, out_T, cols, n = False, True, False, 200, NZ
    th = phis = None
    if label == "non-sorted":
        # zigzags and inversions (knots 20-23 falling) on a dyadic grid: knot
        # steps 1/2, 1/4 or 1/8, phi in steps of 1/16, targets in steps of
        # 1/32.  Targets match several intervals, and every sum is exact in
        # float32, so the kernel (knot order) and the plain version (its own
        # order) give the same value
        k = torch.arange(n, device=dev)
        steps = 2.0 ** -torch.randint(1, 4, (cols, n), generator=gen, device=dev).float()
        zig = torch.where(k % 10 < 6, 1.0, -1.0)
        inversion = torch.where((k >= 20) & (k < 24), -1.0, 1.0)
        sign = torch.where((torch.arange(cols, device=dev) % 2 == 0)[:, None], zig, inversion)
        th = torch.cumsum(steps * sign, -1) + 2.0
        # ascending but for one swapped pair: the first two valid knots (some
        # after a NaN head), or the last two
        rising = torch.cumsum(steps, -1)
        th[3::8], th[7::8] = rising[3::8], rising[7::8]
        th[3::8, :2] = th[3::8, :2].flip(-1)
        th[7::8, -2:] = th[7::8, -2:].flip(-1)
        th[11::16, :3] = float("nan")
        th[11::16, 3:5] = rising[11::16, 3:5].flip(-1)
        phis = [torch.randint(0, 64, (cols, n), generator=gen, device=dev).float() / 16
                for _ in range(4)]
        t = torch.arange(36, device=dev) * (13 / 32) - 1.0
    elif label == "nan-knots-inside":
        th = mono(cols, n)
        th[::2, 7] = nan
        th[1::3, 20:22] = nan
        th[5::7, n - 2] = nan
    elif label == "duplicate-knots":
        th = torch.round(mono(cols, n) * 2) / 2  # many repeated knots
        t = torch.arange(-1.0, 14.0, 0.5, device=dev)  # every target on the knot grid
    elif label == "special-targets":
        th = mono(cols, n)
        th[0:10, 0] = -inf  # th_min = -inf
        th[10:20, -1] = inf  # th_max = +inf
        th[20:30, 0] = -inf
        th[20:30, 1] = -inf  # two -inf knots
        k = torch.randint(0, n, (cols, 8), generator=gen, device=dev)
        on_knots = torch.gather(th, 1, k)  # targets exactly on a knot
        special = torch.tensor([nan, inf, -inf, 0.0], device=dev).expand(cols, 4)
        t = torch.cat([on_knots, special, rand(cols, 8) * 15 - 1], -1)
    elif label == "descending-nan-ends":
        th = mono(cols, n, desc_every=1)
        th[:, :3] = nan
        th[::2, n - 4:] = nan
        th[1::4, 3:6] = nan  # a longer head
    elif label == "no-flip-check":
        th = mono(cols, n, desc_every=2)  # half descending, taken as ascending
        check_flip = False
    elif label == "all-nan-columns":
        th = mono(130, n)
        th[::5] = nan
    elif label == "n2":
        th = mono(cols, 2) * 6
    elif label.startswith("cols"):
        th = mono(int(label[4:]), n)
    elif label == "lanes-major":
        th = mono(cols, n).T.contiguous().T
        phis = [rand(n, cols).T for _ in range(4)]
        out_T = True
    elif label == "sliced-view":
        th = mono(2 * cols, n + 10)[::2, 5:5 + n]  # column stride 2 (n + 10), knots 1
        phis = [rand(2 * cols, n + 10)[::2, 5:5 + n] for _ in range(4)]
    elif label == "broadcast-phi":
        th = mono(cols, n)
        phis = [rand(cols)[:, None].expand(cols, n) for _ in range(4)]
    elif label == "per-column-unsorted-targets":
        th = mono(cols, n)
        t = rand(cols, 36) * 15 - 1
    elif label == "shared-unsorted-targets":
        th = mono(cols, n)
        t = torch.cat([t, torch.tensor([nan, inf, -inf, 0.0, 13.0], device=dev)])
        t = t[torch.randperm(t.shape[0], generator=gen, device=dev)]
    elif label == "masked-edges":
        th = mono(cols, n)
        th[::4, :5] = nan
        mask_edges = True
    else:
        raise ValueError(f"unknown case {label}")
    if phis is None:
        phis = [rand(*th.shape) for _ in range(4)]
    if phis[0].stride(1) != 0:
        phis[0][::7, th.shape[1] // 2] = nan
    return dict(theta=th, phis=phis, target=t, mask_edges=mask_edges, check_flip=check_flip,
                out_T=out_T)


def interp_multi_exact_inputs(gen, dev, cols=300, n=NZ):
    """Eight phis on a mix of sorted, descending, non-sorted and NaN-knot
    columns (phi NaN at some valid knots), for F against single calls of
    C bit for bit."""
    th = torch.cumsum(torch.rand((cols, n), generator=gen, device=dev) * 0.5 + 0.01, -1)
    th[::10] = th[::10].flip(-1)
    th[1::10] = torch.rand((len(range(1, cols, 10)), n), generator=gen, device=dev) * 13
    th[2::10, 17] = float("nan")
    phis = [torch.rand((cols, n), generator=gen, device=dev) for _ in range(8)]
    phis[3][::9, 20] = float("nan")
    return th, phis, torch.linspace(-1.0, 14.0, 36, device=dev)


def check_interp_cases(check, gen, dev):
    """Kernels C and F on every case of :data:`INTERP_CASES` against their
    plain versions (f32 rtol = atol = 1e-6, bf16 rtol 1e-2 / atol 1e-5,
    identical NaN and infinity footprints), and F bit for bit against V
    single calls of C at V = 2, 4, 8 (f32)."""
    from xgcm_tpu_torch.ops.kernels import interp_linear as k

    for label in INTERP_CASES:
        case = interp_case(label, gen, dev)
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            th, t = case["theta"].to(dtype), case["target"].to(dtype)
            phis = [p.to(dtype) for p in case["phis"]]
            args = (case["mask_edges"], case["check_flip"])
            tag = f"{label}/{dtype}"
            got = k.interp_linear(th, phis[0], t, *args, out_T=case["out_T"])
            got = got.T if case["out_T"] else got
            want = k._fused_multi_ref_torch(th, phis, t, *args)
            check.compare("interp_linear", tag, got.float(), want[0].float(), **tol)
            multi = k.interp_linear_multi(th, phis, t, *args, out_T=case["out_T"])
            for v, (o, w) in enumerate(zip(multi, want)):
                o = o.T if case["out_T"] else o
                check.compare("interp_linear_multi", f"{tag}/var {v}", o.float(), w.float(),
                              **tol)
    th, phis, t = interp_multi_exact_inputs(gen, dev)
    for nv in (2, 4, 8):
        multi = k.interp_linear_multi(th, phis[:nv], t)
        for v, o in enumerate(multi):
            if not torch.equal(o.view(torch.int32), k.interp_linear(th, phis[v], t).view(
                    torch.int32)):
                raise AssertionError(f"interp_linear_multi [V={nv}/var {v}]: not bit for bit "
                                     f"equal to kernel C")
    torch.cuda.synchronize()
    log(f"phase 3: interp_linear and interp_linear_multi match their plain versions on "
        f"{len(INTERP_CASES)} search-breaking cases (f32, bf16); F == V calls of C bit for "
        f"bit at V = 2, 4, 8")


CONSERVATIVE_CASES = (
    "ascending-nan-ends", "descending-nan-ends", "non-sorted", "nan-bound-inside",
    "degenerate-on-edge", "touching", "outside-edges", "infinite-bounds", "nan-data",
    "infinite-data", "all-nan-columns", "n1", "n2", "cols15", "cols16", "cols17", "cols31",
    "cols32", "cols33", "cols63", "cols64", "cols65", "lanes-major", "sliced-view",
)


def conservative_case(label, gen, dev):
    """Columns built to break the walk of kernels G and H: a dict of raw
    bounds theta (cols, n + 1), eight fields (cols, n) (field 0 with NaN at
    some valid cells), the bin edges (m,), out_T, and ``finite`` (cols,),
    the columns whose fractions are finite (no infinite bound).  The edges
    are dyadic (-1 to 13.5 in steps of 1/2), so bounds sit on them exactly;
    column counts 15-17, 31-33 and 63-65 straddle the tile sizes (16, 32, 64
    columns) of ``csrc/conservative.cu``."""
    nan, inf = float("nan"), float("inf")

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def mono(cols, n, desc_every=10):
        th = torch.cumsum(rand(cols, n + 1) * (25.0 / max(n, 1)) + 0.01, -1)  # 0 .. ~13
        if desc_every:
            th[::desc_every] = th[::desc_every].flip(-1)
        return th

    def on_edge(x):  # the nearest edge at or below x
        return torch.floor(x * 2) / 2

    edges = torch.arange(-1.0, 14.0, 0.5, device=dev)
    out_T, cols, n = False, 200, NZ
    th = phis = None
    if label == "ascending-nan-ends":
        th = mono(cols, n, 0)
        th[::2, :3] = nan
        th[1::3, n - 3:] = nan
        th[::5, :9] = nan  # a longer head
        th[3::10, :9] = nan
        th[3::10, 9] = on_edge(th[3::10, 9])  # a head cell degenerate on an edge
    elif label == "descending-nan-ends":
        th = mono(cols, n, 1)
        th[::2, :3] = nan
        th[1::3, n - 3:] = nan
        th[::5, n - 8:] = nan  # a longer tail
        th[3::10, n - 7:] = nan
        th[3::10, n - 8] = on_edge(th[3::10, n - 8])  # a tail cell degenerate on an edge
    elif label == "non-sorted":
        th = mono(cols, n)
        perm = torch.argsort(rand(cols // 2, n + 1), -1)
        th[::2] = torch.gather(th[::2], 1, perm)  # shuffled
        th[1::4, 20:24] = th[1::4, 20:24].flip(-1)  # an inversion
        th[3::8, :2] = th[3::8, :2].flip(-1)  # the first two bounds swapped
        th[7::8, -2:] = th[7::8, -2:].flip(-1)  # the last two
    elif label == "nan-bound-inside":
        th = mono(cols, n)
        th[::2, 7] = nan
        th[1::3, 20:22] = nan
        th[5::7, n - 1] = nan
    elif label == "degenerate-on-edge":
        th = mono(cols, n, 0)
        e = on_edge(th[:, 10:11])  # an edge at or below bound 10
        th[:, :11] = torch.minimum(th[:, :11], e)
        th[:, 11] = e[:, 0]  # cell 10 degenerate exactly on the edge
        th[1::6, :5] = nan  # and head or tail cells degenerate on an edge
        th[1::6, 5] = on_edge(th[1::6, 5])
        th[2::6, 40:] = nan
        th[2::6, 39] = torch.ceil(th[2::6, 39] * 2) / 2
        th[::4] = th[::4].flip(-1)
    elif label == "touching":
        # 30 % of the bounds moved onto an edge, each column sorted again: cells
        # that end on an edge, start on one, or sit on one
        th = mono(cols, n, 0)
        th = torch.where(rand(cols, n + 1) < 0.3, on_edge(th), th)
        th = torch.sort(th, -1).values
        th[::5] = th[::5].flip(-1)
    elif label == "outside-edges":
        th = mono(cols, n)
        th[0::5] = th[0::5] * 0.2 - 5.0  # below the first edge
        th[1::5] = th[1::5] * 0.2 + 14.0  # above the last edge
        th[2::5] = th[2::5] * 1.5 - 3.0  # spanning all edges
        top = th[3::5].nan_to_num(-inf).amax(-1, keepdim=True)
        th[3::5] = th[3::5] - top - 1.0  # ending exactly on the first edge
        bottom = th[4::5].nan_to_num(inf).amin(-1, keepdim=True)
        th[4::5] = th[4::5] - bottom + 13.5  # starting exactly on the last edge
    elif label == "infinite-bounds":
        th = mono(cols, n, 0)
        th[0:10, 0] = -inf  # tmin = -inf: every bin NaN
        th[10:20, -1] = inf  # tmax = +inf: that cell deposits 0
        th[20:30, -2:] = inf  # an [inf, inf] cell: every bin NaN
        th[30:40, :2] = -inf  # a [-inf, -inf] cell
        th[40:50, 0], th[40:50, -1] = -inf, inf
        th[50:60, 0], th[50:60, 1] = nan, -inf  # degenerate at -inf
        th[60:70, -2], th[60:70, -1] = inf, nan  # degenerate at +inf
        th[70:80] = th[70:80].flip(-1)
        th[70:75, 0], th[75:80, -1] = inf, -inf  # descending, infinite ends
        th[80:90, 25] = inf  # an infinite bound inside
    elif label == "nan-data":
        th = mono(cols, n)
        th[::3, :4] = nan
    elif label == "infinite-data":
        th = mono(cols, n)
    elif label == "all-nan-columns":
        th = mono(130, n)
        th[::5] = nan
        th[1::5, :] = nan
        th[1::5, 17] = 4.0  # one valid bound: two cells degenerate on an edge
        th[2::5, :30] = nan
        th[2::5, 31:] = nan
    elif label in ("n1", "n2"):
        n = int(label[1:])
        th = torch.sort(rand(cols, n + 1) * 16 - 2, -1).values
        th[::4] = th[::4].flip(-1)
        th[1::6, 0] = nan
        th[2::6, -1] = nan
        th[3::6, 0] = on_edge(th[3::6, 0])
    elif label.startswith("cols"):
        th = mono(int(label[4:]), n)
    elif label == "lanes-major":
        th = mono(cols, n).T.contiguous().T
        phis = [(rand(n, cols) * 2 - 0.5).T for _ in range(8)]
        out_T = True
    elif label == "sliced-view":
        th = mono(2 * cols, n + 10)[::2, 5:5 + n + 1]  # column stride 2 (n + 11), bounds 1
        phis = [(rand(2 * cols, n + 10) * 2 - 0.5)[::2, 5:5 + n] for _ in range(8)]
    else:
        raise ValueError(f"unknown case {label}")
    if phis is None:
        phis = [rand(th.shape[0], n) * 2 - 0.5 for _ in range(8)]
    phis[0][::7, n // 2] = nan
    if label == "infinite-bounds":  # NaN data in infinite cells: G leaves them out, H not
        phis[0][0:5, 0] = phis[0][20:25, -1] = phis[0][30:35, 0] = nan
        phis[1][50:55, 0] = phis[1][60:65, -1] = nan
    elif label == "nan-data":
        for v, p in enumerate(phis):
            p.masked_fill_(rand(*p.shape) < 0.1 * (v % 4), nan)
        phis[3][::4] = nan  # all-NaN data in a column with valid bounds
    elif label == "infinite-data":
        phis[1][::3, 30] = inf
        phis[2][1::3, 12] = -inf
    return dict(theta=th, phis=phis, edges=edges, out_T=out_T,
                finite=~torch.isinf(th).any(-1))


def check_conservative_case(check, case, dtype):
    """Kernels G (both accumulators) and H (V = 4) on one case of
    :data:`CONSERVATIVE_CASES` against their plain versions (f32 within
    n 2**-24 max column sum |phi|, twice that with reassociate; bf16 within
    one bf16 ulp plus that; identical NaN and infinity footprints), and, in
    f32, H at V = 2, 4, 8 bit for bit equal to V calls of G on the columns
    whose fractions are finite and to its plain version on the rest."""
    from xgcm_tpu_torch.ops.kernels import conservative as kg

    th, edges = case["theta"].to(dtype), case["edges"].to(dtype)
    phis = [p.to(dtype) for p in case["phis"]]
    out_T, finite, n = case["out_T"], case["finite"], phis[0].shape[1]

    def untransposed(outs):
        return [o.T if out_T else o for o in outs]

    def compare(name, label, got, want, p, scale=1.0):
        finite_p = torch.where(torch.isinf(p), 0.0, p.float()).nan_to_num()
        atol = scale * rebin_atol(float(finite_p.abs().sum(-1).max()), n)
        if dtype == torch.float32:
            check.compare(name, label, got, want, atol=atol)
        else:
            within_bf16(check, name, label, got, want, atol)

    plain_g = kg._conservative_plain(th, phis[0], edges)
    for reassociate in (False, True):
        got = untransposed([kg.conservative_rebin(th, phis[0], edges, reassociate, out_T)])[0]
        compare("conservative", f"{dtype}/reassociate={reassociate}", got, plain_g, phis[0],
                2.0 if reassociate else 1.0)
    for v, (o, pl) in enumerate(zip(
            untransposed(kg.conservative_rebin_multi(th, phis[:NV], edges, out_T=out_T)),
            kg._conservative_multi_plain(th, phis[:NV], edges))):
        compare("conservative_multi", f"{dtype}/var {v}", o, pl, phis[v])
    if dtype != torch.float32:
        return
    singles = [kg.conservative_rebin(th, p, edges) for p in phis]
    for nv in (2, 4, 8):
        multi = kg.conservative_rebin_multi(th, phis[:nv], edges)
        plain = kg._conservative_multi_plain(th, phis[:nv], edges)
        for v, (o, s, pl) in enumerate(zip(multi, singles, plain)):
            if not torch.equal(o[finite].view(torch.int32), s[finite].view(torch.int32)):
                raise AssertionError(f"conservative_multi [V={nv}/var {v}]: not bit for bit "
                                     f"equal to kernel G")
            if bool(finite.all()):
                continue
            compare("conservative_multi", f"V={nv}/var {v}/infinite bounds", o[~finite],
                    pl[~finite], phis[v][~finite])


def check_conservative_cases(check, gen, dev):
    """Kernels G and H on every case of :data:`CONSERVATIVE_CASES`, in f32
    and bf16 (:func:`check_conservative_case`)."""
    for label in CONSERVATIVE_CASES:
        case = conservative_case(label, gen, dev)
        for dtype in (torch.float32, torch.bfloat16):
            check_conservative_case(check, case, dtype)
    torch.cuda.synchronize()
    log(f"phase 3: conservative and conservative_multi match their plain versions on "
        f"{len(CONSERVATIVE_CASES)} walk-breaking cases (f32, bf16, both accumulators); "
        f"H == V calls of G bit for bit at V = 2, 4, 8 where the fractions are finite")


def check_main_path(check, gen, dev, outputs, ug, vg, theta, targets):
    """The step's results: shapes, finiteness, the fused diagnostics equal
    to the separate Grid ops, the shifts equal to the roll formulation,
    the remap equal to its plain version on a seeded sample of columns and
    to np.interp, and a small step on the card equal to the CPU's."""
    from xgcm_tpu_torch.entry import step
    from xgcm_tpu_torch.ops.kernels.interp_linear import _fused_ref_torch, interp_linear
    from xgcm_tpu_torch.ops.kernels.shift import shift_plain

    zeta, div, ke_on_theta, d_zeta, d_div, d_ke = outputs
    if zeta.shape != (NY, NX) or div.shape != (NY, NX):
        raise AssertionError("zeta/div have the wrong shape")
    if ke_on_theta.shape != (NY, NX, N_TARGETS) or ke_on_theta.dtype != torch.float32:
        raise AssertionError(f"ke_on_theta is {ke_on_theta.shape} {ke_on_theta.dtype}")
    for label, a in (("zeta", zeta), ("div", div), ("ke_on_theta", ke_on_theta)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label} has non-finite values")
    check.compare("cgrid_diagnostics", "main/zeta", d_zeta, zeta, **TOL_F32)
    check.compare("cgrid_diagnostics", "main/div", d_div, div, **TOL_F32)
    u_c = shift_plain(ug, 1, "interp", "right", "periodic")
    v_c = shift_plain(vg, 0, "interp", "right", "periodic")
    check.compare("cgrid_diagnostics", "main/ke", d_ke, 0.5 * (u_c * u_c + v_c * v_c),
                  **TOL_F32)
    check.compare("shift", "main/zeta", zeta,
                  shift_plain(vg, 1, "diff", "left", "periodic")
                  - shift_plain(ug, 0, "diff", "left", "periodic"), exact=True)
    # KE is constant along each column, so every remapped level equals it
    check.compare("interp_linear", "main/constant columns", ke_on_theta,
                  d_ke[..., None].expand_as(ke_on_theta), **TOL_F32)
    cols = NY * NX
    idx = torch.randperm(cols, generator=gen, device=dev)[:65536]
    th_s = theta.reshape(cols, NZ)[idx]
    ph_s = d_ke.reshape(cols)[idx][:, None].expand(-1, NZ)
    check.compare("interp_linear", "main/sample", ke_on_theta.reshape(cols, -1)[idx],
                  _fused_ref_torch(th_s, ph_s, targets), **TOL_F32)
    # a numpy np.interp oracle on 64 of those columns, with a varying phi
    ph_var = torch.rand((64, NZ), generator=gen, device=dev)
    got = interp_linear(th_s[:64], ph_var, targets).cpu().numpy()
    th_np, ph_np, t_np = th_s[:64].cpu().numpy(), ph_var.cpu().numpy(), targets.cpu().numpy()
    want = np.stack([np.interp(t_np, th_np[i], ph_np[i]) for i in range(64)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    small = [torch.rand((40, 72), generator=gen, device=dev) for _ in range(2)]
    small_th = torch.cumsum(torch.rand((40, 72, 9), generator=gen, device=dev) + 0.01, -1)
    small_t = torch.linspace(0.2, 4.0, 7, device=dev)
    on_card = step(*small, small_th, small_t)
    on_cpu = step(*(a.cpu() for a in small), small_th.cpu(), small_t.cpu())
    for a, b in zip(on_card, on_cpu):
        if not torch.allclose(a.cpu(), b, rtol=1e-6, atol=1e-6):
            raise AssertionError("step on the card disagrees with the step on the CPU")
    torch.cuda.synchronize()
    log("phase 4: main path correct (shapes, finiteness, fused == separate ops, "
        "sampled columns == plain, np.interp oracle, card == CPU)")


def linear_bound(cols, nv, n=NZ, m=N_TARGETS, broadcast_phi=False):
    """Kernels C (nv = 1) and F on (cols, n) columns onto m shared levels:
    theta and the nv phis read once (a phi broadcast along the column, knot
    stride 0 as on the step, one value per column), the targets, the nv
    outputs written once; a merge of the sorted knots and levels needs about
    2 (n + m) compares and 3 m operations per variable for each column."""
    phi_values = 1 if broadcast_phi else n
    nbytes = (cols * (n + nv * phi_values) + m + nv * cols * m) * 4
    return bound(nbytes, cols * (2 * (n + m) + 3 * m * nv))


def conservative_bound(cols, nv, n=NZ, m=N_EDGES):
    """Kernels G (nv = 1) and H on (cols, n + 1) bounds into m - 1 bins:
    the bounds, the nv fields and the edges read once, the nv outputs
    written once; a merge of the sorted bounds and edges touches about
    n + m (cell, bin) overlaps per column at about 8 operations each per
    variable."""
    nbytes = (cols * (n + 1) + nv * cols * n + m + nv * cols * (m - 1)) * 4
    return bound(nbytes, cols * (n + m) * 8 * nv)


def density_columns(gen, dev, cols, n=NZ, nv=NV):
    """(sigma on bounds (cols, n + 1), sigma on centres (cols, n), nv
    fields (cols, n)), float32 on the card.  Potential density minus 1000
    kg/m^3 grows with depth from 24 by 0.01-0.09 a level (at 50 levels); ~10 % of the
    columns are stored upside down (descending), ~10 % end at a sea floor
    (NaN bounds below it), ~5 % have NaN bounds on top, 0.5 % are land (all
    NaN).  The fields are T, S, u, v (a few NaN data at valid levels).  With
    fewer levels the steps grow, so a column always spans about 24 to 26.6."""
    r = torch.rand((cols,), generator=gen, device=dev)
    step = 50 / n  # steps sized so that any column spans what 50 levels span
    sig_b = torch.rand((cols, n + 1), generator=gen, device=dev).mul_(0.08 * step)
    sig_b.add_(0.01 * step)
    sig_b = torch.cumsum(sig_b, -1).add_(24.0)
    desc = r < 0.1
    sig_b[desc] = sig_b[desc].flip(-1)
    k = torch.arange(n + 1, device=dev)
    sig_b.masked_fill_(((r >= 0.1) & (r < 0.2))[:, None] & (k >= n + 1 - 7), float("nan"))
    sig_b.masked_fill_(((r >= 0.2) & (r < 0.25))[:, None] & (k < 5), float("nan"))
    sig_b.masked_fill_((r >= 0.995)[:, None], float("nan"))
    sig_c = (sig_b[:, :-1] + sig_b[:, 1:]).mul_(0.5)
    scales = ((30.0, 0.0), (10.0, 30.0), (1.0, -0.5), (1.0, -0.5))
    fields = [torch.rand((cols, n), generator=gen, device=dev).mul_(a).add_(b)
              for a, b in scales[:nv]]
    fields[0].masked_fill_(((r >= 0.25) & (r < 0.27))[:, None] & (k[:n] == n // 2),
                           float("nan"))
    return sig_b, sig_c, fields


def density_targets(dev):
    """36 bin edges (35 density classes) and 36 density levels, float32;
    about half of the columns reach below the last edge."""
    return (torch.linspace(24.0, 26.6, N_EDGES, device=dev),
            torch.linspace(24.05, 26.55, N_TARGETS, device=dev))


def rebin_atol(col_abs_sum: float, n: int = NZ) -> float:
    """n * 2**-24 * the largest column sum of |phi|: a bound on the rounding
    of n float32 additions taken in another order (kernels G and H against
    their plain version)."""
    return n * 2.0**-24 * col_abs_sum


def within_bf16(check, name, label, got, want, atol):
    """bfloat16 results within one bf16 unit in the last place (plus the
    float32 bound ``atol``) of the plain version: both round once from
    float32 sums that may differ in their last bits."""
    err = (got.float() - want.float()).abs()
    nan_ok = torch.equal(torch.isnan(got), torch.isnan(want))
    err = torch.where(torch.isnan(err), 0.0, err)
    check.max_err[name] = max(check.max_err[name], float(err.max()))
    if not nan_ok or not bool((err <= bf16_ulp(want).nan_to_num(0.0) + atol).all()):
        raise AssertionError(f"{name} [{label}]: beyond one bf16 ulp of the plain version")


def check_density_kernels(check, gen, dev):
    """Kernels G, H and F on 262,144 test columns at the main path's depth
    and widths (50 levels, 36 edges or levels, V = 4): against their plain
    versions, the multi kernels against single calls (G, C), both
    layouts, reassociation, bfloat16, and a degenerate cell exactly on an
    edge.  Returns the inputs, for the timing phase."""
    from xgcm_tpu_torch.ops.kernels import conservative as kg
    from xgcm_tpu_torch.ops.kernels import interp_linear as kc

    cols = 512 * 512
    sig_b, sig_c, phis = density_columns(gen, dev, cols)
    edges, levels = density_targets(dev)
    sig_b[:1000, 10:12] = edges[7]  # degenerate cells on an interior edge
    sums = [float(torch.nan_to_num(p).abs().sum(-1).max()) for p in phis]
    plain = kg._conservative_multi_plain(sig_b, phis, edges)
    for reassociate in (False, True):
        check.compare("conservative", f"f32/reassociate={reassociate}",
                      kg.conservative_rebin(sig_b, phis[0], edges, reassociate), plain[0],
                      atol=2 * rebin_atol(sums[0]))
    lanes = kg.conservative_rebin(sig_b.T.contiguous().T, phis[0].T.contiguous().T, edges,
                                  out_T=True)
    check.compare("conservative", "lanes-major", lanes.T, plain[0], atol=rebin_atol(sums[0]))
    bf = [a.to(torch.bfloat16) for a in (sig_b, phis[0], edges)]
    within_bf16(check, "conservative", "bf16", kg.conservative_rebin(*bf),
                kg._conservative_plain(*bf), rebin_atol(sums[0]))
    multi = kg.conservative_rebin_multi(sig_b, phis, edges)
    for v, (o, pl) in enumerate(zip(multi, plain)):
        check.compare("conservative_multi", f"var {v} vs plain", o, pl, atol=rebin_atol(sums[v]))
        check.compare("conservative_multi", f"var {v} vs kernel G", o,
                      kg.conservative_rebin(sig_b, phis[v], edges), atol=rebin_atol(sums[v]))
    del plain, multi
    lin_plain = kc._fused_multi_ref_torch(sig_c, phis, levels, True)
    lin = kc.interp_linear_multi(sig_c, phis, levels, True)
    for v, (o, pl) in enumerate(zip(lin, lin_plain)):
        check.compare("interp_linear_multi", f"var {v} vs plain", o, pl, **TOL_F32)
        check.compare("interp_linear_multi", f"var {v} vs kernel C", o,
                      kc.interp_linear(sig_c, phis[v], levels, True), **TOL_F32)
    bf = [a.to(torch.bfloat16) for a in (sig_c, *phis[:2], levels)]
    for o, pl in zip(kc.interp_linear_multi(bf[0], bf[1:3], bf[3]),
                     kc._fused_multi_ref_torch(bf[0], bf[1:3], bf[3])):
        check.compare("interp_linear_multi", "bf16", o.float(), pl.float(), **TOL_BF16)
    torch.cuda.synchronize()
    log("phase 3: conservative (G), conservative_multi (H) and interp_linear_multi (F) "
        "kernels match their plain versions and single calls")
    return sig_b, sig_c, phis, edges, levels


def walk_lengths(sig_b, edges):
    """The cells the walk of kernels G and H visits per bin on sorted
    columns: those that overlap the bin, plus the one that stops the walk;
    and the share of lanes busy when a warp's 32 lanes take 32 consecutive
    (column, bin) items and wait for the longest walk.  Returns (mean
    visits per bin, lane share)."""
    tmin = torch.fmin(sig_b[:, :-1], sig_b[:, 1:])[:, None, :]
    tmax = torch.fmax(sig_b[:, :-1], sig_b[:, 1:])[:, None, :]
    visits = ((tmin <= edges[1:, None]) & (tmax >= edges[:-1, None])).sum(-1) + 1
    lanes = visits.reshape(-1)[:visits.numel() // 32 * 32].reshape(-1, 32).float()
    return float(visits.float().mean()), float(lanes.mean() / lanes.amax(1).mean())


def rows(*tensors, step=540):
    """Slices of 540 rows of each (NY, ...) tensor, so that comparisons in
    float64 hold a few hundred MB at a time."""
    for r in range(0, tensors[0].shape[0], step):
        yield tuple(t[r:r + step] for t in tensors)


def check_conservation(label, out, phi, sig_b, edges):
    """Per column whose valid bounds all lie inside the bins: the sum of
    the bins (float64) equals the sum of phi over the valid cells within
    (n + m) * 2**-24 * sum |phi| (each bin sums at most n float32 terms,
    and each split cell is rounded in two bins).  A degenerate cell (one
    NaN bound) exactly on an interior edge counts into both bins, as the
    reference does, so its column is left out.  Returns the columns
    checked, those left out for that reason, and the worst relative
    error."""
    lo, hi = float(edges[0]), float(edges[-1])
    checked, on_edge, worst = 0, 0, 0.0
    for o, p, b in rows(out, phi, sig_b):
        t1, t2 = b[..., :-1], b[..., 1:]
        n1, n2 = torch.isnan(t1), torch.isnan(t2)
        valid = ~(n1 & n2) & ~torch.isnan(p)
        want = torch.where(valid, p, 0.0).double().sum(-1)
        abs_sum = torch.where(valid, p.abs(), 0.0).double().sum(-1)
        bn = torch.isnan(b)
        inside = ((torch.where(bn, lo, b) >= lo).all(-1) & (torch.where(bn, hi, b) <= hi).all(-1)
                  & valid.any(-1))
        point = torch.where(n1, t2, t1)  # where a degenerate cell sits
        twice = (valid & (n1 ^ n2) & torch.isin(point, edges[1:-1])).any(-1)
        on_edge += int((inside & twice).sum())
        inside &= ~twice
        err = (torch.nansum(o.double(), -1) - want).abs()
        if not bool((err <= (NZ + N_EDGES) * 2.0**-24 * abs_sum)[inside].all()):
            raise AssertionError(f"{label}: a column's bins do not sum to its total")
        checked += int(inside.sum())
        rel = (err / abs_sum.clamp_min(1e-30))[inside]
        worst = max(worst, float(rel.max()) if rel.numel() else 0.0)
    if checked < NY * NX // 10:
        raise AssertionError(f"{label}: only {checked} columns lie inside the bins")
    return checked, on_edge, worst


def check_finite(label, out):
    """No infinities; a NaN only where no data reach (more than half of the
    values finite)."""
    finite = 0
    for (o,) in rows(out):
        if bool(torch.isinf(o).any()):
            raise AssertionError(f"{label}: infinite values")
        finite += int(torch.isfinite(o).sum())
    if finite < out.numel() // 2:
        raise AssertionError(f"{label}: only {finite} of {out.numel()} values are finite")
    return finite / out.numel()


def density_grid(xtt, nz=NZ, dataset=None):
    """A Grid with one vertical axis: centres zc and bounds (outer) zo, built
    from ``dataset`` (``xtt.Dataset`` by default, or ``xr.Dataset``)."""
    ds = (dataset or xtt.Dataset)(coords={"zc": ("zc", np.arange(nz) + 0.5),
                             "zo": ("zo", np.arange(nz + 1.0))})
    return xtt.Grid(ds, coords={"Z": {"center": "zc", "outer": "zo"}}, periodic=False,
                    autoparse_metadata=False)


def density_calls(grid, das, sb, sc, edges, levels):
    """The density-space analysis through the Grid API, one call per
    kernel: one field into 35 classes (G), the four into the same classes
    (H), the four onto 36 levels (F)."""
    return {
        "conservative": lambda: [grid.transform(das[0], "Z", edges, target_data=sb,
                                                method="conservative")],
        "conservative_multi": lambda: grid.transform_multi(das, "Z", edges, target_data=sb,
                                                           method="conservative"),
        "interp_linear_multi": lambda: grid.transform_multi(das, "Z", levels, target_data=sc),
    }


def run_counted(name, call, build, dev):
    """``call()`` with the launch counts set to 0 just before it and read
    just after; fails unless kernel ``name`` launched.  Returns (outputs,
    launches of ``name``, host-clock ms, peak device GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = call()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    count = build.launch_counts()[name]
    if count < 1:
        raise AssertionError(f"the density path launched {name} {count} times")
    return outs, count, ms, torch.cuda.max_memory_allocated(dev) / 1e9


def check_density_outputs(check, name, outs, sig_b, sig_c, fields, edges, levels, idx):
    """One density call's results at one face: dims, shapes, finiteness,
    conservation (conservative), the outputs against single kernel calls
    (G for H, C for F), and the sampled columns against the plain
    version."""
    from xgcm_tpu_torch.ops.kernels import conservative as kg
    from xgcm_tpu_torch.ops.kernels import interp_linear as kc

    cols = NY * NX
    linear = name == "interp_linear_multi"
    m = N_TARGETS if linear else N_EDGES - 1
    for o in outs:
        if o.dims != ("y", "x", "sigma") or o.shape != (NY, NX, m) or o.dtype != torch.float32:
            raise AssertionError(f"{name} output is {o.dims} {o.shape} {o.dtype}")
    shares = [round(check_finite(f"{name} var {v}", o.data), 4) for v, o in enumerate(outs)]
    b2, c2 = sig_b.reshape(cols, NZ + 1), sig_c.reshape(cols, NZ)
    f2 = [f.reshape(cols, NZ) for f in fields[:len(outs)]]
    sums = [NZ * float(torch.nan_to_num(f).abs().max()) for f in f2]
    conserved = []
    if not linear:
        conserved = [check_conservation(f"{name} var {v}", o.data, fields[v], sig_b, edges)
                     for v, o in enumerate(outs)]
    if name != "conservative":
        for v, (o, f) in enumerate(zip(outs, f2)):
            if linear:
                single = kc.interp_linear(c2, f, levels, True)
                tol = TOL_F32
            else:
                single = kg.conservative_rebin(b2, f, edges)
                tol = dict(atol=rebin_atol(sums[v]))
            for a, b in rows(o.data, single.reshape(NY, NX, m)):
                check.compare(name, f"main/var {v} vs single kernel", a, b, **tol)
            del single
    if linear:
        plain = kc._fused_multi_ref_torch(c2[idx], [f[idx] for f in f2], levels, True)
    else:
        plain = kg._conservative_multi_plain(b2[idx], [f[idx] for f in f2], edges)
    for v, (o, pl) in enumerate(zip(outs, plain)):
        tol = TOL_F32 if linear else dict(atol=rebin_atol(sums[v]))
        check.compare(name, f"main/sample var {v}", o.data.reshape(cols, m)[idx], pl, **tol)
    torch.cuda.synchronize()
    log(f"phase 6: {name} correct: finite shares {shares}; conservation (columns checked, "
        f"left out for a degenerate cell on an edge, worst relative error) {conserved}; "
        f"{'V single kernel calls and ' if name != 'conservative' else ''}"
        f"{SAMPLE} sampled columns == plain")


def check_density_small(gen, dev, xtt):
    """The density calls on a small grid on the card against the same calls
    on the CPU."""
    sb_s, sc_s, fs = density_columns(gen, dev, 40 * 72, n=12)
    e_s = torch.linspace(24.0, 26.6, 11, device=dev)
    l_s = torch.linspace(24.05, 26.55, 9, device=dev)

    def small(d):
        das = [xtt.GriddedArray(f.reshape(40, 72, 12).to(d), ("y", "x", "zc"), name=f"v{i}")
               for i, f in enumerate(fs)]
        sb = xtt.GriddedArray(sb_s.reshape(40, 72, 13).to(d), ("y", "x", "zo"), name="sigma")
        sc = xtt.GriddedArray(sc_s.reshape(40, 72, 12).to(d), ("y", "x", "zc"), name="sigma")
        calls = density_calls(density_grid(xtt, 12), das, sb, sc, e_s.to(d), l_s.to(d))
        return [o for call in calls.values() for o in call()]

    for a, b in zip(small(dev), small(torch.device("cpu"))):
        if a.dims != b.dims or a.data.device.type != dev.type:
            raise AssertionError("density path on the card: wrong dims or device")
        if not torch.allclose(a.data.cpu(), b.data, rtol=1e-5, atol=1e-5, equal_nan=True):
            raise AssertionError("density path on the card disagrees with the CPU")
    log("phase 6: the density calls on a 40 x 72 x 12 grid on the card == on the CPU")


def check_vorticity(check, u, v, ix, iy):
    """Kernel D at one face in f32 (rtol = atol = 1e-6: nvcc contracts the
    products into FMAs), and in bf16 within one bf16 ulp of the plain
    version, which computes in f32 and rounds once, as the kernel does."""
    from xgcm_tpu_torch.ops.kernels import vorticity as k

    check.compare("vorticity", "f32", k.vorticity(u, v, ix, iy),
                  k.vorticity_plain(u, v, ix, iy), **TOL_F32)
    bf = [a.to(torch.bfloat16) for a in (u, v, ix, iy)]
    within_bf16(check, "vorticity", "bf16", k.vorticity(*bf), k.vorticity_plain(*bf), 0.0)
    log("phase 3: vorticity kernel matches its plain version (f32 1e-6, 1 ulp bf16)")


def edge_nonfinite(a):
    """NaN, +inf and -inf on a few face-edge cells of (..., 13, n, n) data,
    in place: the halo sources of the X-left, Y-right, X-right and Y-left
    edges of faces 0, 6, 9 and 12."""
    n = a.shape[-1]
    a[..., 0, 5, 0] = float("nan")
    a[..., 6, n - 1, 9] = float("inf")
    a[..., 9, 3, n - 1] = -float("inf")
    a[..., 12, 0, n - 3] = float("nan")
    return a


def compare_by_face(check, name, label, got, want, **tol):
    """``check.compare`` one face at a time (a few hundred MB of float64
    at once at LLC4320)."""
    for f, (a, b) in enumerate(zip(got.unbind(-3), want.unbind(-3))):
        check.compare(name, f"{label}/face {f}", a, b, **tol)


def check_face_shift(check, gen, dev):
    """Kernel E: every op x direction x axis, f32 and bf16 bit for bit
    against the plain version (bf16 against the plain version computed in
    f32 and rounded once, as the kernel does), at one LLC4320 level (13 x
    4320^2) and at a small batched shape (2, 13, 48, 48), with NaN and
    infinities on face edges and in the halo."""
    from xgcm_tpu_torch.ops.kernels import face_shift as k

    for shape in ((N_FACES, NY, NX), (2, N_FACES, 48, 48)):
        x = edge_nonfinite(torch.randn(shape, generator=gen, device=dev))
        halo = torch.randn(shape[:-1], generator=gen, device=dev)
        halo[..., 2, 11], halo[..., 5, 0] = float("nan"), float("inf")
        for dtype in (torch.float32, torch.bfloat16):
            xd, hd = x.to(dtype), halo.to(dtype)
            for op, direction, axis_is_x in itertools.product(
                    ("diff", "interp", "min", "max"), ("left", "right"), (True, False)):
                label = f"{tuple(shape)}/{dtype}/{op}/{direction}/{'x' if axis_is_x else 'y'}"
                got = k.face_shift(xd, hd, op, direction, axis_is_x)
                want = k.face_shift_plain(xd.float(), hd.float(), op, direction,
                                          axis_is_x).to(dtype)
                if got.dtype != dtype:
                    raise AssertionError(f"face_shift [{label}]: returned {got.dtype}")
                compare_by_face(check, "face_shift", label, got, want, exact=True)
                del got, want
        del x, halo, xd, hd
    # the axis= form of the ring route (phase 11): one shard's block of
    # 50 levels of a face along each of its axes, aligned and misaligned
    shape = (NZ, NY, NX // N_SHARDS)
    for misaligned, axis in itertools.product((False, True), range(3)):
        x = sprinkled(gen, dev, shape, torch.float32, misaligned)
        hshape = shape[:axis] + shape[axis + 1:]
        halo = sprinkled(gen, dev, hshape, torch.float32, misaligned)
        for op, direction in itertools.product(SHIFT_OPS, ("left", "right")):
            label = f"{shape}/axis={axis}/{op}/{direction}/{'mis' if misaligned else ''}aligned"
            got = k.face_shift(x, halo, op, direction, axis=axis)
            want = k.face_shift_plain(x, halo, op, direction, axis=axis)
            compare_by_face(check, "face_shift", label, got, want, exact=True)
            del got, want
        del x, halo
    torch.cuda.synchronize()
    log("phase 3: face_shift kernel matches its plain version (bitwise f32 and bf16, "
        "13 x 4320^2 and (2, 13, 48, 48); its axis= form bitwise f32 on a "
        f"{shape} block along axes 0, 1 and 2, aligned and misaligned)")


def face_analysis(grid, xtt, th, u, v, lead=()):
    """The face analysis of examples/llc_analysis.py and docs/llc_example.md
    on theta (face, y, x), u (face, y, xl) and v (face, yl, x): each call a
    length-preserving pair, so each runs kernel E once (eight launches)."""
    t = xtt.GriddedArray(th, lead + ("face", "y", "x"), name="theta")
    gu = xtt.GriddedArray(u, lead + ("face", "y", "xl"), name="u")
    gv = xtt.GriddedArray(v, lead + ("face", "yl", "x"), name="v")
    out = {
        "dtheta_dx": grid.diff(t, "X"),  # (face, y, xl)
        "dtheta_dy": grid.diff(t, "Y"),  # (face, yl, x)
        # vorticity on (face, yl, xl)
        "zeta": grid.diff({"X": gv}, "X", other_component={"Y": gu})
        - grid.diff({"Y": gu}, "Y", other_component={"X": gv}),
        # divergence on (face, y, x)
        "div": grid.diff({"X": gu}, "X", other_component={"Y": gv})
        + grid.diff({"Y": gv}, "Y", other_component={"X": gu}),
    }
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        vec = grid.interp_2d_vector({"X": gu, "Y": gv}, to="center")
    out["u_c"], out["v_c"] = vec["X"], vec["Y"]
    return out


def face_generic(grid, xtt, th, u, v):
    """The same results from the generic engine: the GridUFuncs of
    ``core/gridops`` called directly, whose halos come from
    ``core.padding._pad_face_connections``; one callable per result."""
    from xgcm_tpu_torch.core import gridops as go

    t = xtt.GriddedArray(th, ("face", "y", "x"), name="theta")
    gu = xtt.GriddedArray(u, ("face", "y", "xl"), name="u")
    gv = xtt.GriddedArray(v, ("face", "yl", "x"), name="v")

    def vec(fn, a, axis, partner, p_axis):
        return fn(grid, {axis: a}, axis=[(axis,)], other_component={p_axis: partner})

    return {
        "dtheta_dx": lambda: go.diff_center_to_left(grid, t, axis=[("X",)]),
        "dtheta_dy": lambda: go.diff_center_to_left(grid, t, axis=[("Y",)]),
        "zeta": lambda: vec(go.diff_center_to_left, gv, "X", gu, "Y")
        - vec(go.diff_center_to_left, gu, "Y", gv, "X"),
        "div": lambda: vec(go.diff_left_to_center, gu, "X", gv, "Y")
        + vec(go.diff_left_to_center, gv, "Y", gu, "X"),
        "u_c": lambda: vec(go.interp_left_to_center, gu, "X", gv, "Y"),
        "v_c": lambda: vec(go.interp_left_to_center, gv, "Y", gu, "X"),
    }


def check_face_small(gen, dev, xtt):
    """The face analysis on a small LLC grid (n = 48) with a leading batch
    dim of 3 on the card against the same calls on the CPU, value for
    value."""
    _, grid = xtt.grids.llc_grid(n=48)
    th, u, v = (edge_nonfinite(torch.randn((3, N_FACES, 48, 48), generator=gen, device=dev))
                for _ in range(3))
    on_card = face_analysis(grid, xtt, th, u, v, lead=("time",))
    on_cpu = face_analysis(grid, xtt, th.cpu(), u.cpu(), v.cpu(), lead=("time",))
    for name, a in on_card.items():
        b = on_cpu[name]
        if a.dims != b.dims or a.data.device.type != dev.type:
            raise AssertionError(f"face analysis on the card: {name} has wrong dims or device")
        if not same_values(a.data.cpu(), b.data):
            raise AssertionError(f"face analysis on the card: {name} differs from the CPU")
    log("phase 8: the face analysis on a (3, 13, 48, 48) LLC grid on the card == on the CPU")


# ---- phase 9: the metric path ------------------------------------------------
METRIC_SMALL = (12, 40, 72)  # (nz, ny, nx) of the card-against-CPU check


def budget_grid(xtt, nx, ny, nz, dtype=np.float32, dataset=None):
    """The grid of ``build_grid`` in examples/tracer_budget.py: dx/dy/dz
    metrics at both positions of each axis, X and Y periodic, Z ``fill``
    with 0; metrics in ``dtype`` (LLC4320's grid files are float32); built
    from ``dataset`` (``xtt.Dataset`` by default, or ``xr.Dataset``)."""
    ds = (dataset or xtt.Dataset)(coords={
        "xc": ("xc", np.arange(nx) + 0.5), "xg": ("xg", np.arange(nx) * 1.0),
        "yc": ("yc", np.arange(ny) + 0.5), "yg": ("yg", np.arange(ny) * 1.0),
        "zc": ("zc", np.arange(nz) + 0.5), "zg": ("zg", np.arange(nz) * 1.0),
        "dx_c": ("xc", (1.0 + 0.1 * np.sin(np.arange(nx))).astype(dtype)),
        "dx_g": ("xg", (1.0 + 0.1 * np.sin(np.arange(nx) - 0.5)).astype(dtype)),
        "dy_c": ("yc", (1.0 + 0.05 * np.cos(np.arange(ny))).astype(dtype)),
        "dy_g": ("yg", (1.0 + 0.05 * np.cos(np.arange(ny) - 0.5)).astype(dtype)),
        "dz_c": ("zc", (1.0 + 0.2 * np.arange(nz) / nz).astype(dtype)),
        "dz_g": ("zg", (1.0 + 0.2 * (np.arange(nz) - 0.5) / nz).astype(dtype)),
    })
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return xtt.Grid(
            ds,
            coords={"X": {"center": "xc", "left": "xg"}, "Y": {"center": "yc", "left": "yg"},
                    "Z": {"center": "zc", "left": "zg"}},
            boundary={"X": "periodic", "Y": "periodic", "Z": "fill"},
            fill_value=0.0,
            metrics={("X",): ["dx_c", "dx_g"], ("Y",): ["dy_c", "dy_g"],
                     ("Z",): ["dz_c", "dz_g"]},
            autoparse_metadata=False,
        )


def budget_inputs(xtt, gen, dev, nz, ny, nx):
    """theta, u, v and w of examples/tracer_budget.py on the card, w = 0 on
    the surface face."""
    def field(dims, offset=0.0, uniform=False):
        make = torch.rand if uniform else torch.randn
        return xtt.GriddedArray(make((nz, ny, nx), generator=gen, device=dev).add_(offset),
                                dims)

    theta = field(("zc", "yc", "xc"), 20.0, uniform=True)
    u, v = field(("zc", "yc", "xg")), field(("zc", "yg", "xc"))
    w = field(("zg", "yc", "xc"))
    w.data[0] = 0.0
    return theta, u, v, w


def budget_terms(grid, theta, u, v, w):
    """``budget_terms`` of examples/tracer_budget.py on the port: the
    advective flux divergence, the cell volumes and the tendency.  Each
    tracer interpolate and flux is dropped once it is used, so that a 50 x
    4320 x 4320 level set fits the card; the arithmetic is the example's."""
    # the tracer on the three face families, times the transport and the
    # face area from the metric registry
    th_x = grid.interp(theta, "X")
    fx = u * th_x * grid.get_metric(th_x, ("Y", "Z"))
    del th_x
    th_y = grid.interp(theta, "Y")
    fy = v * th_y * grid.get_metric(th_y, ("X", "Z"))
    del th_y
    th_z = grid.interp(theta, "Z", boundary="extend")
    fz = w * th_z * grid.get_metric(th_z, ("X", "Y"))
    del th_z
    # divergence back on the centres; the vertical fill_value=0 is the
    # closed budget's "no flux through the surface and bottom"
    div = grid.diff(fx, "X", to="center")
    del fx
    div = div + grid.diff(fy, "Y", to="center")
    del fy
    div = div + grid.diff(fz, "Z", to="center")
    del fz
    vol = grid.get_metric(theta, ("X", "Y", "Z"))
    return div, vol, -div / vol


def budget_closure(grid, tendency):
    """|integral of the tendency| / integral of |tendency| over the
    volume, which the flux form makes 0 up to rounding."""
    total = grid.integrate(tendency, ["X", "Y", "Z"])
    scale = grid.integrate(abs(tendency), ["X", "Y", "Z"])
    return abs(float(total.data)) / float(scale.data)


def calculus_calls(grid, theta):
    """BASELINE.json config 3 on a MITgcm C-grid: name -> (call, launches of
    kernel A its route implies).  Each diff or interp on float data is one
    launch; a metric away from the result's position adds one for
    ``interp_like`` (condition 2 of ``get_metric``)."""
    return {
        # dxC lies on YC, which the X difference keeps
        "derivative X": (lambda: grid.derivative(theta, "X"), 1),
        # the Y and Z differences leave YC and Z: dyC and drF are interpolated
        "derivative Y": (lambda: grid.derivative(theta, "Y"), 2),
        "derivative Z": (lambda: grid.derivative(theta, "Z"), 2),
        "integrate X,Y": (lambda: grid.integrate(theta, ["X", "Y"]), 0),
        "average X,Y": (lambda: grid.average(theta, ["X", "Y"]), 0),
        "integrate Z": (lambda: grid.integrate(theta, "Z"), 0),
        "cumint Z": (lambda: grid.cumint(theta, "Z", to="outer"), 0),
        # theta * rA, interpolated, over rA interpolated to the result
        "interp X metric_weighted X,Y": (
            lambda: grid.interp(theta, "X", metric_weighted=["X", "Y"]), 2),
        "cumsum X": (lambda: grid.cumsum(theta, "X"), 0),
    }


SUMS = ("integrate X,Y", "average X,Y", "integrate Z")


def check_budget_sums(check, grid, tendency):
    """The weighted sums of the budget's closure on the card: the kernel
    against its plain version on the tendency and the grid's factors of the
    volume (float32, the route ``Grid.integrate`` takes), within 1e-6
    relative, for the tendency and its magnitude.  Returns (kernel call,
    plain call, bound) of the whole-volume sum for timing."""
    from xgcm_tpu_torch.core.grid import _fused_factors
    from xgcm_tpu_torch.ops.kernels.weighted_sum import weighted_sum, weighted_sum_plain

    axes = ["X", "Y", "Z"]
    metric, interpolated = grid._find_metric(tendency, axes)
    dims = grid._get_dims_from_axis(tendency, axes)
    factors = _fused_factors(tendency, metric, interpolated, dims, {})
    if factors is None:
        raise AssertionError("the budget's integrals do not take the weighted-sum kernel")
    x, n = tendency.data, len(dims)
    for label, data in (("tendency", x), ("|tendency|", x.abs())):
        got, want = weighted_sum(data, factors, n), weighted_sum_plain(data, factors, n)
        check.compare("weighted_sum", f"budget {label}", got.reshape(1), want.reshape(1),
                      rtol=1e-6)
        del data
    nbytes = (x.numel() + sum(f.numel() for f in factors)) * 4
    return (lambda: weighted_sum(x, factors, n), lambda: weighted_sum_plain(x, factors, n),
            bound(nbytes, (len(factors) + 1) * x.numel()))


def check_metric_small(gen, dev, xtt):
    """The budget and the calculus on a small grid on the card against the
    same calls on the CPU: the shifts, products and prefix sums value for
    value, the reductions within 1e-6 relative (another summation order)."""
    nz, ny, nx = METRIC_SMALL
    theta, u, v, w = budget_inputs(xtt, gen, dev, nz, ny, nx)
    theta.data[3, 5, 7] = float("nan")
    mit = {d: xtt.grids.mitgcm_c_grid(nx=nx, ny=ny, nz=nz)[1] for d in ("card", "cpu")}

    def run(where, d):
        ins = [a if where == "card" else xtt.GriddedArray(a.data.cpu(), a.dims)
               for a in (theta, u, v, w)]
        grid = budget_grid(xtt, nx, ny, nz)
        out = dict(zip(("div", "vol", "tendency"), budget_terms(grid, *ins)))
        th = xtt.GriddedArray(ins[0].data, ("Z", "YC", "XC"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for name, (call, _) in calculus_calls(mit[where], th).items():
                out[name] = call()
        return out

    on_card, on_cpu = run("card", dev), run("cpu", torch.device("cpu"))
    for name, a in on_card.items():
        b = on_cpu[name]
        if a.dims != b.dims or a.dtype != b.dtype or a.data.device.type != dev.type:
            raise AssertionError(f"metric path on the card: {name} has wrong dims, dtype or "
                                 f"device")
        got = a.data.cpu()
        if name in SUMS:
            ok = torch.allclose(got, b.data, rtol=1e-6, atol=0.0, equal_nan=True)
        else:
            ok = same_values(got, b.data)
        if not ok:
            raise AssertionError(f"metric path on the card: {name} differs from the CPU")
    log(f"phase 9: the budget and the calculus on a {nz} x {ny} x {nx} grid on the card == on "
        f"the CPU (sums within 1e-6 relative, the rest value for value)")


def check_identities(grid, theta, ds):
    """The calculus identities at full width on the MITgcm grid: the
    integral of ones is the area, the mean of a constant is the constant,
    the last level of cumint to the outer position is the integral, the X
    derivative of a field linear in X is 1 away from the wrap, and NaN
    cells are skipped by integrate and average."""
    xtt_ga = type(theta)
    dev = theta.data.device
    ny, nx = theta.shape[1:]
    ra = torch.as_tensor(ds["rA"].values, device=dev)

    def rel(a, b):
        return float(((a - b).abs() / b.abs()).max())

    ones = xtt_ga(torch.ones((ny, nx), device=dev), ("YC", "XC"))
    errs = {"area": rel(grid.integrate(ones, ["X", "Y"]).data, ra.sum())}
    const = xtt_ga(torch.full(theta.shape, 7.25, device=dev), theta.dims)
    errs["mean of a constant"] = rel(grid.average(const, ["X", "Y"]).data,
                                     torch.tensor(7.25, dtype=torch.float64, device=dev))
    del const
    last = grid.cumint(theta, "Z", to="outer").isel({"Zp1": -1})
    errs["cumint last level"] = rel(last.data, grid.integrate(theta, "Z").data)
    del last
    dxc = torch.as_tensor(ds["dxC"].values, device=dev)
    ramp = xtt_ga(torch.arange(nx, device=dev, dtype=torch.float64)[None, :] * dxc[:, None],
                  ("YC", "XC"))
    slope = grid.derivative(ramp, "X").data[:, 1:]
    errs["linear ramp"] = float((slope - 1.0).abs().max())
    del ramp, slope
    for name, err in errs.items():
        if not err < 1e-6:  # also fails on NaN
            raise AssertionError(f"phase 9 identity '{name}': error {err:.3e}")
    holes = theta.data.clone()
    holes[::7, ::97, ::89] = float("nan")
    zeros = torch.nan_to_num(holes, nan=0.0)
    with_nan = xtt_ga(holes, theta.dims)
    i_nan = grid.integrate(with_nan, ["X", "Y"]).data
    i_zero = grid.integrate(xtt_ga(zeros, theta.dims), ["X", "Y"]).data
    valid = xtt_ga((~torch.isnan(holes)).float(), theta.dims)
    a_nan = grid.average(with_nan, ["X", "Y"]).data
    a_want = i_nan / grid.integrate(valid, ["X", "Y"]).data
    del holes, zeros, with_nan, valid
    if not (torch.isfinite(i_nan).all() and torch.isfinite(a_nan).all()
            and rel(i_nan, i_zero) < 1e-12 and rel(a_nan, a_want) < 1e-12):
        raise AssertionError("phase 9: NaN cells are not skipped by integrate/average")
    log("phase 9: identities at full width hold (largest relative error " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()) + "; NaN cells skipped by integrate and "
        "average)")


def kernel_class(name: str) -> str:
    """The class of a profiler event: kernel A, elementwise, reduction, a
    copy from or to the host, another copy, or other."""
    if any(k in name for k in SHIFT_KERNELS):
        return "kernel A"
    if "Memcpy HtoD" in name:
        return "Memcpy HtoD"
    if "Memcpy DtoH" in name:
        return "Memcpy DtoH"
    if "Memcpy" in name or "Memset" in name:
        return "copies"
    if "reduce_kernel" in name:
        return "reductions"
    if "elementwise" in name:
        return "elementwise"
    return "other"


def budget_breakdown(fn, reps=3):
    """(wall ms, {class: device ms}) per call of fn from one profiler
    window; None when the profiler gives no device time."""
    averages, wall = profile_window(fn, reps)
    split = {}
    for e in averages or ():
        if e.self_device_time_total > 0:
            c = kernel_class(e.key)
            split[c] = split.get(c, 0.0) + e.self_device_time_total / 1e3 / reps
    return (wall, split) if split else None


def metric_phase(xtt, build, gen, dev, card, report, nz=NZ, ny=NY, nx=NX):
    """Phase 9: the tracer budget of examples/tracer_budget.py and the
    metric-weighted calculus on a MITgcm C-grid, at one LLC4320 face of nz
    levels, with the launch counts of kernel A and the weighted sum their
    routes imply, the weighted sum against its plain version, the card
    against the CPU at a small size, the identities at full width, their
    times, peak memory and the profiler's split of the budget.  The weighted
    sum's row of the kernel report goes into ``report``: (check, launches,
    times, bounds)."""
    check, launches, times, bounds = report
    # (a) the tracer budget; about 9 fields of nz x ny x nx f32 are live
    # at its peak (the four inputs, three fluxes, two temporaries)
    grid = budget_grid(xtt, nx, ny, nz)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)  # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats(dev)
    theta, u, v, w = budget_inputs(xtt, gen, dev, nz, ny, nx)
    gb = theta.data.numel() * 4 / 1e9
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    div, vol, tendency = budget_terms(grid, theta, u, v, w)
    closure = budget_closure(grid, tendency)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = build.launch_counts()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    log(f"phase 9: tracer budget ({nz}, {ny}, {nx}) f32 data and metrics ({gb:.2f} GB a field): "
        f"launches {counts}; closure |int tendency| / int |tendency| = {closure:.3e}; first "
        f"call {first_ms:.1f} ms (host clock, with the metrics' one copy to the card); peak "
        f"device memory {peak:.2f} GB with the inputs, above the {base / 1e9:.2f} GB that "
        f"earlier phases hold")
    if counts["shift"] != 6 or counts["face_shift"] != 0 or counts["weighted_sum"] != 2:
        raise AssertionError(f"the budget launched shift {counts['shift']}, face_shift "
                             f"{counts['face_shift']} and weighted_sum "
                             f"{counts['weighted_sum']} times, expected 6, 0 and 2")
    launches["weighted_sum"] = counts["weighted_sum"]
    if not closure < 1e-4:
        raise AssertionError(f"the budget does not close: {closure:.3e}")
    for name, r in (("div", div), ("tendency", tendency)):
        if r.dims != ("zc", "yc", "xc") or r.dtype != torch.float32:
            raise AssertionError(f"budget {name}: {r.dims} {r.dtype}")
    if not bool(torch.isfinite(tendency.data).all()):
        raise AssertionError("budget: non-finite tendency")
    kernel_fn, plain_fn, bounds["weighted_sum"] = check_budget_sums(check, grid, tendency)
    times["weighted_sum"] = time_pair(kernel_fn, plain_fn, reps=3)
    log(f"time weighted_sum ({nz}, {ny}, {nx}) f32, the budget's whole-volume integral: kernel "
        f"{times['weighted_sum'][0]:.4f} ms, plain {times['weighted_sum'][1]:.4f} ms, bound "
        f"{bounds['weighted_sum'][0]:.4f} ms ({bounds['weighted_sum'][1]}); within 1e-6 of the "
        f"plain version (max abs err {check.max_err['weighted_sum']:.3e}) [{card}]")
    del div, vol, tendency, kernel_fn, plain_fn

    def budget():
        return budget_closure(grid, budget_terms(grid, theta, u, v, w)[2])

    budget_ms, _ = time_pair(budget, reps=3)
    log(f"time tracer budget ({nz}, {ny}, {nx}) f32, terms and closure: {budget_ms:.4f} ms "
        f"[{card}]")
    brk = budget_breakdown(budget)
    if brk is None:
        log("profile budget: no device time from torch.profiler (not measured)")
    else:
        wall, split = brk
        busy = sum(split.values())
        log(f"profile budget: {wall:.4f} ms a call (CUDA events inside the profiler), device "
            f"busy {busy:.4f} ms, idle share {max(0.0, 1 - busy / wall):.4f}; " + "; ".join(
                f"{k} {ms:.4f} ms" for k, ms in sorted(split.items(), key=lambda kv: -kv[1]))
            + f"; Memcpy HtoD in the window: {'yes' if 'Memcpy HtoD' in split else 'none'} "
            f"[{card}]")
        if "Memcpy HtoD" in split:
            raise AssertionError("the budget copies from the host inside its window")
    del u, v, w, budget
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (b) the calculus on mitgcm_c_grid (f64 metrics: the derivatives and
    # the integrals are f64, twice a field's bytes)
    ds, mit = xtt.grids.mitgcm_c_grid(nx=nx, ny=ny, nz=nz)
    th = xtt.GriddedArray(theta.data, ("Z", "YC", "XC"), name="theta")
    del theta
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # metrics interpolated to the diffs
        for name, (call, want) in calculus_calls(mit, th).items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            build.reset_launch_counts()
            out = call()
            torch.cuda.synchronize()
            got = build.launch_counts()
            peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
            if got["shift"] != want or got["face_shift"] != 0:
                raise AssertionError(f"{name} launched shift {got['shift']} and face_shift "
                                     f"{got['face_shift']} times, expected {want} and 0")
            if not bool(torch.isfinite(out.data).all()):
                raise AssertionError(f"{name}: non-finite values")
            what = f"dims {out.dims}, {out.dtype}"
            del out
            ms, _ = time_pair(call, reps=3)
            log(f"phase 9: {name}: {what}, {want} launch(es) of A; {ms:.4f} ms; peak device "
                f"memory {peak:.2f} GB above theta and the metrics [{card}]")
        check_identities(mit, th, ds)
    del th
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # (c) the card against the CPU
    check_metric_small(gen, dev, xtt)



# ---- phase 10: the xarray path ------------------------------------------------
XARRAY_SMALL = (12, 40, 72)  # (nz, ny, nx) of regrid_vertical's card-against-CPU check


def load_xarray_stub():
    """tests/fake_xarray.py, the repo's duck-typed stand-in for xarray,
    loaded by its path."""
    spec = importlib.util.spec_from_file_location("fake_xarray",
                                                  ROOT / "tests" / "fake_xarray.py")
    stub = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stub)
    return stub


@contextlib.contextmanager
def xarray_stub():
    """The stub installed as ``sys.modules["xarray"]`` and the port's
    adapter reloaded to see it; both restored on leaving."""
    from xgcm_tpu_torch.adapters import xarray_adapter as adapter

    stub = load_xarray_stub()
    old = sys.modules.get("xarray")
    sys.modules["xarray"] = stub
    try:
        importlib.reload(adapter)
        if not adapter.HAS_XARRAY:
            raise AssertionError("the port's xarray adapter does not see the stub")
        yield stub
    finally:
        if old is None:
            sys.modules.pop("xarray", None)
        else:
            sys.modules["xarray"] = old
        importlib.reload(adapter)


def expected_coords(ds, inputs, out_dims, core_dims, keep=True, extra=None):
    """The coordinates xgcm's rules give a result with dims ``out_dims``:
    those of the grid's dataset ``ds`` whose dims are all in it, replaced by those of the
    xarray ``inputs`` that lie entirely on dims outside ``core_dims`` (the
    first input winning), then ``extra``; only the dimension coordinates
    without ``keep``."""
    want = {n: c.data for n, c in ds.coords.items() if all(d in out_dims for d in c.dims)}
    for a in reversed(inputs):
        for n, c in a.coords.items():
            if all(d in out_dims and d not in core_dims for d in c.dims):
                want[n] = c.data
    want.update(extra or {})
    return want if keep else {n: v for n, v in want.items() if n in out_dims}


def same_as_native(host, native, dev, chunk=1 << 27):
    """A host result equal to a tensor on the card, value for value with
    NaN in the same places, compared on the card a chunk at a time."""
    a, b = torch.from_numpy(host).reshape(-1), native.reshape(-1)
    return a.dtype == b.dtype and a.numel() == b.numel() and all(
        same_values(a[s:s + chunk].to(dev), b[s:s + chunk]) for s in range(0, a.numel(), chunk))


def check_xr_output(label, xr, out, native, want, dev):
    """An xarray result against the native call's: a stub DataArray of host
    numpy, the same dims and values, and exactly the coordinates ``want``."""
    if not isinstance(out, xr.DataArray) or not isinstance(out.data, np.ndarray):
        raise AssertionError(f"{label}: {type(out)} is no xarray DataArray of host data")
    if tuple(out.dims) != tuple(native.dims) or out.data.shape != tuple(native.shape):
        raise AssertionError(f"{label}: {out.dims} {out.data.shape}, native {native.dims} "
                             f"{tuple(native.shape)}")
    if not same_as_native(out.data, native.data, dev):
        raise AssertionError(f"{label}: values differ from the native call's")
    if set(out.coords) != set(want):
        raise AssertionError(f"{label}: coordinates {sorted(out.coords)}, expected "
                             f"{sorted(want)}")
    for name, values in want.items():
        c = out.coords[name]
        if not np.array_equal(np.asarray(c.data), np.asarray(values)) or any(
                out.sizes[d] != s for d, s in zip(c.dims, np.shape(c.data))):
            raise AssertionError(f"{label}: coordinate {name} is not the expected one")


PCIE_BYTES_PER_S = 64e9  # PCIe 5.0 x16, one direction: no host copy is faster


def device_split(events, wall, launched, in_bytes, out_bytes):
    """{"Memcpy HtoD", "Memcpy DtoH", "kernels", "idle"} ms of the events of
    one profiler window of ``wall`` ms of an xarray call, which copies
    arrays of ``in_bytes`` to the card and of ``out_bytes`` back, and
    launched kernels if ``launched``; None when the window holds fewer
    copies as long as PCIe allows for those arrays, or no kernel (the
    profiler on the H100 machine drops the device's records of some
    windows)."""
    split = {"Memcpy HtoD": 0.0, "Memcpy DtoH": 0.0, "kernels": 0.0}
    least = {"Memcpy HtoD": min(in_bytes) / PCIE_BYTES_PER_S * 1e6,
             "Memcpy DtoH": min(out_bytes) / PCIE_BYTES_PER_S * 1e6}  # us
    copies = {"Memcpy HtoD": 0, "Memcpy DtoH": 0}
    for e in events or ():
        c = kernel_class(e.key)
        split[c if c in split else "kernels"] += e.self_device_time_total / 1e3
        if c in copies and e.self_device_time_total >= least[c]:
            copies[c] += 1
    if not (copies["Memcpy HtoD"] >= len(in_bytes) and copies["Memcpy DtoH"] >= len(out_bytes)
            and (split["kernels"] > 0 or not launched)):
        return None
    split["idle"] = max(0.0, wall - sum(split.values()))
    return split


PROFILE_TRIES = 5  # profiler windows of an xarray call, for one with every record


def xarray_against_native(label, xr, xr_call, native_call, want_coords, inputs, build, dev,
                          card):
    """One xarray call (host numpy in, host numpy out) against the native
    call on tensors already on the card: the same launches of every
    kernel, each output equal bit for bit with the coordinates
    ``want_coords[i]``; the xarray call's time and device split from one
    profiler window (up to PROFILE_TRIES windows, for one with all its
    records), beside the native call's time by CUDA events.  ``inputs``
    are the call's xarray inputs.  Returns the launches."""
    torch.cuda.synchronize()
    build.reset_launch_counts()
    box = []
    events, xr_ms = profile_window(lambda: box.append(xr_call()), 1, warmup=False, raw=True)
    xr_counts = build.launch_counts()
    outs = box.pop()
    build.reset_launch_counts()
    natives = native_call()
    torch.cuda.synchronize()
    counts = build.launch_counts()
    if xr_counts != counts:
        raise AssertionError(f"{label}: the xarray call launched {xr_counts}, the native "
                             f"call {counts}")
    outs = outs if isinstance(outs, list) else [outs]
    natives = natives if isinstance(natives, list) else [natives]
    nbytes = ([a.data.nbytes for a in inputs], [o.data.nbytes for o in outs])
    for i, (o, n) in enumerate(zip(outs, natives)):
        check_xr_output(f"{label} output {i}", xr, o, n, want_coords[i], dev)
    del outs, natives
    native_ms, _ = time_pair(native_call, reps=3)
    launched = {k: v for k, v in counts.items() if v}
    split, windows = device_split(events, xr_ms, launched, *nbytes), 1
    while split is None and windows < PROFILE_TRIES:  # a window the profiler kept whole
        events, ms = profile_window(xr_call, 1, warmup=False, raw=True)
        split, windows = device_split(events, ms, launched, *nbytes), windows + 1
    split_text = (f"split not measured: the profiler dropped device records in {windows} "
                  f"windows" if split is None else ", ".join(
                      f"{k} {v:.4f} ms" for k, v in split.items())
                  + ("" if windows == 1 else f" (window {windows}: {ms:.4f} ms)"))
    log(f"phase 10: {label}: xarray call {xr_ms:.4f} ms (CUDA events, host numpy to host "
        f"numpy; {split_text}) against the native call {native_ms:.4f} ms (tensors on the "
        f"card); launches {launched or 'none'} in both; values bit for bit; coordinates by "
        f"xgcm's rules [{card}]")
    return counts


def xarray_budget_calls(xtt, xr, gen, dev, build, card, nz, ny, nx):
    """The face-less calls through Grid(xr.Dataset) of the budget grid:
    the vorticity of 2-D u, v (A twice), a 3-D diff (A once), derivative
    and integrate along Z with the grid's metrics."""
    grid = budget_grid(xtt, nx, ny, nz, dataset=xr.Dataset)
    xds = grid._ds  # the grid's coordinates, as converted from the xr.Dataset
    lat = np.linspace(-30.0, 30.0, ny)  # the inputs' own coordinates
    lon = np.linspace(0.0, 90.0, nx)
    u = torch.randn((ny, nx), generator=gen, device=dev)
    v = torch.randn((ny, nx), generator=gen, device=dev)
    ux = xr.DataArray(u.cpu().numpy(), dims=("yc", "xg"), name="u")
    vx = xr.DataArray(v.cpu().numpy(), dims=("yg", "xc"), name="v")
    un = xtt.GriddedArray(u, ("yc", "xg"), name="u")
    vn = xtt.GriddedArray(v, ("yg", "xc"), name="v")
    counts = {}
    counts["vorticity"] = xarray_against_native(
        f"vorticity diff(v, X) - diff(u, Y) {ny}x{nx} f32", xr,
        lambda: grid.diff(vx, "X") - grid.diff(ux, "Y"),
        lambda: grid.diff(vn, "X") - grid.diff(un, "Y"),
        [expected_coords(xds, [], ("yg", "xg"), {"yg", "xg"}, keep=False)], [ux, vx], build, dev,
        card)
    del u, v, ux, vx, un, vn

    theta = torch.rand((nz, ny, nx), generator=gen, device=dev).add_(20.0)
    tx = xr.DataArray(theta.cpu().numpy(), dims=("zc", "yc", "xc"), name="theta",
                      coords={"yc": ("yc", lat), "xc": ("xc", lon)})
    tn = xtt.GriddedArray(theta, ("zc", "yc", "xc"), name="theta")
    shape = f"{nz}x{ny}x{nx} f32"
    counts["diff"] = xarray_against_native(
        f"diff(theta, X) {shape}", xr, lambda: grid.diff(tx, "X"), lambda: grid.diff(tn, "X"),
        [expected_coords(xds, [tx], ("zc", "yc", "xg"), {"xg"}, keep=False)], [tx], build, dev,
        card)
    counts["derivative"] = xarray_against_native(
        f"derivative(theta, Z) {shape}", xr, lambda: grid.derivative(tx, "Z"),
        lambda: grid.derivative(tn, "Z"),
        [expected_coords(xds, [tx], ("zg", "yc", "xc"), {"zg"}, keep=False)], [tx], build, dev,
        card)
    counts["integrate"] = xarray_against_native(
        f"integrate(theta, Z) {shape}", xr, lambda: grid.integrate(tx, "Z"),
        lambda: grid.integrate(tn, "Z"), [expected_coords(xds, [tx], ("yc", "xc"), set())],
        [tx], build, dev, card)
    want = {"vorticity": 2, "diff": 1, "derivative": 1, "integrate": 0}
    for name, n in want.items():
        if counts[name]["shift"] != n or sum(counts[name].values()) != n:
            raise AssertionError(f"the xarray {name} launched {counts[name]}, expected {n} of A")


def xarray_density_calls(xtt, xr, gen, dev, build, card, nz, ny, nx):
    """The density-space calls through Grid(xr.Dataset): linear and
    conservative ``transform`` of one field (C, G) and ``transform_multi``
    of four (F, H), each once, float32 targets as the native calls take.
    Returns T, sigma and the levels on the card, for regrid_vertical."""
    grid = density_grid(xtt, nz, dataset=xr.Dataset)
    xds = grid._ds
    sig_b, sig_c, fields = density_columns(gen, dev, ny * nx, n=nz)
    sig_b, sig_c = sig_b.reshape(ny, nx, nz + 1), sig_c.reshape(ny, nx, nz)
    fields = [f.reshape(ny, nx, nz) for f in fields]
    edges, levels = density_targets(dev)
    edges_h, levels_h = edges.cpu().numpy(), levels.cpu().numpy()
    lat, lon = np.linspace(-30.0, 30.0, ny), np.linspace(0.0, 90.0, nx)
    names = ("T", "S", "u", "v")
    fx = [xr.DataArray(f.cpu().numpy(), dims=("y", "x", "zc"), name=nm,
                       coords={"y": ("y", lat)}) for f, nm in zip(fields, names)]
    # target_data's own coordinates: x survives, y loses to the field's
    sbx = xr.DataArray(sig_b.cpu().numpy(), dims=("y", "x", "zo"), name="sigma",
                       coords={"x": ("x", lon), "y": ("y", -lat)})
    scx = xr.DataArray(sig_c.cpu().numpy(), dims=("y", "x", "zc"), name="sigma",
                       coords={"x": ("x", lon), "y": ("y", -lat)})
    fn = [xtt.GriddedArray(f, ("y", "x", "zc"), name=nm) for f, nm in zip(fields, names)]
    sbn = xtt.GriddedArray(sig_b, ("y", "x", "zo"), name="sigma")
    scn = xtt.GriddedArray(sig_c, ("y", "x", "zc"), name="sigma")
    mid = 0.5 * (edges_h[:-1] + edges_h[1:])
    out_dims = ("y", "x", "sigma")

    def want(v, td, extra):
        return expected_coords(xds, [fx[v], td], out_dims, {"sigma"}, extra={"sigma": extra})

    shape = f"{ny}x{nx}x{nz} f32"
    calls = {
        "interp_linear": (
            f"linear transform of T {shape}, {len(levels_h)} levels",
            lambda: grid.transform(fx[0], "Z", levels_h, target_data=scx),
            lambda: grid.transform(fn[0], "Z", levels, target_data=scn),
            [want(0, scx, levels_h)], [fx[0], scx]),
        "conservative": (
            f"conservative transform of T {shape}, {len(mid)} classes",
            lambda: grid.transform(fx[0], "Z", edges_h, target_data=sbx, method="conservative"),
            lambda: grid.transform(fn[0], "Z", edges, target_data=sbn, method="conservative"),
            [want(0, sbx, mid)], [fx[0], sbx]),
        "interp_linear_multi": (
            f"linear transform_multi of T, S, u, v {shape}",
            lambda: grid.transform_multi(fx, "Z", levels_h, target_data=scx),
            lambda: grid.transform_multi(fn, "Z", levels, target_data=scn),
            [want(v, scx, levels_h) for v in range(len(fx))], fx + [scx]),
        "conservative_multi": (
            f"conservative transform_multi of T, S, u, v {shape}",
            lambda: grid.transform_multi(fx, "Z", edges_h, target_data=sbx, method="conservative"),
            lambda: grid.transform_multi(fn, "Z", edges, target_data=sbn, method="conservative"),
            [want(v, sbx, mid) for v in range(len(fx))], fx + [sbx]),
    }
    for kernel, (label, xr_call, native_call, coords, inputs) in calls.items():
        counts = xarray_against_native(label, xr, xr_call, native_call, coords, inputs, build,
                                       dev, card)
        if counts[kernel] != 1 or sum(counts.values()) != 1:
            raise AssertionError(f"the xarray {label} launched {counts}, expected {kernel} once")
    return fields[0], sig_c, levels


def check_regrid(xtt, q, tr, levels, dev, card):
    """``regrid_vertical`` of q by the tracer tr into the bins between
    ``levels`` at full width: per column with finite q the bins sum to the
    column within n * 2**-24 * sum |q|; its peak device memory, well below
    the one-hot (..., nz, nbins) array it does not build."""
    from xgcm_tpu_torch.ops.regridding import regrid_vertical

    ny, nx, nz = q.shape
    nbins = levels.numel() - 1
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = regrid_vertical(xtt.GriddedArray(q, ("y", "x", "zc"), name="T"),
                          xtt.GriddedArray(tr, ("y", "x", "zc"), name="sigma"), levels, "zc")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    if out.dims != ("y", "x", "sigma_coord") or out.shape != (ny, nx, nbins):
        raise AssertionError(f"regrid_vertical: {out.dims} {out.shape}")
    checked = 0
    for o, a in rows(out.data, q):
        finite = torch.isfinite(a).all(-1)
        err = (o.double().sum(-1) - a.double().sum(-1)).abs()
        tol = nz * 2.0**-24 * a.double().abs().sum(-1)
        if not bool((err <= tol)[finite].all()):
            raise AssertionError("regrid_vertical: a column's bins do not sum to its total")
        checked += int(finite.sum())
    one_hot_gb = q.numel() * nbins * q.element_size() / 1e9
    log(f"phase 10: regrid_vertical {ny}x{nx}x{nz} f32 into {nbins} bins: {ms:.1f} ms (host "
        f"clock, first call); peak device memory {peak:.2f} GB above its inputs (the one-hot "
        f"(..., nz, nbins) array would take {one_hot_gb:.1f} GB); bins sum to the column in "
        f"{checked} columns with finite data [{card}]")
    del out


def check_regrid_small(xtt, q, tr, levels, dev):
    """``regrid_vertical`` on a 12 x 40 x 72 cut of the face, NaN and +-inf
    tracer values and a NaN datum among them: the card equals the CPU."""
    from xgcm_tpu_torch.ops.regridding import regrid_vertical

    nz, ny, nx = XARRAY_SMALL
    qs, ts = q[:ny, :nx, :nz].clone(), tr[:ny, :nx, :nz].clone()
    ts[0, 0, :6] = torch.tensor([float("nan"), -float("inf"), float("inf"), 24.5, 26.6, 23.0],
                                device=ts.device)
    ts[5, 7, 3], ts[9, 2, 11] = float("nan"), float("inf")
    qs[1, 1, 3] = float("nan")

    def run(d):
        return regrid_vertical(xtt.GriddedArray(qs.to(d), ("y", "x", "zc"), name="T"),
                               xtt.GriddedArray(ts.to(d), ("y", "x", "zc"), name="sigma"),
                               levels.to(d), "zc")

    a, b = run(dev), run(torch.device("cpu"))
    if a.dims != b.dims or a.data.device.type != dev.type or not same_values(a.data.cpu(),
                                                                            b.data):
        raise AssertionError("regrid_vertical on the card differs from the CPU")
    log(f"phase 10: regrid_vertical on a {nz} x {ny} x {nx} cut with NaN and +-inf tracer "
        f"values on the card == on the CPU, value for value")


def check_profiling(xtt, gen, dev, card, shift_ms):
    """``utils.device_time`` of A's 4320^2 diff beside phase 5's events time,
    and ``utils.trace`` writing a trace that names A's kernel."""
    from xgcm_tpu_torch.ops.kernels.shift import shift
    from xgcm_tpu_torch.utils import device_time, trace

    x = torch.rand((NY, NX), generator=gen, device=dev)
    secs = device_time(lambda a: shift(a, 1, "diff", "left", "periodic"), x, iters=30)
    phase5 = "not measured" if shift_ms is None else f"{shift_ms:.4f} ms"
    log(f"phase 10: utils.device_time of A's diff/left/axis1 {NY}x{NX} f32: {secs * 1e3:.4f} ms "
        f"an iteration, beside phase 5's events time {phase5} (slowest of four "
        f"configurations): device_time adds the chaining pass, x + 1e-20 * out, a multiply "
        f"and an add over x [{card}]")
    logdir = ROOT / "build" / "xgcm_tpu_torch_trace"
    for attempt in range(1, PROFILE_TRIES + 1):
        shutil.rmtree(logdir, ignore_errors=True)
        with trace(str(logdir)):
            y = torch.rand((NY, NX), generator=gen, device=dev)
            shift(y, 1, "diff", "left", "periodic")
        files = list(logdir.iterdir())
        if len(files) != 1:
            raise AssertionError(f"utils.trace wrote {files}, not one trace file")
        if any(k in files[0].read_text() for k in SHIFT_KERNELS):
            break
    else:
        raise AssertionError(f"utils.trace wrote no trace that names kernel A in "
                             f"{PROFILE_TRIES} tries")
    log(f"phase 10: utils.trace wrote {files[0].name} ({files[0].stat().st_size} bytes), which "
        f"names kernel A (try {attempt} of {PROFILE_TRIES}; the profiler on the H100 machine "
        f"drops the device's records of some windows)")


def run_xarray_phase(seed, shift_ms):
    """Phase 10 in a process of its own, which this one waits for: late in
    a long process torch.profiler dropped the device's records of whole
    windows (on the H100 machine, after about 100 s), and the phase's split
    and ``utils.trace`` read them.  Fails when the phase fails."""
    cmd = [sys.executable, str(pathlib.Path(__file__).resolve()), "--xarray-phase",
           "--seed", str(seed)]
    if shift_ms is not None:
        cmd += ["--shift-ms", repr(shift_ms)]
    sys.stdout.flush()
    rc = subprocess.run(cmd, timeout=900).returncode
    if rc != 0:
        raise AssertionError(f"phase 10 failed (exit code {rc})")


def xarray_phase_main(seed, shift_ms) -> int:
    """The entry of the process run_xarray_phase starts."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is false")
    xtt = import_port()
    from xgcm_tpu_torch.ops.kernels import build

    build.load_library()  # built by the parent process
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    xarray_phase(xtt, build, gen, dev, card_line(), shift_ms)
    return 0


def xarray_phase(xtt, build, gen, dev, card, shift_ms, nz=NZ, ny=NY, nx=NX):
    """Phase 10: the profiling helpers (first, while the process is young);
    a user's xarray data through Grid(xr.Dataset) and the entry points at
    one LLC4320 face, each call against the native call on the card
    (launches, values, coordinates, times); regrid_vertical at the face and
    against the CPU."""
    t0 = time.perf_counter()
    check_profiling(xtt, gen, dev, card, shift_ms)
    log("phase 10: the xarray of this phase is the repo's stub, tests/fake_xarray.py (the "
        "card's machine has no xarray)")
    with xarray_stub() as xr, warnings.catch_warnings():
        # keep_coords=False, the default of diff, warns its deprecation
        warnings.simplefilter("ignore", DeprecationWarning)
        xarray_budget_calls(xtt, xr, gen, dev, build, card, nz, ny, nx)
        torch.cuda.empty_cache()
        q, tr, levels = xarray_density_calls(xtt, xr, gen, dev, build, card, nz, ny, nx)
    torch.cuda.empty_cache()
    check_regrid(xtt, q, tr, levels, dev, card)
    check_regrid_small(xtt, q, tr, levels, dev)
    del q, tr
    torch.cuda.empty_cache()
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")


# ---- phase 11: the sharded layer -----------------------------------------------
SHARDED_SMALL = (6, 16, 24)  # (nz, ny, nx) of the cuda test's run of the phase
# the collectives of one op, by boundary: the counts of the jaxprs of
# xgcm_tpu's ShardedGrid on the same programs, which
# tests/test_torch_inspection.py holds the port to on the CPU
RING_BUDGET = {"periodic": {"ppermute": 1}, "fill": {"ppermute": 1},
               "extend": {"ppermute": 1, "all_gather": 2}}
CUMSUM_BUDGET = {"fill": {"ppermute": 1, "all_gather": 1},
                 "periodic": {"ppermute": 1, "all_gather": 2}}
# the face-sharded route on a face-only mesh: one all_gather of the strip
# pool per scalar op, two per vector op (the partner's pool too); on a
# face x rows mesh a psum first and the rows' ring exchange of the pre-pad
# (tests/test_torch_face_sharded_ops.py holds each to JAX's jaxpr)
FACE_BUDGET = {"scalar": {"all_gather": 1}, "vector": {"all_gather": 2}}
FACE_ROWS_VECTOR_BUDGET = {"psum": 2, "all_gather": 2, "ppermute": 2}
FACE_ROWS_CUMSUM_BUDGET = {"psum": 1, "all_gather": 2, "ppermute": 2}
# apply_many pads each distinct (input, boundary conditions, vector role)
# key once.  The face analysis's eight ops have five keys: theta for its
# two diffs (one strip pool), u and v each as the X component with the
# other as partner and as the Y component (the diff and the interp of the
# divergence and the vector interp share the key): 1 + 4 x 2 all_gathers,
# where the eight separate ops make 2 + 6 x 2.  The 2 x 2 diagnostics
# batch pads u and v once each, one ring halo on each of the two axes: the
# fused program's four ppermutes.  tests/test_torch_apply_many.py holds
# both to the jaxprs of xgcm_tpu's sharded_apply_many.
FACE_BATCH_BUDGET = {"all_gather": 1 + 4 * 2}
DIAGNOSTICS_BATCH_BUDGET = {"ppermute": 4}
# tests/test_sharding.py holds the sharded cumsum to rtol 1e-12 in float64;
# scaled by the ratio of the float32 and float64 units in the last place
# (2^-23 / 2^-52), about 5.4e-4
CUMSUM_RTOL = 1e-12 * 2.0 ** 29
METRIC_RTOL = 1e-7  # tests/test_sharded_ufunc.py: assert_allclose's default


def sharded_class(name: str) -> str:
    """The class of a profiler event in the sharded phase: a kernel of the
    port, a copy (the halo exchange's copies between blocks, and the
    concatenations of gathered edge lines), or other."""
    for key, cls in (("face_shift_kernel", "E"), ("shift_rows", "A"), ("shift_planes", "A"),
                     ("interp_linear_kernel", "C/F"), ("conservative_kernel", "G/H")):
        if key in name:
            return cls
    if "Memcpy" in name or "copy" in name.lower() or "Cat" in name:
        return "copies"
    return "other"


def sharded_split(fn, reps=3):
    """'E 1.2 ms; copies 0.1 ms; ...; idle share x' per call of fn from one
    profiler window, or "not measured"."""
    averages, wall = profile_window(fn, reps)
    split = {}
    for e in averages or ():
        if e.self_device_time_total > 0:
            c = sharded_class(e.key)
            split[c] = split.get(c, 0.0) + e.self_device_time_total / 1e3 / reps
    if not split:
        return "split not measured (no device time from torch.profiler)"
    busy = sum(split.values())
    return ("; ".join(f"{k} {ms:.4f} ms" for k, ms in sorted(split.items(), key=lambda kv: -kv[1]))
            + f"; wall {wall:.4f} ms, idle share {max(0.0, 1 - busy / wall):.4f}")


def counted_call(build, call):
    """(result, kernel launches, collectives) of one call, with both counts
    set to 0 just before it and read just after."""
    from xgcm_tpu_torch.utils import count_collectives

    box = {}
    torch.cuda.synchronize()
    build.reset_launch_counts()
    cc = count_collectives(lambda: box.setdefault("out", call()))
    torch.cuda.synchronize()
    return box["out"], build.launch_counts(), cc


def expect_counts(label, launches, cc, want_launches, want_cc):
    got = {k: launches[k] for k in want_launches}
    if got != want_launches:
        raise AssertionError(f"{label}: launches {got}, expected {want_launches}")
    want_cc = {**want_cc, "total": sum(want_cc.values())}
    if cc != want_cc:
        raise AssertionError(f"{label}: collectives {cc}, expected {want_cc} (the JAX budget)")


def phase_devices(dev, n):
    """The devices of an n-shard mesh: logical shards of the one card, or
    the visible cards in turn where there are several (the same code then
    copies halos between cards)."""
    if dev.type != "cuda":
        return [dev] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def same_by_block(label, got, want, rtol=None):
    """Each block of a sharded result that this process holds against the
    matching slice of the single-device result: on its mesh coordinate's
    device, the same dims,
    NaN and infinities in the same places, and equal values (``rtol``:
    within it)."""
    st = got.data
    if got.dims != want.dims or tuple(st.shape) != tuple(want.shape):
        raise AssertionError(f"{label}: {got.dims} {tuple(st.shape)}, single-device "
                             f"{want.dims} {tuple(want.shape)}")
    for c in st.mesh.local_coords:
        b = st.blocks[c]
        if b.device != st.mesh.devices[c]:
            raise AssertionError(f"{label}: block {c} on {b.device}, its mesh coordinate on "
                                 f"{st.mesh.devices[c]}")
        w = want.data[st.block_index(c)].to(b.device)
        if rtol is None:
            ok = same_values(b, w)
        else:
            fin = torch.isfinite(w)
            ok = (torch.equal(torch.isnan(b), torch.isnan(w))
                  and torch.equal(b[~fin].nan_to_num(), w[~fin].nan_to_num())
                  and bool(torch.isclose(b[fin], w[fin], rtol=rtol, atol=0.0).all()))
        if not ok:
            raise AssertionError(f"{label}: block {c} differs from the single-device result")


def sharded_inputs(gen, dev, nz, ny, nx):
    """theta (nz, ny, nx) f32 of the budget's range, with NaN and +-inf,
    two of them on either side of the first shard boundary along X."""
    theta = torch.rand((nz, ny, nx), generator=gen, device=dev).add_(20.0)
    b = nx // N_SHARDS
    theta[3, 5, 0] = float("nan")
    theta[1, 7, nx - 1] = float("inf")
    theta[2, 2, b - 1] = -float("inf")
    theta[2, 2, b] = float("nan")
    return theta


def sharded_phase(xtt, build, gen, dev, card, nz=NZ, ny=NY, nx=NX, timing=True):
    """Phase 11: the sharded layer on logical shards of the one card, at
    one LLC4320 face: the ring route (kernel E per block), the sharded
    cumsum, the batch route (A per block), the sharded C-grid diagnostics
    and the same six ops as one apply_many on a 2 x 2 mesh, the per-shard
    transforms (C, G, F, H per block), the metric route, then the
    face-sharded part; each against the single-device call, with its
    launches, collectives, time and peak memory."""
    from xgcm_tpu_torch import parallel as par
    from xgcm_tpu_torch.parallel.diagnostics import sharded_cgrid_diagnostics

    t_phase = time.perf_counter()
    times = []
    # CUDA events and the profiler window time one card's stream
    timing = timing and len(set(phase_devices(dev, N_SHARDS))) == 1

    def timed(name, sharded, single, other=None):
        """Times of ``sharded`` and ``single``; ``other`` (label, fn): a
        second sharded program of the same results, timed in turns with
        ``sharded``."""
        if not timing:
            return
        if other is None:
            s_ms, one_ms = time_pair(sharded, single, reps=3)
            extra = ""
        else:
            s_ms, o_ms = time_pair(sharded, other[1], reps=3)
            one_ms, _ = time_pair(single, reps=3)
            extra = f", {other[0]} {o_ms:.4f} ms"
        times.append((name, s_ms, one_ms, extra, sharded_split(sharded)))

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    grid = budget_grid(xtt, nx, ny, nz)
    th = xtt.GriddedArray(sharded_inputs(gen, dev, nz, ny, nx), ("zc", "yc", "xc"),
                          name="theta")
    mesh = par.make_mesh({"x": N_SHARDS}, devices=phase_devices(dev, N_SHARDS))
    sg = par.ShardedGrid(grid, mesh, {"X": "x"})
    th_sh = sg.shard(th)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    log(f"phase 11: theta ({nz}, {ny}, {nx}) f32 ({th.data.numel() * 4 / 1e9:.2f} GB) and its "
        f"{N_SHARDS} blocks along X ({nx // N_SHARDS} columns each); mesh {mesh}")

    def peak_gb():
        return (torch.cuda.max_memory_allocated(dev) - base) / 1e9

    # (1) the ring route: kernel E once per block, no kernel A
    peaks = []
    for bc in ("periodic", "fill", "extend"):
        for op in SHIFT_OPS:
            label = f"ring {op} X {bc}"
            torch.cuda.reset_peak_memory_stats(dev)
            out, launches, cc = counted_call(
                build, lambda: getattr(sg, op)(th_sh, "X", boundary=bc, fill_value=1.5))
            peaks.append(peak_gb())
            expect_counts(label, launches, cc, {"face_shift": N_SHARDS, "shift": 0},
                          RING_BUDGET[bc])
            same_by_block(label, out, getattr(grid, op)(th, "X", boundary=bc, fill_value=1.5))
            del out
    log(f"phase 11: ring route: diff, interp, min, max along X under periodic, fill and extend "
        f"== the single-device op bit for bit (NaN and infinities in the same places), kernel "
        f"E {N_SHARDS} launches and kernel A none per op, collectives {RING_BUDGET} (the JAX "
        f"budget); peak device memory {max(peaks):.2f} GB above the inputs [{card}]")
    for bc in ("periodic", "extend"):
        timed(f"ring diff X {bc}", lambda: sg.diff(th_sh, "X", boundary=bc),
              lambda: grid.diff(th, "X", boundary=bc))

    # (2) the sharded cumsum
    for bc in ("fill", "periodic"):
        label = f"cumsum X to=left {bc}"
        torch.cuda.reset_peak_memory_stats(dev)
        out, launches, cc = counted_call(
            build, lambda: sg.cumsum(th_sh, "X", to="left", boundary=bc))
        expect_counts(label, launches, cc, {"face_shift": 0, "shift": 0}, CUMSUM_BUDGET[bc])
        same_by_block(label, out, grid.cumsum(th, "X", to="left", boundary=bc),
                      rtol=CUMSUM_RTOL)
        log(f"phase 11: {label} == the single-device cumsum within rtol {CUMSUM_RTOL:.2e} (the "
            f"JAX test's 1e-12 scaled to f32), same NaN and infinities; collectives {cc}; peak "
            f"device memory {peak_gb():.2f} GB above the inputs [{card}]")
        del out
    timed("cumsum X to=left fill", lambda: sg.cumsum(th_sh, "X", to="left", boundary="fill"),
          lambda: grid.cumsum(th, "X", to="left", boundary="fill"))

    # (3) the metric route, while X is sharded
    torch.cuda.reset_peak_memory_stats(dev)
    out, launches, cc = counted_call(build, lambda: sg.derivative(th_sh, "X"))
    expect_counts("derivative X", launches, cc, {"face_shift": N_SHARDS, "shift": 0},
                  RING_BUDGET["periodic"])
    same_by_block("derivative X", out, grid.derivative(th, "X"), rtol=METRIC_RTOL)
    del out
    par.reset_assembly_count()
    out, launches, cc = counted_call(build, lambda: sg.integrate(th_sh, "Z"))
    assemblies = par.assembly_count()
    want = grid.integrate(th, "Z")
    if out.dims != want.dims or not torch.allclose(out.data, want.data, rtol=METRIC_RTOL,
                                                   atol=0.0, equal_nan=True):
        raise AssertionError("integrate Z: differs from the single-device call")
    if cc["total"] != 0:
        raise AssertionError(f"integrate Z: collectives {cc}, expected none")
    log(f"phase 11: metric route: derivative X (E {N_SHARDS} launches, one ppermute) and "
        f"integrate Z == the single-device calls within rtol {METRIC_RTOL} (the JAX tests'); "
        f"integrate assembled the product {assemblies} time(s) (the gather around the sum), "
        f"no collective; peak device memory {peak_gb():.2f} GB above the inputs [{card}]")
    del out, want
    timed("derivative X", lambda: sg.derivative(th_sh, "X"), lambda: grid.derivative(th, "X"))
    timed("integrate Z", lambda: sg.integrate(th_sh, "Z"), lambda: grid.integrate(th, "Z"))
    del th_sh
    torch.cuda.empty_cache()

    # (4) the batch route: Z over two shards, kernel A once per block
    mesh_z = par.make_mesh({"z": 2}, devices=phase_devices(dev, 2))
    sgz = par.ShardedGrid(grid, mesh_z, {"zc": "z"})
    th_z = sgz.shard(th)
    torch.cuda.reset_peak_memory_stats(dev)
    out, launches, cc = counted_call(build, lambda: sgz.diff(th_z, "X"))
    expect_counts("batch diff X", launches, cc, {"shift": 2, "face_shift": 0}, {})
    same_by_block("batch diff X", out, grid.diff(th, "X"))
    log(f"phase 11: batch route: diff X with Z over 2 shards ({nz // 2} levels each) == the "
        f"single-device diff bit for bit, kernel A 2 launches, no collective; peak device "
        f"memory {peak_gb():.2f} GB above the inputs [{card}]")
    del out
    timed("batch diff X (Z over 2)", lambda: sgz.diff(th_z, "X"), lambda: grid.diff(th, "X"))
    del th_z, th
    torch.cuda.empty_cache()

    # (5) the sharded diagnostics on a 2 x 2 mesh
    u = xtt.GriddedArray(torch.randn((ny, nx), generator=gen, device=dev), ("yc", "xg"),
                         name="u")
    v = xtt.GriddedArray(torch.randn((ny, nx), generator=gen, device=dev), ("yg", "xc"),
                         name="v")
    mesh2 = par.make_mesh({"y": 2, "x": 2}, devices=phase_devices(dev, 4))
    m2 = {"xc": "x", "xg": "x", "yc": "y", "yg": "y"}
    sg2 = par.ShardedGrid(grid, mesh2, m2)

    def chain(g):
        zeta = g.diff(v, "X") - g.diff(u, "Y")
        div = g.diff(u, "X", to="center") + g.diff(v, "Y", to="center")
        u_c, v_c = g.interp(u, "X", to="center"), g.interp(v, "Y", to="center")
        return zeta, div, 0.5 * (u_c * u_c + v_c * v_c)

    fused, launches, cc = counted_call(
        build, lambda: sharded_cgrid_diagnostics(grid, u, v, mesh2, m2))
    expect_counts("sharded diagnostics", launches, cc,
                  {"shift": 0, "face_shift": 0, "cgrid_diagnostics": 0}, {"ppermute": 4})
    seq, launches_seq, _ = counted_call(build, lambda: chain(sg2))
    single = chain(grid)
    for name, f, s, one in zip(("zeta", "div", "ke"), fused, seq, single):
        same_by_block(f"diagnostics {name} (sequential sharded ops)", f, s.with_data(
            s.data.full_tensor()))
        same_by_block(f"diagnostics {name} (single-device ops)", f, one)
    log(f"phase 11: sharded diagnostics {ny}x{nx} f32 on a 2 x 2 mesh: zeta, div, ke == the "
        f"sequential sharded ops (E {launches_seq['face_shift']} launches) == the single-device "
        f"Grid ops, bit for bit; 4 ppermutes, no kernel [{card}]")
    del fused, seq, single
    timed("sharded diagnostics (2 x 2)", lambda: sharded_cgrid_diagnostics(grid, u, v, mesh2, m2),
          lambda: chain(grid))
    check_diagnostics_batch(xtt, build, grid, sg2, u, v, mesh2, m2, card)
    timed("diagnostics batch (apply_many, 2 x 2)",
          lambda: diagnostics_batch(xtt, sg2, u, v),
          lambda: chain(grid),
          other=("fused sharded diagnostics",
                 lambda: sharded_cgrid_diagnostics(grid, u, v, mesh2, m2)))
    del u, v
    torch.cuda.empty_cache()

    # (6) the per-shard transforms: the density columns at the face, X over
    # the shards; the single-device results first, then the inputs are
    # split (each freed as its blocks are made) and the sharded calls are
    # held to them
    cols = ny * nx
    sig_b, sig_c, fields = density_columns(gen, dev, cols, n=nz)
    edges, levels = density_targets(dev)
    dgrid = density_grid(xtt, nz=nz)
    ins = {"sb": xtt.GriddedArray(sig_b.view(ny, nx, nz + 1), ("y", "x", "zo"), name="sigma"),
           "sc": xtt.GriddedArray(sig_c.view(ny, nx, nz), ("y", "x", "zc"), name="sigma")}
    for f, nm in zip(fields, ("T", "S", "u", "v")):
        ins[nm] = xtt.GriddedArray(f.view(ny, nx, nz), ("y", "x", "zc"), name=nm)
    del sig_b, sig_c, fields, f
    four = ("T", "S", "u", "v")

    def calls(g, a):
        return {
            "interp_linear": lambda: [g.transform(a["T"], "Z", levels, target_data=a["sc"])],
            "conservative": lambda: [g.transform(a["T"], "Z", edges, target_data=a["sb"],
                                                 method="conservative")],
            "interp_linear_multi": lambda: g.transform_multi([a[k] for k in four], "Z", levels,
                                                             target_data=a["sc"]),
            "conservative_multi": lambda: g.transform_multi([a[k] for k in four], "Z", edges,
                                                            target_data=a["sb"],
                                                            method="conservative"),
        }

    single = {name: call() for name, call in calls(dgrid, ins).items()}
    one_ms = {}
    if timing:
        for name, call in calls(dgrid, ins).items():
            one_ms[name], _ = time_pair(call, reps=3)
    sgd = par.ShardedGrid(dgrid, mesh, {"x": "x"})
    for k in list(ins):
        ins[k] = sgd.shard(ins[k])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for name, call in calls(sgd, ins).items():
        torch.cuda.reset_peak_memory_stats(dev)
        at = torch.cuda.memory_allocated(dev)
        outs, launches, cc = counted_call(build, call)
        peak = (torch.cuda.max_memory_allocated(dev) - at) / 1e9
        expect_counts(f"per-shard {name}", launches, cc, {name: N_SHARDS}, {})
        for o, w in zip(outs, single[name]):
            same_by_block(f"per-shard {name} {o.name}", o, w)
        del outs, single[name]
        log(f"phase 11: per-shard {name} ({N_SHARDS} x {nx // N_SHARDS} x {ny} columns of {nz} "
            f"levels) == the single-device call bit for bit, {N_SHARDS} launches, no collective; "
            f"peak device memory {peak:.2f} GB above its inputs [{card}]")
        if timing:
            s_ms, _ = time_pair(call, reps=3)
            times.append((f"per-shard {name}", s_ms, one_ms[name], "", sharded_split(call)))
    del ins
    torch.cuda.empty_cache()

    face_sharded_part(xtt, build, gen, dev, card, timed, n=nx)

    if not timing:
        log("phase 11: times not measured (CUDA events time one card's stream)")
    for name, s_ms, one_ms_, extra, split in times:
        log(f"time phase 11 {name}: sharded {s_ms:.4f} ms{extra}, single-device {one_ms_:.4f} "
            f"ms (CUDA events); sharded split: {split} [{card}]")
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")


def no_kernel(build):
    """Launch counts of none of the port's kernels (A-H)."""
    return {name: 0 for name in build.launch_counts()}


def diagnostics_batch(xtt, g, u, v):
    """The six ops of zeta, div and ke (tests/test_apply_many.py's
    ``_diag_specs``) in one ``g.apply_many``, as gridops ufunc specs:
    (dv/dx, du/dy, du/dx, dv/dy, u_c, v_c)."""
    from xgcm_tpu_torch.core import gridops

    def spec(name, arg, axis):
        op = getattr(gridops, name)
        return dict(func=op.ufunc, args=[arg], axis=[(axis,)], signature=op.signature,
                    boundary_width=op.boundary_width)

    return g.apply_many([
        spec("diff_center_to_left", v, "X"), spec("diff_center_to_left", u, "Y"),
        spec("diff_left_to_center", u, "X"), spec("diff_left_to_center", v, "Y"),
        spec("interp_left_to_center", u, "X"), spec("interp_left_to_center", v, "Y"),
    ])


def check_diagnostics_batch(xtt, build, grid, sg2, u, v, mesh2, m2, card):
    """The six-op diagnostics batch on the 2 x 2 mesh: zeta, div and ke
    formed from it equal ``sharded_cgrid_diagnostics`` within the JAX
    test's rtol (1e-7), and each of the six results the single-device op
    bit for bit; no kernel launched, the fused program's four ppermutes,
    where the chain of six separate ops makes more."""
    from xgcm_tpu_torch.parallel.diagnostics import sharded_cgrid_diagnostics

    outs, launches, cc = counted_call(build, lambda: diagnostics_batch(xtt, sg2, u, v))
    expect_counts("diagnostics batch", launches, cc, no_kernel(build), DIAGNOSTICS_BATCH_BUDGET)
    _, _, cc_chain = counted_call(build, lambda: [
        sg2.diff(v, "X"), sg2.diff(u, "Y"), sg2.diff(u, "X", to="center"),
        sg2.diff(v, "Y", to="center"), sg2.interp(u, "X", to="center"),
        sg2.interp(v, "Y", to="center")])
    if cc_chain["total"] <= cc["total"]:
        raise AssertionError(f"diagnostics batch: collectives {cc}, the six separate ops "
                             f"{cc_chain}: the batch should make fewer")
    singles = (grid.diff(v, "X"), grid.diff(u, "Y"), grid.diff(u, "X", to="center"),
               grid.diff(v, "Y", to="center"), grid.interp(u, "X", to="center"),
               grid.interp(v, "Y", to="center"))
    for name, got, want in zip(("dv/dx", "du/dy", "du/dx", "dv/dy", "u_c", "v_c"), outs,
                               singles):
        same_by_block(f"diagnostics batch {name}", got, want)
    dvdx, dudy, dudx, dvdy, u_c, v_c = outs
    fused = sharded_cgrid_diagnostics(grid, u, v, mesh2, m2)
    for name, got, want in zip(("zeta", "div", "ke"),
                               (dvdx - dudy, dudx + dvdy, 0.5 * (u_c * u_c + v_c * v_c)), fused):
        same_by_block(f"diagnostics batch {name}", got, want.with_data(want.data.full_tensor()),
                      rtol=METRIC_RTOL)
    log(f"phase 11: diagnostics batch (apply_many of six ops, {tuple(u.data.shape)} f32 on a "
        f"2 x 2 mesh): dv/dx, du/dy, du/dx, dv/dy, u_c, v_c == the single-device ops bit for "
        f"bit, zeta, div, ke == sharded_cgrid_diagnostics within rtol {METRIC_RTOL} (the JAX "
        f"test's); no kernel launched; collectives {cc} (the fused program's, the JAX "
        f"budget; the six separate ops make {cc_chain}) [{card}]")


def face_analysis_batch(g, xtt, th, u, v):
    """Phase 8's face analysis as one ``g.apply_many`` of its eight ops by
    name (the two theta diffs, the two vector diffs of zeta, the vector
    diffs of the divergence and the vector interps, each component with
    its partner), zeta and div formed from the results."""
    t = xtt.GriddedArray(th, ("face", "y", "x"), name="theta")
    gu = xtt.GriddedArray(u, ("face", "y", "xl"), name="u")
    gv = xtt.GriddedArray(v, ("face", "yl", "x"), name="v")
    dtx, dty, dvx, duy, dux, dvy, u_c, v_c = g.apply_many([
        dict(op="diff", args=t, axis="X"),
        dict(op="diff", args=t, axis="Y"),
        dict(op="diff", args={"X": gv}, axis="X", other_component={"Y": gu}),
        dict(op="diff", args={"Y": gu}, axis="Y", other_component={"X": gv}),
        dict(op="diff", args={"X": gu}, axis="X", other_component={"Y": gv}),
        dict(op="diff", args={"Y": gv}, axis="Y", other_component={"X": gu}),
        dict(op="interp", args={"X": gu}, axis="X", to="center", other_component={"Y": gv}),
        dict(op="interp", args={"Y": gv}, axis="Y", to="center", other_component={"X": gu}),
    ])
    return {"dtheta_dx": dtx, "dtheta_dy": dty, "zeta": dvx - duy, "div": dux + dvy,
            "u_c": u_c, "v_c": v_c}


def check_face_batch(xtt, build, dev, sgf, th, lu, lv, single, card):
    """The face analysis as one apply_many on the face-sharded grid: every
    result equals phase 8's single-device analysis value for value, no
    kernel launched (the gridops ufuncs run on the padded blocks), the
    JAX budget of collectives; logs the peak memory above what the caller
    holds."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out, launches, cc = counted_call(build, lambda: face_analysis_batch(sgf, xtt, th, lu, lv))
    peak = (torch.cuda.max_memory_allocated(dev) - held) / 1e9
    expect_counts("face analysis batch", launches, cc, no_kernel(build), FACE_BATCH_BUDGET)
    for name, got in out.items():
        same_faces(f"face analysis batch {name}", got, single[name])
    log(f"phase 11: face analysis batch (apply_many of its eight ops, {tuple(th.shape)} f32, "
        f"faces over {sgf.mesh.devices.size} shards) == phase 8's single-device face analysis "
        f"value for value (NaN and infinities in the same places); no kernel launched; "
        f"collectives {cc} (the JAX budget; the separate ops make 14 all_gathers); peak device "
        f"memory {peak:.2f} GB above the inputs and the single-device results [{card}]")


def face_analysis_2d(g, xtt, th, u, v):
    """Phase 8's face analysis with the divergence through the vector
    wrapper ``diff_2d_vector`` (which moves components to the cell centres
    only, so the vorticity keeps its two vector diffs onto the corners) and
    the interpolation through ``interp_2d_vector``; eight E ops, as
    :func:`face_analysis`."""
    t = xtt.GriddedArray(th, ("face", "y", "x"), name="theta")
    gu = xtt.GriddedArray(u, ("face", "y", "xl"), name="u")
    gv = xtt.GriddedArray(v, ("face", "yl", "x"), name="v")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        dvg = g.diff_2d_vector({"X": gu, "Y": gv})
        vec = g.interp_2d_vector({"X": gu, "Y": gv}, to="center")
    zeta = (g.diff({"X": gv}, "X", other_component={"Y": gu})
            - g.diff({"Y": gu}, "Y", other_component={"X": gv}))
    return {"dtheta_dx": g.diff(t, "X"), "dtheta_dy": g.diff(t, "Y"), "zeta": zeta,
            "div": dvg["X"] + dvg["Y"], "u_c": vec["X"], "v_c": vec["Y"]}


def face_ring_grid(xtt, n):
    """Four n x n faces joined along X in a ring: a face grid with no
    axis-swapping connection, on which the shifting cumsum is defined."""
    ds = xtt.Dataset(coords={
        "x": ("x", np.arange(n) + 0.5, {"axis": "X"}),
        "xl": ("xl", np.arange(n) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
        "y": ("y", np.arange(n) + 0.5, {"axis": "Y"}),
        "yl": ("yl", np.arange(n) * 1.0, {"axis": "Y", "c_grid_axis_shift": -0.5}),
        "face": ("face", np.arange(4)),
    })
    fc = {"face": {i: {"X": (((i - 1) % 4, "X", False), ((i + 1) % 4, "X", False))}
                   for i in range(4)}}
    return xtt.Grid(ds, face_connections=fc)


def same_faces(label, got, want):
    """A face-sharded result (the real faces, assembled) against the
    single-device one: the same dims and shape, equal values with NaN and
    infinities in the same places, face by face."""
    if got.dims != want.dims or tuple(got.data.shape) != tuple(want.data.shape):
        raise AssertionError(f"{label}: {got.dims} {tuple(got.data.shape)}, single-device "
                             f"{want.dims} {tuple(want.data.shape)}")
    for f, (a, b) in enumerate(zip(got.data.unbind(-3), want.data.unbind(-3))):
        if not same_values(a, b):
            raise AssertionError(f"{label}: face {f} differs from the single-device result")


def face_sharded_part(xtt, build, gen, dev, card, timed, n=NX):
    """Phase 11's face-sharded route: phase 8's inputs (one LLC level of 13
    n x n f32 faces, N(0, 1) with NaN and +-inf on face-edge cells) with the
    face dim over four shards (16 faces with the dummy ones), the face
    analysis as eight separate ops and as one apply_many, and a face x rows
    mesh of 2 x 2; each result against the single-device call."""
    from xgcm_tpu_torch import parallel as par

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _, lgrid = xtt.grids.llc_grid(n=n)
    th, lu, lv = (edge_nonfinite(torch.randn((N_FACES, n, n), generator=gen, device=dev))
                  for _ in range(3))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    single = face_analysis(lgrid, xtt, th, lu, lv)
    mesh = par.make_mesh({"f": N_SHARDS}, devices=phase_devices(dev, N_SHARDS))
    sgf = par.ShardedGrid(lgrid, mesh, {"face": "f"})
    torch.cuda.reset_peak_memory_stats(dev)
    out, launches, cc = counted_call(build, lambda: face_analysis_2d(sgf, xtt, th, lu, lv))
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    want_cc = {"all_gather": 2 * FACE_BUDGET["scalar"]["all_gather"]
               + 6 * FACE_BUDGET["vector"]["all_gather"]}
    expect_counts("face-sharded face analysis", launches, cc,
                  {"face_shift": 8 * N_SHARDS, "shift": 0}, want_cc)
    for name, got in out.items():
        same_faces(f"face-sharded {name}", got, single[name])
    del out
    check_face_batch(xtt, build, dev, sgf, th, lu, lv, single, card)
    fpd = -(-N_FACES // N_SHARDS)
    log(f"phase 11: face-sharded face analysis ({N_FACES} x {n} x {n} f32, {fpd} faces a shard "
        f"with {fpd * N_SHARDS - N_FACES} dummy faces; dtheta/dx, dtheta/dy, zeta, div "
        f"through diff_2d_vector, the vector interp) == phase 8's single-device face analysis "
        f"value for value (NaN and infinities in the same places); kernel E "
        f"{launches['face_shift']} launches (8 ops x {N_SHARDS} blocks), kernel A none; "
        f"collectives {cc} (the JAX budget); peak device memory {peak:.2f} GB above the "
        f"inputs and the single-device results [{card}]")
    del single
    timed(f"face analysis (faces over {N_SHARDS})", lambda: face_analysis_2d(sgf, xtt, th, lu, lv),
          lambda: face_analysis(lgrid, xtt, th, lu, lv))
    timed(f"face analysis batch (apply_many, faces over {N_SHARDS})",
          lambda: face_analysis_batch(sgf, xtt, th, lu, lv),
          lambda: face_analysis(lgrid, xtt, th, lu, lv),
          other=("eight separate ops", lambda: face_analysis_2d(sgf, xtt, th, lu, lv)))

    # the face x rows decomposition: 7 faces a shard (one dummy), the rows
    # of each face in two halves
    mesh2 = par.make_mesh({"f": 2, "y": 2}, devices=phase_devices(dev, 4))
    sg2 = par.ShardedGrid(lgrid, mesh2, {"face": "f", "y": "y", "yl": "y"})
    gu = xtt.GriddedArray(lu, ("face", "y", "xl"), name="u")
    gv = xtt.GriddedArray(lv, ("face", "yl", "x"), name="v")

    def vector_diff(g):
        return g.diff({"X": gu}, "X", boundary="fill", other_component={"Y": gv})

    torch.cuda.reset_peak_memory_stats(dev)
    out, launches, cc = counted_call(build, lambda: vector_diff(sg2))
    expect_counts("face x rows vector diff", launches, cc, {"face_shift": 4, "shift": 0},
                  FACE_ROWS_VECTOR_BUDGET)
    same_faces("face x rows vector diff", out, vector_diff(lgrid))
    log(f"phase 11: face x rows (2 x 2) vector diff X == the single-device diff value for "
        f"value; kernel E 4 launches; collectives {cc} (the JAX budget); peak device memory "
        f"{(torch.cuda.max_memory_allocated(dev) - base) / 1e9:.2f} GB above the inputs [{card}]")
    del out
    timed("face x rows (2 x 2) vector diff X", lambda: vector_diff(sg2),
          lambda: vector_diff(lgrid))
    del th, lu, lv, gu, gv
    torch.cuda.empty_cache()

    rgrid = face_ring_grid(xtt, n)
    # positive values, so that every prefix sum is far from 0 (rtol alone)
    q = xtt.GriddedArray(torch.rand((4, n, n), generator=gen, device=dev).add_(20.0),
                         ("face", "y", "x"), name="q")

    def face_cumsum():
        return par.sharded_face_cumsum(rgrid, q, "Y", mesh2, "f", "X", "Y", to="left",
                                       boundary="fill", interior_mesh_axis="y")

    out, launches, cc = counted_call(build, face_cumsum)
    expect_counts("face x rows cumsum Y", launches, cc, {"face_shift": 0, "shift": 0},
                  FACE_ROWS_CUMSUM_BUDGET)
    want = rgrid.cumsum(q, "Y", to="left", boundary="fill")
    got = out.with_data(out.data.full_tensor())
    if got.dims != want.dims or not bool(torch.isclose(got.data, want.data, rtol=CUMSUM_RTOL,
                                                       atol=0.0).all()):
        raise AssertionError("face x rows cumsum Y: differs from the single-device cumsum")
    log(f"phase 11: face x rows (2 x 2) cumsum Y to=left on a 4-face ring ({n} x {n} faces) == "
        f"the single-device cumsum within rtol {CUMSUM_RTOL:.2e}; collectives {cc} (the JAX "
        f"budget) [{card}]")
    del out, got, want
    timed("face x rows (2 x 2) cumsum Y", face_cumsum,
          lambda: rgrid.cumsum(q, "Y", to="left", boundary="fill"))
    del q
    torch.cuda.empty_cache()


def run_sharded_phase(seed):
    """Phase 11 in a process of its own, which this one waits for (as
    phase 10, for torch.profiler's sake).  Fails when the phase fails."""
    cmd = [sys.executable, str(pathlib.Path(__file__).resolve()), "--sharded-phase",
           "--seed", str(seed)]
    sys.stdout.flush()
    rc = subprocess.run(cmd, timeout=900).returncode
    if rc != 0:
        raise AssertionError(f"phase 11 failed (exit code {rc})")


def sharded_phase_main(seed) -> int:
    """The entry of the process run_sharded_phase starts."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is false")
    xtt = import_port()
    from xgcm_tpu_torch.ops.kernels import build

    build.load_library()  # built by the parent process
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    sharded_phase(xtt, build, gen, dev, card_line())
    return 0


# ---- phase 12: the multi-process runtime ------------------------------------------
MP_PROCESSES = 2  # processes of the multi-process phase
MP_TIMEOUT_S = 480  # the two processes of one layout, from start to exit
MP_COLLECTIVE_TIMEOUT_S = 300  # gloo's and NCCL's: a collective with no match fails


def run_multiprocess_phase(seed, shape=None):
    """Phase 12: two processes on ``cuda:0`` over gloo, CUDA blocks staged
    through host memory; then, where there are two cards, one process a
    card over NCCL.  Each layout's two processes are children of this one,
    which waits for both, kills both when either fails or the pair runs
    past MP_TIMEOUT_S, and fails then.  ``shape`` (nz, ny, nx) cuts the
    phase's sizes."""
    layouts = ["gloo"]
    if torch.cuda.device_count() >= MP_PROCESSES:
        layouts.append("nccl")
    else:
        log(f"phase 12: the NCCL layout (one process a card) needs {MP_PROCESSES} cards; this "
            f"machine has {torch.cuda.device_count()}, so it runs the gloo layout only (not a "
            "failure)")
    for backend in layouts:
        run_multiprocess_pair(seed, backend, shape)


def run_multiprocess_pair(seed, backend, shape=None):
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, str(pathlib.Path(__file__).resolve()), "--multiprocess-child",
               "--backend", backend, "--init", f"file://{d}/init", "--seed", str(seed)]
        if shape is not None:
            cmd += ["--shape", ",".join(str(n) for n in shape)]
        sys.stdout.flush()
        procs = []
        for rank in range(MP_PROCESSES):
            env = dict(os.environ, LOCAL_RANK=str(rank))
            procs.append(subprocess.Popen(cmd + ["--rank", str(rank)], env=env))
        deadline = time.monotonic() + MP_TIMEOUT_S
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            late = [p for p in procs if p.poll() is None]
            for p in late:
                p.kill()
            for p in procs:
                p.wait()
        codes = [p.returncode for p in procs]
        if late or any(codes):
            raise AssertionError(f"phase 12 ({backend}) failed: exit codes {codes}"
                                 + (f", {len(late)} process(es) killed" if late else ""))


def multiprocess_child_main(seed, rank, init, backend, shape) -> int:
    """The entry of each process run_multiprocess_pair starts."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is false")
    xtt = import_port()
    from xgcm_tpu_torch import parallel as par
    from xgcm_tpu_torch.ops.kernels import build

    build.load_library()  # built by the parent process
    if not par.init_distributed(init, MP_PROCESSES, rank, backend=backend,
                                timeout=MP_COLLECTIVE_TIMEOUT_S):
        raise RuntimeError("init_distributed did not start the runtime")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    nz, ny, nx = shape or (NZ, NY, NX)
    try:
        multiprocess_phase(xtt, build, gen, dev, card_line(), backend, nz=nz, ny=ny, nx=nx,
                           timing=shape is None)
    finally:
        torch.distributed.destroy_process_group()
    return 0


# the bytes a process sent in phase 12's ring diff X periodic, in its ring
# diff X extend, and in one face-analysis result's assembly (8 faces)
PROBE_BYTES = (NZ * NY * 4, 9 * NZ * NY * 4, 8 * NY * NX * 4)


def transport_probe(dev, backend, card, reps=3):
    """The parts of the transport, timed alone for PROBE_BYTES each way
    between the two processes: under gloo the staging copy to host memory
    (``.cpu()``), the exchange of host buffers (one ``batch_isend_irecv``)
    and the copy back (``.to(dev)``); under NCCL the exchange of device
    buffers.  Host clock, mean of ``reps``, logged by rank 0."""
    dist = torch.distributed
    peer = 1 - dist.get_rank()
    parts = []
    for n in PROBE_BYTES:
        src = torch.full((n,), 7, dtype=torch.uint8, device=dev)
        ms = {}

        def clock(name, fn):
            fn()
            ms[name] = 0.0
            for _ in range(reps):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms[name] += (time.perf_counter() - t0) * 1e3 / reps

        if backend == "gloo":
            host, buf = src.cpu(), torch.empty(n, dtype=torch.uint8)
            clock("to host", lambda: src.cpu())
            clock("gloo exchange", lambda: [w.wait() for w in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, host, peer), dist.P2POp(dist.irecv, buf, peer)])])
            clock("to the card", lambda: buf.to(dev))
        else:
            buf = torch.empty_like(src)
            clock("NCCL exchange", lambda: [w.wait() for w in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, src, peer), dist.P2POp(dist.irecv, buf, peer)])])
        if not torch.equal(buf.to(dev), src):
            raise AssertionError(f"transport probe: {n} bytes arrived changed")
        parts.append(f"{n} B: " + ", ".join(
            f"{k} {v:.4f} ms ({n / v / 1e6:.3f} GB/s)" for k, v in ms.items()))
        del src, buf
    if dist.get_rank() == 0:
        log(f"time phase 12 transport ({backend}, host clock, mean of {reps}, each way at once): "
            + "; ".join(parts) + f" [{card}]")


def multiprocess_phase(xtt, build, gen, dev, card, backend, nz=NZ, ny=NY, nx=NX, timing=True):
    """Phase 12, in one of two processes: the routes of phase 11 on meshes
    whose coordinates the two processes share (two blocks each on
    ``{"x": 4}`` and ``{"f": 4}``, one on ``{"z": 2}``, a row of
    ``{"y": 2, "x": 2}``), each process holding its blocks against the
    single-device result it computes on its card, with its launches (its
    own blocks'), its collectives (phase 11's budgets), the bytes that
    crossed to the other process, its peak memory, and the wall time
    between barriers beside the one-process time on four logical
    shards."""
    from xgcm_tpu_torch import parallel as par
    from xgcm_tpu_torch.parallel import collectives
    from xgcm_tpu_torch.parallel.diagnostics import sharded_cgrid_diagnostics

    dist = torch.distributed
    rank = dist.get_rank()
    per = N_SHARDS // MP_PROCESSES  # blocks a process holds on a 4-shard mesh
    tag = f"phase 12 [{backend}, rank {rank} on {dev}]"
    t_phase = time.perf_counter()
    times, moved = [], {}

    def meshes(axes):
        """(the mesh over both processes, the one-process mesh of logical
        shards of this card)."""
        n = int(np.prod(list(axes.values())))
        return (par.make_multihost_mesh(axes, devices=[dev] * (n // MP_PROCESSES)),
                par.make_mesh(axes, devices=[dev] * n))

    def call(label, fn):
        """``fn()`` with the launches, collectives and bytes counted."""
        collectives.TRANSPORT.clear()
        out, launches, cc = counted_call(build, fn)
        moved[label] = dict(collectives.TRANSPORT)
        return out, launches, cc

    def wall_ms(fn, reps=3):
        """(mean, min) ms of ``fn`` between barriers of both processes."""
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            dist.barrier()
            ms.append((time.perf_counter() - t0) * 1e3)
        return sum(ms) / reps, min(ms)

    def timed(name, two, one, single):
        """The two-process wall time of ``two``; on rank 0, while rank 1
        waits, phase 11's CUDA-event times of ``one`` (four logical shards
        in one process) and ``single``."""
        if not timing:
            return
        mean, least = wall_ms(two)
        one_ms = single_ms = None
        if rank == 0:
            one_ms, single_ms = time_pair(one, single, reps=3)
        dist.barrier()
        times.append((name, mean, least, one_ms, single_ms))

    def peak_gb():
        return torch.cuda.max_memory_allocated(dev) / 1e9

    def fresh():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # (1) the ring route, the cumsum and the metric route on {"x": 4}
    fresh()
    grid = budget_grid(xtt, nx, ny, nz)
    theta = sharded_inputs(gen, dev, nz, ny, nx)
    # NaN and -inf either side of the process boundary too
    theta[4, 1, nx // 2 - 1] = float("nan")
    theta[0, 3, nx // 2] = -float("inf")
    th = xtt.GriddedArray(theta, ("zc", "yc", "xc"), name="theta")
    del theta
    mesh, mesh1 = meshes({"x": N_SHARDS})
    log(f"{tag}: mesh {mesh}, this process holds {mesh.local_coords}; theta ({nz}, {ny}, {nx}) "
        f"f32, {nx // N_SHARDS} columns a block")
    sg, sg1 = par.ShardedGrid(grid, mesh, {"X": "x"}), par.ShardedGrid(grid, mesh1, {"X": "x"})
    th_sh = sg.shard(th)
    for bc in ("periodic", "fill", "extend"):
        for op in SHIFT_OPS:
            label = f"ring {op} X {bc}"
            out, launches, cc = call(label, lambda: getattr(sg, op)(th_sh, "X", boundary=bc,
                                                                   fill_value=1.5))
            expect_counts(f"{tag} {label}", launches, cc, {"face_shift": per, "shift": 0},
                          RING_BUDGET[bc])
            same_by_block(f"{tag} {label}", out, getattr(grid, op)(th, "X", boundary=bc,
                                                                    fill_value=1.5))
            del out
    log(f"{tag}: ring route: diff, interp, min, max along X under periodic, fill and extend == "
        f"the single-device op bit for bit on this process's blocks, kernel E {per} launches "
        f"(its blocks) and A none per op, collectives {RING_BUDGET} (phase 11's, the JAX "
        f"budget); bytes to/from the other process: "
        + "; ".join(f"{bc} {moved[f'ring diff X {bc}']}" for bc in ("periodic", "fill", "extend"))
        + f"; peak device memory {peak_gb():.2f} GB [{card}]")
    for bc in ("fill", "periodic"):
        label = f"cumsum X to=left {bc}"
        out, launches, cc = call(label, lambda: sg.cumsum(th_sh, "X", to="left", boundary=bc))
        expect_counts(f"{tag} {label}", launches, cc, {"face_shift": 0, "shift": 0},
                      CUMSUM_BUDGET[bc])
        same_by_block(f"{tag} {label}", out, grid.cumsum(th, "X", to="left", boundary=bc),
                      rtol=CUMSUM_RTOL)
        del out
    out, launches, cc = call("derivative X", lambda: sg.derivative(th_sh, "X"))
    expect_counts(f"{tag} derivative X", launches, cc, {"face_shift": per, "shift": 0},
                  RING_BUDGET["periodic"])
    same_by_block(f"{tag} derivative X", out, grid.derivative(th, "X"), rtol=METRIC_RTOL)
    del out
    log(f"{tag}: cumsum X to=left (fill, periodic) within rtol {CUMSUM_RTOL:.2e} and derivative "
        f"X within {METRIC_RTOL} of the single-device calls, collectives {CUMSUM_BUDGET} and "
        f"{RING_BUDGET['periodic']}; bytes: cumsum fill {moved['cumsum X to=left fill']}, "
        f"derivative {moved['derivative X']}; peak device memory {peak_gb():.2f} GB [{card}]")
    if timing:
        th_1 = sg1.shard(th) if rank == 0 else None
        for bc in ("periodic", "extend"):
            timed(f"ring diff X {bc}", lambda: sg.diff(th_sh, "X", boundary=bc),
                  lambda: sg1.diff(th_1, "X", boundary=bc), lambda: grid.diff(th, "X", boundary=bc))
        timed("cumsum X to=left fill", lambda: sg.cumsum(th_sh, "X", to="left", boundary="fill"),
              lambda: sg1.cumsum(th_1, "X", to="left", boundary="fill"),
              lambda: grid.cumsum(th, "X", to="left", boundary="fill"))
        timed("derivative X", lambda: sg.derivative(th_sh, "X"),
              lambda: sg1.derivative(th_1, "X"), lambda: grid.derivative(th, "X"))
        del th_1
    del th_sh
    peaks = {"ring, cumsum, derivative": peak_gb()}

    # (2) the batch route: Z over {"z": 2}, one block and one launch of A a process
    fresh()
    mesh_z, mesh_z1 = meshes({"z": 2})
    sgz, sgz1 = par.ShardedGrid(grid, mesh_z, {"zc": "z"}), par.ShardedGrid(grid, mesh_z1,
                                                                            {"zc": "z"})
    th_z = sgz.shard(th)
    out, launches, cc = call("batch diff X", lambda: sgz.diff(th_z, "X"))
    expect_counts(f"{tag} batch diff X", launches, cc, {"shift": 1, "face_shift": 0}, {})
    same_by_block(f"{tag} batch diff X", out, grid.diff(th, "X"))
    del out
    log(f"{tag}: batch route: diff X with Z over 2 processes == the single-device diff bit for "
        f"bit, kernel A 1 launch, no collective, bytes {moved['batch diff X']}; peak device "
        f"memory {peak_gb():.2f} GB [{card}]")
    if timing:
        th_z1 = sgz1.shard(th) if rank == 0 else None
        timed("batch diff X (Z over 2)", lambda: sgz.diff(th_z, "X"),
              lambda: sgz1.diff(th_z1, "X"), lambda: grid.diff(th, "X"))
        del th_z1
    del th_z, th
    peaks["batch"] = peak_gb()

    # (3) the sharded C-grid diagnostics on {"y": 2, "x": 2}: a row each
    fresh()
    u = xtt.GriddedArray(torch.randn((ny, nx), generator=gen, device=dev), ("yc", "xg"), name="u")
    v = xtt.GriddedArray(torch.randn((ny, nx), generator=gen, device=dev), ("yg", "xc"), name="v")
    mesh2, mesh21 = meshes({"y": 2, "x": 2})
    m2 = {"xc": "x", "xg": "x", "yc": "y", "yg": "y"}

    def chain(g):
        zeta = g.diff(v, "X") - g.diff(u, "Y")
        div = g.diff(u, "X", to="center") + g.diff(v, "Y", to="center")
        u_c, v_c = g.interp(u, "X", to="center"), g.interp(v, "Y", to="center")
        return zeta, div, 0.5 * (u_c * u_c + v_c * v_c)

    fused, launches, cc = call("diagnostics",
                               lambda: sharded_cgrid_diagnostics(grid, u, v, mesh2, m2))
    expect_counts(f"{tag} sharded diagnostics", launches, cc,
                  {"shift": 0, "face_shift": 0, "cgrid_diagnostics": 0}, {"ppermute": 4})
    for name, f, one in zip(("zeta", "div", "ke"), fused, chain(grid)):
        same_by_block(f"{tag} diagnostics {name}", f, one)
    del fused
    log(f"{tag}: sharded diagnostics {ny}x{nx} f32: zeta, div, ke == the single-device Grid ops "
        f"bit for bit; 4 ppermutes, no kernel; bytes {moved['diagnostics']} [{card}]")
    timed("sharded diagnostics (2 x 2)", lambda: sharded_cgrid_diagnostics(grid, u, v, mesh2, m2),
          lambda: sharded_cgrid_diagnostics(grid, u, v, mesh21, m2), lambda: chain(grid))
    del u, v
    peaks["diagnostics"] = peak_gb()

    # (4) the per-shard linear transform: the density columns of the face,
    # X over {"x": 4}, kernel C once per block
    fresh()
    sig_b, sig_c, (field,) = density_columns(gen, dev, ny * nx, n=nz, nv=1)
    del sig_b
    _, levels = density_targets(dev)
    dgrid = density_grid(xtt, nz=nz)
    T = xtt.GriddedArray(field.view(ny, nx, nz), ("y", "x", "zc"), name="T")
    sc = xtt.GriddedArray(sig_c.view(ny, nx, nz), ("y", "x", "zc"), name="sigma")
    del field, sig_c
    single = dgrid.transform(T, "Z", levels, target_data=sc)
    sgd, sgd1 = (par.ShardedGrid(dgrid, m, {"x": "x"}) for m in (mesh, mesh1))
    T_sh, sc_sh = sgd.shard(T), sgd.shard(sc)
    out, launches, cc = call("transform linear",
                             lambda: sgd.transform(T_sh, "Z", levels, target_data=sc_sh))
    expect_counts(f"{tag} per-shard interp_linear", launches, cc, {"interp_linear": per}, {})
    same_by_block(f"{tag} per-shard interp_linear", out, single)
    del out, single
    log(f"{tag}: per-shard linear transform ({per} of {N_SHARDS} x {nx // N_SHARDS} x {ny} "
        f"columns of {nz} levels) == the single-device call bit for bit, kernel C {per} "
        f"launches, no collective, bytes {moved['transform linear']}; peak device memory "
        f"{peak_gb():.2f} GB [{card}]")
    if timing:
        T_1, sc_1 = (sgd1.shard(T), sgd1.shard(sc)) if rank == 0 else (None, None)
        timed("per-shard interp_linear",
              lambda: sgd.transform(T_sh, "Z", levels, target_data=sc_sh),
              lambda: sgd1.transform(T_1, "Z", levels, target_data=sc_1),
              lambda: dgrid.transform(T, "Z", levels, target_data=sc))
        del T_1, sc_1
    del T, sc, T_sh, sc_sh
    peaks["transform"] = peak_gb()

    # (5) phase 8's face analysis with the faces over {"f": 4}: two face
    # blocks a process, 16 faces with the three dummy ones
    fresh()
    _, lgrid = xtt.grids.llc_grid(n=nx)
    fth, lu, lv = (edge_nonfinite(torch.randn((N_FACES, nx, nx), generator=gen, device=dev))
                   for _ in range(3))
    single = face_analysis(lgrid, xtt, fth, lu, lv)
    meshf, meshf1 = meshes({"f": N_SHARDS})
    sgf, sgf1 = (par.ShardedGrid(lgrid, m, {"face": "f"}) for m in (meshf, meshf1))
    out, launches, cc = call("face analysis", lambda: face_analysis_2d(sgf, xtt, fth, lu, lv))
    want_cc = {"all_gather": 2 * FACE_BUDGET["scalar"]["all_gather"]
               + 6 * FACE_BUDGET["vector"]["all_gather"]}
    expect_counts(f"{tag} face analysis", launches, cc, {"face_shift": 8 * per, "shift": 0},
                  want_cc)
    for name, got in out.items():
        same_faces(f"{tag} face analysis {name}", got, single[name])
    del out
    out, launches, cc = call("face analysis batch",
                             lambda: face_analysis_batch(sgf, xtt, fth, lu, lv))
    expect_counts(f"{tag} face analysis batch", launches, cc, no_kernel(build), FACE_BATCH_BUDGET)
    for name, got in out.items():
        same_faces(f"{tag} face analysis batch {name}", got, single[name])
    del out
    log(f"{tag}: face analysis ({N_FACES} x {nx} x {nx} f32, faces over 4 shards of 2 "
        f"processes) as eight ops == phase 8's single-device analysis value for value, kernel E "
        f"{8 * per} launches (8 ops x {per} blocks), collectives {want_cc}, bytes "
        f"{moved['face analysis']}; as one apply_many the same, no kernel, collectives "
        f"{FACE_BATCH_BUDGET}, bytes {moved['face analysis batch']}; peak device memory "
        f"{peak_gb():.2f} GB [{card}]")
    del single
    timed("face analysis (faces over 4)", lambda: face_analysis_2d(sgf, xtt, fth, lu, lv),
          lambda: face_analysis_2d(sgf1, xtt, fth, lu, lv),
          lambda: face_analysis(lgrid, xtt, fth, lu, lv))
    timed("face analysis batch (apply_many, faces over 4)",
          lambda: face_analysis_batch(sgf, xtt, fth, lu, lv),
          lambda: face_analysis_batch(sgf1, xtt, fth, lu, lv),
          lambda: face_analysis(lgrid, xtt, fth, lu, lv))
    del fth, lu, lv
    peaks["face analysis"] = peak_gb()
    fresh()

    if timing:
        transport_probe(dev, backend, card)

    both = [None] * MP_PROCESSES
    dist.all_gather_object(both, peaks)
    if rank == 0:
        log(f"phase 12 [{backend}]: peak device memory per process (GB, rank 0 / rank 1): "
            + "; ".join(f"{k} {both[0][k]:.2f} / {both[1][k]:.2f}" for k in peaks)
            + f"; at most {max(sum(b[k] for b in both) for k in peaks):.2f} GB on the card(s) "
            f"together [{card}]")
        for name, mean, least, one_ms, single_ms in times:
            log(f"time phase 12 {name} ({backend}, {MP_PROCESSES} processes): {mean:.4f} ms "
                f"(wall between barriers, mean of 3; least {least:.4f}), one process of four "
                f"logical shards {one_ms:.4f} ms, single-device {single_ms:.4f} ms (CUDA "
                f"events) [{card}]")
    log(f"{tag}: {time.perf_counter() - t_phase:.1f} s")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    # phase 10 alone, in the process run_xarray_phase starts
    parser.add_argument("--xarray-phase", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--shift-ms", type=float, default=None, help=argparse.SUPPRESS)
    # phase 11 alone, as the process run_sharded_phase starts
    parser.add_argument("--sharded-phase", action="store_true",
                        help="run phase 11, the sharded layer, alone")
    parser.add_argument("--multiprocess-phase", action="store_true",
                        help="run phase 12, the multi-process runtime, alone")
    # one process of phase 12, as run_multiprocess_pair starts it
    parser.add_argument("--multiprocess-child", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--backend", default="gloo", help=argparse.SUPPRESS)
    parser.add_argument("--init", help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--shape", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.xarray_phase:
        return xarray_phase_main(args.seed, args.shift_ms)
    if args.sharded_phase:
        return sharded_phase_main(args.seed)
    if args.multiprocess_child:
        shape = tuple(int(n) for n in args.shape.split(",")) if args.shape else None
        return multiprocess_child_main(args.seed, args.rank, args.init, args.backend, shape)
    if args.multiprocess_phase:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: torch.cuda.is_available() is false")
        import_port()
        from xgcm_tpu_torch.ops.kernels import build

        build.build_library()
        log(f"card: {card_line()}")
        run_multiprocess_phase(args.seed)
        return 0

    # ---- phase 1: device ------------------------------------------------
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is false")
    xtt = import_port()
    from xgcm_tpu_torch.entry import build_grid, step
    from xgcm_tpu_torch.ops.diagnostics import cgrid_diagnostics as diagnostics_op
    from xgcm_tpu_torch.ops.kernels import build
    from xgcm_tpu_torch.ops.kernels.cgrid_diagnostics import (
        cgrid_diagnostics, cgrid_diagnostics_plain)
    from xgcm_tpu_torch.ops.kernels.interp_linear import _fused_ref_torch, interp_linear
    from xgcm_tpu_torch.ops.kernels.face_shift import face_shift, face_shift_plain
    from xgcm_tpu_torch.ops.kernels.shift import shift, shift_plain
    from xgcm_tpu_torch.ops.kernels.vorticity import vorticity, vorticity_plain

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")

    # ---- phase 2: build -------------------------------------------------
    t0 = time.perf_counter()
    report_io = io.StringIO()
    with contextlib.redirect_stdout(report_io):
        lib_path = build.build_library(verbose=True)
    build.load_library()
    ptxas = report_io.getvalue()
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", ptxas)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", ptxas))
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}; {len(regs)} kernels, "
        f"registers {min(regs)}-{max(regs)}, spill stores {spills} bytes")
    per_kernel = re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) registers", ptxas,
                            re.S)
    for source, kernel, what in (
            ("interp_linear.cu", "interp_linear_kernel", "NV = 1..8 x 4 dtype pairs"),
            ("conservative.cu", "conservative_kernel", "NV = 1..8 x 4 dtype pairs"),
            ("shift.cu", "shift_rows", "4 dtypes x vector/scalar x 32/64-bit offsets"),
            ("shift.cu", "shift_planes", "4 dtypes x vector/scalar x 32/64-bit offsets")):
        regs_of = [int(r) for fn, r in per_kernel if kernel in fn]
        if regs_of:
            log(f"build: {source} {kernel}, {len(regs_of)} instantiations ({what}), "
                f"registers {min(regs_of)}-{max(regs_of)}")
    # spill stores of each entry function, from its block of the report
    spilled = {}
    for block in ptxas.split("Compiling entry function '")[1:]:
        found = re.search(r"(\d+) bytes spill stores", block)
        if found and int(found.group(1)):
            spilled[block.split("'", 1)[0]] = int(found.group(1))
    log(f"build: entry functions with spill stores (bytes): {spilled}")

    # ---- phase 3: each kernel against its plain version ---------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    check = Checker()
    check_shift(check, gen, dev)
    u = torch.randn((NY, NX), generator=gen, device=dev)
    v = torch.randn((NY, NX), generator=gen, device=dev)
    ix = torch.rand((NX,), generator=gen, device=dev) + 0.5
    iy = torch.rand((NY,), generator=gen, device=dev) + 0.5
    check_diagnostics(check, u, v, ix, iy)
    check_vorticity(check, u, v, ix, iy)
    check_face_shift(check, gen, dev)
    th_c, ph_c = columns(gen, dev, 512 * 512, NZ)
    t_c = torch.linspace(-1.0, 27.0, N_TARGETS, device=dev)
    check_interp(check, gen, dev, th_c, ph_c, t_c)
    check_interp_cases(check, gen, dev)
    check_conservative_cases(check, gen, dev)
    dens_sample = check_density_kernels(check, gen, dev)
    torch.cuda.synchronize()

    # ---- phase 4: the main path at one LLC4320 face --------------------
    ug = torch.rand((NY, NX), generator=gen, device=dev)
    vg = torch.rand((NY, NX), generator=gen, device=dev)
    theta = torch.rand((NY, NX, NZ), generator=gen, device=dev).add_(0.01)
    theta = torch.cumsum(theta, -1)  # monotone columns
    targets = torch.linspace(0.5, 25.0, N_TARGETS, device=dev)
    grid = build_grid(NX, NY)
    gu = xtt.GriddedArray(ug, ("yc", "xg"))
    gv = xtt.GriddedArray(vg, ("yg", "xc"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    build.reset_launch_counts()
    t0 = time.perf_counter()
    zeta, div, ke_on_theta = step(ug, vg, theta, targets, grid=grid)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    d_zeta, d_div, d_ke = diagnostics_op(grid, gu, gv)
    torch.cuda.synchronize()
    launches = build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"phase 4: main-path launches {launches}; first step {step_s * 1e3:.1f} ms "
        f"(host clock); peak device memory {peak_gb:.2f} GB")
    for name, least in {"shift": 6, "cgrid_diagnostics": 1, "interp_linear": 1}.items():
        if launches[name] < least:
            raise AssertionError(f"main path launched {name} {launches[name]} times, "
                                 f"expected at least {least}")
    check_main_path(check, gen, dev,
                    (zeta, div, ke_on_theta, d_zeta.data, d_div.data, d_ke.data),
                    ug, vg, theta, targets)

    # ---- phase 5: timing ----------------------------------------------
    times, bounds, library = {}, {}, {}
    n_face = NY * NX
    times["shift"], library["shift"] = time_shift(check, card, ug)
    bounds["shift"] = bound(2 * n_face * 4, n_face)
    times["cgrid_diagnostics"] = time_pair(lambda: cgrid_diagnostics(u, v, ix, iy),
                                           lambda: cgrid_diagnostics_plain(u, v, ix, iy))
    log(f"time cgrid_diagnostics {NY}x{NX} f32: kernel {times['cgrid_diagnostics'][0]:.4f} ms, "
        f"plain {times['cgrid_diagnostics'][1]:.4f} ms [{card}]")
    # u, v and the three outputs; about 12 operations per point
    bounds["cgrid_diagnostics"] = bound((5 * n_face + NX + NY) * 4, 12 * n_face)
    k_ms, p_ms = time_pair(lambda: interp_linear(th_c, ph_c, t_c),
                           lambda: _fused_ref_torch(th_c, ph_c, t_c), reps=5)
    b_ms, b_by = linear_bound(th_c.shape[0], 1)
    log(f"time interp_linear {th_c.shape[0]} cols x {NZ} knots -> {N_TARGETS} f32: kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{card}]")
    cols = NY * NX
    ke_cols = d_ke.data[..., None].expand(NY, NX, NZ).reshape(cols, NZ)
    th_main = theta.reshape(cols, NZ)
    k_main, _ = time_pair(lambda: interp_linear(th_main, ke_cols, targets), reps=3)
    chunk = th_c.shape[0]

    def plain_main():  # the plain version one sample-sized slice of columns at a time
        for s in range(0, cols, chunk):
            _fused_ref_torch(th_main[s:s + chunk], ke_cols[s:s + chunk], targets)

    p_main, _ = time_pair(plain_main, reps=1)
    times["interp_linear"] = (k_main, p_main)
    # the step's phi is KE broadcast along the column: one value per column
    bounds["interp_linear"] = linear_bound(cols, 1, broadcast_phi=True)
    log(f"time interp_linear main path {cols} cols x {NZ} knots -> {N_TARGETS} f32, phi "
        f"broadcast: kernel {k_main:.4f} ms, plain {p_main:.4f} ms (in slices of {chunk} "
        f"columns), bound {bounds['interp_linear'][0]:.4f} ms ({bounds['interp_linear'][1]}) "
        f"[{card}]")
    step_ms, _ = time_pair(lambda: step(ug, vg, theta, targets, grid=grid), reps=3)
    diag_ms, _ = time_pair(lambda: diagnostics_op(grid, gu, gv))
    log(f"time step {NY}x{NX}x{NZ} -> {N_TARGETS} f32: {step_ms:.4f} ms; "
        f"cgrid_diagnostics op: {diag_ms:.4f} ms [{card}]")
    brk = device_breakdown(lambda: step(ug, vg, theta, targets, grid=grid))
    if brk is None:
        log("profile step: no device time from torch.profiler (not measured)")
    else:
        wall, busy, top = brk
        log(f"profile step: {wall:.4f} ms a step (CUDA events inside the profiler), kernels "
            f"{busy:.4f} ms, device idle share {max(0.0, 1 - busy / wall):.4f}; top kernels "
            + "; ".join(f"{name} {ms:.4f} ms" for name, ms in top) + f" [{card}]")

    # the vorticity benchmark configuration at one face: kernel D, driven
    # as the JAX package's bench drives fused_vorticity, beside the Grid
    # API's two shifts and the arithmetic, and kernel B
    def api_vorticity():
        dvdx = grid.diff(xtt.GriddedArray(v, ("yg", "xc")), "X")
        dudy = grid.diff(xtt.GriddedArray(u, ("yc", "xg")), "Y")
        return (dvdx * xtt.GriddedArray(ix, ("xg",))
                - dudy * xtt.GriddedArray(iy, ("yg",))).data

    torch.cuda.synchronize()
    build.reset_launch_counts()
    zeta_d = vorticity(u, v, ix, iy)
    torch.cuda.synchronize()
    launches["vorticity"] = build.launch_counts()["vorticity"]
    if launches["vorticity"] != 1:
        raise AssertionError(f"the vorticity configuration launched D "
                             f"{launches['vorticity']} times")
    if zeta_d.shape != (NY, NX) or not bool(torch.isfinite(zeta_d).all()):
        raise AssertionError("kernel D: wrong shape or non-finite vorticity")
    check.compare("vorticity", "config/Grid API", zeta_d, api_vorticity(), **TOL_F32)
    check.compare("vorticity", "config/kernel B", zeta_d, cgrid_diagnostics(u, v, ix, iy)[0],
                  **TOL_F32)
    times["vorticity"] = time_pair(lambda: vorticity(u, v, ix, iy),
                                   lambda: vorticity_plain(u, v, ix, iy))
    api_ms, _ = time_pair(api_vorticity)
    log(f"time vorticity {NY}x{NX} f32: kernel D {times['vorticity'][0]:.4f} ms, plain "
        f"{times['vorticity'][1]:.4f} ms, Grid API (two shift launches + arithmetic) "
        f"{api_ms:.4f} ms, kernel B (zeta, div, ke) {times['cgrid_diagnostics'][0]:.4f} ms "
        f"[{card}]")
    # u, v and zeta, with inv_dx and inv_dy; about 5 operations per point
    bounds["vorticity"] = bound((3 * n_face + NX + NY) * 4, 5 * n_face)

    # kernel E on one LLC4320 level against its plain version, the concat
    # formulation
    xf = torch.randn((N_FACES, NY, NX), generator=gen, device=dev)
    hf = torch.randn((N_FACES, NX), generator=gen, device=dev)
    for op, direction, axis_is_x in (("diff", "left", True), ("diff", "left", False),
                                     ("interp", "right", True)):
        k_ms, p_ms = time_pair(lambda: face_shift(xf, hf, op, direction, axis_is_x),
                               lambda: face_shift_plain(xf, hf, op, direction, axis_is_x))
        log(f"time face_shift {op}/{direction}/{'x' if axis_is_x else 'y'} {N_FACES}x{NY}x{NX} "
            f"f32: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms [{card}]")
        times.setdefault("face_shift", (k_ms, p_ms))
    # x in, out, and the halo; one operation per point
    bounds["face_shift"] = bound((2 * xf.numel() + hf.numel()) * 4, xf.numel())
    del xf, hf
    # kernel A at 3-D, after the other kernels' timings, as they ran before
    time_shift_3d(check, card, gen, dev)
    del theta, th_main, ke_cols, zeta, div, ke_on_theta, d_zeta, d_div, d_ke, gu, gv, zeta_d
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- phase 6: the density-space path at one LLC4320 face -----------
    sig_b, sig_c, fields = density_columns(gen, dev, cols)
    sig_b = sig_b.reshape(NY, NX, NZ + 1)
    sig_c = sig_c.reshape(NY, NX, NZ)
    fields = [f.reshape(NY, NX, NZ) for f in fields]
    edges, levels = density_targets(dev)
    dgrid = density_grid(xtt)
    das = [xtt.GriddedArray(f, ("y", "x", "zc"), name=nm)
           for f, nm in zip(fields, ("T", "S", "u", "v"))]
    sb = xtt.GriddedArray(sig_b, ("y", "x", "zo"), name="sigma")
    sc = xtt.GriddedArray(sig_c, ("y", "x", "zc"), name="sigma")
    idx = torch.randperm(cols, generator=gen, device=dev)[:SAMPLE]
    for name, call in density_calls(dgrid, das, sb, sc, edges, levels).items():
        outs, launches[name], ms, peak_gb = run_counted(name, call, build, dev)
        log(f"phase 6: {name} launched {launches[name]} time(s); first call {ms:.1f} ms (host "
            f"clock); peak device memory {peak_gb:.2f} GB")
        check_density_outputs(check, name, outs, sig_b, sig_c, fields, edges, levels, idx)
        del outs
        torch.cuda.empty_cache()
    check_density_small(gen, dev, xtt)
    torch.cuda.synchronize()

    # ---- phase 7: timing of the density kernels -------------------------
    from xgcm_tpu_torch.ops.kernels import conservative as kg
    from xgcm_tpu_torch.ops.kernels import interp_linear as kc

    s_b, s_c, s_phis, s_edges, s_levels = dens_sample
    s_cols = s_b.shape[0]
    pairs = {
        "conservative": (lambda: kg.conservative_rebin(s_b, s_phis[0], s_edges),
                         lambda: kg._conservative_plain(s_b, s_phis[0], s_edges)),
        "conservative_multi": (lambda: kg.conservative_rebin_multi(s_b, s_phis, s_edges),
                               lambda: kg._conservative_multi_plain(s_b, s_phis, s_edges)),
        "interp_linear_multi": (lambda: kc.interp_linear_multi(s_c, s_phis, s_levels, True),
                                lambda: kc._fused_multi_ref_torch(s_c, s_phis, s_levels, True)),
    }
    bounds["conservative"] = conservative_bound(s_cols, 1)
    bounds["conservative_multi"] = conservative_bound(s_cols, NV)
    bounds["interp_linear_multi"] = linear_bound(s_cols, NV)
    visits, busy = walk_lengths(s_b, s_edges)
    log(f"walk of conservative/conservative_multi on {s_cols} density columns: {visits:.4f} "
        f"cell visits per bin, lanes {busy:.4f} busy (32 consecutive items a warp)")
    for name, (kernel_fn, plain_fn) in pairs.items():
        times[name] = time_pair(kernel_fn, plain_fn, reps=5)
        log(f"time {name} {s_cols} cols x {NZ} levels, V = {1 if name == 'conservative' else NV}"
            f" f32: kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms, bound "
            f"{bounds[name][0]:.4f} ms ({bounds[name][1]}) [{card}]")
    b2, c2 = sig_b.reshape(cols, NZ + 1), sig_c.reshape(cols, NZ)
    f2 = [f.reshape(cols, NZ) for f in fields]
    face = {
        "conservative": (lambda: kg.conservative_rebin(b2, f2[0], edges),
                         conservative_bound(cols, 1)),
        "conservative_multi": (lambda: kg.conservative_rebin_multi(b2, f2, edges),
                               conservative_bound(cols, NV)),
        "interp_linear_multi": (lambda: kc.interp_linear_multi(c2, f2, levels, True),
                                linear_bound(cols, NV)),
        "interp_linear (V = 1, same inputs)": (lambda: kc.interp_linear(c2, f2[0], levels, True),
                                               linear_bound(cols, 1)),
    }
    for name, (kernel_fn, (b_ms, b_by)) in face.items():
        k_ms, _ = time_pair(kernel_fn, reps=3)
        log(f"time {name} main path {cols} cols x {NZ} levels f32: kernel {k_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), plain not measured (needs the dense "
            f"(cols, m, n) tensors) [{card}]")
    for name, call in density_calls(dgrid, das, sb, sc, edges, levels).items():
        a_ms, _ = time_pair(call, reps=3)
        log(f"time Grid API call of {name} {NY}x{NX}x{NZ} f32: {a_ms:.4f} ms [{card}]")

    # the loops' last callables hold the density inputs in their closures
    del s_b, s_c, s_phis, s_edges, s_levels, dens_sample, b2, c2, f2, face
    del sig_b, sig_c, fields, das, sb, sc, call, kernel_fn, plain_fn, pairs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- phase 8: the face analysis of one LLC4320 level ---------------
    _, lgrid = xtt.grids.llc_grid(n=NX)
    th, lu, lv = (edge_nonfinite(torch.randn((N_FACES, NY, NX), generator=gen, device=dev))
                  for _ in range(3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    results = face_analysis(lgrid, xtt, th, lu, lv)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches["face_shift"] = counts["face_shift"]
    log(f"phase 8: face analysis launches {counts}; first call {first_ms:.1f} ms (host clock); "
        f"peak device memory {peak_gb:.2f} GB")
    if counts["face_shift"] != 8 or counts["shift"] != 0:
        raise AssertionError(f"the face analysis launched face_shift {counts['face_shift']} "
                             f"and shift {counts['shift']} times, expected 8 and 0")
    generic = face_generic(lgrid, xtt, th, lu, lv)
    for name, got in results.items():
        want = generic[name]()
        if got.dims != want.dims or got.shape != (N_FACES, NY, NX):
            raise AssertionError(f"face analysis {name}: {got.dims} {got.shape}, generic "
                                 f"{want.dims} {want.shape}")
        compare_by_face(check, "face_shift", f"main/{name} vs generic", got.data, want.data,
                        exact=True)
        del want
    nan_cells = {name: int(torch.isnan(r.data).sum()) for name, r in results.items()}
    del results
    torch.cuda.empty_cache()
    log(f"phase 8: all six results == the generic halo engine, value for value (NaN cells "
        f"{nan_cells})")
    one = xtt.GriddedArray(torch.ones((N_FACES, NY, NX), device=dev), ("face", "y", "x"))
    for axis in ("X", "Y"):
        if int(torch.count_nonzero(lgrid.diff(one, axis, boundary="extend").data)) != 0:
            raise AssertionError(f"the {axis} gradient of a constant is not 0 on every face")
    del one
    log("phase 8: the gradient of a constant with boundary='extend' is 0 on every face")
    check_face_small(gen, dev, xtt)
    face_ms, _ = time_pair(lambda: face_analysis(lgrid, xtt, th, lu, lv), reps=3)
    log(f"time face analysis {N_FACES}x{NY}x{NX} f32 (8 face_shift launches, strip "
        f"gathers, the vorticity and divergence arithmetic): {face_ms:.4f} ms [{card}]")
    del th, lu, lv
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- phase 9: the metric path at one LLC4320 face -------------------
    metric_phase(xtt, build, gen, dev, card, (check, launches, times, bounds))

    # ---- phase 10: the xarray path at one LLC4320 face ------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    run_xarray_phase(args.seed, times["shift"][0])

    # ---- phase 11: the sharded layer at one LLC4320 face -----------------
    run_sharded_phase(args.seed)

    # ---- phase 12: the multi-process runtime at one LLC4320 face ----------
    run_multiprocess_phase(args.seed)

    report = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": launches[name],
            "max_abs_err": check.max_err[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            "library_ms": library.get(name),
        }
        for name in KERNELS
    ]}
    torch.cuda.synchronize()
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start to report")
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
