#!/usr/bin/env python3
"""Smoke run of xgcm_tpu_torch on one CUDA card.

Builds the three hand-written CUDA kernels from ``xgcm_tpu_torch/csrc``,
holds each against its plain PyTorch version at the shapes of the main path,
drives the C-grid analysis step (``xgcm_tpu_torch.entry.step``) and the fused
diagnostics at the width of one LLC4320 face (4320 x 4320, 50 levels, 36
theta targets, float32), checks that the step went through every kernel and
that its results are right, and times each kernel beside its plain version.

    python3 chip_smoke.py [--seed N]

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
describing the kernels, then ``{"ok": true, "device": {...}}`` as the last
line.  Exits non-zero, printing no result, when there is no CUDA card, when
the package is not beside this script, or when any check fails.  Imports
torch and numpy only.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

NY = NX = 4320  # one LLC4320 face
NZ = 50
N_TARGETS = 36
TOL_F32 = dict(rtol=1e-6, atol=1e-6)  # nvcc contracts a*b+c into FMAs
TOL_BF16 = dict(rtol=1e-2, atol=1e-5)
KERNELS = {
    "shift": ("xgcm_tpu_torch/csrc/shift.cu", "xgcm_tpu/ops/pallas_stencils.py:290"),
    "cgrid_diagnostics": (
        "xgcm_tpu_torch/csrc/cgrid_diagnostics.cu", "xgcm_tpu/ops/pallas_stencils.py:205"),
    "interp_linear": (
        "xgcm_tpu_torch/csrc/interp_linear.cu", "xgcm_tpu/ops/pallas_transform.py:239"),
}


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


def check_shift(check, gen, dev):
    """Kernel A: every op x direction x boundary on one face, both axes,
    bitwise; axis 0 of a 3-D field; a bf16 case within one ulp."""
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
    log("phase 3: shift kernel matches its plain version (bitwise f32, 1 ulp bf16)")


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    # ---- phase 1: device ------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is false")
    xtt = import_port()
    from xgcm_tpu_torch.entry import build_grid, step
    from xgcm_tpu_torch.ops.diagnostics import cgrid_diagnostics as diagnostics_op
    from xgcm_tpu_torch.ops.kernels import build
    from xgcm_tpu_torch.ops.kernels.cgrid_diagnostics import (
        cgrid_diagnostics, cgrid_diagnostics_plain)
    from xgcm_tpu_torch.ops.kernels.interp_linear import _fused_ref_torch, interp_linear
    from xgcm_tpu_torch.ops.kernels.shift import shift, shift_plain

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")

    # ---- phase 2: build -------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build_library(verbose=True)
    build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")

    # ---- phase 3: each kernel against its plain version ---------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    check = Checker()
    check_shift(check, gen, dev)
    u = torch.randn((NY, NX), generator=gen, device=dev)
    v = torch.randn((NY, NX), generator=gen, device=dev)
    ix = torch.rand((NX,), generator=gen, device=dev) + 0.5
    iy = torch.rand((NY,), generator=gen, device=dev) + 0.5
    check_diagnostics(check, u, v, ix, iy)
    th_c, ph_c = columns(gen, dev, 512 * 512, NZ)
    t_c = torch.linspace(-1.0, 27.0, N_TARGETS, device=dev)
    check_interp(check, gen, dev, th_c, ph_c, t_c)
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
    times = {}
    for op, direction, axis in (("diff", "left", 1), ("diff", "left", 0),
                                ("diff", "right", 1), ("interp", "right", 0)):
        k_ms, p_ms = time_pair(lambda: shift(ug, axis, op, direction, "periodic"),
                               lambda: shift_plain(ug, axis, op, direction, "periodic"))
        log(f"time shift {op}/{direction}/axis{axis} {NY}x{NX} f32: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms [{card}]")
        times.setdefault("shift", (k_ms, p_ms))
    times["cgrid_diagnostics"] = time_pair(lambda: cgrid_diagnostics(u, v, ix, iy),
                                           lambda: cgrid_diagnostics_plain(u, v, ix, iy))
    log(f"time cgrid_diagnostics {NY}x{NX} f32: kernel {times['cgrid_diagnostics'][0]:.4f} ms, "
        f"plain {times['cgrid_diagnostics'][1]:.4f} ms [{card}]")
    times["interp_linear"] = time_pair(lambda: interp_linear(th_c, ph_c, t_c),
                                       lambda: _fused_ref_torch(th_c, ph_c, t_c), reps=5)
    log(f"time interp_linear {th_c.shape[0]} cols x {NZ} knots -> {N_TARGETS} f32: kernel "
        f"{times['interp_linear'][0]:.4f} ms, plain {times['interp_linear'][1]:.4f} ms [{card}]")
    cols = NY * NX
    ke_cols = d_ke.data[..., None].expand(NY, NX, NZ).reshape(cols, NZ)
    th_main = theta.reshape(cols, NZ)
    k_main, _ = time_pair(lambda: interp_linear(th_main, ke_cols, targets), reps=3)
    log(f"time interp_linear main path {cols} cols x {NZ} knots -> {N_TARGETS} f32: "
        f"kernel {k_main:.4f} ms, plain not measured (needs the (cols, m, n) tensor) [{card}]")
    step_ms, _ = time_pair(lambda: step(ug, vg, theta, targets, grid=grid), reps=3)
    diag_ms, _ = time_pair(lambda: diagnostics_op(grid, gu, gv))
    log(f"time step {NY}x{NX}x{NZ} -> {N_TARGETS} f32: {step_ms:.4f} ms; "
        f"cgrid_diagnostics op: {diag_ms:.4f} ms [{card}]")

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
        }
        for name in KERNELS
    ]}
    torch.cuda.synchronize()
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
