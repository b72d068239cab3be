"""The port's kernel wrappers.

On any host: the kernel module imports with no ``nvcc`` and no card, a
wrapper given CPU tensors runs its plain version and launches nothing, and
a wrapper given a tensor off the CPU on a host without CUDA raises instead
of falling back.  On a CUDA card (tests marked ``cuda``, skipped elsewhere):
each kernel against its plain version on the same inputs, and the analysis
step on the card against the same step on the CPU.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close
from xgcm_tpu_torch.entry import step
from xgcm_tpu_torch.ops.kernels import build
from xgcm_tpu_torch.ops.kernels.cgrid_diagnostics import (
    cgrid_diagnostics,
    cgrid_diagnostics_plain,
)
from xgcm_tpu_torch.ops.kernels.interp_linear import _fused_ref_torch, interp_linear
from xgcm_tpu_torch.ops.kernels.shift import shift, shift_plain

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_kernel_module_imports_without_nvcc_or_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import xgcm_tpu_torch, xgcm_tpu_torch.entry, xgcm_tpu_torch.ops.kernels as k\n"
        "import xgcm_tpu_torch.ops.diagnostics, xgcm_tpu_torch.ops.transform\n"
        "new = set(sys.modules) - before\n"
        "assert not [m for m in new if m.split('.')[0] in ('jax', 'xgcm_tpu')], new\n"
        "assert k.build.load_library.cache_info().currsize == 0\n"
    )
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)


def test_find_nvcc_raises_when_missing(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this host has the CUDA toolkit at its default prefix")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


@pytest.fixture
def no_library(monkeypatch):
    """Fail loudly if anything tries to build or load the kernel library."""

    def _refuse():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(build, "load_library", _refuse)
    build.reset_launch_counts()
    yield
    assert build.launch_counts() == {k: 0 for k in build.LAUNCHES}


def test_wrappers_take_plain_version_on_cpu(no_library):
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(3, 4, 5).astype(np.float32))
    assert torch.equal(shift(x, 1, "interp", "left", "fill", 2.0),
                       shift_plain(x, 1, "interp", "left", "fill", 2.0))
    u, v = (torch.as_tensor(rng.randn(4, 6)) for _ in range(2))
    ix, iy = torch.ones(6, dtype=u.dtype), torch.ones(4, dtype=u.dtype)
    for a, b in zip(cgrid_diagnostics(u, v, ix, iy), cgrid_diagnostics_plain(u, v, ix, iy)):
        assert torch.equal(a, b)
    th = torch.sort(torch.as_tensor(rng.rand(5, 6)), -1).values
    ph = torch.as_tensor(rng.rand(5, 6))
    t = torch.linspace(0, 1, 4, dtype=th.dtype)
    assert torch.equal(interp_linear(th, ph, t), _fused_ref_torch(th, ph, t))
    # the step on CPU tensors runs end to end without the library
    step(u.float(), v.float(), torch.sort(torch.rand(4, 6, 3), -1).values,
         torch.linspace(0.2, 0.8, 3))


def test_wrappers_raise_off_cpu_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    x = torch.empty((4, 6), device="meta")
    t = torch.empty((3,), device="meta")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shift(x, 0, "diff", "left", "periodic")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cgrid_diagnostics(x, x, torch.empty(6, device="meta"), torch.empty(4, device="meta"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interp_linear(x, x, t)


def test_shift_rejects_unknown_arguments():
    with pytest.raises(ValueError):
        shift(torch.zeros(3), 0, "mean", "left", "periodic")
    with pytest.raises(ValueError):
        shift(torch.zeros(3), 0, "diff", "up", "periodic")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bc", ["periodic", "fill", "extend", "extrapolate"])
@pytest.mark.parametrize("direction", ["left", "right"])
@pytest.mark.parametrize("op", ["diff", "interp", "min", "max"])
def test_shift_kernel_matches_plain(cuda, op, direction, bc, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((5, 37, 130), generator=g, device=cuda).to(dtype)
    x.view(-1)[[3, 77]] = float("nan")
    for axis in range(3):
        k = shift(x, axis, op, direction, bc, 1.5)
        if dtype in (torch.float32, torch.float64):
            p = shift_plain(x, axis, op, direction, bc, 1.5)
        else:
            # 16-bit types compute in float32 and round once at the store
            p = shift_plain(x.float(), axis, op, direction, bc, 1.5).to(dtype)
        assert k.dtype == dtype
        assert torch.equal(torch.isnan(k), torch.isnan(p))
        assert torch.equal(k.nan_to_num(), p.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_diagnostics_kernel_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    u, v = (torch.randn((67, 129), generator=g, device=cuda).to(dtype) for _ in range(2))
    ix = torch.rand(129, generator=g, device=cuda).to(dtype) + 0.5
    iy = torch.rand(67, generator=g, device=cuda).to(dtype) + 0.5
    plain = cgrid_diagnostics_plain(*(a.float() if dtype == torch.bfloat16 else a
                                      for a in (u, v, ix, iy)))
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 else dict(rtol=1e-6, atol=1e-6)
    for a, b in zip(cgrid_diagnostics(u, v, ix, iy), plain):
        assert a.dtype == dtype
        assert_close(a.float(), b.float(), **tol)


def _cuda_columns(cuda, cols, n, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    th = torch.sort(torch.rand((cols, n), generator=g, device=cuda), -1).values * 30
    ph = torch.rand((cols, n), generator=g, device=cuda)
    th[: cols // 10] = th[: cols // 10].flip(-1)
    th[cols // 10: cols // 5, n - 3:] = float("nan")
    th[cols // 5: cols // 4, :2] = float("nan")
    th[-3:] = float("nan")
    # the two intervals touching the NaN datum span more than one target
    # step, so it surely brackets a target
    th[7] = torch.linspace(-2.0, 33.0, n, device=cuda)
    ph[7, n // 2] = float("nan")
    return th, ph


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_column", [False, True])
@pytest.mark.parametrize("mask_edges", [False, True])
def test_interp_kernel_matches_plain(cuda, mask_edges, per_column, dtype):
    th, ph = _cuda_columns(cuda, 1000, 20, seed=2)
    th, ph = th.to(dtype), ph.to(dtype)
    if per_column:
        t = torch.sort(torch.rand((1000, 9), device=cuda) * 36 - 3, -1).values.to(dtype)
    else:
        t = torch.linspace(-3, 33, 13, device=cuda).to(dtype)
    k = interp_linear(th, ph, t, mask_edges)
    p = _fused_ref_torch(th, ph, t, mask_edges)
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 else dict(rtol=1e-6, atol=1e-6)
    assert_close(k.float(), p.float(), **tol)
    kT = interp_linear(th.T.contiguous().T, ph, t, mask_edges, out_T=True)
    assert_close(kT.T.float(), p.float(), **tol)


@pytest.mark.cuda
def test_interp_kernel_gradient_matches_plain(cuda):
    th, ph = _cuda_columns(cuda, 64, 10, seed=3)
    th = th.nan_to_num(15.0)
    t = torch.linspace(1, 29, 6, device=cuda)
    ins_k = [a.clone().requires_grad_() for a in (th, ph, t)]
    ins_p = [a.clone().requires_grad_() for a in (th, ph, t)]
    interp_linear(*ins_k).sum().backward()
    _fused_ref_torch(*ins_p).sum().backward()
    for a, b in zip(ins_k, ins_p):
        assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_step_on_card_matches_cpu(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    ny, nx, nz = 96, 160, 12
    u, v = (torch.rand((ny, nx), generator=g, device=cuda) for _ in range(2))
    theta = torch.cumsum(torch.rand((ny, nx, nz), generator=g, device=cuda) + 0.01, -1)
    targets = torch.linspace(0.5, 5.0, 7, device=cuda)
    build.reset_launch_counts()
    out = step(u, v, theta, targets)
    counts = build.launch_counts()
    assert counts["shift"] == 6 and counts["interp_linear"] == 1
    ref = step(*(a.cpu() for a in (u, v, theta, targets)))
    for a, b in zip(out, ref):
        assert_close(a.cpu(), b, rtol=1e-6, atol=1e-6)
