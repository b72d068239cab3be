"""The port's kernel wrappers.

On any host: the kernel module imports with no ``nvcc`` and no card, a
wrapper given CPU tensors runs its plain version and launches nothing, and
a wrapper given a tensor off the CPU on a host without CUDA raises instead
of falling back.  On a CUDA card (tests marked ``cuda``, skipped elsewhere):
each kernel against its plain version on the same inputs, the multi-variable
kernels against single calls, gradients through the kernels against the
plain versions', and the analysis step, the density-space transforms, the
face analysis of an LLC grid and the tracer budget on the card against the
same calls on the CPU; the xarray path on the card against the native
calls; the sharded layer on logical shards of the card against the
single-device calls.
On the CPU, the plain versions of kernels D and E also against the Pallas
kernels they replace (interpret mode) and the JAX formulations.  The card's
machine has no JAX, so JAX is imported inside the CPU tests only.

Tolerances on the card: kernels A and E equal to the plain version bit for
bit (16-bit types against the plain version computed in float32 and rounded
once, as the kernels do); float32 kernels B and D within rtol = atol = 1e-6
of the plain version, C and F too (nvcc contracts a*b+c into FMAs); G and
H within n * 2**-24 * max column sum of |phi|, a bound on the rounding of
n float32 additions in another order, and H equal to V calls of G bit for
bit where the fractions are finite; bfloat16 within 1e-2 (one bf16 unit in
the last place, since both round once from float32).
"""

import itertools
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import chip_smoke
import xgcm_tpu_torch as xtt
from tests.torch_parity import assert_close
from xgcm_tpu_torch import parallel as par
from xgcm_tpu_torch.core import device as port_device
from xgcm_tpu_torch.entry import step
from xgcm_tpu_torch.ops.kernels import build
from xgcm_tpu_torch.ops.kernels import conservative as kg
from xgcm_tpu_torch.ops.kernels.cgrid_diagnostics import (
    cgrid_diagnostics,
    cgrid_diagnostics_plain,
)
from xgcm_tpu_torch.ops.kernels import interp_linear as kc
from xgcm_tpu_torch.ops.kernels.interp_linear import (
    _fused_multi_ref_torch,
    _fused_ref_torch,
    interp_linear,
    interp_linear_multi,
)
from xgcm_tpu_torch.ops.kernels import face_shift as kfs
from xgcm_tpu_torch.ops.kernels.face_shift import face_shift, face_shift_plain
from xgcm_tpu_torch.ops.kernels.shift import shift, shift_plain
from xgcm_tpu_torch.ops.kernels.vorticity import vorticity, vorticity_plain
from xgcm_tpu_torch.ops.kernels import weighted_sum as kw

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
    for a, b in zip(interp_linear_multi(th, [ph, 2 * ph], t),
                    (_fused_ref_torch(th, ph, t), _fused_ref_torch(th, 2 * ph, t))):
        assert torch.equal(a, b)
    tb = torch.sort(torch.as_tensor(rng.rand(5, 7)), -1).values
    e = torch.linspace(0, 1, 4, dtype=th.dtype)
    assert torch.equal(kg.conservative_rebin(tb, ph, e).nan_to_num(),
                       kg._conservative_plain(tb, ph, e).nan_to_num())
    for a, b in zip(kg.conservative_rebin_multi(tb, [ph, 2 * ph], e),
                    kg._conservative_multi_plain(tb, [ph, 2 * ph], e)):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    x4 = torch.as_tensor(rng.randn(2, 3, 5, 5))
    h = torch.as_tensor(rng.randn(2, 3, 5))
    assert torch.equal(face_shift(x4, h, "max", "right", False),
                       face_shift_plain(x4, h, "max", "right", False))
    assert torch.equal(vorticity(u, v, ix, iy), vorticity_plain(u, v, ix, iy))
    fs = [torch.as_tensor(rng.rand(1, 5, 1)), torch.as_tensor(rng.rand(1, 1, 5))]
    assert torch.equal(kw.weighted_sum(x4[0], fs, 2), kw.weighted_sum_plain(x4[0], fs, 2))
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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interp_linear_multi(x, [x, x], t)
    xb = torch.empty((4, 7), device="meta")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kg.conservative_rebin(xb, x, t)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kg.conservative_rebin_multi(xb, [x, x], t)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        face_shift(x, torch.empty((4,), device="meta"), "diff", "left", True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vorticity(x, x, torch.empty(6, device="meta"), torch.empty(4, device="meta"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kw.weighted_sum(x, [torch.empty((1, 6), device="meta")], 1)


def test_outputs_are_checked():
    new = build.outputs(None, 2, (3, 4), torch.float32, torch.device("cpu"))
    assert [tuple(o.shape) for o in new] == [(3, 4), (3, 4)]
    given = [torch.empty((4, 3)).T, torch.empty((4, 3)).T]
    assert build.outputs(given, 2, (3, 4), torch.float32, torch.device("cpu")) == given
    for bad in ([torch.empty((3, 4))], [given[0], torch.empty((3, 4))],
                [torch.empty((3, 4), dtype=torch.float64)] * 2):
        with pytest.raises(ValueError, match="one layout"):
            build.outputs(bad, 2, (3, 4), torch.float32, torch.device("cpu"))


@pytest.fixture
def recorded_launches(monkeypatch):
    """The C entries' calls, recorded instead of made: CPU tensors then go
    through the launch wrappers up to the library."""
    calls = []
    monkeypatch.setattr(build, "require_cuda", lambda *tensors: None)
    monkeypatch.setattr(build, "launch", lambda name, device, *args: calls.append((name, args)))
    build.reset_launch_counts()
    yield calls
    build.reset_launch_counts()


# targets of 5 columns (m = 4) and the (column, target) strides kernels C
# and F read them with: shared targets have column stride 0
TARGET_STRIDES = {
    "shared": (lambda t: t, (0, 1)),
    "expanded": (lambda t: t.expand(5, 4), (0, 1)),
    "strided": (lambda t: torch.linspace(0.1, 0.9, 8)[::2], (0, 2)),
    "per_column": (lambda t: t.expand(5, 4).contiguous(), (4, 1)),
    "per_column_T": (lambda t: t.expand(5, 4).T.contiguous().T, (1, 5)),
}


@pytest.mark.parametrize("nv", [1, 3])
@pytest.mark.parametrize("kind", TARGET_STRIDES)
def test_launch_passes_target_strides(recorded_launches, kind, nv):
    """Each launch wrapper makes one call of its C entry a launch, counted
    once in build.LAUNCHES, with the targets' column and target strides as
    the kernel reads them."""
    make, strides = TARGET_STRIDES[kind]
    th = torch.sort(torch.rand(5, 6), -1).values
    t = make(torch.linspace(0.1, 0.9, 4))
    phis = [torch.rand(5, 6) for _ in range(nv)]
    for _ in range(2):
        if nv == 1:
            out = kc.interp_linear_launch(th, phis[0], t)
            assert out.shape == (5, 4)
        else:
            outs = kc.interp_linear_multi_launch(th, phis, t)
            assert [o.shape for o in outs] == [(5, 4)] * nv
    name = "interp_linear" if nv == 1 else "interp_linear_multi"
    assert [c[0] for c in recorded_launches] == [f"xt_{name}"] * 2
    assert build.launch_counts()[name] == 2 and sum(build.launch_counts().values()) == 2
    # cols, n, m and the target strides (build.SIGNATURES)
    at = 6 if nv == 1 else 9
    for _, args in recorded_launches:
        assert args[at:at + 3] == (5, 6, 4)
        t_cs = 13 if nv == 1 else 14
        assert args[t_cs:t_cs + 2] == strides


def test_shift_rejects_unknown_arguments():
    with pytest.raises(ValueError):
        shift(torch.zeros(3), 0, "mean", "left", "periodic")
    with pytest.raises(ValueError):
        shift(torch.zeros(3), 0, "diff", "up", "periodic")
    with pytest.raises(ValueError, match="unsupported face shift"):
        face_shift(torch.zeros(2, 3, 3), torch.zeros(2, 3), "mean", "left", True)
    with pytest.raises(ValueError, match="halo must be"):
        face_shift(torch.zeros(2, 3, 4), torch.zeros(2, 4), "diff", "left", True)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("direction", ["left", "right"])
@pytest.mark.parametrize("op", ["diff", "interp", "min", "max"])
def test_face_shift_axis_form_plain(op, direction, axis):
    """Kernel E's axis= form (the ring route's local stencil): op(x,
    neighbour) along any axis with the halo line x.shape less that axis,
    against numpy's concatenate; the last two axes equal the face form."""
    rng = np.random.RandomState(31)
    x = rng.randn(4, 5, 6)
    hshape = x.shape[:axis] + x.shape[axis + 1:]
    halo = rng.randn(*hshape)
    h = np.expand_dims(halo, axis)
    n = x.shape[axis]
    ops = {"diff": lambda lo, hi: hi - lo, "interp": lambda lo, hi: (hi + lo) * 0.5,
           "min": np.minimum, "max": np.maximum}
    if direction == "left":
        want = ops[op](np.concatenate([h, np.take(x, range(n - 1), axis)], axis), x)
    else:
        want = ops[op](x, np.concatenate([np.take(x, range(1, n), axis), h], axis))
    tx, th = torch.as_tensor(x), torch.as_tensor(halo)
    routes = dict(kfs.ROUTES)
    got = face_shift(tx, th, op, direction, axis=axis)
    assert kfs.ROUTES == routes  # the plain version takes no route of the kernel
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, face_shift_plain(tx, th, op, direction, axis=axis))
    if axis >= 1:
        assert torch.equal(got, face_shift(tx, th, op, direction, axis == 2))
    with pytest.raises(TypeError, match="one of axis_is_x and axis"):
        face_shift(tx, th, op, direction, True, axis=axis)
    with pytest.raises(ValueError, match="halo must be"):
        face_shift(tx, torch.zeros(3), op, direction, axis=axis)


VORTICITY_SHAPES = [(16, 128), (64, 256), (40, 384)]  # tests/test_pallas.py


def _vorticity_inputs(shape, seed=0):
    ny, nx = shape
    rng = np.random.RandomState(seed)
    return (rng.rand(ny, nx).astype(np.float32), rng.rand(ny, nx).astype(np.float32),
            (rng.rand(nx) + 1).astype(np.float32), (rng.rand(ny) + 1).astype(np.float32))


@pytest.mark.parametrize("shape", VORTICITY_SHAPES)
def test_vorticity_plain_matches_pallas_and_roll(shape):
    """Kernel D's plain version against ``fused_vorticity`` in interpret
    mode (atol 1e-6, as tests/test_pallas.py), and bit for bit against the
    JAX roll formulation of the same operations."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from xgcm_tpu.ops import pallas_stencils as ps

    u, v, ix, iy = _vorticity_inputs(shape)
    got = vorticity_plain(*(torch.as_tensor(a) for a in (u, v, ix, iy)))
    with pltpu.force_tpu_interpret_mode():
        pallas = ps.fused_vorticity(*(jnp.asarray(a) for a in (u, v, ix, iy)), tile_rows=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0, atol=1e-6)
    uj, vj, ixj, iyj = (jnp.asarray(a) for a in (u, v, ix, iy))
    roll = (vj - jnp.roll(vj, 1, 1)) * ixj[None, :] - (uj - jnp.roll(uj, 1, 0)) * iyj[:, None]
    np.testing.assert_array_equal(got.numpy(), np.asarray(roll))


def test_vorticity_plain_bf16_matches_pallas():
    """bf16 inputs: both compute in float32 and round once."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from xgcm_tpu.ops import pallas_stencils as ps

    args = [jnp.asarray(a, jnp.bfloat16) for a in _vorticity_inputs((32, 256), seed=7)]
    with pltpu.force_tpu_interpret_mode():
        pallas = ps.fused_vorticity(*args, tile_rows=8)
    got = vorticity_plain(*(torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
                            for a in args))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(pallas, np.float32),
                               rtol=2**-8, atol=0)


def _jax_face_ref(x, halo, op, direction, axis_is_x):
    """tests/test_pallas.py's roll + edge-set formulation."""
    import jax.numpy as jnp

    roll_axis = -1 if axis_is_x else -2
    n = x.shape[roll_axis]
    edge = 0 if direction == "left" else n - 1
    nb = jnp.roll(x, 1 if direction == "left" else -1, axis=roll_axis)
    nb = nb.at[..., :, edge].set(halo) if axis_is_x else nb.at[..., edge, :].set(halo)
    lo, hi = (nb, x) if direction == "left" else (x, nb)
    return {"diff": hi - lo, "interp": (hi + lo) * 0.5, "min": jnp.minimum(lo, hi),
            "max": jnp.maximum(lo, hi)}[op]


@pytest.mark.parametrize("shape", [(6, 32, 256), (3, 8, 128)])
@pytest.mark.parametrize("axis_is_x", [True, False])
@pytest.mark.parametrize("direction", ["left", "right"])
@pytest.mark.parametrize("op", ["diff", "interp", "min", "max"])
def test_face_shift_plain_matches_pallas_and_jax(op, direction, axis_is_x, shape):
    """Kernel E's plain version against ``face_shift_op`` in interpret mode
    (atol 1e-6, as tests/test_pallas.py), and bit for bit against the JAX
    roll + edge-set formulation."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from xgcm_tpu.ops import pallas_stencils as ps

    nf, ny, nx = shape
    rng = np.random.RandomState(11)
    x = rng.rand(nf, ny, nx).astype(np.float32)
    halo = rng.rand(nf, ny if axis_is_x else nx).astype(np.float32)
    got = face_shift_plain(torch.as_tensor(x), torch.as_tensor(halo), op, direction, axis_is_x)
    with pltpu.force_tpu_interpret_mode():
        pallas = ps.face_shift_op(jnp.asarray(x), jnp.asarray(halo), op, direction, axis_is_x,
                                  tile_rows=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0, atol=1e-6)
    ref = _jax_face_ref(jnp.asarray(x), jnp.asarray(halo), op, direction, axis_is_x)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda(monkeypatch):
    """The card, with host data going to it for the test's duration (the
    parity harness asks for the CPU for the CPU tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(port_device, "_default", torch.device("cuda"))
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bc", ["periodic", "fill", "extend", "extrapolate"])
@pytest.mark.parametrize("direction", ["left", "right"])
@pytest.mark.parametrize("op", ["diff", "interp", "min", "max"])
def test_shift_kernel_matches_plain(cuda, op, direction, bc, dtype):
    """Every axis of a 3-D field, odd and vector-width widths along the last
    axis, n = 1 and 2 on each axis, a 4-D middle axis, and each of these as
    a view one element off 16-byte alignment (the kernel's scalar route)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    shapes = [(5, 37, 130), *((6, w) for w in (1, 2, 3, 5, 8, 127, 129)),
              *(tuple(n if i == a else (6, 7, 16)[i] for i in range(3))
                for n in (1, 2) for a in range(3)),
              (3, 4, 5, 8)]
    for shape, misaligned in itertools.product(shapes, (False, True)):
        numel = int(np.prod(shape))
        flat = torch.randn((numel + 8,), generator=g, device=cuda).to(dtype)
        flat[[3, 11]] = float("nan")
        off = max(1, 4 // flat.element_size()) if misaligned else 0
        x = flat[off:off + numel].view(shape)
        assert (x.data_ptr() % 16 != 0) == misaligned
        for axis in range(len(shape)):
            k = shift(x, axis, op, direction, bc, 1.5)
            if dtype in (torch.float32, torch.float64):
                p = shift_plain(x, axis, op, direction, bc, 1.5)
            else:
                # 16-bit types compute in float32 and round once at the store
                p = shift_plain(x.float(), axis, op, direction, bc, 1.5).to(dtype)
            assert k.dtype == dtype
            assert torch.equal(torch.isnan(k), torch.isnan(p)), (shape, misaligned, axis)
            assert torch.equal(k.nan_to_num(), p.nan_to_num()), (shape, misaligned, axis)


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


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_column", [False, True])
@pytest.mark.parametrize("mask_edges", [False, True])
def test_interp_multi_kernel_matches_singles(cuda, mask_edges, per_column, dtype, nv):
    th, ph = _cuda_columns(cuda, 1000, 20, seed=5)
    g = torch.Generator(device=cuda).manual_seed(6)
    phis = [ph.to(dtype)] + [torch.rand(ph.shape, generator=g, device=cuda).to(dtype)
                             for _ in range(nv - 1)]
    th = th.to(dtype)
    if per_column:
        t = torch.sort(torch.rand((1000, 9), device=cuda) * 36 - 3, -1).values.to(dtype)
    else:
        t = torch.linspace(-3, 33, 13, device=cuda).to(dtype)
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 else dict(rtol=1e-6, atol=1e-6)
    build.reset_launch_counts()
    multi = interp_linear_multi(th, phis, t, mask_edges)
    multi_T = interp_linear_multi(th.T.contiguous().T, phis, t, mask_edges, out_T=True)
    assert build.launch_counts()["interp_linear_multi"] == 2
    for o, oT, p in zip(multi, multi_T, phis):
        single = interp_linear(th, p, t, mask_edges)
        assert_close(o.float(), single.float(), **tol)
        assert_close(oT.T.float(), single.float(), **tol)
        assert_close(o.float(), _fused_ref_torch(th, p, t, mask_edges).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label", chip_smoke.INTERP_CASES)
def test_interp_kernels_on_search_cases(cuda, label, dtype):
    """Kernels C and F (V = 4) against their plain versions on the columns
    of ``chip_smoke.interp_case``, built to break an interval search:
    non-sorted columns, NaN knots inside the range, duplicate knots, NaN and
    infinite targets and targets on a knot, descending columns with NaN
    ends, all-NaN columns, n = 2, column counts around each tile size,
    lanes-major inputs with ``out_T``, sliced views, broadcast phis and
    unsorted shared and per-column targets."""
    case = chip_smoke.interp_case(label, torch.Generator(device=cuda).manual_seed(8), cuda)
    th, t = case["theta"].to(dtype), case["target"].to(dtype)
    phis = [p.to(dtype) for p in case["phis"]]
    args = (case["mask_edges"], case["check_flip"])
    out_T = case["out_T"]
    tol = dict(rtol=1e-2, atol=1e-5) if dtype == torch.bfloat16 else dict(rtol=1e-6, atol=1e-6)
    want = _fused_multi_ref_torch(th, phis, t, *args)
    single = interp_linear(th, phis[0], t, *args, out_T=out_T)
    assert_close((single.T if out_T else single).float(), want[0].float(), **tol)
    for o, w in zip(interp_linear_multi(th, phis, t, *args, out_T=out_T), want):
        assert_close((o.T if out_T else o).float(), w.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [2, 4, 8])
def test_interp_multi_kernel_equals_singles_bitwise(cuda, nv):
    """Kernel F computes each variable with kernel C's code: its outputs
    equal V single calls bit for bit in float32."""
    th, phis, t = chip_smoke.interp_multi_exact_inputs(
        torch.Generator(device=cuda).manual_seed(9), cuda)
    for o, p in zip(interp_linear_multi(th, phis[:nv], t), phis):
        assert torch.equal(o.view(torch.int32), interp_linear(th, p, t).view(torch.int32))


def _target_columns(cuda, cols, n, seed):
    """Theta (cols, n) and eight phis for kernels C and F against their
    shared and per-column targets: rising and falling columns, NaN heads,
    tails and holes, all-NaN, a swapped pair (not sorted), duplicate knots,
    -inf and +inf end knots.
    Knots step by 1/2, 1/4, 1/8 or 0 and phis lie on a grid of 1/16, so the
    full scan's sums are exact and the plain version's order gives the same
    floats; the first phi is NaN at a valid knot of some columns."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    steps = 2.0 ** -torch.randint(1, 4, (cols, n), generator=g, device=cuda).float()
    kind = torch.arange(cols, device=cuda) % 16
    steps[kind == 7] *= torch.rand((int((kind == 7).sum()), n), generator=g, device=cuda) > 0.4
    steps[kind == 11] *= torch.rand((int((kind == 11).sum()), n), generator=g, device=cuda) > 0.4
    th = torch.cumsum(steps, -1) - 1.0
    flip = (kind == 1) | (kind == 8) | (kind == 11)
    th[flip] = th[flip].flip(-1)
    th[kind == 2, n - 7:] = float("nan")
    th[kind == 3, :5] = float("nan")
    th[kind == 4, n // 3] = float("nan")
    th[kind == 5] = float("nan")
    th[kind == 6, n // 3: n // 3 + 2] = th[kind == 6, n // 3: n // 3 + 2].flip(-1)
    th[kind == 8, :4] = float("nan")
    th[kind == 8, n - 3:] = float("nan")
    th[kind == 9, 0] = -float("inf")
    th[kind == 10, n - 1] = float("inf")
    phis = [torch.randint(0, 64, (cols, n), generator=g, device=cuda).float() / 16
            for _ in range(8)]
    phis[0][(kind % 7 == 3) & (kind != 5), n // 2] = float("nan")
    return th, phis


def _shared_targets(cuda, n, m, order):
    """m shared targets over the columns' range (about -1 to 0.3 n), on the
    knots' grid of 1/8 so many lie on a knot; at m = 36 also -inf, NaN and
    +inf.  ``order``: rising, falling or mixed."""
    top = 0.3 * n
    if m == 36:
        grid = torch.round(torch.linspace(-1.5, top + 1.0, 33, device=cuda) * 8) / 8
        t = torch.cat([torch.tensor([-float("inf")], device=cuda), grid[:16],
                       torch.tensor([float("nan")], device=cuda), grid[16:],
                       torch.tensor([float("inf")], device=cuda)])
    else:
        t = torch.round(torch.tensor([0.4, 0.7][:m], device=cuda) * top * 8) / 8
    if order == "falling":
        t = t.flip(0)
    elif order == "mixed":
        t = t[torch.randperm(m, generator=torch.Generator().manual_seed(m)).to(cuda)]
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", ["rising", "falling", "mixed"])
@pytest.mark.parametrize("m", [1, 2, 36])
@pytest.mark.parametrize("n", [90, 51])
def test_interp_shared_targets_equal_per_column_bitwise(cuda, n, m, order, dtype):
    """Kernels C and F with shared (m,) targets against the same targets as
    an expand (column stride 0) and copied to a contiguous (cols, m) tensor,
    bit for bit, and against the plain version: 1,001 columns (no tile size
    divides it), C with a full and a broadcast phi, F at V = 2..8, with and
    without mask_edges, in both output layouts."""
    cols = 1001
    th, phis = _target_columns(cuda, cols, n, seed=20 + n)
    broadcast = phis[1][:, :1].expand(cols, n)
    th, t = th.to(dtype), _shared_targets(cuda, n, m, order).to(dtype)
    phis = [p.to(dtype) for p in phis]
    broadcast = broadcast.to(dtype)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 else dict(rtol=1e-6, atol=1e-6)
    per_column = t.expand(cols, m).contiguous()
    for mask_edges, out_T in itertools.product((False, True), (False, True)):
        theta = th.T.contiguous().T if out_T else th
        for vs in [phis[:1], [broadcast], *(phis[:nv] for nv in range(2, 9))]:

            def run(tg):
                if len(vs) == 1:
                    outs = [interp_linear(theta, vs[0], tg, mask_edges, out_T=out_T)]
                else:
                    outs = interp_linear_multi(theta, vs, tg, mask_edges, out_T=out_T)
                return [o.T if out_T else o for o in outs]

            build.reset_launch_counts()
            shared, copied, expanded = run(t), run(per_column), run(t.expand(cols, m))
            want = _fused_multi_ref_torch(th, vs, t, mask_edges)
            case = (mask_edges, out_T, len(vs), vs[0].stride(1))
            name = "interp_linear" if len(vs) == 1 else "interp_linear_multi"
            assert build.launch_counts()[name] == 3, case
            for w, s, x, p in zip(shared, copied, expanded, want):
                assert torch.equal(w.view(bits), s.view(bits)), case
                assert torch.equal(w.view(bits), x.view(bits)), case
                assert_close(w.float(), p.float(), **tol)


def _cuda_cells(cuda, cols, n, seed):
    """Raw bounds (cols, n + 1) and cells (cols, n) on the card: monotone
    columns, some descending, NaN bound tails and heads, degenerate cells
    (some on a bin edge), all-NaN columns, NaN data."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    th = torch.cumsum(torch.rand((cols, n + 1), generator=g, device=cuda) + 0.05, -1)
    ph = torch.rand((cols, n), generator=g, device=cuda) * 2 - 0.5
    th[: cols // 10] = th[: cols // 10].flip(-1)
    th[cols // 10: cols // 5, n - 3:] = float("nan")
    th[cols // 5: cols // 4, :2] = float("nan")
    th[cols // 4: cols // 4 + 20, 5] = th[cols // 4: cols // 4 + 20, 4]
    th[cols // 4: cols // 4 + 5, 4:6] = 4.0  # degenerate, exactly on an edge
    th[-3:] = float("nan")
    ph[cols // 2: cols // 2 + 30, 3] = float("nan")
    return th, ph


def _rebin_tol(ph):
    """n * 2**-24 * the largest column sum of |phi| (see the module doc)."""
    return ph.shape[-1] * 2.0**-24 * float(ph.float().abs().nansum(-1).max())


@pytest.mark.cuda
@pytest.mark.parametrize("reassociate", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conservative_kernel_matches_plain(cuda, dtype, reassociate):
    th, ph = _cuda_cells(cuda, 1000, 20, seed=7)
    th, ph = th.to(dtype), ph.to(dtype)
    edges = torch.linspace(-1.0, 25.0, 27, device=cuda).to(dtype)  # 4.0 is an edge
    build.reset_launch_counts()
    k = kg.conservative_rebin(th, ph, edges, reassociate)
    kT = kg.conservative_rebin(th.T.contiguous().T, ph.T.contiguous().T, edges, reassociate,
                               out_T=True)
    assert build.launch_counts()["conservative"] == 2
    p = kg._conservative_plain(th, ph, edges)
    tol = (dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16
           else dict(rtol=0, atol=2 * _rebin_tol(ph)))
    assert_close(k.float(), p.float(), **tol)
    assert_close(kT.T.float(), p.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conservative_multi_kernel_matches_singles(cuda, dtype, nv):
    """Kernel H runs kernel G's per-cell code on the same cells in the same
    order: its outputs equal V single calls bit for bit (these columns have
    no infinite bound), and the plain version within the tolerance."""
    th, ph = _cuda_cells(cuda, 1000, 20, seed=8)
    g = torch.Generator(device=cuda).manual_seed(9)
    phis = [ph] + [torch.rand(ph.shape, generator=g, device=cuda) for _ in range(nv - 1)]
    phis[-1][100:140, 7] = float("nan")  # variable-specific NaN data
    th, phis = th.to(dtype), [p.to(dtype) for p in phis]
    edges = torch.linspace(-1.0, 25.0, 27, device=cuda).to(dtype)
    build.reset_launch_counts()
    multi = kg.conservative_rebin_multi(th, phis, edges)
    assert build.launch_counts()["conservative_multi"] == 1
    plain = kg._conservative_multi_plain(th, phis, edges)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for o, p, pl in zip(multi, phis, plain):
        tol = (dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16
               else dict(rtol=0, atol=_rebin_tol(p)))
        assert torch.equal(o.view(bits), kg.conservative_rebin(th, p, edges).view(bits))
        assert_close(o.float(), pl.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label", chip_smoke.CONSERVATIVE_CASES)
def test_conservative_kernels_on_walk_cases(cuda, label, dtype):
    """Kernels G (both accumulators) and H (V = 4) against their plain
    versions on the columns of ``chip_smoke.conservative_case``, built to
    break the walk over a column's cells: NaN heads and tails in both
    directions, unsorted columns, NaN bounds inside, degenerate cells on an
    edge, cells touching a bin, columns outside or spanning the edges,
    -inf, +inf and [inf, inf] bounds, NaN and infinite data, all-NaN
    columns, n = 1 and 2, column counts around each tile size, lanes-major
    inputs with ``out_T`` and sliced views; in float32 also H at V = 2, 4, 8
    bit for bit against V calls of G where the fractions are finite
    (``chip_smoke.check_conservative_case``)."""
    case = chip_smoke.conservative_case(label, torch.Generator(device=cuda).manual_seed(12),
                                        cuda)
    chip_smoke.check_conservative_case(chip_smoke.Checker(), case, dtype)


PREPASS_FEATURES = ("nan-at-run-start", "swap-across-runs", "huge-in-last-run", "one-valid",
                    "empty-run-inside", "all-nan")


def _prepass_columns(cuda, cols, n, feature, seed):
    """Raw bounds (cols, n + 1) and eight fields (cols, n) for the prepass
    of kernels G and H, which splits a column's n + 1 bounds into g runs of
    ceil((n + 1) / g), g a power of two from 2 to 32 as the tile gives it.
    Column i takes g = 32 >> (i % 5) and one boundary between two of its
    runs, and ``feature`` is placed there (three columns in four; the
    fourth stays plain): a NaN bound at the first bound of a run, a pair
    out of order across the boundary, a bound beyond 2**126 alone in the
    last run, a single valid bound, a run of NaN bounds between valid runs,
    or all bounds NaN.  One column in three descends."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    th = torch.cumsum(torch.rand((cols, n + 1), generator=g, device=cuda) * (25.0 / n) + 0.01,
                      -1) - 1.0
    th[::3] = th[::3].flip(-1)
    nk = n + 1
    for i in range(cols):
        if i % 4 == 3:
            continue
        gs = 32 >> (i % 5)
        kn = -(-nk // gs)
        runs = -(-nk // kn)  # runs that hold a bound
        h = 1 + (i // 5) % max(runs - 1, 1)
        b = min(h * kn, n)  # the first bound of run h
        row = th[i]
        if feature == "nan-at-run-start":
            row[b if 0 < b < n else n // 2] = float("nan")
        elif feature == "swap-across-runs":
            row[b - 1], row[b] = row[b].clone(), row[b - 1].clone()
        elif feature == "huge-in-last-run":
            row[n] = 2.0**127 if row[n] > row[0] else -(2.0**127)
        elif feature == "one-valid":
            keep = row[b].clone()
            row[:] = float("nan")
            row[b] = keep
        elif feature == "empty-run-inside":
            lo = b if runs > 2 else 1
            row[lo:min(lo + kn, n)] = float("nan")
        else:
            row[:] = float("nan")
    phis = [torch.rand((cols, n), generator=g, device=cuda) * 2 - 0.5 for _ in range(8)]
    phis[0][::7, n // 2] = float("nan")
    return th, phis


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cols", [1001, 3])
@pytest.mark.parametrize("n", [90, 20])
@pytest.mark.parametrize("feature", PREPASS_FEATURES)
def test_conservative_prepass_run_boundaries(cuda, feature, n, cols, dtype):
    """Kernels G (both accumulators) and H (V = 2, 4, 8) against their plain
    versions, in both output layouts, on columns whose prepass features sit
    on the boundaries between the runs of the column's threads; H bit for
    bit equal to V calls of G.  At n = 90, G's tile takes 32 columns (g = 4)
    and H's at V = 4 takes 16 (g = 8); three columns (g = 32) at n = 20
    leave runs with no bound (n + 1 < g); 1,001 columns end on a part
    tile."""
    th, phis = _prepass_columns(cuda, cols, n, feature, seed=31 + n)
    th, phis = th.to(dtype), [p.to(dtype) for p in phis]
    edges = torch.linspace(-1.0, 25.0, 27, device=cuda).to(dtype)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32

    def tol(p, scale=1.0):
        if dtype == torch.bfloat16:
            return dict(rtol=1e-2, atol=1e-2)
        return dict(rtol=0, atol=scale * _rebin_tol(p))

    for out_T in (False, True):
        theta = th.T.contiguous().T if out_T else th
        vs = [p.T.contiguous().T if out_T else p for p in phis]

        def untransposed(o):
            return o.T if out_T else o

        plain_g = kg._conservative_plain(th, phis[0], edges)
        for reassociate in (False, True):
            got = untransposed(kg.conservative_rebin(theta, vs[0], edges, reassociate, out_T))
            assert_close(got.float(), plain_g.float(), **tol(phis[0], 2.0 if reassociate else 1.0))
        singles = [untransposed(kg.conservative_rebin(theta, p, edges, out_T=out_T)) for p in vs]
        for nv in (2, 4, 8):
            multi = kg.conservative_rebin_multi(theta, vs[:nv], edges, out_T=out_T)
            plain = kg._conservative_multi_plain(th, phis[:nv], edges)
            for v, (o, s, pl) in enumerate(zip(multi, singles, plain)):
                o = untransposed(o)
                assert torch.equal(o.view(bits), s.view(bits)), (out_T, nv, v)
                assert_close(o.float(), pl.float(), **tol(phis[v]))


@pytest.mark.cuda
def test_conservative_kernel_gradient_matches_plain(cuda):
    th, ph = _cuda_cells(cuda, 64, 10, seed=10)
    th, ph = th.nan_to_num(3.0), ph.nan_to_num(0.5)
    edges = torch.linspace(-1.0, 14.0, 6, device=cuda)
    ins_k = [a.clone().requires_grad_() for a in (th, ph)]
    ins_p = [a.clone().requires_grad_() for a in (th, ph)]
    kg.conservative_rebin(*ins_k, edges).nan_to_num().sum().backward()
    kg._conservative_plain(*ins_p, edges).nan_to_num().sum().backward()
    for a, b in zip(ins_k, ins_p):
        assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_density_transforms_on_card_match_cpu(cuda):
    """Grid.transform (conservative) and Grid.transform_multi (linear and
    conservative, V = 4) on the card launch G, F and H and agree with the
    same calls on the CPU."""
    g = torch.Generator(device=cuda).manual_seed(11)
    ny, nx, nz = 24, 40, 12
    sig_b = 24.0 + torch.cumsum(torch.rand((ny, nx, nz + 1), generator=g, device=cuda), -1)
    sig_b[0, :5, nz - 3:] = float("nan")
    sig_c = 0.5 * (sig_b[..., :-1] + sig_b[..., 1:])
    fields = [torch.rand((ny, nx, nz), generator=g, device=cuda) for _ in range(4)]
    bins = torch.linspace(24.0, 34.0, 11, device=cuda)
    levels = torch.linspace(24.5, 33.0, 9, device=cuda)

    def run(dev):
        ds = xtt.Dataset(coords={"zc": ("zc", np.arange(nz) + 0.5), "zo": ("zo", np.arange(nz + 1.0))})
        grid = xtt.Grid(ds, coords={"Z": {"center": "zc", "outer": "zo"}}, periodic=False,
                        autoparse_metadata=False)
        das = [xtt.GriddedArray(f.to(dev), ("y", "x", "zc"), name=f"v{i}")
               for i, f in enumerate(fields)]
        sb = xtt.GriddedArray(sig_b.to(dev), ("y", "x", "zo"), name="sigma")
        sc = xtt.GriddedArray(sig_c.to(dev), ("y", "x", "zc"), name="sigma")
        build.reset_launch_counts()
        out = [grid.transform(das[0], "Z", bins.to(dev), target_data=sb, method="conservative")]
        out += grid.transform_multi(das, "Z", bins.to(dev), target_data=sb, method="conservative")
        out += grid.transform_multi(das, "Z", levels.to(dev), target_data=sc)
        return out, build.launch_counts()

    on_card, counts = run(cuda)
    assert counts["conservative"] == 1 and counts["conservative_multi"] == 1
    assert counts["interp_linear_multi"] == 1
    on_cpu, cpu_counts = run(torch.device("cpu"))
    assert all(v == 0 for v in cpu_counts.values())
    for a, b in zip(on_card, on_cpu):
        assert a.dims == b.dims and a.data.device.type == "cuda"
        assert_close(a.data.cpu(), b.data, rtol=1e-5, atol=2e-5)


def _plain_in_f32(fn, dtype, *tensors, **kwargs):
    """The plain version as the kernels compute: 16-bit inputs in float32,
    rounded once; float32 and float64 as they are."""
    if dtype in (torch.float16, torch.bfloat16):
        return fn(*(t.float() for t in tensors), **kwargs).to(dtype)
    return fn(*tensors, **kwargs)


def _assert_same_values(k, p):
    assert k.dtype == p.dtype and k.shape == p.shape
    assert torch.equal(torch.isnan(k), torch.isnan(p))
    assert torch.equal(k.nan_to_num(), p.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("axis_is_x", [True, False])
@pytest.mark.parametrize("direction", ["left", "right"])
@pytest.mark.parametrize("op", ["diff", "interp", "min", "max"])
def test_face_shift_kernel_matches_plain(cuda, op, direction, axis_is_x, dtype):
    """Batch dims (2, 6) in front of 37 x 37 faces; NaN and +-inf on the
    face edges and in the halo."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((2, 6, 37, 37), generator=g, device=cuda)
    x[0, 1, 0, 5], x[1, 4, 36, 0], x[0, 3, 7, 36] = float("nan"), float("inf"), -float("inf")
    halo = torch.randn((2, 6, 37), generator=g, device=cuda)
    halo[1, 2, 3], halo[0, 5, 36] = float("nan"), float("inf")
    x, halo = x.to(dtype), halo.to(dtype)
    build.reset_launch_counts()
    _reset_routes()
    k = face_shift(x, halo, op, direction, axis_is_x)
    assert build.launch_counts()["face_shift"] == 1
    assert kfs.ROUTES == {"rows": 0, "planes": 0, "scalar": 1}  # 37 wide: no vectors
    p = _plain_in_f32(face_shift_plain, dtype, x, halo, op=op, direction=direction,
                      axis_is_x=axis_is_x)
    _assert_same_values(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_face_shift_kernel_axis_form_matches_plain(cuda, axis, dtype, misaligned):
    """The axis= form on a 3-D block along each axis, its data and halo
    aligned and one element off 16 bytes, NaN and infinities in both."""
    g = torch.Generator(device=cuda).manual_seed(33)
    shape = (7, 37, 45)
    hshape = shape[:axis] + shape[axis + 1:]
    x = chip_smoke.sprinkled(g, cuda, shape, dtype, misaligned)
    halo = chip_smoke.sprinkled(g, cuda, hshape, dtype, misaligned)
    for op, direction in itertools.product(("diff", "interp", "min", "max"), ("left", "right")):
        build.reset_launch_counts()
        _reset_routes()
        k = face_shift(x, halo, op, direction, axis=axis)
        assert build.launch_counts()["face_shift"] == 1
        assert kfs.ROUTES == {"rows": 0, "planes": 0, "scalar": 1}  # runs of 45 or 1,665
        p = _plain_in_f32(face_shift_plain, dtype, x, halo, op=op, direction=direction,
                          axis=axis)
        _assert_same_values(k, p)


def _reset_routes():
    kfs.ROUTES.update(dict.fromkeys(kfs.ROUTES, 0))


def _edged(g, dev, shape, dtype, misaligned):
    """N(0, 9) values with NaN, +-inf and -0.0 on each edge line of the last
    two axes and around the vector and warp-segment boundaries of the last
    one (elements 3, 4, 127, 128); ``misaligned`` puts the data one element
    off 16 bytes."""
    off = max(1, 4 // torch.tensor([], dtype=dtype).element_size()) if misaligned else 0
    n = int(np.prod(shape))
    flat = torch.randn((n + off,), generator=g, device=dev).mul_(3)
    x = flat[off:].view(shape)
    specials = (float("nan"), float("inf"), -float("inf"), -0.0)
    for i, v in enumerate(specials):
        x[..., min(i, shape[-2] - 1), min(2 * i + 1, shape[-1] - 1)] = v  # first row
        x[..., -1, max(shape[-1] - 2 - 2 * i, 0)] = specials[-1 - i]  # last row
        x[..., min(3 * i + 1, shape[-2] - 1), 0] = v  # first column
        x[..., max(shape[-2] - 2 - i, 0), -1] = specials[-1 - i]  # last column
    for i, at in enumerate((3, 4, 127, 128)):
        if at < shape[-1]:
            x[..., min(i, shape[-2] - 1), at] = specials[i]
    flat = flat.to(dtype)
    x = flat[off:off + n].view(shape)
    assert (x.data_ptr() % 16 != 0) == misaligned
    return x


# label: (shape, roll axis, the array one element off 16 bytes).  The face
# form for the last two axes, the axis= form for axis 0.  3 x 2 faces of
# 96 x 4,104 and 4,104 x 96 take several blocks' chunks on each route.
FACE_SHIFT_CASES = {
    "rows-wide": ((3, 2, 96, 4104), -1, None),
    "planes-wide": ((3, 2, 96, 4104), -2, None),
    "rows-tall": ((3, 2, 4104, 96), -1, None),
    "planes-tall": ((3, 2, 4104, 96), -2, None),
    "odd-rows": ((2, 3, 37, 45), -1, None),
    "odd-planes": ((2, 3, 45, 37), -2, None),
    "x-off-rows": ((2, 3, 40, 64), -1, "x"),
    "x-off-planes": ((2, 3, 40, 64), -2, "x"),
    "halo-off-rows": ((2, 3, 40, 64), -1, "halo"),
    "halo-off-planes": ((2, 3, 40, 64), -2, "halo"),
    "n1-rows": ((2, 3, 16, 1), -1, None),
    "n1-planes": ((2, 3, 1, 64), -2, None),
    "n2-rows": ((2, 3, 16, 2), -1, None),
    "n2-planes": ((2, 3, 2, 64), -2, None),
    "lead-axis": ((5, 8, 64), 0, None),
}


def _face_shift_route(x, halo, axis):
    """The route the kernel should take: 16-byte vectors need x and out
    aligned (out is new, so aligned), the halo too where the planes route
    loads it in vectors, and a contiguous run that fills whole vectors."""
    rows = axis % x.ndim == x.ndim - 1
    run = x.shape[axis] if rows else int(np.prod(x.shape[axis % x.ndim + 1:]))
    aligned = x.data_ptr() % 16 == 0 and (rows or halo.data_ptr() % 16 == 0)
    if run % (16 // x.element_size()) or not aligned:
        return "scalar"
    return "rows" if rows else "planes"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("label", FACE_SHIFT_CASES)
def test_face_shift_kernel_routes_match_plain(cuda, label, dtype):
    """Each route of kernel E (rows, planes, and their scalar form) against
    the plain version for every op and direction: values, NaN and
    infinities where the plain version puts them, and one launch a call
    counted under the route the layout asks for."""
    shape, axis, off = FACE_SHIFT_CASES[label]
    g = torch.Generator(device=cuda).manual_seed(25)
    hshape = shape[:axis % len(shape)] + shape[axis % len(shape) + 1:]
    x = _edged(g, cuda, shape, dtype, off == "x")
    halo = _edged(g, cuda, hshape, dtype, off == "halo")
    route = _face_shift_route(x, halo, axis)
    # f64 vectors hold 2 elements, so its rows of 2 fill them
    assert (route == "scalar") == (label.startswith(("odd", "x-off", "halo-off-planes", "n1-rows"))
                                   or (label == "n2-rows" and dtype != torch.float64))
    for op, direction in itertools.product(("diff", "interp", "min", "max"), ("left", "right")):
        build.reset_launch_counts()
        _reset_routes()
        if axis < 0:
            k = face_shift(x, halo, op, direction, axis == -1)
        else:
            k = face_shift(x, halo, op, direction, axis=axis)
        assert build.launch_counts()["face_shift"] == 1
        assert kfs.ROUTES == {name: int(name == route) for name in kfs.ROUTES}, label
        p = _plain_in_f32(face_shift_plain, dtype, x, halo, op=op, direction=direction,
                          axis=axis)
        _assert_same_values(k, p)


@pytest.mark.cuda
def test_sharded_layer_on_card(cuda):
    """chip_smoke's phase 11 on a 6 x 16 x 24 grid, logical shards of the
    card: the ring route (E once per block, no A) and the sharded cumsum,
    the metric route, the batch route (A once per block), the sharded
    diagnostics and their apply_many batch on a 2 x 2 mesh, the per-shard
    transforms (C, G, F, H once per block) and the face-sharded route with
    its apply_many batch, each against the single-device call on the card, every
    block of every result on the card, each collective count the JAX
    budget."""
    g = torch.Generator(device=cuda).manual_seed(34)
    nz, ny, nx = chip_smoke.SHARDED_SMALL
    chip_smoke.sharded_phase(xtt, build, g, torch.device("cuda", 0), "test", nz=nz, ny=ny,
                             nx=nx, timing=False)


@pytest.mark.cuda
def test_multiprocess_ring_on_card(cuda):
    """chip_smoke's phase 12 at 6 x 16 x 24 in two gloo processes on
    ``cuda:0`` (CUDA blocks staged through host memory): each process
    holds two of the four blocks of ``{"x": 4}``, and its ring diff (and
    every other op of the phase) launches kernel E once per block it holds
    and equals the single-device op on the card bit for bit, with the JAX
    budget of collectives in each process; the phase's child processes
    are joined with a timeout and killed on it."""
    build.build_library()
    chip_smoke.run_multiprocess_pair(35, "gloo", shape=chip_smoke.SHARDED_SMALL)


@pytest.mark.cuda
def test_apply_many_on_card(cuda):
    """chip_smoke's apply_many checks at a small size on four logical shards
    of the card: the face analysis's eight ops in one batch on a 13-face
    LLC grid of 24 x 24 faces (16 with the dummy ones), and the six-op
    diagnostics batch on a 2 x 2 mesh; each against the single-device ops
    on the card, no kernel launched, the JAX budget of collectives."""
    g = torch.Generator(device=cuda).manual_seed(43)
    dev = torch.device("cuda", 0)
    _, lgrid = xtt.grids.llc_grid(n=24)
    th, u, v = (chip_smoke.edge_nonfinite(torch.randn((13, 24, 24), generator=g, device=dev))
                for _ in range(3))
    single = chip_smoke.face_analysis(lgrid, xtt, th, u, v)
    sgf = par.ShardedGrid(lgrid, par.make_mesh({"f": 4}, devices=[dev] * 4), {"face": "f"})
    chip_smoke.check_face_batch(xtt, build, dev, sgf, th, u, v, single, "test")
    nz, ny, nx = chip_smoke.SHARDED_SMALL
    grid = chip_smoke.budget_grid(xtt, nx, ny, nz)
    gu = xtt.GriddedArray(torch.randn((ny, nx), generator=g, device=dev), ("yc", "xg"), name="u")
    gv = xtt.GriddedArray(torch.randn((ny, nx), generator=g, device=dev), ("yg", "xc"), name="v")
    mesh2 = par.make_mesh({"y": 2, "x": 2}, devices=[dev] * 4)
    m2 = {"xc": "x", "xg": "x", "yc": "y", "yg": "y"}
    chip_smoke.check_diagnostics_batch(xtt, build, grid, par.ShardedGrid(grid, mesh2, m2), gu,
                                       gv, mesh2, m2, "test")


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_axes", [{"f": 4}, {"f": 2, "r": 2}])
def test_face_sharded_diff_on_card(cuda, mesh_axes):
    """A face-sharded diff and vector diff of a 13-face LLC grid on logical
    shards of the card (16 faces with the dummy ones): kernel E once per
    block per op, no kernel A, every block on the card, and the single-
    device result on the card value for value (under periodic, fill and
    extend: in float32 an extrapolated face edge rounds differently on the
    two routes, in JAX as in the port)."""
    _, grid = xtt.grids.llc_grid(n=24)
    g = torch.Generator(device=cuda).manual_seed(41)
    th, u, v = (chip_smoke.edge_nonfinite(torch.randn((13, 24, 24), generator=g, device=cuda))
                for _ in range(3))
    n = int(np.prod(list(mesh_axes.values())))
    spec = {"face": "f", "y": "r", "yl": "r"} if "r" in mesh_axes else {"face": "f"}
    sg = par.ShardedGrid(grid, par.make_mesh(mesh_axes, devices=[cuda] * n), spec)
    t = xtt.GriddedArray(th, ("face", "y", "x"))
    gu = xtt.GriddedArray(u, ("face", "y", "xl"))
    gv = xtt.GriddedArray(v, ("face", "yl", "x"))
    for call in (lambda g_: g_.diff(t, "X", boundary="fill"),
                 lambda g_: g_.diff(t, "Y", boundary="extend"),
                 lambda g_: g_.diff({"X": gu}, "X", other_component={"Y": gv})):
        build.reset_launch_counts()
        got = call(sg)
        torch.cuda.synchronize()
        counts = build.launch_counts()
        assert counts["face_shift"] == n and counts["shift"] == 0, counts
        want = call(grid)
        assert got.dims == want.dims and got.data.device.type == "cuda"
        assert chip_smoke.same_values(got.data, want.data)


@pytest.mark.cuda
def test_face_shift_kernel_gradient_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn((6, 16, 16), generator=g, device=cuda)
    halo = torch.randn((6, 16), generator=g, device=cuda)
    ins_k = [a.clone().requires_grad_() for a in (x, halo)]
    ins_p = [a.clone().requires_grad_() for a in (x, halo)]
    (face_shift(*ins_k, "interp", "right", False) ** 2).sum().backward()
    (face_shift_plain(*ins_p, "interp", "right", False) ** 2).sum().backward()
    for a, b in zip(ins_k, ins_p):
        assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_vorticity_kernel_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(14)
    u, v = (torch.randn((67, 129), generator=g, device=cuda).to(dtype) for _ in range(2))
    u[3, 0] = float("nan")
    ix = torch.rand(129, generator=g, device=cuda).to(dtype) + 0.5
    iy = torch.rand(67, generator=g, device=cuda).to(dtype) + 0.5
    build.reset_launch_counts()
    k = vorticity(u, v, ix, iy)
    assert build.launch_counts()["vorticity"] == 1
    p = vorticity_plain(u, v, ix, iy)
    tol = {torch.bfloat16: dict(rtol=1e-2, atol=1e-2),
           torch.float32: dict(rtol=1e-6, atol=1e-6),
           torch.float64: dict(rtol=1e-12, atol=1e-12)}[dtype]
    assert k.dtype == dtype
    assert_close(k.float().cpu(), p.float().cpu(), **tol)
    zeta, _, _ = cgrid_diagnostics(u, v, ix, iy)  # kernel B's vorticity
    assert_close(k.float().cpu(), zeta.float().cpu(), **tol)


@pytest.mark.cuda
def test_vorticity_kernel_gradient_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(15)
    ins = [torch.randn(s, generator=g, device=cuda) for s in ((24, 40), (24, 40), (40,), (24,))]
    ins_k = [a.clone().requires_grad_() for a in ins]
    ins_p = [a.clone().requires_grad_() for a in ins]
    (vorticity(*ins_k) ** 2).sum().backward()
    (vorticity_plain(*ins_p) ** 2).sum().backward()
    for a, b in zip(ins_k, ins_p):
        assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_shift_and_diagnostics_kernels_carry_gradients(cuda):
    """Kernels A and B on tensors that need gradients: autograd runs through
    their plain versions, as on the CPU (the kernels alone would leave the
    outputs without a gradient)."""
    g = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn((20, 30), generator=g, device=cuda)
    xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    (shift(xk, 1, "diff", "left", "extrapolate") ** 2).sum().backward()
    (shift_plain(xp, 1, "diff", "left", "extrapolate") ** 2).sum().backward()
    assert_close(xk.grad, xp.grad, rtol=1e-6, atol=1e-6)
    ins = [torch.randn(s, generator=g, device=cuda) for s in ((20, 30), (20, 30), (30,), (20,))]
    ins_k = [a.clone().requires_grad_() for a in ins]
    ins_p = [a.clone().requires_grad_() for a in ins]
    sum(o.sum() for o in cgrid_diagnostics(*ins_k)).backward()
    sum(o.sum() for o in cgrid_diagnostics_plain(*ins_p)).backward()
    for a, b in zip(ins_k, ins_p):
        assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grad_mode, needs", [(False, True), (True, False), (True, True)])
def test_autograd_launch_takes_plain_backward_only_for_a_gradient(grad_mode, needs):
    """``build.autograd_launch``, the kernel wrappers' one autograd rule:
    the launch alone unless grad mode is on and an input needs a gradient;
    then ``PlainBackward``, whose gradient is the plain version's."""
    launched, planned = [], []

    def launch(a, b):
        launched.append(torch.is_grad_enabled())
        return a * b

    def plain(a, b):
        planned.append(1)
        return a * b

    a = torch.arange(4.0, requires_grad=needs)
    b = torch.full((4,), 3.0)
    with torch.set_grad_enabled(grad_mode):
        out = build.autograd_launch(launch, plain, a, b)
    assert torch.equal(out, torch.arange(4.0) * 3)
    through = grad_mode and needs
    # PlainBackward's forward runs the launch with grad mode off
    assert launched == [grad_mode and not through] and out.requires_grad == through
    if through:
        out.sum().backward()
        assert planned == [1] and torch.equal(a.grad, b)


def _gradient_wrappers(cuda):
    """Every kernel wrapper that offers a gradient, by name: (its inputs,
    the call), small, on the card."""
    g = torch.Generator(device=cuda).manual_seed(18)
    th, ph = _cuda_columns(cuda, 64, 10, seed=3)
    th = th.nan_to_num(15.0)
    t = torch.linspace(1, 29, 6, device=cuda)
    tc, pc = _cuda_cells(cuda, 64, 10, seed=10)
    tc, pc = tc.nan_to_num(3.0), pc.nan_to_num(0.5)
    edges = torch.linspace(-1.0, 14.0, 6, device=cuda)
    x = torch.randn((6, 16, 16), generator=g, device=cuda)
    halo = torch.randn((6, 16), generator=g, device=cuda)
    uv = [torch.randn(s, generator=g, device=cuda) for s in ((20, 30), (20, 30), (30,), (20,))]
    return {
        "shift": ([x], lambda x: shift(x, 1, "diff", "left", "extrapolate")),
        "face_shift": ([x, halo], lambda x, h: face_shift(x, h, "interp", "right", False)),
        "interp_linear": ([th, ph, t], interp_linear),
        "interp_linear_multi": ([th, t, ph, ph * 2],
                                lambda th, t, *phs: interp_linear_multi(th, list(phs), t)),
        "conservative": ([tc, pc], lambda th, ph: kg.conservative_rebin(th, ph, edges)),
        "conservative_multi": ([tc, pc, pc * 2],
                               lambda th, *phs: kg.conservative_rebin_multi(th, list(phs), edges)),
        "vorticity": (uv, vorticity),
        "cgrid_diagnostics": (uv, cgrid_diagnostics),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["shift", "face_shift", "interp_linear", "interp_linear_multi",
                                  "conservative", "conservative_multi", "vorticity",
                                  "cgrid_diagnostics"])
def test_kernel_wrappers_enter_plain_backward_only_for_a_gradient(cuda, name, monkeypatch):
    """Under ``torch.no_grad()`` and on inputs that need no gradient a
    wrapper launches its kernel without entering ``PlainBackward.forward``;
    on inputs that need one it enters it once.  The launches and the
    outputs are the same all three ways."""
    entered = []
    real = build.PlainBackward.forward

    def forward(ctx, launch, plain, *tensors):
        entered.append(name)
        return real(ctx, launch, plain, *tensors)

    monkeypatch.setattr(build.PlainBackward, "forward", staticmethod(forward))
    inputs, call = _gradient_wrappers(cuda)[name]
    results, counts = [], []
    for needs, mode in ((True, torch.no_grad), (False, torch.enable_grad),
                        (True, torch.enable_grad)):
        ins = [a.clone().requires_grad_(needs) for a in inputs]
        build.reset_launch_counts()
        with mode():
            out = call(*ins)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        counts.append(build.launch_counts())
        assert all(o.requires_grad == (needs and mode is torch.enable_grad) for o in outs)
        results.append([o.detach() for o in outs])
    assert entered == [name]
    assert counts[0] == counts[1] == counts[2] and sum(counts[0].values()) >= 1
    for outs in results[1:]:
        for a, b in zip(outs, results[0]):
            assert_close(a, b, rtol=0)


@pytest.mark.cuda
def test_face_analysis_on_card_matches_cpu(cuda):
    """The LLC face analysis (tracer gradients, vorticity, divergence, the
    2-D vector interp) with a leading batch dim: 8 launches of kernel E and
    none of A on the card, the same values as on the CPU."""
    import warnings

    _, grid = xtt.grids.llc_grid(n=48)
    g = torch.Generator(device=cuda).manual_seed(17)
    th, u, v = (torch.randn((3, 13, 48, 48), generator=g, device=cuda) for _ in range(3))
    u[0, 6, 0, 5], v[2, 9, 47, 3], th[1, 0, 10, 47] = float("nan"), float("inf"), -float("inf")

    def run(dev):
        t = xtt.GriddedArray(th.to(dev), ("time", "face", "y", "x"))
        gu = xtt.GriddedArray(u.to(dev), ("time", "face", "y", "xl"))
        gv = xtt.GriddedArray(v.to(dev), ("time", "face", "yl", "x"))
        build.reset_launch_counts()
        out = [grid.diff(t, "X"), grid.diff(t, "Y"),
               grid.diff({"X": gv}, "X", other_component={"Y": gu})
               - grid.diff({"Y": gu}, "Y", other_component={"X": gv}),
               grid.diff({"X": gu}, "X", other_component={"Y": gv})
               + grid.diff({"Y": gv}, "Y", other_component={"X": gu})]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            vec = grid.interp_2d_vector({"X": gu, "Y": gv}, to="center")
        return out + [vec["X"], vec["Y"]], build.launch_counts()

    on_card, counts = run(cuda)
    assert counts["face_shift"] == 8 and counts["shift"] == 0
    on_cpu, _ = run(torch.device("cpu"))
    for a, b in zip(on_card, on_cpu):
        assert a.dims == b.dims and a.data.device.type == "cuda"
        _assert_same_values(a.data.cpu(), b.data)


@pytest.mark.cuda
def test_tracer_budget_on_card_matches_cpu(cuda):
    """The tracer budget of examples/tracer_budget.py (chip_smoke's copy)
    on a 12 x 40 x 72 grid: exactly 6 launches of kernel A (three interps,
    three diffs) and none of E on the card, the same values as on the
    CPU."""
    nz, ny, nx = chip_smoke.METRIC_SMALL
    g = torch.Generator(device=cuda).manual_seed(23)
    ins = chip_smoke.budget_inputs(xtt, g, cuda, nz, ny, nx)
    ins[0].data[2, 3, 4] = float("nan")

    def run(dev):
        grid = chip_smoke.budget_grid(xtt, nx, ny, nz)
        build.reset_launch_counts()
        out = chip_smoke.budget_terms(grid, *(xtt.GriddedArray(a.data.to(dev), a.dims)
                                              for a in ins))
        return out, build.launch_counts()

    on_card, counts = run(cuda)
    assert counts["shift"] == 6 and counts["face_shift"] == 0
    on_cpu, _ = run(torch.device("cpu"))
    for a, b in zip(on_card, on_cpu):
        assert a.dims == b.dims and a.dtype == b.dtype and a.data.device.type == "cuda"
        _assert_same_values(a.data.cpu(), b.data)


@pytest.mark.cuda
def test_budget_sums_on_card_match_plain(cuda):
    """chip_smoke's phase 9 closure on a 12 x 40 x 72 grid: two launches
    of the weighted sum, the budget closes, and the kernel's sums of the
    tendency and its magnitude equal its plain version within 1e-6."""
    nz, ny, nx = chip_smoke.METRIC_SMALL
    g = torch.Generator(device=cuda).manual_seed(37)
    ins = chip_smoke.budget_inputs(xtt, g, cuda, nz, ny, nx)
    grid = chip_smoke.budget_grid(xtt, nx, ny, nz)
    tendency = chip_smoke.budget_terms(grid, *ins)[2]
    build.reset_launch_counts()
    assert chip_smoke.budget_closure(grid, tendency) < 1e-4
    assert build.launch_counts()["weighted_sum"] == 2
    check = chip_smoke.Checker()
    kernel_fn, plain_fn, (bound_ms, bound_by) = chip_smoke.check_budget_sums(
        check, grid, tendency)
    assert torch.equal(kernel_fn().view(torch.int32), kernel_fn().view(torch.int32))
    assert_close(kernel_fn().cpu(), plain_fn().cpu(), rtol=1e-6)
    assert bound_by == "bytes" and bound_ms > 0


@pytest.mark.cuda
def test_xarray_path_on_card_matches_native(cuda):
    """chip_smoke's phase 10 on a 12 x 40 x 72 grid: xarray diffs,
    derivative and integrate through Grid(xr.Dataset), and linear and
    conservative transforms of one field and of four, each equal to the
    native call on the card bit for bit with the same launches (A, C, G, F,
    H) and xgcm's coordinates; regrid_vertical on the card equals the
    CPU."""
    nz, ny, nx = chip_smoke.XARRAY_SMALL
    g = torch.Generator(device=cuda).manual_seed(29)
    with chip_smoke.xarray_stub() as xr, warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        chip_smoke.xarray_budget_calls(xtt, xr, g, cuda, build, "test", nz, ny, nx)
        q, tr, levels = chip_smoke.xarray_density_calls(xtt, xr, g, cuda, build, "test", nz,
                                                        ny, nx)
    assert "xarray" not in sys.modules or sys.modules["xarray"].__name__ != "fake_xarray"
    chip_smoke.check_regrid_small(xtt, q, tr, levels, cuda)


# -- the weighted sum of Grid.integrate ----------------------------------------------


def test_weighted_sum_plan_covers_each_row_once():
    """The launch of the tracer budget's integrals (90 levels of a 4320^2
    face) and of odd shapes: every vector of a row has one thread, blocks
    fit a launch, and the plan depends on the shape alone."""
    p = kw.plan((90, 4320, 4320), 3, 4)
    assert p == kw.Plan(segments=1, rows=90 * 4320, vw=4, tiles=1, vpt=5, chunk_rows=24,
                        chunks=16200)
    for shape, ndims, vw in [((90, 4320, 4320), 1, 4), ((90, 4320, 4320), 2, 4), ((7,), 1, 1),
                             ((3, 5, 4321), 3, 1), ((2, 100_000), 1, 4), ((5, 1), 1, 1)]:
        p = kw.plan(shape, ndims, vw)
        nv = shape[-1] // vw
        width = kw.THREADS * p.vpt
        assert p.vpt <= kw.MAX_VECTORS and (p.tiles - 1) * width < nv <= p.tiles * width
        assert (p.chunks - 1) * p.chunk_rows < p.rows <= p.chunks * p.chunk_rows
        assert p.segments * p.rows * shape[-1] == int(np.prod(shape))
        assert p.segments * p.chunks * p.tiles < 2**31
        assert kw.plan(shape, ndims, vw) == p


def _weighted_sum_inputs(cuda, shape, factor_dims, ndims, offset=0, seed=0, extremes=True):
    """x of positive values (a temperature-like field, so that float32 sums
    are well conditioned) with NaN in places and, with ``extremes``, +inf
    in the first segment, -inf in the last and a finite value whose
    product overflows in the middle one; factors over factor_dims of x's
    dims, each in [1.05, 1.15)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    numel = int(np.prod(shape))
    flat = torch.rand((numel + 4,), generator=g, device=cuda).add_(20.0)
    x = flat[offset:offset + numel].view(shape)
    x.view(-1)[3::97] = float("nan")
    segments = int(np.prod(shape[:len(shape) - ndims]))
    per = numel // segments
    if extremes:
        x.view(-1)[1] = float("inf")
    if extremes and segments >= 2:
        x.view(-1)[numel - 2] = float("-inf")
    if extremes and segments >= 3:
        x.view(-1)[(segments // 2) * per + 5] = torch.finfo(torch.float32).max
    factors = []
    for dims in factor_dims:
        fshape = [n if d in dims else 1 for d, n in enumerate(shape)]
        factors.append(torch.rand(fshape, generator=g, device=cuda).mul_(0.1).add_(1.05))
    return x, factors


def _check_weighted_sum(x, factors, ndims):
    """One launch a call; two calls equal to the bit; within rtol 1e-6 of
    the plain path's weighted values summed in float64, and of the plain
    float32 path within the JAX tests' tolerance, with its NaN footprint."""
    build.reset_launch_counts()
    got = kw.weighted_sum(x, factors, ndims)
    assert build.launch_counts()["weighted_sum"] == 1
    assert sum(build.launch_counts().values()) == 1
    again = kw.weighted_sum(x, factors, ndims)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    metric = factors[0]
    for f in factors[1:]:
        metric = metric * f
    w = torch.nan_to_num(x * metric, nan=0.0)
    dims = tuple(range(x.ndim - ndims, x.ndim))
    assert got.shape == x.shape[:x.ndim - ndims] and got.dtype == torch.float32
    assert torch.allclose(got.double(), w.sum(dims, dtype=torch.float64), rtol=1e-6, atol=0)
    assert_close(got.cpu(), w.sum(dims).cpu(), rtol=1e-6)
    return got


# (shape, the dims of each factor, trailing dims summed, storage offset)
WEIGHTED_SUM_CASES = [
    ((4320,), [(0,)], 1, 0),
    ((7,), [(0,)], 1, 0),
    ((12, 4320), [(1,), (0,)], 1, 0),
    ((12, 4320), [(0,), (1,)], 2, 0),
    ((3, 5, 4321), [(2,), (1,), (0,)], 3, 0),
    ((3, 5, 4321), [(0,), (2,), (1,)], 1, 0),
    ((3, 5, 7), [(1,), (2,), (0,)], 2, 0),
    ((3, 5, 4320), [(2,), (1,), (0,)], 3, 1),  # a misaligned view: the scalar route
    ((3, 5, 4320), [(1,), (0,), (2,)], 2, 1),
    # a time dim the metric lacks
    ((4, 3, 5, 4320), [(3,), (2,), (1,)], 3, 0),
    ((4, 3, 5, 4320), [(2,), (3,)], 2, 0),
    # a registered full-size metric, and one over the horizontal dims
    ((4, 3, 5, 4320), [(1, 2, 3)], 3, 0),
    ((4, 3, 5, 4320), [(1, 2, 3)], 1, 0),
    ((4, 3, 5, 4320), [(2, 3), (1,)], 2, 0),
    ((4, 3, 5, 4321), [(2, 3), (1,)], 3, 0),
    # a row longer than a block's tile
    ((3, 20000), [(1,), (0,)], 1, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, factor_dims, ndims, offset", WEIGHTED_SUM_CASES)
def test_weighted_sum_kernel_matches_plain(cuda, shape, factor_dims, ndims, offset):
    for extremes in (False, True):
        x, factors = _weighted_sum_inputs(cuda, shape, factor_dims, ndims, offset,
                                          extremes=extremes)
        assert (x.data_ptr() % 16 != 0) == bool(offset)
        _check_weighted_sum(x, factors, ndims)


@pytest.mark.cuda
@pytest.mark.parametrize("ndims", [1, 2, 3])
@pytest.mark.parametrize("order", list(itertools.permutations([(0,), (1,), (2,)])))
def test_weighted_sum_kernel_in_each_factor_order(cuda, order, ndims):
    """The metric's factors in each of the six orders that frozenset
    iteration can give: the sums match, and a field with one nonzero value
    a row gives each row's weighted value bit for bit, so the kernel
    rounds the product in the order it was given."""
    for extremes in (False, True):
        x, factors = _weighted_sum_inputs(cuda, (6, 40, 4320), order, ndims, seed=5,
                                          extremes=extremes)
        _check_weighted_sum(x, factors, ndims)
    g = torch.Generator(device=cuda).manual_seed(6)
    factors = [torch.rand(f.shape, generator=g, device=cuda).add_(0.5) for f in factors]
    sparse = torch.zeros((6, 40, 4320), device=cuda)
    rows = torch.arange(6 * 40, device=cuda)
    sparse.view(-1, 4320)[rows, (rows * 37) % 4320] = torch.rand(
        (6 * 40,), generator=g, device=cuda).add_(0.5)
    metric = factors[0] * factors[1] * factors[2]
    want = (sparse * metric).sum(-1)
    got = kw.weighted_sum(sparse, factors, 1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_weighted_sum_kernel_refuses_a_gradient():
    """The kernel computes no gradient, and Grid.integrate sends no tensor
    that needs one: off the CPU such a call raises before any launch."""
    def meta(shape, grad):
        return torch.empty(shape, device="meta", requires_grad=grad)

    for x_grad, f_grad in ((True, False), (False, True)):
        with pytest.raises(ValueError, match="no gradient"):
            kw.weighted_sum(meta((4, 6), x_grad), [meta((1, 6), f_grad)], 1)
    with torch.no_grad(), pytest.raises(RuntimeError, match="CUDA"):
        kw.weighted_sum(meta((4, 6), True), [meta((1, 6), False)], 1)


# Grid.integrate's route: the label, and the launches of the weighted sum on
# the card; each case of no launch differs from one of a launch in one respect
INTEGRATE_ROUTES = {
    "X": 1, "X, Y": 1, "Y, X": 1, "X, Y, Z": 1, "a registered area": 1,
    "Z": 0, "X, Z": 0, "float64 data": 0, "integer data": 0, "keepdims": 0, "dtype": 0,
    "a gradient": 0, "an interpolated metric": 0, "a float64 metric": 0,
    "a view that is not contiguous": 0, "a ShardedTensor": 0,
}


def _integrate_route_case(label, theta):
    """(integrate, data, axes, keywords) of a route case on the tracer
    budget's grid (float32 metrics dx, dy, dz at both positions), with
    ``theta`` (Z, Y, X at the centres) on the device the case runs on."""
    nz, ny, nx = theta.shape
    grid = chip_smoke.budget_grid(xtt, nx, ny, nz)
    da = xtt.GriddedArray(theta, ("zc", "yc", "xc"), name="theta")
    if label in ("a registered area", "an interpolated metric", "a float64 metric"):
        area = grid.get_metric(xtt.GriddedArray(torch.zeros((ny, nx)), ("yc", "xc")),
                               ("X", "Y"))
        if label == "a float64 metric":
            area = area.astype(torch.float64)
        grid._metrics[frozenset(("X", "Y"))] = [area]
        if label == "an interpolated metric":  # the area lies on xc, the data on xg
            da = xtt.GriddedArray(theta, ("zc", "yc", "xg"), name="theta")
        return grid.integrate, da, ("X", "Y"), {}
    if label == "a ShardedTensor":
        mesh = par.make_mesh({"x": 2}, devices=[theta.device] * 2)
        sgrid = par.ShardedGrid(grid, mesh, {"xc": "x"})
        return sgrid.integrate, sgrid.shard(da), ("X", "Y"), {}
    axes = {"X": ["X"], "X, Y": ["X", "Y"], "Y, X": ["Y", "X"], "X, Y, Z": ["X", "Y", "Z"],
            "Z": ["Z"], "X, Z": ["X", "Z"]}.get(label, ["X", "Y"])
    da = {
        "float64 data": da.astype(torch.float64),
        "integer data": da.with_data((theta * 100).nan_to_num().int()),
        "a gradient": da.with_data(theta.clone().requires_grad_(True)),
        "a view that is not contiguous": da.transpose("zc", "xc", "yc"),
    }.get(label, da)
    kwargs = {"keepdims": {"keepdims": False}, "dtype": {"dtype": np.float32}}.get(label, {})
    return grid.integrate, da, axes, kwargs


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(INTEGRATE_ROUTES))
def test_integrate_on_card_takes_one_launch(cuda, label):
    """Grid.integrate of float32 data on the tracer budget's grid: one
    launch of the weighted sum for X, (X, Y) and the whole volume, with the
    values of the same calls on the CPU within the JAX tests' tolerance;
    none where the route stays in PyTorch (a leading dim, other dtypes, a
    keyword to the sum, a gradient, an interpolated or float64 metric, a
    view that is not contiguous, a ShardedTensor), equal to the CPU there
    too."""
    nz, ny, nx = 6, 40, 4320
    g = torch.Generator(device=cuda).manual_seed(31)
    theta = torch.rand((nz, ny, nx), generator=g, device=cuda).add_(20.0)
    theta[2, 3, 4] = float("nan")
    out = {}
    for where, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
        integrate, da, axes, kwargs = _integrate_route_case(label, theta.to(dev))
        build.reset_launch_counts()
        out[where] = integrate(da, axes, **kwargs)
        assert build.launch_counts()["weighted_sum"] == (
            INTEGRATE_ROUTES[label] if where == "card" else 0)
    a, b = out["card"], out["cpu"]
    assert a.dims == b.dims and a.dtype == b.dtype and a.name == "theta"
    assert a.data.device.type == "cuda"
    assert_close(a.data.detach().cpu(), b.data.detach(), rtol=1e-6)
