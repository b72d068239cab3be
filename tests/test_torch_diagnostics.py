"""The port's ``cgrid_diagnostics`` against xgcm_tpu's, bit for bit in
float64 and float32, and kernel B's plain version against the Pallas
``fused_cgrid_diagnostics`` run in interpret mode."""

import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu_torch as xtt
from tests.torch_parity import assert_bitwise, to_numpy
from xgcm_tpu.ops.diagnostics import cgrid_diagnostics as jax_diag
from xgcm_tpu_torch.ops.diagnostics import cgrid_diagnostics as torch_diag
from xgcm_tpu_torch.ops.kernels.cgrid_diagnostics import cgrid_diagnostics_plain


def _grids(ny, nx, periodic):
    ds = xgcm_tpu.Dataset(coords={
        "xc": ("xc", np.arange(nx, dtype=float)), "xg": ("xg", np.arange(nx, dtype=float)),
        "yc": ("yc", np.arange(ny, dtype=float)), "yg": ("yg", np.arange(ny, dtype=float)),
    })
    axes = {"X": {"center": "xc", "left": "xg"}, "Y": {"center": "yc", "left": "yg"}}
    g_j = xgcm_tpu.Grid(ds, coords=axes, periodic=periodic, autoparse_metadata=False)
    g_t = xtt.Grid(xtt.from_numpy_dataset(ds), coords=axes, periodic=periodic,
                   autoparse_metadata=False)
    return g_j, g_t


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("spacing", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cgrid_diagnostics_bitwise(dtype, spacing, periodic):
    ny, nx = 6, 9
    g_j, g_t = _grids(ny, nx, periodic)
    rng = np.random.RandomState(0)
    u = rng.randn(ny, nx).astype(dtype)
    v = rng.randn(ny, nx).astype(dtype)
    u[2, 3] = np.nan
    kw_j, kw_t = {}, {}
    if spacing:
        ix = (rng.rand(nx) + 0.5).astype(dtype)
        iy = (rng.rand(ny) + 0.5).astype(dtype)
        kw_j = dict(inv_dx=xgcm_tpu.GriddedArray(ix, ("xc",)),
                    inv_dy=xgcm_tpu.GriddedArray(iy, ("yc",)))
        kw_t = dict(inv_dx=xtt.GriddedArray(torch.as_tensor(ix), ("xc",)),
                    inv_dy=xtt.GriddedArray(torch.as_tensor(iy), ("yc",)))
    # v given in (x, y) order: the transpose to (y, x) is part of the op
    out_j = jax_diag(g_j, xgcm_tpu.GriddedArray(u, ("yc", "xg")),
                     xgcm_tpu.GriddedArray(v.T.copy(), ("xc", "yg")), **kw_j)
    out_t = torch_diag(g_t, xtt.GriddedArray(torch.as_tensor(u), ("yc", "xg")),
                       xtt.GriddedArray(torch.as_tensor(v.T.copy()), ("xc", "yg")), **kw_t)
    for a_t, a_j in zip(out_t, out_j):
        assert (a_t.dims, a_t.name) == (a_j.dims, a_j.name)
        assert_bitwise(a_t, a_j)


def test_plain_matches_pallas_kernel_in_interpret_mode():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from xgcm_tpu.ops import pallas_stencils as ps

    ny, nx = 16, 128
    rng = np.random.RandomState(1)
    u = rng.rand(ny, nx).astype(np.float32)
    v = rng.rand(ny, nx).astype(np.float32)
    ix = (rng.rand(nx) + 1).astype(np.float32)
    iy = (rng.rand(ny) + 1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = ps.fused_cgrid_diagnostics(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(ix), jnp.asarray(iy), tile_rows=8
        )
    out = cgrid_diagnostics_plain(*(torch.as_tensor(a) for a in (u, v, ix, iy)))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), atol=1e-5)
