"""The port's legacy vertical binner (``ops/regridding.py``) against
xgcm_tpu's: the cases of tests/test_regridding.py, NaN and +-inf tracer
values, integer data, and the per-level ``scatter_add_`` route against the
JAX package's select-then-sum.  Sums of one column's cells in ascending
level order equal the JAX package's bit for bit."""

import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu_torch as xtt
from tests.test_regridding import oracle
from tests.torch_parity import assert_bitwise, to_numpy
from xgcm_tpu.ops import regridding as jax_rg
from xgcm_tpu_torch.ops import regridding as torch_rg


def _both(q, tr, levs, dims, dim, q_name="q", tr_name="theta"):
    out = []
    for pkg, rg in ((xgcm_tpu, jax_rg), (xtt, torch_rg)):
        out.append(rg.regrid_vertical(pkg.GriddedArray(q, dims, name=q_name),
                                      pkg.GriddedArray(tr, dims, name=tr_name), levs, dim))
    r_j, r_t = out
    assert r_t.dims == r_j.dims and r_t.name == r_j.name
    np.testing.assert_array_equal(r_t.attrs["bin_centers"], r_j.attrs["bin_centers"])
    assert_bitwise(r_t, r_j)
    return r_t


def test_matches_jax_1d():
    rng = np.random.RandomState(0)
    q, tr, levs = rng.rand(20), rng.rand(20) * 10, np.linspace(0, 10, 6)
    out = _both(q, tr, levs, ("z",), "z")
    assert out.dims == ("theta_coord",)
    np.testing.assert_allclose(to_numpy(out), oracle(q, tr, levs))


def test_matches_jax_3d_middle_axis():
    rng = np.random.RandomState(1)
    q, tr = rng.rand(3, 12, 4), rng.rand(3, 12, 4) * 5 - 1  # out-of-range values too
    levs = np.linspace(0, 4, 5)
    out = _both(q, tr, levs, ("y", "z", "x"), "z", tr_name="sigma")
    assert out.dims == ("y", "sigma_coord", "x")
    np.testing.assert_allclose(to_numpy(out), oracle(q, tr, levs, axis=1), rtol=1e-12)


def test_total_conserved():
    rng = np.random.RandomState(2)
    q, tr = rng.rand(30), rng.rand(30) * 100
    out = _both(q, tr, np.linspace(0, 100, 11), ("z",), "z", tr_name="t")
    np.testing.assert_allclose(float(to_numpy(out).sum()), q.sum())


def test_nan_confined_to_own_bin():
    rng = np.random.RandomState(0)
    q = rng.rand(4, 10)
    tr = np.sort(rng.rand(4, 10), axis=-1)
    q[1, 3] = np.nan
    levs = np.linspace(0.0, 1.0, 6)
    out = to_numpy(torch_rg._regrid_vertical(torch.as_tensor(q), torch.as_tensor(tr), levs,
                                             axis=-1))
    np.testing.assert_array_equal(out, np.asarray(jax_rg._regrid_vertical(q, tr, levs, axis=-1)))
    nan_cols = np.isnan(out).sum(axis=-1)
    assert nan_cols[1] == 1
    assert (nan_cols[[0, 2, 3]] == 0).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nonfinite_tracer_values_match_jax(dtype):
    """NaN and +inf tracer values go into the last bin, -inf into the
    first; NaN in q stays in its bin; float32 data against float64 edges
    compares in float64, as jnp.searchsorted promotes."""
    rng = np.random.RandomState(7)
    q = rng.randn(5, 9, 6).astype(dtype)
    tr = (rng.rand(5, 9, 6) * 3).astype(dtype)
    tr[0, 0, :] = [np.nan, -np.inf, np.inf, 1.0, 3.0, -1.0]
    tr[2, 4, 1] = np.nan
    q[3, 2, 2] = np.nan
    _both(q, tr, np.array([0.0, 1.0, 2.0, 3.0]), ("y", "x", "z"), "z")
    _both(q, tr, np.array([0.0, 1.0, 2.0, 3.0], dtype), ("z", "y", "x"), "z")


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_integer_q_matches_jax(dtype):
    rng = np.random.RandomState(8)
    q = rng.randint(-1000, 1000, (4, 11, 3)).astype(dtype)
    tr = rng.rand(4, 11, 3) * 2
    out = _both(q, tr, np.linspace(0.0, 2.0, 5), ("y", "z", "x"), "z")
    assert to_numpy(out).dtype == dtype


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_scatter_route_equals_select_then_sum(axis):
    """The per-level scatter_add_ route against JAX's one-hot
    select-then-sum on the same inputs, bit for bit, on every axis."""
    rng = np.random.RandomState(9 + axis)
    q = rng.randn(6, 7, 8)
    tr = rng.rand(6, 7, 8) * 4
    q[rng.rand(6, 7, 8) < 0.05] = np.nan
    levs = np.linspace(0.5, 3.5, 7)
    got = torch_rg._regrid_vertical(torch.as_tensor(q), torch.as_tensor(tr), levs, axis=axis)
    want = jax_rg._regrid_vertical(q, tr, levs, axis=axis)
    assert_bitwise(got, want)
