"""``GriddedArray.sum`` and ``GriddedArray.mean`` of the port against the
JAX package (x64, as ``conftest.py`` sets up): the result dtype of
``jnp.sum``/``jnp.mean`` for every dtype (int64 or uint64 sums of bool and
integers, float32 or float64 means of them), the values (integers exactly;
float means within a few units in the last place, since both sum in the
result's float type in their own order), and the keyword arguments both
pass on (``dtype``; ``keepdims``, which neither ``GriddedArray`` takes
with fewer dims)."""

import numpy as np
import pytest

import xgcm_tpu
import xgcm_tpu_torch as xtt
from tests.torch_parity import to_numpy

DTYPES = [np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint32,
          np.float16, np.float32, np.float64]
RTOL = {np.float16: 2e-3, np.float32: 1e-6, np.float64: 1e-12}


def _pair(dtype, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.rand(6, 9) * 120 - (0 if np.dtype(dtype).kind in "bu" else 60)
    a = (a > 0) if dtype == np.bool_ else a.astype(dtype)
    return (xgcm_tpu.GriddedArray(a, ("y", "x"), name="q"),
            xtt.GriddedArray(a, ("y", "x"), name="q"))


@pytest.mark.parametrize("dims", [None, "x"])
@pytest.mark.parametrize("how", ["sum", "mean"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_reduction_matches_jax(dtype, how, dims):
    j, t = _pair(dtype)
    out_j, out_t = getattr(j, how)(dims), getattr(t, how)(dims)
    assert out_t.dims == out_j.dims and out_t.name == out_j.name
    want, got = np.asarray(out_j.data), to_numpy(out_t)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL[want.dtype.type])


def test_reduction_keywords_match_jax():
    j, t = _pair(np.int16, seed=1)
    for how in ("sum", "mean"):
        for dtype in (np.float32, np.float64, np.int32):
            out_j = getattr(j, how)("y", dtype=dtype)
            out_t = getattr(t, how)("y", dtype=dtype)
            assert to_numpy(out_t).dtype == np.asarray(out_j.data).dtype
            np.testing.assert_allclose(to_numpy(out_t), np.asarray(out_j.data), rtol=1e-6)
        for dims in (None, "x"):
            with pytest.raises(ValueError):
                getattr(j, how)(dims, keepdims=True)
            with pytest.raises(ValueError):
                getattr(t, how)(dims, keepdims=True)
        with pytest.raises(TypeError):
            getattr(j, how)("x", bogus=1)
        with pytest.raises(TypeError):
            getattr(t, how)("x", bogus=1)
