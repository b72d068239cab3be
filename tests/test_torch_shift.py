"""The shift stencils of the port against xgcm_tpu, bit for bit:
``fused_shift_op`` (kernel A's plain version on the CPU) and Grid
``interp``/``diff``/``min``/``max`` over every op, direction and boundary
condition, along each axis of a 3-D array (also with 1, 2, 3 or 5 points
on that axis), in float64 and float32; integer inputs and inner/outer
position pairs through the generic engine."""

import warnings

import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu_torch as xtt
from tests.torch_parity import assert_bitwise, to_numpy
from xgcm_tpu.ops.fused import fused_shift_op as jax_shift
from xgcm_tpu_torch.ops.fused import fused_shift_op as torch_shift

OPS = ("diff", "interp", "min", "max")
BCS = ("periodic", None, "fill", "extend", "extrapolate")
DTYPES = (np.float64, np.float32)


def _field(shape, dtype, seed=0):
    """Random values with a NaN, an inf and a -0.0 sprinkled in, so NaN
    propagation and min/max ordering are exercised too."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3).astype(dtype)
    flat = x.reshape(-1)
    flat[[3, 11]] = np.nan
    flat[7] = np.inf
    flat[5] = -0.0
    return x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("direction", ("left", "right"))
@pytest.mark.parametrize("op", OPS)
def test_fused_shift_op_bitwise(op, direction, bc, dtype):
    import jax.numpy as jnp

    x = _field((4, 5, 6), dtype)
    for axis in range(3):
        j = jax_shift(jnp.asarray(x), axis, op, direction, bc, 1.5)
        t = torch_shift(torch.as_tensor(x), axis, op, direction, bc, 1.5)
        assert_bitwise(t, j)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("direction", ("left", "right"))
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n", (1, 2, 3, 5))
def test_fused_shift_op_bitwise_small_odd_shapes(n, op, direction, dtype):
    """n = 1, 2, 3 and 5 along each axis, every boundary: the widths at which
    kernel A's index arithmetic breaks, pinned on the plain version that the
    card holds the kernel against."""
    import jax.numpy as jnp

    for axis in range(3):
        shape = tuple(n if i == axis else (4, 3, 5)[i] for i in range(3))
        x = _field(shape, dtype, seed=6)
        for bc in BCS:
            j = jax_shift(jnp.asarray(x), axis, op, direction, bc, 1.5)
            t = torch_shift(torch.as_tensor(x), axis, op, direction, bc, 1.5)
            assert_bitwise(t, j)


def _grids(dtype):
    """(jax grid, port grid, {pos: dims}) on a 3-D grid whose X and Z axes
    have center+left and whose Y axis has center+right."""
    nz, ny, nx = 3, 4, 5
    coords = {
        "zc": ("zc", np.arange(nz, dtype=dtype)), "zl": ("zl", np.arange(nz, dtype=dtype)),
        "yc": ("yc", np.arange(ny, dtype=dtype)), "yr": ("yr", np.arange(ny, dtype=dtype)),
        "xc": ("xc", np.arange(nx, dtype=dtype)), "xl": ("xl", np.arange(nx, dtype=dtype)),
    }
    axes = {
        "X": {"center": "xc", "left": "xl"},
        "Y": {"center": "yc", "right": "yr"},
        "Z": {"center": "zc", "left": "zl"},
    }
    ds = xgcm_tpu.Dataset(coords=coords)
    g_j = xgcm_tpu.Grid(ds, coords=axes, autoparse_metadata=False)
    g_t = xtt.Grid(xtt.from_numpy_dataset(ds), coords=axes, autoparse_metadata=False)
    return g_j, g_t, (nz, ny, nx)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("op", OPS)
def test_grid_ops_bitwise(op, bc, dtype):
    g_j, g_t, shape = _grids(dtype)
    x = _field(shape, dtype, seed=1)
    kwargs = {} if bc is None else dict(boundary=bc, fill_value=-2.0)
    for dims in [("zc", "yc", "xc"), ("zl", "yr", "xl")]:
        a_j = xgcm_tpu.GriddedArray(x, dims, name="a")
        a_t = xtt.GriddedArray(torch.as_tensor(x), dims, name="a")
        for axis in ("X", "Y", "Z"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                r_j = getattr(g_j, op)(a_j, axis, **kwargs)
                r_t = getattr(g_t, op)(a_t, axis, **kwargs)
            assert r_t.dims == r_j.dims and r_t.name == r_j.name
            assert_bitwise(r_t, r_j)


@pytest.mark.parametrize("op", ("diff", "interp", "min", "max"))
@pytest.mark.parametrize("bc", ("periodic", "fill", "extend"))
def test_int_input_takes_generic_engine(op, bc):
    g_j, g_t, shape = _grids(np.float64)
    x = np.random.RandomState(2).randint(-50, 50, size=shape).astype(np.int64)
    dims = ("zc", "yc", "xc")
    for axis in ("X", "Y"):
        r_j = getattr(g_j, op)(xgcm_tpu.GriddedArray(x, dims), axis, boundary=bc)
        r_t = getattr(g_t, op)(xtt.GriddedArray(torch.as_tensor(x), dims), axis, boundary=bc)
        assert r_t.dims == r_j.dims
        # integer interp is float64, as in JAX with x64; the rest stay int64
        assert r_t.dtype == (torch.float64 if op == "interp" else torch.int64)
        assert_bitwise(r_t, r_j)


def _inner_outer_grids():
    n = 7
    ds = xgcm_tpu.Dataset(coords={
        "xc": ("xc", np.arange(n) + 0.5), "xo": ("xo", np.arange(n + 1) * 1.0),
        "yc": ("yc", np.arange(n) + 0.5), "yi": ("yi", np.arange(n - 1) + 1.0),
        "t": ("t", np.arange(3.0)),
    })
    axes = {"X": {"center": "xc", "outer": "xo"}, "Y": {"center": "yc", "inner": "yi"}}
    g_j = xgcm_tpu.Grid(ds, coords=axes, periodic=False, autoparse_metadata=False)
    g_t = xtt.Grid(xtt.from_numpy_dataset(ds), coords=axes, periodic=False,
                   autoparse_metadata=False)
    return g_j, g_t, n


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("bc", ("fill", "extend", "extrapolate"))
def test_inner_outer_pairs_bitwise(op, bc):
    g_j, g_t, n = _inner_outer_grids()
    rng = np.random.RandomState(3)
    cases = [
        (("t", "yc", "xc"), (3, n, n), "X"),  # center -> outer
        (("t", "yc", "xo"), (3, n, n + 1), "X"),  # outer -> center
        (("xc", "yc"), (n, n), "Y"),  # center -> inner
        (("xc", "yi", "t"), (n, n - 1, 3), "Y"),  # inner -> center
    ]
    for dims, shape, axis in cases:
        x = rng.randn(*shape)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r_j = getattr(g_j, op)(xgcm_tpu.GriddedArray(x, dims), axis, boundary=bc)
            r_t = getattr(g_t, op)(xtt.GriddedArray(torch.as_tensor(x), dims), axis,
                                   boundary=bc)
        assert r_t.dims == r_j.dims
        assert_bitwise(r_t, r_j)


def test_vector_component_and_multi_axis_dispatch():
    g_j, g_t, shape = _grids(np.float64)
    x = _field(shape, np.float64, seed=4)
    dims = ("zc", "yc", "xc")
    r_j = g_j.interp({"X": xgcm_tpu.GriddedArray(x, dims)}, ["X", "Y"])
    r_t = g_t.interp({"X": xtt.GriddedArray(torch.as_tensor(x), dims)}, ["X", "Y"])
    assert r_t.dims == r_j.dims
    assert_bitwise(r_t, r_j)


def test_non_gridded_input_raises_type_error():
    g_j, g_t, shape = _grids(np.float64)
    with pytest.raises(TypeError):
        g_t.diff(torch.zeros(shape), "X")
    # metric_weighted= is ported: on a grid without metrics both packages
    # raise get_metric's KeyError
    for g, da in ((g_t, xtt.GriddedArray(torch.zeros(shape), ("zc", "yc", "xc"))),
                  (g_j, xgcm_tpu.GriddedArray(np.zeros(shape), ("zc", "yc", "xc")))):
        with pytest.raises(KeyError, match="Unable to find any combinations"):
            g.diff(da, "X", metric_weighted=["X"])


def test_numpy_data_and_to_numpy_roundtrip():
    g_j, g_t, shape = _grids(np.float64)
    x = _field(shape, np.float64, seed=5)
    r_t = g_t.diff(xtt.GriddedArray(x, ("zc", "yc", "xc")), "Y")
    r_j = g_j.diff(xgcm_tpu.GriddedArray(x, ("zc", "yc", "xc")), "Y")
    assert_bitwise(to_numpy(r_t), to_numpy(r_j))
