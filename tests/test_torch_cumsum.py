"""The port's cumsum against xgcm_tpu: the prefix sum itself
(``ops.stencils.cumsum``, ``GriddedArray.cumsum``) in every dtype, the
cumsum grid ufuncs, and ``Grid.cumsum`` on every position pair under each
boundary, with ``metric_weighted=``, on several axes and on a
face-connected grid (the halo engine).  Float sums equal the JAX package's
bit for bit: the port sums in the order of XLA's blocked scan."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu_torch as xtt
from tests.torch_parity import assert_bitwise
from xgcm_tpu import grids as jax_grids
from xgcm_tpu.core import gridops as jax_gridops
from xgcm_tpu_torch.core import gridops as torch_gridops
from xgcm_tpu_torch.ops.stencils import cumsum

N = 9
SIZES = {"center": N, "left": N, "right": N, "inner": N - 1, "outer": N + 1}
# (grid ufunc, positions of the axis, input dim, to): the table of
# tests/test_cumsum_ufuncs.py
CASES = [
    ("cumsum_center_to_left", {"center": "xc", "left": "xg"}, "xc", "left"),
    ("cumsum_left_to_center", {"left": "xg", "center": "xc"}, "xg", "center"),
    ("cumsum_center_to_right", {"center": "xc", "right": "xg"}, "xc", "right"),
    ("cumsum_right_to_center", {"right": "xg", "center": "xc"}, "xg", "center"),
    ("cumsum_center_to_outer", {"center": "xc", "outer": "xg"}, "xc", "outer"),
    ("cumsum_outer_to_center", {"outer": "xg", "center": "xc"}, "xg", "center"),
    ("cumsum_center_to_inner", {"center": "xc", "inner": "xg"}, "xc", "inner"),
    ("cumsum_inner_to_center", {"inner": "xg", "center": "xc"}, "xg", "center"),
]


def _sprinkle(a, rng):
    """NaN, +-inf and -0.0 at random cells of a float array."""
    for val in (np.nan, np.inf, -np.inf, -0.0):
        a.flat[rng.randint(a.size)] = val
    return a


def _assert_same_sums(t, j):
    """The same values, NaN in the same places, zeros of the same sign."""
    np.testing.assert_array_equal(t, j)
    zeros = j == 0
    np.testing.assert_array_equal(np.signbit(t[zeros]), np.signbit(j[zeros]))


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.float16, "bfloat16"])
@pytest.mark.parametrize(
    "shape", [(1,), (16,), (17,), (5000,), (33, 2, 3), (4, 300, 7), (2, 3, 257, 40)]
)
def test_prefix_sum_equals_jnp_cumsum_bitwise(shape, dtype):
    """Every axis; lengths 1, 16, 17, 33, 257, 300 and 5000 take XLA's
    window of one, one block, a short last block and the recursion over
    block totals; short and long inner strides take both layouts."""
    rng = np.random.RandomState(len(shape) * 7 + sum(shape))
    a = _sprinkle(rng.randn(*shape) * 10, rng)
    if dtype == "bfloat16":
        j_in = jnp.asarray(a).astype(jnp.bfloat16)
        t_in = torch.as_tensor(a).to(torch.bfloat16)
    else:
        a = a.astype(dtype)
        j_in, t_in = jnp.asarray(a), torch.as_tensor(a)
    for axis in range(len(shape)):
        j = jnp.cumsum(j_in, axis=axis)
        t = cumsum(t_in, axis)
        assert t.shape == tuple(j.shape)
        if dtype == "bfloat16":
            assert t.dtype == torch.bfloat16
            t, j = t.float(), j.astype(jnp.float32)
        t, j = t.numpy(), np.asarray(j)
        assert t.dtype == j.dtype
        _assert_same_sums(t, j)


@pytest.mark.parametrize(
    "dtype",
    [np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32,
     np.uint64, np.float16, np.float32, np.float64],
)
def test_gridded_array_cumsum_dtype_and_values(dtype):
    """The dtype of jnp.cumsum under x64 (bool -> int64, the rest keep
    theirs), wrapping where the sums overflow the narrow integers."""
    rng = np.random.RandomState(5)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        a = rng.randint(info.min // 2, info.max // 2 + 1, size=(6, 20), dtype=np.int64)
        a = a.astype(dtype)
    elif dtype == np.bool_:
        a = rng.rand(6, 20) > 0.5
    else:
        a = _sprinkle(rng.randn(6, 20), rng).astype(dtype)
    for dim in ("y", "x"):
        r_j = xgcm_tpu.GriddedArray(a, ("y", "x")).cumsum(dim)
        r_t = xtt.GriddedArray(torch.as_tensor(a), ("y", "x")).cumsum(dim)
        assert r_t.dims == r_j.dims
        assert_bitwise(r_t, r_j)


def _grid_1d(pkg, pos2dim, boundary, dtype=float):
    coords = {
        dim: (dim, np.arange(SIZES[pos], dtype=dtype)) for pos, dim in pos2dim.items()
    }
    for pos, dim in pos2dim.items():
        coords["d" + dim] = ((dim,), 1.0 + 0.25 * np.cos(np.arange(SIZES[pos])))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return pkg.Grid(
            pkg.Dataset(coords=coords), coords={"X": pos2dim}, boundary=boundary,
            metrics={("X",): ["d" + d for d in pos2dim.values()]},
            autoparse_metadata=False,
        )


def _run(call_j, call_t):
    """Both calls' results, or both calls' exception types."""
    try:
        r_j = call_j()
    except Exception as e:  # the port must raise the same
        with pytest.raises(type(e)):
            call_t()
        return None, None
    return r_j, call_t()


@pytest.mark.parametrize("fill_value", [None, 2.5])
@pytest.mark.parametrize("boundary", ["periodic", "fill", "extend"])
@pytest.mark.parametrize("ufunc_name, pos2dim, in_dim, to", CASES)
def test_grid_cumsum_position_pairs(ufunc_name, pos2dim, in_dim, to, boundary, fill_value):
    frm = [p for p, d in pos2dim.items() if d == in_dim][0]
    rng = np.random.RandomState(SIZES[frm])
    a = _sprinkle(rng.randn(3, SIZES[frm]), rng)
    g_j = _grid_1d(xgcm_tpu, pos2dim, boundary)
    g_t = _grid_1d(xtt, pos2dim, boundary)
    kw = dict(to=to, boundary=boundary, fill_value=fill_value)
    r_j, r_t = _run(
        lambda: g_j.cumsum(xgcm_tpu.GriddedArray(a, ("t", in_dim)), "X", **kw),
        lambda: g_t.cumsum(xtt.GriddedArray(torch.as_tensor(a), ("t", in_dim)), "X", **kw),
    )
    if r_j is not None:
        assert r_t.dims == r_j.dims
        assert_bitwise(r_t, r_j)


@pytest.mark.parametrize("ufunc_name, pos2dim, in_dim, to", CASES)
def test_cumsum_grid_ufuncs(ufunc_name, pos2dim, in_dim, to):
    """The grid ufuncs of core/gridops (pad after the prefix sum, from
    fill_value 0) against the JAX package's, and against Grid.cumsum."""
    frm = [p for p, d in pos2dim.items() if d == in_dim][0]
    a = np.random.RandomState(2).rand(SIZES[frm])
    g_j = _grid_1d(xgcm_tpu, pos2dim, "fill")
    g_t = _grid_1d(xtt, pos2dim, "fill")
    da_t = xtt.GriddedArray(torch.as_tensor(a), (in_dim,))
    r_j = getattr(jax_gridops, ufunc_name)(
        g_j, xgcm_tpu.GriddedArray(a, (in_dim,)), axis=[("X",)], boundary="fill"
    )
    r_t = getattr(torch_gridops, ufunc_name)(g_t, da_t, axis=[("X",)], boundary="fill")
    assert r_t.dims == r_j.dims
    assert_bitwise(r_t, r_j)
    via_grid = g_t.cumsum(da_t, "X", to=to, boundary="fill", fill_value=0.0)
    assert via_grid.dims == r_t.dims
    assert_bitwise(via_grid, r_t)


@pytest.mark.parametrize("metric_weighted", [None, "X", ["X"]])
@pytest.mark.parametrize("ufunc_name, pos2dim, in_dim, to", CASES[:4])
def test_grid_cumsum_metric_weighted(ufunc_name, pos2dim, in_dim, to, metric_weighted):
    rng = np.random.RandomState(9)
    a = _sprinkle(rng.randn(4, N), rng)
    g_j = _grid_1d(xgcm_tpu, pos2dim, "fill")
    g_t = _grid_1d(xtt, pos2dim, "fill")
    r_j = g_j.cumsum(xgcm_tpu.GriddedArray(a, ("t", in_dim)), "X", to=to,
                     metric_weighted=metric_weighted)
    r_t = g_t.cumsum(xtt.GriddedArray(torch.as_tensor(a), ("t", in_dim)), "X", to=to,
                     metric_weighted=metric_weighted)
    assert r_t.dims == r_j.dims
    assert_bitwise(r_t, r_j)


def _grid_2d(pkg):
    ds = pkg.Dataset(coords={
        "xc": ("xc", np.arange(7) + 0.5), "xg": ("xg", np.arange(7) * 1.0),
        "yc": ("yc", np.arange(5) + 0.5), "yo": ("yo", np.arange(6) * 1.0),
    })
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return pkg.Grid(ds, coords={"X": {"center": "xc", "left": "xg"},
                                    "Y": {"center": "yc", "outer": "yo"}},
                        boundary={"X": "periodic", "Y": "fill"}, fill_value=0.0,
                        autoparse_metadata=False)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32, np.bool_])
@pytest.mark.parametrize("axes, to", [(["X", "Y"], None), (["Y", "X"], {"Y": "outer"}),
                                      ("Y", "outer"), ("X", None)])
def test_grid_cumsum_several_axes(axes, to, dtype):
    rng = np.random.RandomState(3)
    a = (rng.randn(2, 5, 7) * 4).astype(dtype)
    dims = ("t", "yc", "xc")
    r_j = _grid_2d(xgcm_tpu).cumsum(xgcm_tpu.GriddedArray(a, dims), axes, to=to)
    r_t = _grid_2d(xtt).cumsum(xtt.GriddedArray(torch.as_tensor(a), dims), axes, to=to)
    assert r_t.dims == r_j.dims
    assert_bitwise(r_t, r_j)


def test_grid_cumsum_errors_match():
    a = np.zeros((5, 7))
    for pkg in (xgcm_tpu, xtt):
        g = _grid_2d(pkg)
        da = pkg.GriddedArray(a, ("yc", "xc"))
        with pytest.raises(KeyError, match="Did not find axis Z"):
            g.cumsum(da, "Z")
        with pytest.raises(ValueError, match="single matching dimension"):
            g.cumsum(pkg.GriddedArray(np.zeros(5), ("yc",)), "X")
        with pytest.raises(ValueError, match="not a valid position shift"):
            g.cumsum(da, "Y", to="center")


def _ring(pkg, reversed_link):
    """Four faces joined along X (the ring of
    tests/test_face_sharded_cumsum.py), one link reversed or none."""
    n = 8
    ds = pkg.Dataset(coords={
        "x": ("x", np.arange(n) + 0.5, {"axis": "X"}),
        "xl": ("xl", np.arange(n) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
        "y": ("y", np.arange(n) + 0.5, {"axis": "Y"}),
        "yl": ("yl", np.arange(n) * 1.0, {"axis": "Y", "c_grid_axis_shift": -0.5}),
        "face": ("face", np.arange(4)),
    })
    if reversed_link:
        links = {0: (None, (1, "X", False)), 1: ((0, "X", False), (2, "X", True)),
                 2: ((3, "X", False), (1, "X", True)), 3: (None, (2, "X", False))}
    else:
        links = {f: (((f - 1) % 4, "X", False), ((f + 1) % 4, "X", False))
                 for f in range(4)}
    return pkg.Grid(ds, face_connections={"face": {f: {"X": lr} for f, lr in links.items()}})


@pytest.mark.parametrize("boundary", ["fill", "extend", "periodic"])
@pytest.mark.parametrize("reversed_link", [False, True])
@pytest.mark.parametrize("axis", ["X", "Y"])
def test_grid_cumsum_face_connected(axis, reversed_link, boundary):
    """On a face-connected grid the pad takes the face-connection halos."""
    rng = np.random.RandomState(11)
    a = _sprinkle(rng.randn(2, 4, 8, 8), rng)
    dims = ("t", "face", "y", "x")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        r_j = _ring(xgcm_tpu, reversed_link).cumsum(xgcm_tpu.GriddedArray(a, dims), axis,
                                                    to="left", boundary=boundary)
        r_t = _ring(xtt, reversed_link).cumsum(xtt.GriddedArray(torch.as_tensor(a), dims),
                                               axis, to="left", boundary=boundary)
    assert r_t.dims == r_j.dims
    assert_bitwise(r_t, r_j)


@pytest.mark.parametrize("axis", ["X", "Y"])
def test_grid_cumsum_cubed_sphere_raises_as_jax_does(axis):
    """Connections that swap axes meet faces the trim made non-square: the
    halo assembly fails in both packages (each with its framework's
    concatenation error)."""
    a = np.random.RandomState(1).rand(6, 8, 8)
    _, g_j = jax_grids.cubed_sphere_grid(n=8)
    _, g_t = xtt.grids.cubed_sphere_grid(n=8)
    with pytest.raises(TypeError, match="concatenate"):
        g_j.cumsum(xgcm_tpu.GriddedArray(a, ("face", "y", "x")), axis)
    with pytest.raises(RuntimeError, match="Sizes of tensors must match"):
        g_t.cumsum(xtt.GriddedArray(torch.as_tensor(a), ("face", "y", "x")), axis)
