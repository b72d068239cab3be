"""Integer and bool data in the port against xgcm_tpu under x64.

JAX (x64) takes every unsigned width and promotes an integer against a
Python float to float64; torch adds, subtracts and orders no uint16,
uint32 or uint64 and promotes an integer against a Python float to
float32.  These cases hold the port to JAX bit for bit, dtype included:

* the four 2-point ops on one device for every integer dtype and bool
  under every basic boundary (the single-device ``Grid`` extrapolates
  integers and bools in float64, as JAX's fused path does);
* the ring route of the sharded layer, which keeps the integer dtype under
  ``extrapolate`` in both packages, and takes uint16/32/64 under every
  boundary;
* ``GriddedArray`` arithmetic and ``where`` against Python floats;
* linear and log transforms of integer data near 2^25, where float32
  rounds.

Where JAX raises (a difference of two boolean arrays), the port raises the
same exception type.
"""

import jax
import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu.parallel as jpar
import xgcm_tpu_torch as xtt
import xgcm_tpu_torch.parallel as tpar
from tests.torch_parity import assert_bitwise, to_numpy

DTYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64", "bool"]
BOUNDARIES = ["periodic", "fill", "extend", "extrapolate"]
OPS = ["diff", "interp", "min", "max"]


def _data(dtype, n=8):
    """Small values that wrap when subtracted, and each dtype's extremes
    (for the unsigned ones values at and above 2^(bits-1), whose order a
    plain signed cast would break)."""
    if dtype == "bool":
        return np.array([1, 0, 1, 1, 0, 0, 1, 0][:n], dtype=bool)
    info = np.iinfo(dtype)
    vals = [5, 0, 3, int(info.max), 9, int(info.max) // 2 + 3, int(info.min), 2]
    return np.array(vals[:n], dtype=dtype)


def _grid(pkg, boundary):
    ds = pkg.Dataset(coords={
        "x": ("x", np.arange(8) + 0.5, {"axis": "X"}),
        "xl": ("xl", np.arange(8) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
    })
    return pkg.Grid(ds, boundary=boundary, fill_value=3)


def _outcome(fn):
    """fn()'s result as numpy, or the type of what it raised."""
    try:
        return to_numpy(fn())
    except Exception as e:  # noqa: BLE001 — the exception type is the result
        return type(e)


def _assert_same(t, j):
    if isinstance(j, type):
        assert isinstance(t, type) and issubclass(t, j), (t, j)
    else:
        assert not isinstance(t, type), t
        assert_bitwise(t, j)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pair_ops_on_one_device(dtype, boundary, op):
    a = _data(dtype)
    j = _outcome(lambda: getattr(_grid(xgcm_tpu, boundary), op)(
        xgcm_tpu.GriddedArray(a, ("x",)), "X"))
    t = _outcome(lambda: getattr(_grid(xtt, boundary), op)(
        xtt.GriddedArray(torch.from_numpy(a.copy()), ("x",)), "X"))
    _assert_same(t, j)
    if boundary == "extrapolate" and not isinstance(j, type):
        assert j.dtype == np.float64  # JAX's fused path: 2.0 * x - inward


def _ring(pkg, par, mesh, dtype, boundary, op, a):
    sg = par.ShardedGrid(_grid(pkg, boundary), mesh, {"X": "x"})
    return getattr(sg, op)(sg.shard(pkg.GriddedArray(a, ("x",))), "X")


RING_CASES = ([(d, "extrapolate") for d in DTYPES]
              + [(d, b) for d in ("uint16", "uint32", "uint64")
                 for b in ("periodic", "fill", "extend")])


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype,boundary", RING_CASES)
def test_pair_ops_on_the_ring_route(dtype, boundary, op):
    """The ring route keeps the integer dtype under extrapolate (JAX's
    sharded engine pads in the data's dtype), and wraps the wide unsigned
    ones as JAX does."""
    a = _data(dtype)
    jm = jpar.make_mesh({"x": 4}, devices=jax.devices()[:4])
    tm = tpar.make_mesh({"x": 4}, devices=[torch.device("cpu")] * 4)
    j = _outcome(lambda: _ring(xgcm_tpu, jpar, jm, dtype, boundary, op, a))
    t = _outcome(lambda: _ring(xtt, tpar, tm, dtype, boundary, op, torch.from_numpy(a.copy())))
    _assert_same(t, j)
    if boundary == "extrapolate" and op != "interp" and not isinstance(j, type):
        assert j.dtype == a.dtype


ARITHMETIC = {
    "mul_float": lambda x: x * 0.5,
    "add_float": lambda x: x + 1.5,
    "rdiv_float": lambda x: 2.0 / x,
    "div_int": lambda x: x / 2,
    "div_self": lambda x: x / x,
    "add_int": lambda x: x + 1,
    "where_nan": lambda x: x.where(x.with_data(x.data[::-1].copy() if isinstance(
        x.data, np.ndarray) else x.data.flip(0)) == x),
}


@pytest.mark.parametrize("expr", list(ARITHMETIC))
@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "int64", "uint8", "bool",
                                   "float32", "float64"])
def test_gridded_array_scalar_arithmetic(dtype, expr):
    """int/bool against a Python float is float64 in both; a float tensor
    keeps its dtype; true division follows JAX (float32 below 64-bit
    integers, float64 for int64 and for bool against a Python int)."""
    if dtype == "bool" and expr == "add_int":
        a = np.array([1, 0, 1, 1], dtype=bool)
    else:
        a = np.array([5, 1, 3, 2], dtype=dtype) if dtype != "bool" else np.array(
            [1, 0, 1, 1], dtype=bool)
    fn = ARITHMETIC[expr]
    j = _outcome(lambda: fn(xgcm_tpu.GriddedArray(a, ("x",))))
    t = _outcome(lambda: fn(xtt.GriddedArray(torch.from_numpy(a.copy()), ("x",))))
    _assert_same(t, j)


@pytest.mark.parametrize("dtype", ["uint16", "uint32", "uint64"])
@pytest.mark.parametrize("expr", ["mul_float", "add_float", "rdiv_float"])
def test_wide_unsigned_against_python_floats(dtype, expr):
    a = _data(dtype, n=4)
    fn = ARITHMETIC[expr]
    _assert_same(_outcome(lambda: fn(xtt.GriddedArray(torch.from_numpy(a.copy()), ("x",)))),
                 _outcome(lambda: fn(xgcm_tpu.GriddedArray(a, ("x",)))))


def _z_grid(pkg):
    ds = pkg.Dataset(coords={"z": ("z", np.arange(10) + 0.5)})
    return pkg.Grid(ds, coords={"Z": {"center": "z"}}, periodic=False,
                    autoparse_metadata=False)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("method", ["linear", "log"])
@pytest.mark.parametrize("dtype", ["int32", "int64", "uint32", "bool"])
def test_integer_transforms_near_2_25(dtype, method, multi):
    """Integer data near 2^25 transform in float64 in both packages: in
    float32 most of these outputs would round by up to 4."""
    rng = np.random.RandomState(5)
    theta = np.sort(rng.rand(3, 10), -1) * 20 + 1.0
    if dtype == "bool":
        phi = rng.rand(3, 10) < 0.5
    else:
        phi = (2**25 + rng.randint(0, 1000, size=(3, 10))).astype(dtype)
    target = np.linspace(0.5, 22.0, 10)
    outs = []
    for pkg, wrap in ((xgcm_tpu, np.asarray), (xtt, lambda v: torch.from_numpy(v.copy()))):
        grid = _z_grid(pkg)
        da = pkg.GriddedArray(wrap(phi), ("c", "z"), name="phi")
        th = pkg.GriddedArray(wrap(theta), ("c", "z"), name="theta")
        if multi:
            outs.append(grid.transform_multi([da, da], "Z", target, target_data=th,
                                             method=method)[1])
        else:
            outs.append(grid.transform(da, "Z", target, target_data=th, method=method))
    j, t = outs
    assert t.dims == j.dims
    assert_bitwise(t, j)
    assert to_numpy(j).dtype == np.float64
