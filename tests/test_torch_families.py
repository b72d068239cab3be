"""The port's grid factories (``xgcm_tpu_torch.grids``) against
``xgcm_tpu.grids``: the same axes, boundaries and face links, and the same
results, value for value, for the ops their users run on them: cross-face
tracer gradients, C-grid vorticity and divergence with the vector sign
rules, the 2-D vector wrappers, with a leading batch dim and with NaN and
infinities on the face edges (LLC: uneven face count, unconnected edges)."""

import warnings

import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu_torch as xtt
from tests.torch_parity import assert_bitwise, assert_close
from xgcm_tpu import grids as jax_grids


def _axes_summary(grid):
    return {
        name: (dict(ax.coords), dict(ax.default_shifts), ax.boundary, ax.fill_value,
               ax._facedim,
               {f: tuple(None if c is None else (c[0], c[1].name, c[2]) for c in lr)
                for f, lr in (ax._face_connections or {}).items()})
        for name, ax in grid.axes.items()
    }


def _pair(a, dims):
    return xgcm_tpu.GriddedArray(a, dims), xtt.GriddedArray(torch.as_tensor(a), dims)


def _check(r_t, r_j):
    assert r_t.dims == r_j.dims
    assert_bitwise(r_t, r_j)


def test_connection_tables_are_the_jax_packages():
    assert xtt.grids.CUBED_SPHERE_CONNECTIONS == jax_grids.CUBED_SPHERE_CONNECTIONS
    assert xtt.grids.LLC_CONNECTIONS == jax_grids.LLC_CONNECTIONS


@pytest.mark.parametrize(
    "factory, kwargs",
    [("cubed_sphere_grid", dict(n=4)), ("cubed_sphere_grid", dict()),
     ("llc_grid", dict(n=6)), ("llc_grid", dict()),
     ("mom6_symmetric_grid", dict(nx=12, ny=8)), ("mom6_symmetric_grid", dict()),
     ("mitgcm_c_grid", dict(nx=12, ny=8, nz=5)), ("mitgcm_c_grid", dict()),
     ("nemo_c_grid", dict(nx=12, ny=8, nz=5)), ("nemo_c_grid", dict())],
)
def test_factory_builds_the_same_grid(factory, kwargs):
    ds_j, g_j = getattr(jax_grids, factory)(**kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)  # the factory keeps them quiet
        ds_t, g_t = getattr(xtt.grids, factory)(**kwargs)
    assert _axes_summary(g_t) == _axes_summary(g_j)
    assert ds_t.dims == ds_j.dims
    for name, c in ds_j.coords.items():
        np.testing.assert_array_equal(ds_t.coords[name].values, np.asarray(c.data))
    assert ({k: [(v.name, v.dims) for v in vs] for k, vs in g_t._metrics.items()}
            == {k: [(v.name, v.dims) for v in vs] for k, vs in g_j._metrics.items()})


def _analysis(grid, theta, u, v):
    """The face analysis of examples/llc_analysis.py on one grid."""
    out = [grid.diff(theta, "X"), grid.diff(theta, "Y"),
           grid.diff({"X": v}, "X", other_component={"Y": u})
           - grid.diff({"Y": u}, "Y", other_component={"X": v}),
           grid.diff({"X": u}, "X", other_component={"Y": v})
           + grid.diff({"Y": v}, "Y", other_component={"X": u})]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        vec = grid.interp_2d_vector({"X": u, "Y": v}, to="center")
    return out + [vec["X"], vec["Y"]]


def _edges_nonfinite(a, rng):
    flat = a.reshape(-1, *a.shape[-2:])
    n = a.shape[-1]
    for val in (np.nan, np.inf, -np.inf, np.nan):
        b, k = rng.randint(flat.shape[0]), rng.randint(n)
        edge = rng.randint(4)
        idx = [(k, 0), (k, n - 1), (0, k), (n - 1, k)][edge]
        flat[(b, *idx)] = val
    return a


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("factory, nf", [("cubed_sphere_grid", 6), ("llc_grid", 13)])
def test_face_analysis_matches_jax(factory, nf, batch, dtype):
    n = 8
    _, g_j = getattr(jax_grids, factory)(n=n)
    _, g_t = getattr(xtt.grids, factory)(n=n)
    rng = np.random.RandomState(nf + batch)
    shape = (3, nf, n, n) if batch else (nf, n, n)
    lead = ("time",) if batch else ()
    arrays = [_edges_nonfinite(rng.randn(*shape).astype(dtype), rng) for _ in range(3)]
    dims = [lead + ("face", "y", "x"), lead + ("face", "y", "xl"), lead + ("face", "yl", "x")]
    (th_j, th_t), (u_j, u_t), (v_j, v_t) = (_pair(a, d) for a, d in zip(arrays, dims))
    for r_t, r_j in zip(_analysis(g_t, th_t, u_t, v_t), _analysis(g_j, th_j, u_j, v_j)):
        _check(r_t, r_j)


@pytest.mark.parametrize("factory, nf", [("cubed_sphere_grid", 6), ("llc_grid", 13)])
def test_constant_field_has_no_seams(factory, nf):
    """examples/llc_analysis.py step 6: with ``boundary="extend"`` the
    gradients of a constant vanish across every connection."""
    _, g_t = getattr(xtt.grids, factory)(n=6)
    one = xtt.GriddedArray(torch.ones(nf, 6, 6, dtype=torch.float64), ("face", "y", "x"))
    for axis in ("X", "Y"):
        assert torch.equal(g_t.diff(one, axis, boundary="extend").data,
                           torch.zeros(nf, 6, 6, dtype=torch.float64))


@pytest.mark.parametrize("boundary", ["extend", "fill", "periodic"])
@pytest.mark.parametrize("op", ["diff", "interp"])
def test_mom6_outer_positions_match_jax(op, boundary):
    _, g_j = jax_grids.mom6_symmetric_grid(nx=12, ny=8)
    _, g_t = xtt.grids.mom6_symmetric_grid(nx=12, ny=8)
    rng = np.random.RandomState(3)
    for shape, dims in (((8, 12), ("yh", "xh")), ((9, 13), ("yq", "xq"))):
        a_j, a_t = _pair(rng.randn(*shape), dims)
        for axis in ("X", "Y"):
            _check(getattr(g_t, op)(a_t, axis, boundary=boundary),
                   getattr(g_j, op)(a_j, axis, boundary=boundary))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("factory, dims", [("mitgcm_c_grid", ("Z", "YC", "XC")),
                                           ("nemo_c_grid", ("z_c", "y_c", "x_c"))])
def test_c_grid_calculus_matches_jax(factory, dims, dtype):
    """derivative along each axis (diffs bit for bit; the metrics are f64,
    so f32 data gives f64 as in JAX) and integrate over X-Y and Z (the JAX
    tests' rtol, 1e-7, in f64), with NaN and infinities in the data."""
    _, g_j = getattr(jax_grids, factory)(nx=12, ny=8, nz=5)
    _, g_t = getattr(xtt.grids, factory)(nx=12, ny=8, nz=5)
    rng = np.random.RandomState(8)
    a = rng.randn(5, 8, 12).astype(dtype)
    a[1, 2, 3], a[0, 4, 5], a[3, 7, 11] = np.nan, np.inf, -np.inf
    th_j, th_t = _pair(a, dims)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # metrics interpolated to the diffs
        for axis in ("X", "Y", "Z"):
            _check(g_t.derivative(th_t, axis), g_j.derivative(th_j, axis))
    for axes in (["X", "Y"], "Z"):
        r_j, r_t = g_j.integrate(th_j, axes), g_t.integrate(th_t, axes)
        assert r_t.dims == r_j.dims and r_t.values.dtype == np.asarray(r_j.data).dtype
        assert_close(r_t, r_j, rtol=1e-7)
