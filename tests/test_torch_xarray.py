"""The port's xarray bridge against xgcm_tpu's, through the duck-typed
xarray stub of tests/fake_xarray.py.

The stub is installed as ``sys.modules["xarray"]`` and both packages'
adapters are reloaded around each test, as tests/test_xarray_adapter_stub.py
does for the JAX package.  Every entry point of ``Grid`` then runs on the
same stub objects in both packages, and the results are compared: type,
dims, name, values and every coordinate.  Values are held bit for bit where
the JAX package's adapter tests are (shifts, cumsum, the transform round
trips against the native path); sums and transforms across the two
packages use the tolerances of their own parity tests (rtol 1e-7 for
``integrate``/``average``, 1e-12 for float64 transforms).

Cases: every case of tests/test_xarray_adapter_stub.py, the two seeded sweeps of tests/test_fuzz_adapter.py, each entry
point's xarray-in/xarray-out contract, and the port's bfloat16 rule.
"""

import importlib
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu_torch as xtt
from tests import fake_xarray
from tests.torch_parity import assert_bitwise, assert_close, to_numpy

N = 8
ADAPTERS = ("xgcm_tpu.adapters.xarray_adapter", "xgcm_tpu_torch.adapters.xarray_adapter")


@pytest.fixture()
def xr():
    mods = [importlib.import_module(name) for name in ADAPTERS]
    old = sys.modules.get("xarray")
    sys.modules["xarray"] = fake_xarray
    for mod in mods:
        importlib.reload(mod)
        assert mod.HAS_XARRAY
    try:
        yield fake_xarray
    finally:
        if old is not None:
            sys.modules["xarray"] = old
        else:
            sys.modules.pop("xarray", None)
        for mod in mods:
            importlib.reload(mod)


def _adapter(pkg):
    return importlib.import_module(pkg.__name__ + ".adapters.xarray_adapter")


def _both(case, *args):
    """(JAX result, port result) of ``case(pkg, *args)``."""
    return case(xgcm_tpu, *args), case(xtt, *args)


def _same(r_t, r_j, rtol=None):
    """Same container, dims, name and values (bit for bit, or within
    ``rtol``), and for xarray results the same coordinates, value for
    value."""
    if isinstance(r_j, dict):
        assert isinstance(r_t, dict) and list(r_t) == list(r_j)
        for k in r_j:
            _same(r_t[k], r_j[k], rtol)
        return
    if isinstance(r_j, (list, tuple)):
        assert type(r_t) is type(r_j) and len(r_t) == len(r_j)
        for a, b in zip(r_t, r_j):
            _same(a, b, rtol)
        return
    assert type(r_t).__name__ == type(r_j).__name__
    assert tuple(r_t.dims) == tuple(r_j.dims)
    assert r_t.name == r_j.name
    if isinstance(r_j, fake_xarray.DataArray):
        assert isinstance(r_t.data, np.ndarray)
        assert set(r_t.coords) == set(r_j.coords)
        for name, c in r_j.coords.items():
            assert r_t.coords[name].dims == c.dims, name
            assert_bitwise(r_t.coords[name].data, c.data)
    if rtol is None:
        assert_bitwise(r_t, r_j)
    else:
        assert_close(r_t, r_j, rtol=rtol)


def _xds(xr):
    rs = np.random.RandomState(0)
    return xr.Dataset(
        {
            "temp": (("YC", "XC"), rs.rand(N, N)),
            "u": (("YC", "XG"), rs.rand(N, N)),
            "v": (("YG", "XC"), rs.rand(N, N)),
            "itemp": (("YC", "XC"), rs.randint(0, 100, (N, N))),
        },
        coords={
            "XC": ("XC", np.arange(N) + 0.5, {"axis": "X"}),
            "XG": ("XG", np.arange(N) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
            "YC": ("YC", np.arange(N) + 0.5, {"axis": "Y"}),
            "YG": ("YG", np.arange(N) * 1.0, {"axis": "Y", "c_grid_axis_shift": -0.5}),
        },
    )


def _metric_grid(pkg, xr):
    ds = xr.Dataset(
        {"tracer": (("YC", "XC"), np.random.RandomState(2).rand(N, N))},
        coords={
            "XC": ("XC", np.arange(N) + 0.5, {"axis": "X"}),
            "XG": ("XG", np.arange(N) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
            "YC": ("YC", np.arange(N) + 0.5, {"axis": "Y"}),
            "YG": ("YG", np.arange(N) * 1.0, {"axis": "Y", "c_grid_axis_shift": -0.5}),
            "dx": ("XG", np.full(N, 2.0)),
            "dxc": ("XC", 1.0 + np.arange(N) / N),
            "dy": ("YC", 1.0 + np.arange(N) / 4.0),
        },
    )
    grid = pkg.Grid(
        ds,
        coords={"X": {"center": "XC", "left": "XG"}, "Y": {"center": "YC", "left": "YG"}},
        metrics={("X",): ["dx", "dxc"], ("Y",): ["dy"]},
        autoparse_metadata=False,
    )
    tr = ds["tracer"]
    tr.data[3, 4] = np.nan
    return grid, tr


def _z_grid(pkg, xr, nz=6):
    ds = xr.Dataset(coords={"zc": ("zc", np.arange(nz) + 0.5), "zo": ("zo", np.arange(nz + 1.0))})
    return pkg.Grid(ds, coords={"Z": {"center": "zc", "outer": "zo"}}, periodic=False,
                    autoparse_metadata=False)


def _add(x, y):
    return x + y


def _mean3(x):
    return 0.5 * (x[..., :-2] + x[..., 2:])


def _no_trim(x):
    return x


# -- every Grid entry point: xarray in, xarray out, as in the JAX package -------

# name -> (case(pkg, xr) -> result, rtol or None for bit for bit)
ENTRY_CASES = {
    "diff X (fused)": (lambda pkg, xr: pkg.Grid(_xds(xr)).diff(_xds(xr)["temp"], "X"), None),
    "interp Y (fused)": (lambda pkg, xr: pkg.Grid(_xds(xr)).interp(_xds(xr)["temp"], "Y"), None),
    "min X to left, fill": (lambda pkg, xr: pkg.Grid(_xds(xr)).min(
        _xds(xr)["temp"], "X", to="left", boundary="fill", fill_value=0.25), None),
    "max Y, extend": (lambda pkg, xr: pkg.Grid(_xds(xr)).max(
        _xds(xr)["v"], "Y", boundary="extend"), None),
    "diff X, X and Y in turn": (lambda pkg, xr: pkg.Grid(_xds(xr)).diff(
        _xds(xr)["temp"], ["X", "Y"]), None),
    # integer data and a dask keyword take the grid-ufunc engine
    "diff X of ints (grid ufunc)": (lambda pkg, xr: pkg.Grid(_xds(xr)).diff(
        _xds(xr)["itemp"], "X"), None),
    "interp X, dask= (grid ufunc)": (lambda pkg, xr: pkg.Grid(_xds(xr)).interp(
        _xds(xr)["temp"], "X", dask="forbidden"), None),
    "interp vector component with other_component": (lambda pkg, xr: pkg.Grid(_xds(xr)).interp(
        {"X": _xds(xr)["u"]}, "X", other_component={"Y": _xds(xr)["v"]}), None),
    "diff_2d_vector": (lambda pkg, xr: pkg.Grid(_xds(xr)).diff_2d_vector(
        {"X": _xds(xr)["u"], "Y": _xds(xr)["v"]}), None),
    "interp_2d_vector": (lambda pkg, xr: pkg.Grid(_xds(xr)).interp_2d_vector(
        {"X": _xds(xr)["u"], "Y": _xds(xr)["v"]}), None),
    # an xarray array gives a native result in the JAX package too
    "interp_like": (lambda pkg, xr: pkg.Grid(_xds(xr)).interp_like(
        _xds(xr)["temp"], _xds(xr)["u"]), None),
    "cumsum X": (lambda pkg, xr: pkg.Grid(_xds(xr)).cumsum(_xds(xr)["temp"], "X"), None),
    "cumsum of u to center, keep_coords": (lambda pkg, xr: pkg.Grid(_xds(xr)).cumsum(
        _xds(xr)["u"], "X", to="center", keep_coords=True), None),
    "cumsum X and Y, fill": (lambda pkg, xr: pkg.Grid(_xds(xr)).cumsum(
        _xds(xr)["temp"], ["X", "Y"], boundary="fill"), None),
    "derivative X": (lambda pkg, xr: _metric_grid(pkg, xr)[0].derivative(
        _metric_grid(pkg, xr)[1], "X"), None),
    # dy lies on YC, the Y difference on YG: the metric is interpolated
    "derivative Y, metric interpolated": (lambda pkg, xr: _metric_grid(pkg, xr)[0].derivative(
        _metric_grid(pkg, xr)[1], "Y"), None),
    "integrate X": (lambda pkg, xr: _metric_grid(pkg, xr)[0].integrate(
        _metric_grid(pkg, xr)[1], "X"), 1e-7),
    "integrate X, Y": (lambda pkg, xr: _metric_grid(pkg, xr)[0].integrate(
        _metric_grid(pkg, xr)[1], ["X", "Y"]), 1e-7),
    "average Y": (lambda pkg, xr: _metric_grid(pkg, xr)[0].average(
        _metric_grid(pkg, xr)[1], "Y"), 1e-7),
    "cumint X, fill": (lambda pkg, xr: _metric_grid(pkg, xr)[0].cumint(
        _metric_grid(pkg, xr)[1], "X", boundary="fill"), None),
    "interp X, metric_weighted": (lambda pkg, xr: _metric_grid(pkg, xr)[0].interp(
        _metric_grid(pkg, xr)[1], "X", metric_weighted="X"), None),
    "apply_as_grid_ufunc, padded 3-point mean": (lambda pkg, xr: pkg.apply_as_grid_ufunc(
        _mean3, _xds(xr)["temp"], axis=[("X",)], grid=pkg.Grid(_xds(xr)),
        signature="(X:center)->(X:center)", boundary_width={"X": (1, 1)}), None),
    "apply_as_grid_ufunc, two outputs": (lambda pkg, xr: pkg.apply_as_grid_ufunc(
        lambda a: (a * 2.0, a + 1.0), _xds(xr)["u"], axis=[("X",)], grid=pkg.Grid(_xds(xr)),
        signature="(X:left)->(X:left),(X:left)"), None),
}


@pytest.mark.parametrize("name", list(ENTRY_CASES))
def test_entry_point_matches_jax(xr, name):
    case, rtol = ENTRY_CASES[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        warnings.simplefilter("ignore", UserWarning)  # metrics interpolated
        r_j, r_t = _both(case, xr)
    _same(r_t, r_j, rtol)
    if name != "interp_like":
        out = list(r_t.values()) if isinstance(r_t, dict) else r_t
        for o in out if isinstance(out, (list, tuple)) else [out]:
            assert isinstance(o, xr.DataArray)


def _transform_case(pkg, xr, method, target_kind):
    nz = 6
    rs = np.random.RandomState(1)
    grid = _z_grid(pkg, xr, nz)
    da = xr.DataArray(np.sort(rs.rand(nz, 3), axis=0), dims=("zc", "x"), name="temp",
                      coords={"xlabel": ("x", np.arange(3.0) * 7)})
    kwargs = {"method": method}
    if target_kind == "auto, same length":
        target = np.linspace(0.6, 5.4, nz + (method == "conservative"))
    elif target_kind == "auto, shorter":
        target = np.linspace(0.5, 5.5, 4)
    else:
        dim = "zo" if method == "conservative" else "zc"
        kwargs["target_data"] = xr.DataArray(
            np.broadcast_to(np.linspace(20.0, 28.0, nz + (dim == "zo"))[:, None],
                            (nz + (dim == "zo"), 3)).copy(),
            dims=(dim, "x"), name="s", coords={"lon": ("x", np.linspace(0.0, 3.0, 3))})
        target = np.linspace(21.0, 27.0, 4)
        if target_kind == "xarray target":
            target = xr.DataArray(target, dims=("s",), name="s")
    return grid.transform(da, "Z", target, **kwargs)


@pytest.mark.parametrize("target_kind",
                         ["named target_data", "xarray target", "auto, same length",
                          "auto, shorter"])
@pytest.mark.parametrize("method", ["linear", "log", "conservative"])
def test_transform_matches_jax(xr, method, target_kind):
    r_j, r_t = _both(_transform_case, xr, method, target_kind)
    _same(r_t, r_j, rtol=1e-12)
    assert isinstance(r_t, xr.DataArray)


def _multi_case(pkg, xr, method):
    nz = 6
    rs = np.random.RandomState(5)
    grid = _z_grid(pkg, xr, nz)
    das = [xr.DataArray(rs.rand(nz, 3), dims=("zc", "x"), name=nm,
                        coords={"lon": ("x", np.full(3, float(i)))})
           for i, nm in enumerate(("T", "S", "u"))]
    das[1] = das[1].drop_vars("lon")  # falls back on target_data's lon
    dim = "zo" if method == "conservative" else "zc"
    sigma = xr.DataArray(
        np.broadcast_to(np.linspace(20.0, 28.0, nz + (dim == "zo"))[:, None],
                        (nz + (dim == "zo"), 3)).copy(),
        dims=(dim, "x"), name="s", coords={"lon": ("x", np.linspace(0.0, 3.0, 3))})
    native = grid.transform(_adapter(pkg).dataarray_from_xarray(das[0]), "Z",
                            np.linspace(21.0, 27.0, 4), method=method,
                            target_data=_adapter(pkg).dataarray_from_xarray(sigma))
    return grid.transform_multi(das, "Z", np.linspace(21.0, 27.0, 4), method=method,
                                target_data=sigma), native


@pytest.mark.parametrize("method", ["linear", "log", "conservative"])
def test_transform_multi_matches_jax(xr, method):
    (r_j, n_j), (r_t, n_t) = _both(_multi_case, xr, method)
    _same(r_t, r_j, rtol=1e-12)
    # each variable's own coordinates win over target_data's
    for i, o in enumerate(r_t):
        assert isinstance(o, xr.DataArray)
        want = np.linspace(0.0, 3.0, 3) if i == 1 else np.full(3, float(i))
        np.testing.assert_array_equal(o.coords["lon"].data, want)
    # the xarray round trip leaves the values as the native call gives them
    np.testing.assert_array_equal(r_t[0].data, to_numpy(n_t))


# -- the cases of tests/test_xarray_adapter_stub.py ------------------------------


def test_dataset_roundtrip(xr):
    xds = _xds(xr)
    ad = _adapter(xtt)
    ds = ad.dataset_from_xarray(xds)
    assert ds.dims == dict(xds.sizes)
    assert ds.coords["XC"].attrs["axis"] == "X"
    # coordinates stay on the host; data variables go to the default device
    assert all(isinstance(c.data, np.ndarray) for c in ds.coords.values())
    for name, v in ds.data_vars.items():
        assert isinstance(v.data, torch.Tensor)
        assert v.data.device == xtt.get_default_device()
        np.testing.assert_array_equal(to_numpy(v), xds[name].values)
    back = ad.dataset_to_xarray(ds)
    assert dict(back.sizes) == dict(xds.sizes)
    assert back["XG"].attrs["c_grid_axis_shift"] == -0.5
    np.testing.assert_array_equal(back["temp"].values, xds["temp"].values)
    j_back = _adapter(xgcm_tpu).dataset_to_xarray(_adapter(xgcm_tpu).dataset_from_xarray(xds))
    for name in list(xds.data_vars) + list(xds.coords):
        _same(back[name], j_back[name])


def test_grid_autoparses_stub_dataset(xr):
    g_j, g_t = _both(lambda pkg: pkg.Grid(_xds(xr)))
    for name in ("X", "Y"):
        assert g_t.axes[name].coords == g_j.axes[name].coords
    assert g_t.axes["X"].coords == {"center": "XC", "left": "XG"}
    # Grid(xr_ds)._ds holds what the (dims, data)-tuple Dataset holds
    xds = _xds(xr)
    tup = xtt.Dataset(coords={k: (v.dims, v.data, v.attrs) for k, v in xds.coords.items()},
                      data_vars={k: (v.dims, v.data) for k, v in xds.data_vars.items()})
    for name, v in tup.variables.items():
        got = g_t._ds[name]
        assert type(got.data) is type(v.data) and got.dims == v.dims
        assert_bitwise(got, v)


def test_grid_rejects_other_objects(xr):
    for pkg in (xgcm_tpu, xtt):
        with pytest.raises(TypeError, match=r"\(or xarray.Dataset\)"):
            pkg.Grid({"XC": np.arange(3.0)})


def test_ops_accept_dataarrays_directly(xr):
    def case(pkg):
        ad = _adapter(pkg)
        xds = _xds(xr)
        grid = pkg.Grid(xds)
        native = ad.dataarray_from_xarray(xds["temp"])
        out = []
        for implicit, explicit in (
            (grid.diff(xds["temp"], "X"), grid.diff(native, "X")),
            (grid.interp({"X": xds["u"]}, "X"),
             grid.interp({"X": ad.dataarray_from_xarray(xds["u"])}, "X")),
            (grid.cumsum(xds["temp"], "X"), grid.cumsum(native, "X")),
        ):
            assert isinstance(implicit, xr.DataArray)
            assert isinstance(explicit, pkg.GriddedArray)
            np.testing.assert_array_equal(implicit.data, to_numpy(explicit))
            out.append(implicit)
        like = grid.interp(native, "X")
        out.append(grid.interp_like(xds["temp"], like))
        np.testing.assert_array_equal(to_numpy(out[-1]), to_numpy(like))
        return out

    r_j, r_t = _both(case)
    _same(r_t, r_j)


def test_sharded_grid_accepts_dataarrays(xr):
    """A ShardedGrid op and ``apply_many`` take an ``xr.DataArray`` as its
    native GriddedArray; the batch equals the explicit single op, in both
    packages, and the two packages agree bit for bit."""
    import jax

    def case(pkg):
        par = importlib.import_module(pkg.__name__ + ".parallel")
        devices = jax.devices()[:8] if pkg is xgcm_tpu else [torch.device("cpu")] * 8
        xds = _xds(xr)
        grid = pkg.Grid(xds)
        sg = par.ShardedGrid(grid, par.make_mesh({"xm": 4, "ym": 2}, devices=devices),
                             {"XC": "xm", "XG": "xm", "YC": "ym", "YG": "ym"})
        implicit = sg.diff(xds["temp"], "X")
        explicit = sg.diff(_adapter(pkg).dataarray_from_xarray(xds["temp"]), "X")
        np.testing.assert_array_equal(to_numpy(implicit), to_numpy(explicit))
        [am] = sg.apply_many([dict(op="diff", args=xds["temp"], axis="X")])
        assert isinstance(am, pkg.GriddedArray) and am.dims == explicit.dims
        np.testing.assert_array_equal(to_numpy(am), to_numpy(explicit))
        return to_numpy(am), to_numpy(implicit)

    r_j, r_t = _both(case)
    for a, b in zip(r_t, r_j):
        assert_bitwise(a, b)


def test_xarray_out_coord_reattachment(xr):
    """Grid coordinates go on the position-shifted dim; input coordinates on
    the other dims survive and override the grid's; keep_coords=False warns
    and drops the non-dimension coordinates."""
    def case(pkg):
        xds = _xds(xr)
        grid = pkg.Grid(xds)
        temp = xds["temp"].assign_coords({
            "YC": xr.DataArray(np.arange(N) * 10.0, dims=("YC",), name="YC"),
            "ylabel": (("YC",), np.arange(N) + 100.0),
        })
        out = grid.diff(temp, "X", keep_coords=True)
        with pytest.warns(DeprecationWarning, match="keep_coords"):
            out2 = grid.diff(temp, "X", keep_coords=False)
        return out, out2

    (o_j, o2_j), (o_t, o2_t) = _both(case)
    _same(o_t, o_j)
    _same(o2_t, o2_j)
    np.testing.assert_array_equal(o_t.coords["XG"].data, np.arange(N) * 1.0)
    np.testing.assert_array_equal(o_t.coords["YC"].data, np.arange(N) * 10.0)
    np.testing.assert_array_equal(o_t.coords["ylabel"].data, np.arange(N) + 100.0)
    assert "ylabel" not in o2_t.coords and "XG" in o2_t.coords


def test_xarray_out_calculus_and_reductions(xr):
    def case(pkg):
        grid, tr = _metric_grid(pkg, xr)
        return (grid.derivative(tr, "X"), grid.integrate(tr, "X"), grid.average(tr, "X"),
                grid.cumint(tr, "X", boundary="fill"))

    r_j, r_t = _both(case)
    for a, b, rtol in zip(r_t, r_j, (None, 1e-7, 1e-7, None)):
        _same(a, b, rtol)
        assert isinstance(a, xr.DataArray)
    d, integ, _, ci = r_t
    grid, tr = _metric_grid(xtt, xr)
    np.testing.assert_array_equal(d.data, grid.diff(tr, "X").data / 2.0)
    assert integ.dims == ("YC",) and "YC" in integ.coords
    assert "XG" in ci.dims


def test_vector_ops_accept_dataarrays(xr):
    def case(pkg):
        ad = _adapter(pkg)
        xds = _xds(xr)
        grid = pkg.Grid(xds)
        with pytest.warns(DeprecationWarning):
            implicit = grid.interp_2d_vector({"X": xds["u"], "Y": xds["v"]})
        with pytest.warns(DeprecationWarning):
            explicit = grid.interp_2d_vector({"X": ad.dataarray_from_xarray(xds["u"]),
                                              "Y": ad.dataarray_from_xarray(xds["v"])})
        for k in ("X", "Y"):
            np.testing.assert_array_equal(implicit[k].data, to_numpy(explicit[k]))
        other = grid.diff({"X": xds["u"]}, "X", other_component={"Y": xds["v"]})
        np.testing.assert_array_equal(other.data, to_numpy(grid.diff(
            {"X": ad.dataarray_from_xarray(xds["u"])}, "X",
            other_component={"Y": ad.dataarray_from_xarray(xds["v"])})))
        return implicit, other

    r_j, r_t = _both(case)
    _same(r_t, r_j)


def test_transform_accepts_dataarrays(xr):
    def case(pkg):
        ad = _adapter(pkg)
        nz = 6
        rs = np.random.RandomState(1)
        ds = xr.Dataset(coords={"zc": ("zc", np.arange(nz) + 0.5)})
        grid = pkg.Grid(ds, coords={"Z": {"center": "zc"}}, periodic=False,
                        autoparse_metadata=False)
        da = xr.DataArray(rs.rand(nz), dims=("zc",), name="temp")
        sigma = xr.DataArray(np.linspace(20.0, 28.0, nz), dims=("zc",), name="s")
        target = np.linspace(21.0, 27.0, 4)
        implicit = grid.transform(da, "Z", target, target_data=sigma)
        explicit = grid.transform(ad.dataarray_from_xarray(da), "Z", target,
                                  target_data=ad.dataarray_from_xarray(sigma))
        np.testing.assert_array_equal(implicit.data, to_numpy(explicit))
        assert implicit.dims == ("s",)
        np.testing.assert_array_equal(implicit.coords["s"].data, target)
        [im] = grid.transform_multi([da], "Z", target, target_data=sigma)
        np.testing.assert_array_equal(im.data, to_numpy(explicit))
        return implicit, im

    r_j, r_t = _both(case)
    _same(r_t, r_j, rtol=1e-12)


def test_transform_auto_naming_fallback_coord(xr):
    """Without target_data the source dim's name is reused, and it carries
    the target values, also when the target is as long as the source."""
    def case(pkg):
        nz = 6
        rs = np.random.RandomState(3)
        ds = xr.Dataset(coords={"zc": ("zc", np.arange(nz) + 0.5)})
        grid = pkg.Grid(ds, coords={"Z": {"center": "zc"}}, periodic=False,
                        autoparse_metadata=False)
        da = xr.DataArray(np.sort(rs.rand(nz)), dims=("zc",), name="temp")
        same = np.linspace(1.1, 4.9, nz)
        out = grid.transform(da, "Z", same)
        np.testing.assert_array_equal(out.coords["zc"].data, same)
        out2 = grid.transform(da, "Z", np.linspace(0.5, 5.5, 4))
        np.testing.assert_array_equal(out2.coords["zc"].data, np.linspace(0.5, 5.5, 4))
        [om] = grid.transform_multi([da], "Z", same)
        np.testing.assert_array_equal(om.coords["zc"].data, same)
        return out, out2, om

    r_j, r_t = _both(case)
    _same(r_t, r_j, rtol=1e-12)


def test_to_xarray_reattaches_grid_coords(xr):
    def case(pkg):
        ad = _adapter(pkg)
        xds = _xds(xr)
        grid = pkg.Grid(xds)
        xa = ad.to_xarray(grid.interp(xds["temp"], "X"), grid)
        assert "XG" in xa.coords and "YC" in xa.coords and "XC" not in xa.coords
        with pytest.warns(DeprecationWarning):
            vec = grid.interp_2d_vector({"X": xds["u"], "Y": xds["v"]})
        xvec = ad.to_xarray(vec, grid)
        assert set(xvec) == {"X", "Y"} and "XC" in xvec["X"].coords
        native = ad.to_xarray(grid.diff(ad.dataarray_from_xarray(xds["temp"]), "X"), grid)
        return xa, xvec, native

    r_j, r_t = _both(case)
    _same(r_t, r_j)


def test_transform_merges_target_data_coords(xr):
    """Coordinates of an xarray target_data on the dims the output keeps are
    merged, the data variable's own winning."""
    def case(pkg):
        nz, nx = 6, 4
        rs = np.random.RandomState(2)
        ds = xr.Dataset(coords={"zc": ("zc", np.arange(nz) + 0.5)})
        grid = pkg.Grid(ds, coords={"Z": {"center": "zc"}}, periodic=False,
                        autoparse_metadata=False)
        da = xr.DataArray(rs.rand(nz, nx), dims=("zc", "x"), name="temp")
        sigma = xr.DataArray(
            np.broadcast_to(np.linspace(20.0, 28.0, nz)[:, None], (nz, nx)).copy(),
            dims=("zc", "x"), name="s", coords={"lon": ("x", np.linspace(0.0, 3.0, nx))})
        target = np.linspace(21.0, 27.0, 4)
        out = grid.transform(da, "Z", target, target_data=sigma)
        np.testing.assert_array_equal(out.coords["lon"].data, np.linspace(0.0, 3.0, nx))
        da2 = da.assign_coords({"lon": ("x", np.full(nx, 9.0))})
        out2 = grid.transform(da2, "Z", target, target_data=sigma)
        np.testing.assert_array_equal(out2.coords["lon"].data, np.full(nx, 9.0))
        [outm] = grid.transform_multi([da], "Z", target, target_data=sigma)
        assert "lon" in outm.coords
        return out, out2, outm

    r_j, r_t = _both(case)
    _same(r_t, r_j, rtol=1e-12)


def test_first_input_wins_coord_precedence(xr):
    def case(pkg):
        xds = _xds(xr)
        a = xds["temp"].assign_coords({"tag": ("YC", np.arange(N) * 1.0)})
        b = xds["temp"].assign_coords({"tag": ("YC", np.arange(N) * 2.0)})
        return pkg.apply_as_grid_ufunc(_add, a, b, axis=[("X",), ("X",)], grid=pkg.Grid(xds),
                                       signature="(X:center),(X:center)->(X:center)")

    r_j, r_t = _both(case)
    _same(r_t, r_j)
    np.testing.assert_array_equal(r_t.coords["tag"].data, np.arange(N) * 1.0)


def test_stub_assign_coords_matches_real_xarray_semantics(xr):
    """The two assign_coords failures the port's reattachment relies on."""
    ad = _adapter(xtt)
    assert ad.xr is xr
    da = xr.DataArray(np.zeros((3, 4)), dims=("y", "x"))
    with pytest.raises(ValueError, match="^conflicting sizes"):
        da.assign_coords({"x": ("x", np.arange(5.0))})
    with pytest.raises(ValueError, match="new dimensions"):
        da.assign_coords({"t": ("time", np.arange(2.0))})
    ok = da.assign_coords({"x": ("x", np.arange(4.0))}).assign_coords(xlabel=("x", np.arange(4.0)))
    assert "xlabel" in ok.coords


def test_untrimmed_ufunc_raises_trim_hint(xr):
    for pkg in (xgcm_tpu, xtt):
        xds = _xds(xr)
        with pytest.raises(ValueError, match="correctly trim"):
            pkg.apply_as_grid_ufunc(_no_trim, xds["temp"], axis=[("X",)], grid=pkg.Grid(xds),
                                    signature="(X:center)->(X:center)",
                                    boundary_width={"X": (1, 1)})


def test_reattach_conflicting_sizes_rewrap(xr):
    grid = xtt.Grid(_xds(xr))
    ad = _adapter(xtt)
    bad = xtt.GriddedArray(np.zeros((N - 1, N)), ("YC", "XG"), name="z")
    with pytest.raises(ValueError, match="correctly trim"):
        ad.reattach_coords(bad, grid, input_args=(), out_core_dim_names={"XG"},
                           boundary_width={"X": (1, 1)})
    with pytest.raises(ValueError, match="^conflicting sizes"):
        ad.reattach_coords(bad, grid, input_args=(), out_core_dim_names={"XG"},
                           boundary_width=None)


# -- the bfloat16 rule ------------------------------------------------------------


def test_bfloat16_does_not_cross_the_bridge(xr):
    """Torch has no numpy bfloat16: a bfloat16 result raises TypeError on its
    way to xarray, as torch does for a numpy bfloat16 input; the JAX package
    gives and takes ml_dtypes arrays instead."""
    ad = _adapter(xtt)
    xds = _xds(xr)
    grid = xtt.Grid(xds)
    u16 = xtt.GriddedArray(torch.rand(N, N, dtype=torch.bfloat16), ("YC", "XG"), name="u")
    for convert in (lambda: ad.to_xarray(u16, grid),
                    lambda: ad.reattach_coords(u16, grid),
                    lambda: ad.dataset_to_xarray(xtt.Dataset(data_vars={"u": u16})),
                    lambda: ad.host_array(u16.data)):
        with pytest.raises(TypeError, match="bfloat16"):
            convert()
    ml = xr.DataArray(np.asarray(xds["temp"].data).astype(jnp.bfloat16), dims=("YC", "XC"))
    with pytest.raises(TypeError, match="bfloat16"):
        grid.diff(ml, "X")
    out_j = xgcm_tpu.Grid(_xds(xr)).diff(ml, "X")
    assert out_j.data.dtype.name == "bfloat16"
    # float32 crosses both ways
    f32 = grid.diff(xr.DataArray(np.asarray(xds["temp"].data, np.float32), dims=("YC", "XC")),
                    "X")
    assert f32.data.dtype == np.float32


# -- the seeded sweeps of tests/test_fuzz_adapter.py ---------------------------------

OPS = ["diff", "interp", "min", "max"]
BOUNDARIES = ["periodic", "fill", "extend"]


def _op_case(pkg, xr, seed):
    """One random op through the stub, its values against the package's
    native path and its coordinates by xgcm's rules; returns the result."""
    rng = np.random.RandomState(seed)
    ad = _adapter(pkg)
    n = int(rng.randint(5, 13))
    op = OPS[rng.randint(len(OPS))]
    to = ["center", "left"][rng.randint(2)]
    boundary = BOUNDARIES[rng.randint(len(BOUNDARIES))]
    n_extra = int(rng.randint(0, 3))
    extra_sizes = {f"e{i}": int(rng.randint(2, 5)) for i in range(n_extra)}
    xc_vals = np.arange(n) + rng.rand()
    xg_vals = np.arange(n) + rng.rand() - 0.5
    ds = xr.Dataset(coords={"xc": ("xc", xc_vals), "xg": ("xg", xg_vals),
                            "xc2": ("xc", xc_vals * 2.0)})
    grid = pkg.Grid(ds, coords={"X": {"center": "xc", "left": "xg"}}, boundary=boundary,
                    autoparse_metadata=False)
    frm = ["center", "left"][rng.randint(2)]
    src_dim = {"center": "xc", "left": "xg"}[frm]
    if frm == to:
        to = "left" if frm == "center" else "center"
    to_dim = {"center": "xc", "left": "xg"}[to]
    dims = list(extra_sizes)
    dims.insert(int(rng.randint(0, len(dims) + 1)), src_dim)
    data = rng.randn(*[extra_sizes.get(d, n) for d in dims])
    coords = {"on_core": (src_dim, rng.randn(n))}
    if n_extra:
        coords["on_extra"] = ("e0", rng.randn(extra_sizes["e0"]))
    da = xr.DataArray(data, dims=tuple(dims), name="q", coords=coords)

    out = getattr(grid, op)(da, "X", to=to, keep_coords=True)
    native = getattr(grid, op)(ad.dataarray_from_xarray(da), "X", to=to)
    assert out.dims == native.dims
    np.testing.assert_array_equal(out.data, to_numpy(native))
    np.testing.assert_array_equal(out.coords[to_dim].data,
                                  xg_vals if to_dim == "xg" else xc_vals)
    assert ("xc2" in out.coords) == (to_dim == "xc")
    assert "on_core" not in out.coords
    if n_extra:
        np.testing.assert_array_equal(out.coords["on_extra"].data, coords["on_extra"][1])
    for cname, cv in out.coords.items():
        for d, s in zip(cv.dims, np.shape(cv.data)):
            assert out.sizes[d] == s, cname
    return out


def _transform_sweep_case(pkg, xr, seed):
    rng = np.random.RandomState(seed)
    ad = _adapter(pkg)
    nz = int(rng.randint(5, 11))
    method = ["linear", "conservative"][rng.randint(2)]
    named = bool(rng.randint(2))
    zc_vals = np.arange(nz) + 0.5
    zo_vals = np.arange(nz + 1) * 1.0
    grid = pkg.Grid(xr.Dataset(coords={"zc": ("zc", zc_vals), "zo": ("zo", zo_vals)}),
                    coords={"Z": {"center": "zc", "outer": "zo"}}, periodic=False,
                    autoparse_metadata=False)
    da = xr.DataArray(np.sort(rng.rand(nz)), dims=("zc",), name="temp",
                      coords={"zlabel": ("zc", rng.randn(nz))})
    if method == "linear":
        m = [nz, int(rng.randint(3, nz + 3))][rng.randint(2)]
        target = np.sort(rng.rand(m)) * nz
    else:
        m = [nz + 1, int(rng.randint(3, nz + 3))][rng.randint(2)]
        target = np.linspace(0.0, nz, m)
    kwargs = {"method": method}
    if named:
        src = zo_vals if method == "conservative" else zc_vals
        kwargs["target_data"] = xr.DataArray(
            20.0 + 0.8 * src, dims=("zo" if method == "conservative" else "zc",), name="s")
        target = 20.0 + 0.8 * target

    out = grid.transform(da, "Z", target, **kwargs)
    nkw = dict(kwargs)
    if "target_data" in nkw:
        nkw["target_data"] = ad.dataarray_from_xarray(nkw["target_data"])
    native = grid.transform(ad.dataarray_from_xarray(da), "Z", target, **nkw)
    assert out.dims == native.dims
    np.testing.assert_array_equal(out.data, to_numpy(native))
    expected = 0.5 * (target[:-1] + target[1:]) if method == "conservative" else target
    np.testing.assert_allclose(out.coords[out.dims[-1]].data, expected)
    assert "zlabel" not in out.coords
    for cname, cv in out.coords.items():
        for d, s in zip(cv.dims, np.shape(cv.data)):
            assert out.sizes[d] == s, cname
    return out


@pytest.mark.parametrize("trial", range(15))
def test_random_op_roundtrip(xr, trial):
    r_j, r_t = _both(_op_case, xr, 30_000 + trial)
    _same(r_t, r_j)


@pytest.mark.parametrize("trial", range(15))
def test_random_transform_roundtrip(xr, trial):
    r_j, r_t = _both(_transform_sweep_case, xr, 31_000 + trial)
    _same(r_t, r_j, rtol=1e-12)
