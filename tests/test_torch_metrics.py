"""The port's metrics and metric-weighted calculus against xgcm_tpu: metric
registration (``Grid(metrics=)``, ``set_metrics``), the four conditions of
``get_metric`` with their warnings, ``interp_like``, ``metric_weighted=``,
``derivative``, ``integrate``, ``average`` and ``cumint`` on the B- and
C-grid datasets of tests/test_metrics_ops.py with NaN and infinities in the
data, the dtypes of JAX x64's promotion, and the tracer budget of
examples/tracer_budget.py as a whole.

Shifts (every diff and interp, and what only multiplies and divides them)
equal the JAX package's bit for bit; sums are held to the JAX tests' own
tolerance (``assert_allclose``'s rtol = 1e-7), with the same NaN
footprint, since torch and XLA reduce in other orders."""

import importlib.util
import pathlib
import warnings

import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu_torch as xtt
from xgcm_tpu_torch.core import grid as grid_module
from tests.datasets import datasets_grid_metric
from tests.torch_parity import assert_bitwise, assert_close

ROOT = pathlib.Path(__file__).resolve().parent.parent
# numpy.testing.assert_allclose's default, the tolerance of
# tests/test_metrics_ops.py (float64); float32 sums of a few terms in
# another order differ by a few units of 2^-24
RTOL = {np.dtype(np.float64): 1e-7, np.dtype(np.float32): 1e-6}


def _grids(grid_type, metrics=None, nonfinite=True, float32=False):
    """(ds_j, grid_j, ds_t, grid_t) of datasets_grid_metric(grid_type),
    the data variables sprinkled with NaN and +-inf; with ``float32`` its
    float64 data and metrics in float32."""
    ds_j, coords, all_metrics = datasets_grid_metric(grid_type)
    if float32:
        def f32(vs):
            return {k: (v.dims, np.asarray(v.data, np.float32)) for k, v in vs.items()
                    if np.asarray(v.data).dtype == np.float64}

        ds_j = ds_j.assign_coords(**f32(ds_j.coords)).assign(**f32(ds_j.data_vars))
    if nonfinite:
        # +inf and -inf in different time slices: integrate takes them as
        # the largest finite values, and a sum holding both cancels them in
        # an order-dependent way
        rng = np.random.RandomState(0 if grid_type == "B" else 1)
        new = {}
        for name, v in ds_j.data_vars.items():
            a = np.array(v.data)
            a.flat[rng.randint(a.size)] = np.nan
            a[0].flat[rng.randint(a[0].size)] = np.inf
            a[1].flat[rng.randint(a[1].size)] = -np.inf
            new[name] = (v.dims, a)
        ds_j = ds_j.assign(**new)
    metrics = all_metrics if metrics is None else metrics
    g_j = xgcm_tpu.Grid(ds_j, coords=coords, metrics=metrics, autoparse_metadata=False)
    ds_t = xtt.from_numpy_dataset(ds_j)
    g_t = xtt.Grid(ds_t, coords=coords, metrics=metrics, autoparse_metadata=False)
    return ds_j, g_j, ds_t, g_t


def _metrics_summary(grid):
    return {k: [(v.name, v.dims) for v in vs] for k, vs in grid._metrics.items()}


def _same(r_t, r_j, exact=True):
    assert r_t.dims == r_j.dims
    if exact:
        assert_bitwise(r_t, r_j)
    else:
        expected = np.asarray(r_j.data)
        assert r_t.values.dtype == expected.dtype
        if expected.dtype.kind != "f":  # integer sums are exact
            assert_bitwise(r_t, r_j)
        else:
            assert_close(r_t, r_j, rtol=RTOL[expected.dtype])


# -- registration --------------------------------------------------------------


@pytest.mark.parametrize("grid_type", ["B", "C"])
def test_grid_registers_the_same_metrics(grid_type):
    _, g_j, _, g_t = _grids(grid_type, nonfinite=False)
    assert _metrics_summary(g_t) == _metrics_summary(g_j)


def test_set_metrics_add_overwrite_and_errors():
    ds_j, coords, _ = datasets_grid_metric("C")
    ds_t = xtt.from_numpy_dataset(ds_j)
    grids = [pkg.Grid(ds, coords=coords, metrics={("X",): ["dx_t"]},
                      autoparse_metadata=False)
             for pkg, ds in ((xgcm_tpu, ds_j), (xtt, ds_t))]
    for g in grids:
        g.set_metrics("X", ["dx_e"])  # another position: added
        g.set_metrics(("X", "Y"), "area_t")  # new axes
        g.set_metrics("X", "dx_n", overwrite=True)  # the dims of dx_t: replaces it
        with pytest.raises(ValueError, match="already assigned in metrics"):
            g.set_metrics("X", "dx_ne")  # the dims of dx_e
        with pytest.raises(KeyError, match="not compatible with grid axes"):
            g.set_metrics(("X", "W"), "dx_t")
        with pytest.raises(KeyError, match="not found in dataset"):
            g.set_metrics("Y", "nonexistent")
    assert _metrics_summary(grids[1]) == _metrics_summary(grids[0])
    assert [v.name for v in grids[1]._metrics[frozenset("X")]] == ["dx_n", "dx_e"]


def test_registered_metrics_copy_to_a_device_once():
    """get_metric returns tensors; the dataset keeps its host coordinates."""
    _, _, ds_t, g_t = _grids("C", nonfinite=False)
    tracer = ds_t["tracer"]
    a = g_t.get_metric(tracer, ("X", "Y"))
    b = g_t.get_metric(tracer, ("Y", "X"))
    assert a is b and isinstance(a.data, torch.Tensor)
    assert isinstance(ds_t["area_t"].data, np.ndarray)
    np.testing.assert_array_equal(a.values, ds_t["area_t"].values)


def test_derived_metric_is_laid_out_like_the_array():
    """A product of metrics has the JAX package's dims (in the order of
    its factors, which follows frozenset iteration and so the process's
    hash seed) but lies in memory in the array's dim order, so that an op
    broadcasting it against the array copies nothing."""
    _, _, ds_t, g_t = _grids("C", metrics={("X",): ["dx_t"], ("Y",): ["dy_t"],
                                           ("Z",): ["dz_t"]}, nonfinite=False)
    tracer = ds_t["tracer"]
    vol = g_t.get_metric(tracer, ("X", "Y", "Z"))
    assert set(vol.dims) == {"zt", "yt", "xt"}
    assert vol.data.permute([vol.dims.index(d) for d in ("zt", "yt", "xt")]).is_contiguous()


# -- get_metric and interp_like ---------------------------------------------------


def _warned(call):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = call()
    return out, [str(x.message) for x in w if x.category is UserWarning]


# (label, registered metrics, array, axes, warns): each condition of get_metric
GET_METRIC_CASES = [
    ("1: exact", None, "tracer", ("X", "Y"), False),
    ("1: exact, axes permuted", None, "u", ("Y", "X"), False),
    ("2: interpolated", {("X", "Y"): ["area_t"]}, "u", ("X", "Y"), True),
    ("2: volume at u", None, "u", ("X", "Y", "Z"), True),
    ("3: product", None, "tracer", ("Y", "Z"), False),
    ("3: product of three", {("X",): ["dx_t"], ("Y",): ["dy_t"], ("Z",): ["dz_t"]},
     "tracer", ("X", "Y", "Z"), False),
    ("4: product interpolated", {("X",): ["dx_t"], ("Z",): ["dz_t"]}, "u", ("X", "Z"),
     True),
]


@pytest.mark.parametrize("label, metrics, var, axes, warns", GET_METRIC_CASES,
                         ids=[c[0] for c in GET_METRIC_CASES])
def test_get_metric_conditions(label, metrics, var, axes, warns):
    ds_j, g_j, ds_t, g_t = _grids("C", metrics=metrics, nonfinite=False)
    r_j, w_j = _warned(lambda: g_j.get_metric(ds_j[var], axes))
    r_t, w_t = _warned(lambda: g_t.get_metric(ds_t[var], axes))
    assert w_t == w_j and bool(w_t) == warns
    _same(r_t, r_j)


def test_get_metric_errors_match():
    for ds, g in (_grids("C", metrics={("X",): ["dx_t"]})[i:i + 2] for i in (0, 2)):
        with pytest.raises(KeyError, match="Unable to find any combinations"):
            g.get_metric(ds["tracer"], ("Z",))
        with pytest.raises(KeyError, match="Did not find axis W"):
            g.get_metric(ds["tracer"], ("W",))


@pytest.mark.parametrize("boundary", [None, "extend", "fill"])
@pytest.mark.parametrize("var, like", [("area_t", "u"), ("area_t", "v"), ("dx_e", "tracer"),
                                       ("area_ne", "tracer"), ("dx_t", "tracer")])
def test_interp_like(var, like, boundary):
    ds_j, g_j, ds_t, g_t = _grids("C")
    r_j = g_j.interp_like(ds_j[var], ds_j[like], boundary=boundary, fill_value=1.5)
    r_t = g_t.interp_like(ds_t[var], ds_t[like], boundary=boundary, fill_value=1.5)
    _same(r_t, r_j)


# -- the metric's factors and the routes of integrate -------------------------------

# 1-D metrics only: every metric of more than one axis is a product
ONE_AXIS = {("X",): ["dx_t", "dx_e", "dx_n", "dx_ne"], ("Y",): ["dy_t", "dy_e", "dy_n", "dy_ne"],
            ("Z",): ["dz_t", "dz_w"]}
INTEGRATE_AXES = [("X",), ("Y",), ("X", "Y"), ("X", "Y", "Z"), "Z"]


@pytest.mark.parametrize("metrics", ["registered", "products"])
@pytest.mark.parametrize("grid_type", ["B", "C"])
@pytest.mark.parametrize("axes", INTEGRATE_AXES)
def test_found_factors_make_get_metric(grid_type, axes, metrics):
    """What _find_metric resolves, multiplied by _metric_product where it
    is a tuple of factors, is get_metric's result: the same values bit for
    bit, dims, dtype and strides, and the same warnings."""
    from xgcm_tpu_torch.core.grid import _metric_product

    _, _, ds_t, g_t = _grids(grid_type, metrics=None if metrics == "registered" else ONE_AXIS,
                             nonfinite=False)
    for var in ("tracer", "u", "wt"):
        (found, interpolated), w_found = _warned(lambda: g_t._find_metric(ds_t[var], axes))
        want, w_want = _warned(lambda: g_t.get_metric(ds_t[var], axes))
        got = found if isinstance(found, xtt.GriddedArray) else _metric_product(found, ds_t[var])
        assert w_found == w_want and interpolated == bool(w_want)
        assert got.dims == want.dims and got.dtype == want.dtype
        assert got.data.stride() == want.data.stride()
        assert_bitwise(got, want)


# (label, registered metrics, array, axes): the conditions that interpolate
INTERPOLATING = [("2: volume at u", None, "u", ("X", "Y", "Z")),
                 ("4: product interpolated", {("X",): ["dx_t"], ("Z",): ["dz_t"]}, "u",
                  ("X", "Z"))]


@pytest.mark.parametrize("label, metrics, var, axes", INTERPOLATING,
                         ids=[c[0] for c in INTERPOLATING])
def test_integrate_warns_once_a_call(label, metrics, var, axes):
    ds_j, g_j, ds_t, g_t = _grids("C", metrics=metrics)
    for _ in range(2):
        r_j, w_j = _warned(lambda: g_j.integrate(ds_j[var], axes))
        r_t, w_t = _warned(lambda: g_t.integrate(ds_t[var], axes))
        assert len(w_t) == 1 and w_t == w_j
        _same(r_t, r_j, exact=False)


def _float32_grid(metrics=None):
    """The port's float32 C grid and its dataset."""
    _, _, ds_t, g_t = _grids("C", metrics=metrics, nonfinite=False, float32=True)
    return g_t, ds_t


def _route(grid, da, axes, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        metric, interpolated = grid._find_metric(da, axes)
    return grid_module._fused_factors(da, metric, interpolated,
                                      grid._get_dims_from_axis(da, axes), kwargs)


def _route_case(label):
    """(grid, array, axes, keywords) of a route case on the float32 C grid."""
    grid, ds = _float32_grid()
    tracer = ds["tracer"]  # (time, zt, yt, xt)
    if label.startswith("axes "):
        return grid, tracer, tuple(label[5:].split(",")), {}
    if label == "a registered area":
        return _float32_grid({("X", "Y"): ["area_t"]})[0], tracer, ("X", "Y"), {}
    if label == "a ShardedTensor":
        from xgcm_tpu_torch import parallel as par

        mesh = par.make_mesh({"x": 2}, devices=[tracer.data.device] * 2)
        sharded = par.ShardedGrid(grid, mesh, {"xt": "x"}).shard(tracer)
        assert type(sharded.data) is not torch.Tensor
        return grid, sharded, ("X", "Y"), {}
    if label == "a float64 metric":
        area64, _ = _float32_grid({("X", "Y"): ["area_t"]})
        area64._metrics[frozenset(("X", "Y"))] = [ds["area_t"].astype(torch.float64)]
        return area64, tracer, ("X", "Y"), {}
    if label == "an interpolated metric":
        return _float32_grid({("X", "Y"): ["area_t"]})[0], ds["u"], ("X", "Y"), {}
    return {
        "float64 data": (grid, tracer.astype(torch.float64), ("X", "Y"), {}),
        "integer data": (grid, tracer.astype(torch.int32), ("X", "Y"), {}),
        "keepdims": (grid, tracer, ("X", "Y"), {"keepdims": False}),
        "dtype": (grid, tracer, ("X", "Y"), {"dtype": np.float32}),
        "a leading dim": (grid, tracer, "Z", {}),
        "leading and trailing dims": (grid, tracer, ("X", "Z"), {}),
        "a gradient": (grid, tracer.with_data(tracer.data.clone().requires_grad_(True)),
                       ("X", "Y"), {}),
        "a view that is not contiguous": (grid, tracer.transpose("time", "zt", "xt", "yt"),
                                          ("X", "Y"), {}),
    }[label]


ROUTE_TAKEN = ["axes X", "axes X,Y", "axes Y,X", "axes X,Y,Z", "a registered area"]
ROUTE_REFUSED = ["a ShardedTensor", "float64 data", "integer data", "keepdims", "dtype",
                 "an interpolated metric", "a float64 metric", "a leading dim",
                 "leading and trailing dims", "a gradient", "a view that is not contiguous"]


@pytest.mark.parametrize("label", ROUTE_TAKEN + ROUTE_REFUSED)
def test_the_route_of_integrate(label):
    """A CPU tensor never takes the weighted-sum kernel: each case, also
    those that take it on the card, resolves no factors, and integrate
    multiplies, cleans and sums in PyTorch.  The card's twin of each case
    is tests/test_torch_kernels.py::test_integrate_on_card_takes_one_launch."""
    grid, da, axes, kwargs = _route_case(label)
    assert _route(grid, da, axes, **kwargs) is None


@pytest.mark.parametrize("grid_type", ["B", "C"])
@pytest.mark.parametrize("axes", INTEGRATE_AXES)
def test_integrate_float32_on_cpu(grid_type, axes, monkeypatch):
    """float32 data on the CPU: PyTorch's product and sum as before the
    kernel, which is never called; the JAX package's result within its
    tolerance, with its dims and NaN footprint."""
    calls = []
    monkeypatch.setattr(grid_module, "weighted_sum", lambda *a: calls.append(a))
    ds_j, g_j, ds_t, g_t = _grids(grid_type, float32=True)
    for var in ("tracer", "u"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            r_t = g_t.integrate(ds_t[var], axes)
            r_j = g_j.integrate(ds_j[var], axes)
        _same(r_t, r_j, exact=False)
    assert not calls


# -- the calculus ------------------------------------------------------------------


@pytest.mark.parametrize("grid_type", ["B", "C"])
@pytest.mark.parametrize("axes", [("X",), ("Y",), ("X", "Y"), ("X", "Y", "Z"), "Z"])
def test_integrate(grid_type, axes):
    ds_j, g_j, ds_t, g_t = _grids(grid_type)
    for var in ("tracer", "u"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            _same(g_t.integrate(ds_t[var], axes), g_j.integrate(ds_j[var], axes), exact=False)


@pytest.mark.parametrize("grid_type", ["B", "C"])
@pytest.mark.parametrize("axes", [("X", "Y"), ("X", "Y", "Z"), "Y"])
def test_average(grid_type, axes):
    ds_j, g_j, ds_t, g_t = _grids(grid_type)
    for var in ("tracer", "wt"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            _same(g_t.average(ds_t[var], axes), g_j.average(ds_j[var], axes), exact=False)


@pytest.mark.parametrize("grid_type", ["B", "C"])
def test_average_skips_nan_cells(grid_type):
    """tests/test_metrics_ops.py's NaN case: finite data but one NaN."""
    ds_j, g_j, ds_t, g_t = _grids(grid_type, nonfinite=False)
    t = np.array(ds_j["tracer"].data)
    t[0, 0, 1, 2] = np.nan
    r_j = g_j.average(ds_j["tracer"].with_data(t), ("X", "Y"))
    r_t = g_t.average(xtt.GriddedArray(torch.as_tensor(t), ds_t["tracer"].dims), ("X", "Y"))
    _same(r_t, r_j, exact=False)
    assert np.isfinite(r_t.values).all()


@pytest.mark.parametrize("op", ["integrate", "average"])
def test_reduction_keywords_reach_the_sum(op):
    ds_j, g_j, ds_t, g_t = _grids("C")
    r_j = getattr(g_j, op)(ds_j["tracer"], ("X", "Y"), dtype=np.float32)
    r_t = getattr(g_t, op)(ds_t["tracer"], ("X", "Y"), dtype=np.float32)
    _same(r_t, r_j, exact=False)
    # keepdims keeps the summed axes, which the named dims then miscount:
    # both containers refuse it
    for ds, g in ((ds_j, g_j), (ds_t, g_t)):
        with pytest.raises(ValueError, match="dims .* has 2 entries"):
            getattr(g, op)(ds["tracer"], ("X", "Y"), keepdims=True)


@pytest.mark.parametrize("grid_type", ["B", "C"])
@pytest.mark.parametrize("axis, to", [("X", None), ("Y", None), ("Z", None), ("X", "right"),
                                      ("Z", "right")])
def test_derivative(grid_type, axis, to):
    ds_j, g_j, ds_t, g_t = _grids(grid_type)
    for var in ("tracer", "u", "wt"):
        kw = {} if to is None else {"to": to}
        try:
            r_j, w_j = _warned(lambda: g_j.derivative(ds_j[var], axis, **kw))
        except (KeyError, ValueError, NotImplementedError) as e:
            with pytest.raises(type(e)):
                g_t.derivative(ds_t[var], axis, **kw)
            continue
        r_t, w_t = _warned(lambda: g_t.derivative(ds_t[var], axis, **kw))
        assert w_t == w_j
        _same(r_t, r_j)


@pytest.mark.parametrize("grid_type", ["B", "C"])
@pytest.mark.parametrize("axis, kw", [("X", dict(boundary="fill")), ("Z", dict()),
                                      ("Y", dict(to="right", boundary="extend"))])
def test_cumint(grid_type, axis, kw):
    ds_j, g_j, ds_t, g_t = _grids(grid_type)
    _same(g_t.cumint(ds_t["tracer"], axis, **kw), g_j.cumint(ds_j["tracer"], axis, **kw))


@pytest.mark.parametrize("grid_type", ["B", "C"])
@pytest.mark.parametrize("op", ["interp", "diff"])
@pytest.mark.parametrize("weighted", ["X", ["X", "Y"], {"X": "X", "Y": ("X", "Y")}])
def test_metric_weighted_ops(grid_type, op, weighted):
    ds_j, g_j, ds_t, g_t = _grids(grid_type)
    axes = ["X", "Y"] if isinstance(weighted, dict) else "X"
    r_j, w_j = _warned(lambda: getattr(g_j, op)(ds_j["tracer"], axes, metric_weighted=weighted))
    r_t, w_t = _warned(lambda: getattr(g_t, op)(ds_t["tracer"], axes, metric_weighted=weighted))
    assert w_t == w_j
    _same(r_t, r_j)


@pytest.mark.parametrize("data_dtype", [np.float32, np.int32, np.bool_])
@pytest.mark.parametrize("metric_dtype", [np.float64, np.float32, np.int32])
def test_calculus_dtypes_follow_jax_promotion(data_dtype, metric_dtype):
    """f32 data times an f64 metric is f64, as in JAX; integer data and
    metrics promote as JAX x64's weakly typed fills do.  Bool data has no
    difference: derivative raises TypeError in both packages."""
    coords = {"xc": ("xc", np.arange(6) + 0.5), "xg": ("xg", np.arange(6) * 1.0),
              "dxc": (("xc",), (np.arange(6) + 1).astype(metric_dtype)),
              "dxg": (("xg",), (np.arange(6) + 2).astype(metric_dtype))}
    a = (np.random.RandomState(4).rand(3, 6) * 5).astype(data_dtype)
    out = []
    for pkg, make in ((xgcm_tpu, lambda x: x), (xtt, torch.as_tensor)):
        g = pkg.Grid(pkg.Dataset(coords=coords), coords={"X": {"center": "xc", "left": "xg"}},
                     metrics={("X",): ["dxc", "dxg"]}, autoparse_metadata=False)
        da = pkg.GriddedArray(make(a), ("y", "xc"))
        out.append([g.integrate(da, "X"), g.average(da, "X"), g.cumint(da, "X")])
        if data_dtype == np.bool_:
            with pytest.raises(TypeError):
                g.derivative(da, "X")
        else:
            out[-1].append(g.derivative(da, "X"))
    for r_j, r_t in zip(*out):
        _same(r_t, r_j, exact=False)


# -- the tracer budget of examples/tracer_budget.py -------------------------------


def _example():
    spec = importlib.util.spec_from_file_location(
        "tracer_budget_example", ROOT / "examples" / "tracer_budget.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tracer_budget_matches_jax():
    """budget_terms of the example on each package's grid (nx=12, ny=10,
    nz=4, float64): the terms within 1e-12, and the budget closes in
    both."""
    ex = _example()
    ds_j, g_j = ex.build_grid(nx=12, ny=10, nz=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        g_t = xtt.Grid(
            xtt.from_numpy_dataset(ds_j),
            coords={"X": {"center": "xc", "left": "xg"}, "Y": {"center": "yc", "left": "yg"},
                    "Z": {"center": "zc", "left": "zg"}},
            boundary={"X": "periodic", "Y": "periodic", "Z": "fill"}, fill_value=0.0,
            metrics={("X",): ["dx_c", "dx_g"], ("Y",): ["dy_c", "dy_g"],
                     ("Z",): ["dz_c", "dz_g"]},
            autoparse_metadata=False)
    rng = np.random.RandomState(7)
    theta = 20.0 + rng.rand(4, 10, 12)
    u, v, w = (rng.randn(4, 10, 12) for _ in range(3))
    w[0] = 0.0
    dims = [("zc", "yc", "xc"), ("zc", "yc", "xg"), ("zc", "yg", "xc"), ("zg", "yc", "xc")]
    ins_j = [xgcm_tpu.GriddedArray(a, d) for a, d in zip((theta, u, v, w), dims)]
    ins_t = [xtt.GriddedArray(torch.as_tensor(a), d) for a, d in zip((theta, u, v, w), dims)]
    terms_j = ex.budget_terms(g_j, *ins_j)
    terms_t = ex.budget_terms(g_t, *ins_t)
    for r_t, r_j in zip(terms_t, terms_j):
        assert r_t.dims == r_j.dims
        assert_close(r_t, r_j, rtol=1e-12, atol=1e-12)
    for g, tendency in ((g_j, terms_j[2]), (g_t, terms_t[2])):
        total = float(np.asarray(g.integrate(tendency, ["X", "Y", "Z"]).data))
        scale = float(np.asarray(g.integrate(abs(tendency), ["X", "Y", "Z"]).data))
        assert abs(total) / scale < 1e-10
