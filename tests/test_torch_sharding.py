"""The port's sharded layer against xgcm_tpu.parallel: the ring ops, the
sharded cumsum, the batch route and the per-shard transforms of
tests/test_sharding.py and tests/test_sharding_2d.py (their face-less
cases), the mesh and the sharded tensor, and ``entry.dryrun_multichip``.

tests/test_fuzz_sharded_routing.py's plain-grid sweep is here too.  Each
test runs the JAX function on conftest's 8-device CPU mesh and the
port on ``make_mesh(..., devices=[torch.device("cpu")] * 8)``, on the same
numpy inputs.  Tolerances are the JAX tests' own, stated beside each
assertion: ``assert_allclose``'s default rtol = 1e-7 for the shifts, 1e-12
for the cumsums and transforms.  The port's ring route also equals its
single-device op bit for bit.

Not ported, since eager torch has no counterpart: the tests of ``jax.jit``
(``test_gspmd_auto_sharding_matches``, ``test_batch_dim_sharding_free``'s
jit, ``test_sharded_transform_matches_single_device``), ``jax.vmap``
(``test_vmap_over_batch``) and ``jax.grad`` through a transform of
unsharded data (``test_grad_through_transform``, a single-device test).
The face-sharded cases (``TestFaceSharded``,
``test_sharded_grid_face_routing``) wait for the face-sharded route: here
they check that the port refuses them.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu.parallel as jpar
import xgcm_tpu_torch as xtt
import xgcm_tpu_torch.parallel as tpar
from tests.datasets import cubed_sphere_dataset
from tests.torch_parity import assert_bitwise, assert_close, to_numpy
from xgcm_tpu_torch.parallel import collectives, sharded_tensor

CPU8 = [torch.device("cpu")] * 8
N, NY = 64, 16


def _grid(pkg, n=N, ny=NY, right=True):
    coords = {
        "xc": ("xc", np.arange(n, dtype=float)),
        "xg": ("xg", np.arange(n, dtype=float)),
        "yc": ("yc", np.arange(ny, dtype=float)),
        "yg": ("yg", np.arange(ny, dtype=float)),
    }
    x = {"center": "xc", "left": "xg"}
    if right:
        coords["xr"] = ("xr", np.arange(n, dtype=float))
        x["right"] = "xr"
    return pkg.Grid(pkg.Dataset(coords=coords), coords={"X": x, "Y": {"center": "yc",
                                                                      "left": "yg"}},
                    autoparse_metadata=False)


def _jmesh(axes):
    return jpar.make_mesh(axes, devices=jax.devices()[: int(np.prod(list(axes.values())))])


def _tmesh(axes):
    return tpar.make_mesh(axes, devices=CPU8)


def _both(a, dims, name=None):
    return xgcm_tpu.GriddedArray(a, dims, name=name), xtt.GriddedArray(a, dims, name=name)


@pytest.mark.parametrize("boundary", ["periodic", "fill", "extend", "extrapolate"])
@pytest.mark.parametrize("op", ["diff", "interp", "min", "max"])
def test_sharded_op_matches(op, boundary):
    a = np.random.rand(NY, N)
    ja, ta = _both(a, ("yc", "xc"))
    jm, tm = _jmesh({"x": 8}), _tmesh({"x": 8})
    jg, tg = _grid(xgcm_tpu), _grid(xtt)
    j = jpar.sharded_op(jg, op, jpar.shard_gridded(ja, jm, {"xc": "x"}), "X", jm, {"xc": "x"},
                        boundary=boundary, fill_value=2.5)
    t = tpar.sharded_op(tg, op, tpar.shard_gridded(ta, tm, {"xc": "x"}), "X", tm, {"xc": "x"},
                        boundary=boundary, fill_value=2.5)
    assert t.dims == j.dims
    assert isinstance(t.data, tpar.ShardedTensor)
    assert_close(t, j, rtol=1e-7)  # test_sharding.py: assert_allclose's default
    # the ring route (kernel E's plain version here) == the single-device op
    assert_bitwise(t, getattr(tg, op)(ta, "X", boundary=boundary, fill_value=2.5))


@pytest.mark.parametrize("frm_to", [("center", "left"), ("center", "right"),
                                    ("left", "center"), ("right", "center")])
@pytest.mark.parametrize("boundary", ["fill", "extend", "periodic", "extrapolate"])
def test_sharded_cumsum_matches(frm_to, boundary):
    """test_sharding.py's cases (from center), and the two shifts onto the
    center."""
    frm, to = frm_to
    a = np.random.rand(NY, N)
    dim = {"center": "xc", "left": "xg", "right": "xr"}[frm]
    ja, ta = _both(a, ("yc", dim))
    jm, tm = _jmesh({"x": 8}), _tmesh({"x": 8})
    jg, tg = _grid(xgcm_tpu), _grid(xtt)
    spec = {"xc": "x", "xg": "x", "xr": "x"}
    j = jpar.sharded_cumsum(jg, jpar.shard_gridded(ja, jm, spec), "X", jm, spec,
                            to=to, boundary=boundary)
    t = tpar.sharded_cumsum(tg, tpar.shard_gridded(ta, tm, spec), "X", tm, spec,
                            to=to, boundary=boundary)
    assert t.dims == j.dims
    assert_close(t, j, rtol=1e-12)  # test_sharding.py's rtol
    assert_close(t, tg.cumsum(ta, "X", to=to, boundary=boundary), rtol=1e-12)


@pytest.mark.parametrize("dtype", [np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8,
                                   np.uint16, np.uint32, np.uint64])
def test_sharded_cumsum_integer_dtypes(dtype):
    """The wrap total of a small int keeps the cumsum's dtype, and bool
    offsets stay int (the cumsum of bool is int64): the periodic shift
    exercises both."""
    rng = np.random.RandomState(3)
    if dtype == np.bool_:
        a = rng.rand(4, 32) < 0.5
    else:
        info = np.iinfo(dtype)
        a = rng.randint(max(info.min, -100), min(info.max, 100) + 1, size=(4, 32)).astype(dtype)
    ja, ta = _both(a, ("yc", "xc"))
    jm, tm = _jmesh({"x": 4}), _tmesh({"x": 4})
    jg, tg = _grid(xgcm_tpu, n=32, ny=4), _grid(xtt, n=32, ny=4)
    j = jpar.sharded_cumsum(jg, jpar.shard_gridded(ja, jm, {"xc": "x"}), "X", jm, {"xc": "x"},
                            to="left", boundary="periodic")
    t = tpar.sharded_cumsum(tg, tpar.shard_gridded(ta, tm, {"xc": "x"}), "X", tm,
                            {"xc": "x"}, to="left", boundary="periodic")
    assert_bitwise(t, j)
    assert_bitwise(t, tg.cumsum(ta, "X", to="left", boundary="periodic"))


def test_sharded_cumsum_nan_in_later_shard():
    """A NaN in a later shard's total must not reach earlier shards
    (0 * NaN): the offsets are selected, never masked by multiplying."""
    a = np.random.rand(NY, N)
    a[3, 50] = np.nan  # shard 6 of 8
    ja, ta = _both(a, ("yc", "xc"))
    jm, tm = _jmesh({"x": 8}), _tmesh({"x": 8})
    jg, tg = _grid(xgcm_tpu), _grid(xtt)
    j = jpar.sharded_cumsum(jg, jpar.shard_gridded(ja, jm, {"xc": "x"}), "X", jm, {"xc": "x"},
                            to="right", boundary="fill")
    t = tpar.sharded_cumsum(tg, tpar.shard_gridded(ta, tm, {"xc": "x"}), "X", tm,
                            {"xc": "x"}, to="right", boundary="fill")
    assert_close(t, j, rtol=1e-12)
    out = to_numpy(t)
    assert np.isnan(out[3, 50:]).all() and not np.isnan(out[3, :50]).any()


def test_sharded_periodic_cumsum_wrap_with_infinite_last_element():
    """The periodic wrap of the shifted cumsum is the trimmed array's last
    value cs[N-2], taken from the shard that holds it: an infinite last
    element leaves it finite, as on one device.  (The JAX package computes
    it as S - x_last, inf - inf = NaN there; with finite data the two agree
    within rtol 1e-12, test_sharded_cumsum_matches.)"""
    a = np.random.rand(NY, N)
    a[2, -1] = np.inf
    a[5, -1] = -np.inf
    ta = xtt.GriddedArray(a, ("yc", "xc"))
    tg = _grid(xtt)
    for shards in (8, 64):  # 8 a shard, and one a shard (cs[N-2] on the shard before)
        tm = _tmesh({"x": 8}) if shards == 8 else tpar.make_mesh({"x": 64}, devices=["cpu"] * 64)
        t = tpar.sharded_cumsum(tg, tpar.shard_gridded(ta, tm, {"xc": "x"}), "X", tm,
                                {"xc": "x"}, to="left", boundary="periodic")
        one = tg.cumsum(ta, "X", to="left", boundary="periodic")
        assert_close(t, one, rtol=1e-12)
        assert np.isfinite(to_numpy(t)[[2, 5], 0]).all()
    j = xgcm_tpu.GriddedArray(a, ("yc", "xc"))
    assert_close(t, _grid(xgcm_tpu).cumsum(j, "X", to="left", boundary="periodic"), rtol=1e-12)


def test_batch_dim_route():
    """The y (non-core) dim sharded: the op along X runs per block."""
    a = np.random.rand(NY, N)
    ja, ta = _both(a, ("yc", "xc"))
    jm, tm = _jmesh({"b": 8}), _tmesh({"b": 8})
    jg, tg = _grid(xgcm_tpu), _grid(xtt)
    j = jpar.ShardedGrid(jg, jm, {"yc": "b"}).interp(
        jpar.shard_gridded(ja, jm, {"yc": "b"}), "X")
    sg = tpar.ShardedGrid(tg, tm, {"yc": "b"})
    t = sg.interp(sg.shard(ta), "X")
    assert t.data.spec == ("b", None)
    assert_close(t, j, rtol=1e-7)  # test_sharding.py: assert_allclose's default
    assert_bitwise(t, tg.interp(ta, "X"))


def test_single_shard_mesh_periodic_halo():
    """A size-1 mesh axis self-wraps periodic halos."""
    def grid(pkg):
        ds = pkg.Dataset(coords={"xc": ("xc", np.arange(16, dtype=float)),
                                 "xg": ("xg", np.arange(16) - 0.5)})
        return pkg.Grid(ds, coords={"X": {"center": "xc", "left": "xg"}},
                        autoparse_metadata=False)

    a = np.random.RandomState(0).rand(16)
    ja, ta = _both(a, ("xc",))
    jm, tm = _jmesh({"x": 1}), _tmesh({"x": 1})
    j = jpar.ShardedGrid(grid(xgcm_tpu), jm, {"xc": "x", "xg": "x"}).diff(
        jpar.shard_gridded(ja, jm, {"xc": "x"}), "X", boundary="periodic")
    t = tpar.ShardedGrid(grid(xtt), tm, {"xc": "x", "xg": "x"}).diff(
        tpar.shard_gridded(ta, tm, {"xc": "x"}), "X", boundary="periodic")
    assert_close(t, j, rtol=1e-7)


def test_face_sharded_ops_are_refused():
    """The face-sharded route through every entry point that reaches it:
    ``ShardedGrid`` ops and ``apply_as_grid_ufunc`` and ``sharded_op`` on
    a face-mapped cubed sphere equal JAX's ``sharded_face_op`` value for
    value, assembling nothing on the way.  What JAX refuses stays refused:
    the shifting cumsum across axis-swapping connections.  A one-op
    ``apply_many`` equals ``diff`` and assembles nothing either."""
    ds, fc = cubed_sphere_dataset(n=8)
    tds = xtt.from_numpy_dataset(ds)
    grid = xtt.Grid(tds, face_connections=fc, periodic=False)
    jgrid = xgcm_tpu.Grid(ds, face_connections=fc, periodic=False)
    mesh, jmesh = _tmesh({"f": 6}), _jmesh({"f": 6})
    a = np.random.RandomState(11).rand(6, 8, 8)
    da = xtt.GriddedArray(a, ("face", "y", "x"))
    sg = tpar.ShardedGrid(grid, mesh, {"face": "f"})
    sh = sg.shard(da)
    sharded_tensor.reset_assembly_count()
    want = jax.jit(lambda x: jpar.sharded_face_op(
        jgrid, "diff", xgcm_tpu.GriddedArray(x, ("face", "y", "x")), "X", jmesh, "f", "X", "Y",
        boundary="fill").data)(a)
    for got in (sg.diff(sh, "X", boundary="fill"),
                tpar.sharded_op(grid, "diff", sh, "X", mesh, {"face": "f"}, boundary="fill")):
        assert isinstance(got.data, tpar.ShardedTensor)
        np.testing.assert_array_equal(to_numpy(got.data.full_tensor()), np.asarray(want))
    got = sg.apply_as_grid_ufunc(lambda b: b, sh, axis=[("X",)],
                                 signature="(X:center)->(X:center)")
    np.testing.assert_array_equal(to_numpy(got.data.full_tensor()), a)
    sharded_tensor.reset_assembly_count()
    for g in (sg, jpar.ShardedGrid(jgrid, jmesh, {"face": "f"})):
        with pytest.raises(NotImplementedError, match="swap"):
            g.cumsum(sh if g is sg else xgcm_tpu.GriddedArray(a, ("face", "y", "x")), "X",
                     boundary="fill")
    [many] = sg.apply_many([dict(op="diff", args=sh, axis="X", boundary="fill")])
    assert isinstance(many.data, tpar.ShardedTensor)
    assert sharded_tensor.assembly_count() == 0
    np.testing.assert_array_equal(to_numpy(many.data.full_tensor()), np.asarray(want))


# ------------------------------------------------------ test_sharding_2d.py
NX2, NY2 = 32, 16


def test_2d_decomposition_x_op():
    a = np.random.rand(NY2, NX2)
    ja, ta = _both(a, ("yc", "xc"))
    jm, tm = _jmesh({"x": 4, "y": 2}), _tmesh({"x": 4, "y": 2})
    jg, tg = _grid(xgcm_tpu, NX2, NY2, False), _grid(xtt, NX2, NY2, False)
    spec = {"xc": "x", "yc": "y"}
    j = jpar.sharded_op(jg, "diff", jpar.shard_gridded(ja, jm, spec), "X", jm, spec,
                        boundary="fill")
    t = tpar.sharded_op(tg, "diff", tpar.shard_gridded(ta, tm, spec), "X", tm, spec,
                        boundary="fill")
    assert t.data.spec == ("y", "x")
    assert_close(t, j, rtol=1e-7)  # assert_allclose's default


def test_2d_decomposition_both_axes_sequential():
    a = np.random.rand(NY2, NX2)
    ja, ta = _both(a, ("yc", "xc"))
    jm, tm = _jmesh({"x": 4, "y": 2}), _tmesh({"x": 4, "y": 2})
    jg, tg = _grid(xgcm_tpu, NX2, NY2, False), _grid(xtt, NX2, NY2, False)
    spec = {"xc": "x", "yc": "y", "xg": "x", "yg": "y"}

    def run(par, g, m, da):
        s1 = par.sharded_op(g, "interp", par.shard_gridded(da, m, spec), "X", m, spec,
                            boundary="periodic")
        return par.sharded_op(g, "diff", s1, "Y", m, spec, boundary="periodic")

    j, t = run(jpar, jg, jm, ja), run(tpar, tg, tm, ta)
    assert t.dims == j.dims
    assert_close(t, j, rtol=1e-7)  # assert_allclose's default


def test_grad_through_sharded_diff():
    """test_grad_through_diff with the diff sharded: the gradient of
    sum(diff(x)^2) flows through the ring halo and the blocks back to x,
    equal to JAX's gradient of the single-device op (rtol 1e-12: the same
    products and sums)."""
    a = np.random.rand(NX2)

    def jloss(x):
        d = _grid(xgcm_tpu, NX2, NY2, False).diff(
            xgcm_tpu.GriddedArray(x, ("xc",)), "X", boundary="periodic")
        return jnp.sum(d.data ** 2)

    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(a)))
    tg = _grid(xtt, NX2, NY2, False)
    sg = tpar.ShardedGrid(tg, _tmesh({"x": 4}), {"xc": "x", "xg": "x"})
    x = torch.tensor(a, requires_grad=True)
    d = sg.diff(sg.shard(xtt.GriddedArray(x, ("xc",))), "X", boundary="periodic")
    (d.data.full_tensor() ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=1e-12)


@pytest.fixture(scope="module")
def proxy_results():
    """The JAX ShardedGrid proxy results, once for the module."""
    rng = np.random.RandomState(21)
    a = rng.rand(NY2, NX2)
    jg = _grid(xgcm_tpu, NX2, NY2, False)
    jm = _jmesh({"x": 4})
    sg = jpar.ShardedGrid(jg, jm, {"xc": "x", "xg": "x"})
    da = sg.shard(xgcm_tpu.GriddedArray(a, ("yc", "xc")))
    out = {
        "chain": sg.diff(sg.interp(da, "X", boundary="extend"), "Y"),
        "cumsum": sg.cumsum(da, "X", to="left", boundary="fill"),
        "min": sg.min(da, "X", boundary="extrapolate"),
        "max": sg.max(da, "X", boundary="extrapolate"),
    }
    return a, out


@pytest.mark.parametrize("what", ["chain", "cumsum", "min", "max"])
def test_sharded_grid_proxy(proxy_results, what):
    a, jout = proxy_results
    tg = _grid(xtt, NX2, NY2, False)
    sg = tpar.ShardedGrid(tg, _tmesh({"x": 4}), {"xc": "x", "xg": "x"})
    da = sg.shard(xtt.GriddedArray(a, ("yc", "xc")))
    t = {
        "chain": lambda: sg.diff(sg.interp(da, "X", boundary="extend"), "Y"),
        "cumsum": lambda: sg.cumsum(da, "X", to="left", boundary="fill"),
        "min": lambda: sg.min(da, "X", boundary="extrapolate"),
        "max": lambda: sg.max(da, "X", boundary="extrapolate"),
    }[what]()
    assert t.dims == jout[what].dims
    # assert_allclose's default (1e-7); the cumsum at the JAX sharded rtol
    assert_close(t, jout[what], rtol=1e-12 if what == "cumsum" else 1e-7)


def test_sharding_pins():
    """Axis-name keys expand to every dim of the axis (an explicit dim key
    wins); a mesh value that names no mesh axis raises."""
    tg = _grid(xtt, NX2, NY2, False)
    mesh = _tmesh({"x": 4})
    sg = tpar.ShardedGrid(tg, mesh, {"X": "x", "xg": None})
    assert sg.dim_to_mesh_axis == {"xc": "x", "xg": None}
    jsg = jpar.ShardedGrid(_grid(xgcm_tpu, NX2, NY2, False), _jmesh({"x": 4}),
                           {"X": "x", "xg": None})
    assert jsg.dim_to_mesh_axis == sg.dim_to_mesh_axis
    with pytest.raises(ValueError, match="not in mesh"):
        tpar.ShardedGrid(tg, mesh, {"xc": "nope"})
    a = np.random.rand(NY2, NX2)
    sgx = tpar.ShardedGrid(tg, mesh, {"X": "x"})
    out = sgx.diff(sgx.shard(xtt.GriddedArray(a, ("yc", "xc"))), "X")
    assert out.data.spec == (None, "x")  # the ring route, not a fall-through
    assert_bitwise(out, tg.diff(xtt.GriddedArray(a, ("yc", "xc")), "X"))


# ------------------------------------------------------------- transforms
def _zgrid(pkg, nz):
    ds = pkg.Dataset(coords={"zc": ("zc", np.arange(nz) + 0.5),
                             "zo": ("zo", np.arange(nz + 1) * 1.0)})
    return pkg.Grid(ds, coords={"Z": {"center": "zc", "outer": "zo"}}, periodic=False,
                    autoparse_metadata=False)


def _transform_pair(case, pkg, par, mesh):
    """One TestPerShardTransform case in either package: (sharded call,
    single-device call)."""
    nz, ncol = 10, 64
    g = _zgrid(pkg, nz)
    rng = np.random.RandomState({"single": 5, "conservative": 6, "columns_first": 9,
                                 "log": 10, "default_target_data": 10, "per_column": 13,
                                 "multi": 1}[case])
    GA = pkg.GriddedArray
    sg = par.ShardedGrid(g, mesh, {"col": "c"})

    def sh(x):
        return par.shard_gridded(x, mesh, {"col": "c"})

    if case == "columns_first":
        q = GA(rng.rand(nz, ncol), ("zc", "col"), name="q")
        s = GA(np.sort(rng.rand(nz, ncol), 0) * 8 + 20, ("zc", "col"), name="sigma")
        tgt = GA(np.linspace(21, 27, 5), ("sigma",), name="sigma")
        return (lambda: sg.transform(sh(q), "Z", tgt, target_data=sh(s)),
                lambda: g.transform(q, "Z", tgt, target_data=s))
    q = GA(rng.rand(ncol, nz), ("col", "zc"), name="q")
    if case == "conservative":
        so = GA(np.sort(rng.rand(ncol, nz + 1), -1) * 8 + 20, ("col", "zo"), name="sigma")
        bins = np.linspace(19, 29, 6)
        kw = dict(target_data=so, target_dim="sigma", method="conservative")
        return (lambda: sg.transform(sh(q), "Z", bins, **{**kw, "target_data": sh(so)}),
                lambda: g.transform(q, "Z", bins, **kw))
    s = GA(np.sort(rng.rand(ncol, nz), -1) * 8 + 20, ("col", "zc"), name="sigma")
    if case == "single":
        tgt = GA(np.linspace(21, 27, 5), ("sigma",), name="sigma")
        return (lambda: sg.transform(sh(q), "Z", tgt, target_data=sh(s)),
                lambda: g.transform(q, "Z", tgt, target_data=s))
    if case == "log":
        t = np.linspace(21, 27, 5)
        return (lambda: sg.transform(sh(q), "Z", t, target_data=sh(s), target_dim="sigma",
                                     method="log"),
                lambda: g.transform(q, "Z", t, target_data=s, target_dim="sigma",
                                    method="log"))
    if case == "default_target_data":
        t = np.linspace(1.5, 8.5, 4)
        return lambda: sg.transform(sh(q), "Z", t), lambda: g.transform(q, "Z", t)
    if case == "per_column":
        tgt2 = GA(np.sort(rng.rand(ncol, 5), -1) * 6 + 21, ("col", "sigma"), name="sigma")
        return (lambda: sg.transform(sh(q), "Z", sh(tgt2), target_data=sh(s),
                                     target_dim="sigma"),
                lambda: g.transform(q, "Z", tgt2, target_data=s, target_dim="sigma"))
    # multi: two variables, mask_edges off
    das = [q, GA(rng.rand(ncol, nz), ("col", "zc"), name="q1")]
    t = np.linspace(21, 27, 5)
    return (lambda: sg.transform_multi([sh(d) for d in das], "Z", t, target_data=sh(s),
                                       target_dim="sigma", mask_edges=False),
            lambda: [g.transform(d, "Z", t, target_data=s, target_dim="sigma",
                                 mask_edges=False) for d in das])


@pytest.mark.parametrize("case", ["single", "conservative", "columns_first", "log",
                                  "default_target_data", "per_column", "multi"])
def test_per_shard_transform(case):
    """ShardedGrid.transform/transform_multi per shard == the JAX sharded
    call and the port's single-device call (rtol 1e-12, the JAX tests')."""
    j_sh, _ = _transform_pair(case, xgcm_tpu, jpar, _jmesh({"c": 8}))
    t_sh, t_one = _transform_pair(case, xtt, tpar, _tmesh({"c": 8}))
    j, t, one = j_sh(), t_sh(), t_one()
    if case != "multi":
        j, t, one = [j], [t], [one]
    for jo, to_, oo in zip(j, t, one):
        assert to_.dims == jo.dims == oo.dims
        assert to_.name == jo.name
        assert_close(to_, jo, rtol=1e-12)
        assert_bitwise(to_, oo)  # per column, the same arithmetic
    c = tpar.ShardedTensor
    assert all(isinstance(o.data, c) for o in t)


def test_per_shard_transform_zero_collectives_and_sharded_dim_refused():
    from xgcm_tpu.utils import count_collectives as jcount
    from xgcm_tpu_torch.utils import count_collectives as tcount

    nz, ncol = 10, 64
    rng = np.random.RandomState(7)
    q = rng.rand(ncol, nz)
    s = np.sort(rng.rand(ncol, nz), -1) * 8 + 20
    target = np.linspace(21, 27, 5)
    jsg = jpar.ShardedGrid(_zgrid(xgcm_tpu, nz), _jmesh({"c": 8}), {"col": "c"})
    tsg = tpar.ShardedGrid(_zgrid(xtt, nz), _tmesh({"c": 8}), {"col": "c"})

    def run(pkg, sg, qd, sd):
        return sg.transform(pkg.GriddedArray(qd, ("col", "zc"), name="q"), "Z", target,
                            target_data=pkg.GriddedArray(sd, ("col", "zc"), name="sigma"),
                            target_dim="sigma").data

    jc = jcount(lambda qd, sd: run(xgcm_tpu, jsg, qd, sd), q, s)
    tc = tcount(run, xtt, tsg, torch.as_tensor(q), torch.as_tensor(s))
    assert tc == jc == {"total": 0}
    sgz = tpar.ShardedGrid(_zgrid(xtt, nz), _tmesh({"c": 2}), {"zc": "c"})
    with pytest.raises(NotImplementedError, match="sharded dimension"):
        sgz.transform_multi([xtt.GriddedArray(q, ("col", "zc"))], "Z", target,
                            target_data=xtt.GriddedArray(s, ("col", "zc")))


def test_transform_of_face_sharded_columns():
    """Faces are just more columns: a transform per shard with the face
    dim mesh-mapped is no face route, and equals the single-device call."""
    n, nz = 4, 6
    _, fc = cubed_sphere_dataset(n=n)
    rng = np.random.RandomState(8)
    q = rng.rand(6, nz, n, n)
    s = np.sort(rng.rand(6, nz, n, n), axis=1) * 8 + 20
    target = np.linspace(21, 27, 5)

    def run(pkg, par, mesh):
        ds = pkg.Dataset(coords={
            "x": ("x", np.arange(n) + 0.5, {"axis": "X"}),
            "y": ("y", np.arange(n) + 0.5, {"axis": "Y"}),
            "zc": ("zc", np.arange(nz) + 0.5, {"axis": "Z"}),
            "face": ("face", np.arange(6)),
        })
        g = pkg.Grid(ds, periodic=False, autoparse_metadata=False,
                     coords={"X": {"center": "x"}, "Y": {"center": "y"},
                             "Z": {"center": "zc"}}, face_connections=fc)
        dims = ("face", "zc", "y", "x")
        m = {"face": "f", "y": "ym"}
        sg = par.ShardedGrid(g, mesh, m)
        return sg.transform(
            par.shard_gridded(pkg.GriddedArray(q, dims, name="q"), mesh, m), "Z", target,
            target_data=par.shard_gridded(pkg.GriddedArray(s, dims, name="sigma"), mesh, m),
            target_dim="sigma")

    j = run(xgcm_tpu, jpar, _jmesh({"f": 2, "ym": 4}))
    t = run(xtt, tpar, _tmesh({"f": 2, "ym": 4}))
    assert t.dims == j.dims
    assert_close(t, j, rtol=1e-12)  # the JAX test's rtol


# ------------------------------------------------------------ batch route
def _batch_grid(pkg, nx=16, nz=8):
    ds = pkg.Dataset(coords={
        "xc": ("xc", np.arange(nx) + 0.5, {"axis": "X"}),
        "xg": ("xg", np.arange(nx) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
        "z": ("z", np.arange(nz) * 1.0, {"axis": "Z"}),
    })
    return pkg.Grid(ds)


def test_batch_sharded_diff_matches_and_is_collective_free():
    from xgcm_tpu.utils import count_collectives as jcount
    from xgcm_tpu_torch.utils import count_collectives as tcount

    rng = np.random.RandomState(11)
    q = rng.rand(8, 8, 16)
    dims = ("z", "yb", "xc")
    jg, tg = _batch_grid(xgcm_tpu), _batch_grid(xtt)
    jm, tm = _jmesh({"zm": 8}), _tmesh({"zm": 8})
    jsg, tsg = jpar.ShardedGrid(jg, jm, {"z": "zm"}), tpar.ShardedGrid(tg, tm, {"z": "zm"})
    jq, tq = _both(q, dims, "q")
    tq_sh = tsg.shard(tq)
    j = jsg.diff(jsg.shard(jq), "X", boundary="fill")
    t = tsg.diff(tq_sh, "X", boundary="fill")
    assert t.dims == j.dims and t.data.spec == ("zm", None, None)
    assert_close(t, j, rtol=1e-12)  # the JAX test's rtol
    assert_bitwise(t, tg.diff(tq, "X", boundary="fill"))
    jc = jcount(lambda d: jsg.diff(xgcm_tpu.GriddedArray(d, dims, name="q"), "X",
                                   boundary="fill").data, q)
    tc = tcount(lambda: tsg.diff(tq_sh, "X", boundary="fill"))
    assert tc == jc == {"total": 0}
    # cumsum along the unsharded dim is shard-local too
    assert_close(tsg.cumsum(tq_sh, "X", boundary="fill"),
                 jsg.cumsum(jsg.shard(jq), "X", boundary="fill"), rtol=1e-12)


def _face_z_grid(pkg, n=4, nz=8):
    _, fc = cubed_sphere_dataset(n=n)
    ds = pkg.Dataset(coords={
        "x": ("x", np.arange(n) + 0.5, {"axis": "X"}),
        "xl": ("xl", np.arange(n) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
        "y": ("y", np.arange(n) + 0.5, {"axis": "Y"}),
        "yl": ("yl", np.arange(n) * 1.0, {"axis": "Y", "c_grid_axis_shift": -0.5}),
        "z": ("z", np.arange(nz) * 1.0, {"axis": "Z"}),
        "face": ("face", np.arange(6)),
    })
    return pkg.Grid(ds, face_connections=fc)


def test_face_inface_sharding_falls_through():
    """A sharded face-connected in-face dim is not batch-safe: the op
    takes the fall-through (assembled, then re-sharded) and stays right."""
    ds, fc = cubed_sphere_dataset(n=8)
    jg = xgcm_tpu.Grid(ds, face_connections=fc)
    tg = xtt.Grid(xtt.from_numpy_dataset(ds), face_connections=fc)
    a = np.asarray(ds["data_c"].data)
    ja, ta = _both(a, ds["data_c"].dims)
    jm, tm = _jmesh({"ym": 8}), _tmesh({"ym": 8})
    jsg, tsg = jpar.ShardedGrid(jg, jm, {"y": "ym"}), tpar.ShardedGrid(tg, tm, {"y": "ym"})
    assert not tsg._batch_safe_dims(ta.dims, tg.axes["X"].coords.values())
    j = jsg.diff(jpar.shard_gridded(ja, jm, {"y": "ym"}), "X", boundary="fill")
    sharded_tensor.reset_assembly_count()
    t = tsg.diff(tpar.shard_gridded(ta, tm, {"y": "ym"}), "X", boundary="fill")
    assert sharded_tensor.assembly_count() == 1
    assert_close(t, j, rtol=1e-12)  # the JAX test's rtol


def test_z_batch_on_face_grid_is_shard_local():
    from xgcm_tpu.utils import count_collectives as jcount
    from xgcm_tpu_torch.utils import count_collectives as tcount

    rng = np.random.RandomState(12)
    q = rng.rand(6, 8, 4, 4)
    dims = ("face", "z", "y", "x")
    jq, tq = _both(q, dims, "q")
    jm, tm = _jmesh({"zm": 8}), _tmesh({"zm": 8})
    jsg = jpar.ShardedGrid(_face_z_grid(xgcm_tpu), jm, {"z": "zm"})
    tsg = tpar.ShardedGrid(_face_z_grid(xtt), tm, {"z": "zm"})
    tq_sh = tsg.shard(tq)
    j = jsg.diff(jsg.shard(jq), "X", boundary="fill")
    t = tsg.diff(tq_sh, "X", boundary="fill")
    assert_close(t, j, rtol=1e-12)  # the JAX test's rtol
    jc = jcount(lambda d: jsg.diff(xgcm_tpu.GriddedArray(d, dims, name="q"), "X",
                                   boundary="fill").data, q)
    assert tcount(lambda: tsg.diff(tq_sh, "X", boundary="fill")) == jc == {"total": 0}


def _sm3(a):
    return (a[..., :-2] + a[..., 1:-1] + a[..., 2:]) / 3.0


@pytest.mark.parametrize("face", [False, True])
def test_custom_ufunc_batch_only_sharding(face):
    """A custom ufunc whose sharded dims are pure batch dims runs per
    shard with no collective; on a face grid whose face dim is not mapped
    too."""
    from xgcm_tpu.utils import count_collectives as jcount
    from xgcm_tpu_torch.utils import count_collectives as tcount

    rng = np.random.RandomState(15 if face else 14)
    if face:
        q, dims = rng.rand(6, 8, 4, 4), ("face", "z", "y", "x")
        jg, tg = _face_z_grid(xgcm_tpu), _face_z_grid(xtt)
        bc = "fill"
    else:
        q, dims = rng.rand(8, 8, 16), ("z", "yb", "xc")
        jg, tg = _batch_grid(xgcm_tpu), _batch_grid(xtt)
        bc = "extend"
    kw = dict(axis=[("X",)], signature="(X:center)->(X:center)",
              boundary_width={"X": (1, 1)}, boundary=bc)
    jm, tm = _jmesh({"zm": 8}), _tmesh({"zm": 8})
    jsg, tsg = jpar.ShardedGrid(jg, jm, {"z": "zm"}), tpar.ShardedGrid(tg, tm, {"z": "zm"})
    jq, tq = _both(q, dims, "q")
    tq_sh = tsg.shard(tq)
    j = jsg.apply_as_grid_ufunc(_sm3, jsg.shard(jq), **kw)
    t = tsg.apply_as_grid_ufunc(_sm3, tq_sh, **kw)
    assert t.dims == j.dims
    assert_close(t, j, rtol=1e-12)  # the JAX test's rtol
    jc = jcount(lambda d: jsg.apply_as_grid_ufunc(
        _sm3, xgcm_tpu.GriddedArray(d, dims, name="q"), **kw).data, q)
    assert tcount(lambda: tsg.apply_as_grid_ufunc(_sm3, tq_sh, **kw)) == jc == {"total": 0}


# ------------------------------------------- test_fuzz_sharded_routing.py
def _routing_grid(pkg):
    ds = pkg.Dataset(coords={
        "xc": ("xc", np.arange(16) + 0.5, {"axis": "X"}),
        "xg": ("xg", np.arange(16) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
        "yc": ("yc", np.arange(8) + 0.5, {"axis": "Y"}),
        "yg": ("yg", np.arange(8) * 1.0, {"axis": "Y", "c_grid_axis_shift": -0.5}),
        "z": ("z", np.arange(8) * 1.0, {"axis": "Z"}),
    })
    return pkg.Grid(ds)


# core-dim sharding, batch sharding, both, a 2-D decomposition, and nothing
# relevant sharded
ROUTING_MAPPINGS = [
    {"xc": "a", "xg": "a"},
    {"z": "a"},
    {"xc": "a", "xg": "a", "z": "b"},
    {"yc": "a", "yg": "a", "xc": "b", "xg": "b"},
    {"yc": "a", "yg": "a"},
]


@pytest.mark.parametrize("mapping", range(len(ROUTING_MAPPINGS)))
@pytest.mark.parametrize("op", ["interp", "diff", "min", "max", "cumsum"])
def test_plain_grid_routing_fuzz(op, mapping):
    """Every (op, mesh mapping) takes some route (ring, batch, or the
    fall-through) and equals the JAX sharded call (rtol 1e-12, the JAX
    test's) and the port's single-device call."""
    m = ROUTING_MAPPINGS[mapping]
    q = np.random.RandomState(100 + 10 * mapping + len(op)).rand(8, 8, 16)
    outs = []
    for pkg, par, mesh in ((xgcm_tpu, jpar, _jmesh({"a": 4, "b": 2})),
                           (xtt, tpar, _tmesh({"a": 4, "b": 2}))):
        grid = _routing_grid(pkg)
        da = pkg.GriddedArray(q, ("z", "yc", "xc"), name="q")
        sg = par.ShardedGrid(grid, mesh, m)
        sh = par.shard_gridded(da, mesh, {d: v for d, v in m.items() if d in da.dims})
        outs.append(getattr(sg, op)(sh, "X", boundary="fill"))
    j, t = outs
    assert t.dims == j.dims
    assert_close(t, j, rtol=1e-12)
    one = getattr(_routing_grid(xtt), op)(xtt.GriddedArray(q, ("z", "yc", "xc")), "X",
                                          boundary="fill")
    assert_close(t, one, rtol=1e-12)


# ------------------------------------------------- mesh and sharded tensor
def test_make_mesh_takes_cuda_cards_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="needs 2 devices but only 0"):
        tpar.make_mesh({"x": 2})
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = tpar.make_mesh({"x": 2})
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:1"]
    assert mesh.shape == {"x": 2}
    logical = tpar.make_mesh({"a": 2, "b": 2}, devices=["cpu"] * 4)
    assert logical.shape == {"a": 2, "b": 2} and logical.size == 4


def test_sharded_tensor_stays_a_tensor_and_assembles_on_purpose():
    """GriddedArray keeps a ShardedTensor as its data (as_tensor would send
    anything else through numpy to the host); pointwise and view ops run
    block by block; np.asarray, .cpu() and full_tensor assemble, and each
    assembly is counted."""
    mesh = _tmesh({"b": 2, "x": 4})
    a = torch.as_tensor(np.random.rand(4, 6, 8))
    st = tpar.ShardedTensor
    x = sharded_tensor.distribute(a, mesh, (None, None, "x"))
    ga = xtt.GriddedArray(x, ("t", "y", "x"))
    assert ga.data is x and xtt.core.dataarray.as_tensor(x) is x
    # blocks are distinct tensors, even along the replicated mesh axis
    ptrs = {b.data_ptr() for b in x.blocks.flat}
    assert len(ptrs) == 8
    sharded_tensor.reset_assembly_count()
    w = torch.as_tensor(np.random.rand(6, 8))
    y = (x * w + 1.0).permute(2, 0, 1).unsqueeze(0)
    assert isinstance(y, st) and y.spec == (None, "x", None, None)
    z = torch.where(torch.isnan(y), 0.0, y)
    assert isinstance(z, st)
    assert sharded_tensor.assembly_count() == 0
    want = (a * w + 1.0).permute(2, 0, 1).unsqueeze(0)
    assert torch.equal(z.full_tensor(), want)
    assert sharded_tensor.assembly_count() == 1
    np.testing.assert_array_equal(np.asarray(z), want.numpy())
    on_host = z.cpu()
    assert torch.equal(on_host, want) and not isinstance(on_host, st)
    assert sharded_tensor.assembly_count() == 3
    # an op with no blockwise rule assembles, and the result keeps the
    # input's spec where its shape allows
    r = torch.roll(x, 1, dims=2)
    assert isinstance(r, st) and r.spec == x.spec
    assert torch.equal(r.full_tensor(), torch.roll(a, 1, dims=2))
    s = x.sum(dim=2)
    assert not isinstance(s, st) and torch.allclose(s, a.sum(dim=2))
    # in place, block by block
    x.mul_(2.0)
    assert torch.equal(x.full_tensor(), 2 * a)


def test_ppermute_copies():
    """A received block is a copy: changing the sender's block afterwards
    leaves it as it was."""
    mesh = _tmesh({"x": 4})
    x = sharded_tensor.distribute(torch.arange(8.0), mesh, ("x",))
    got = collectives.ppermute(x.blocks, mesh, "x", [(i, (i + 1) % 4) for i in range(4)])
    x.blocks[0].fill_(-1.0)
    assert torch.equal(got[1], torch.tensor([0.0, 1.0]))


def test_parallel_modules_import_first_without_jax():
    """Each module of the sharded layer can be imported first, and none
    imports JAX or the JAX package."""
    import subprocess
    import sys

    mods = ("xgcm_tpu_torch.parallel", "xgcm_tpu_torch.parallel.mesh",
            "xgcm_tpu_torch.parallel.sharded_tensor", "xgcm_tpu_torch.parallel.collectives",
            "xgcm_tpu_torch.parallel.halo", "xgcm_tpu_torch.parallel.sharded_ufunc",
            "xgcm_tpu_torch.parallel.sharded_grid", "xgcm_tpu_torch.parallel.diagnostics",
            "xgcm_tpu_torch.parallel.apply_many", "xgcm_tpu_torch.utils.inspection")
    check = ("bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'xgcm_tpu')]; "
             "assert not bad, bad")
    procs = [subprocess.Popen([sys.executable, "-c", f"import sys, {mod}; {check}"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for mod in mods]
    for mod, p in zip(mods, procs):
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, f"{mod}: {err[-500:]}"


def test_dryrun_multichip_on_cpu():
    from xgcm_tpu_torch.entry import dryrun_multichip

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dryrun_multichip(8, devices=CPU8)
    dryrun_multichip(3, devices=CPU8)


@pytest.mark.parametrize("n_shards", [4, 8])
def test_dryrun_multichip_runs_the_batch_route(monkeypatch, n_shards):
    """Route 5: one ``sharded_apply_many`` of a diff along X and an interp
    along Y of one cubed-sphere field (dummy-padded on 4 shards, face x
    rows x cols on 8), checked inside against the single-device ops; a
    batch that is wrong fails the run."""
    from xgcm_tpu_torch import entry

    calls = []
    real = tpar.sharded_apply_many

    def spy(specs, **kw):
        out = real(specs, **kw)
        calls.append([s["func"].__name__ for s in specs])
        return out

    monkeypatch.setattr(tpar, "sharded_apply_many", spy)
    entry.dryrun_multichip(n_shards, devices=CPU8)
    assert len(calls) == 1 and len(calls[0]) == 2

    def wrong(specs, **kw):
        outs = real(specs, **kw)
        return [outs[0], outs[0]]

    monkeypatch.setattr(tpar, "sharded_apply_many", wrong)
    with pytest.raises(AssertionError, match="apply_many"):
        entry.dryrun_multichip(n_shards, devices=CPU8)
