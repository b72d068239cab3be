"""The port's sharded grid-ufunc engine and ShardedGrid surface against
xgcm_tpu.parallel: every case of tests/test_sharded_ufunc.py and the
face-less cases of tests/test_sharded_grid_surface.py.

Each test runs the JAX call on conftest's 8-device CPU mesh and the port
on ``make_mesh(..., devices=[torch.device("cpu")] * 8)``, on the same numpy
inputs, and holds the two to the JAX tests' tolerance, numpy's
``assert_allclose`` default rtol = 1e-7 (1e-12 where the JAX test says so),
with the same NaN footprint.

Not ported: ``test_jit_wrapped`` (``jax.jit``; eager torch has no
counterpart).  The face-sharded surface case
(``test_vector_wrappers_on_face_sharded_grid``) waits for the face-sharded
route: here it checks that the port refuses it.
"""

import types
import warnings

import jax
import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu.parallel as jpar
import xgcm_tpu_torch as xtt
import xgcm_tpu_torch.parallel as tpar
from tests.datasets import cubed_sphere_dataset
from tests.torch_parity import assert_close

CPU8 = [torch.device("cpu")] * 8
NX, NY = 32, 8
RTOL = 1e-7  # numpy.testing.assert_allclose's default, the JAX tests'


def _grid(pkg, seed=0):
    rng = np.random.RandomState(seed)
    ds = pkg.Dataset(coords={
        "xc": ("xc", np.arange(NX) + 0.5),
        "xg": ("xg", np.arange(NX) * 1.0),
        "yc": ("yc", np.arange(NY) + 0.5),
        "yg": ("yg", np.arange(NY) * 1.0),
        "dxg": (("xg",), rng.rand(NX) + 0.5),
        "dxc": (("xc",), rng.rand(NX) + 0.5),
    })
    return pkg.Grid(ds, coords={"X": {"center": "xc", "left": "xg"},
                                "Y": {"center": "yc", "left": "yg"}},
                    metrics={("X",): ["dxg", "dxc"]}, autoparse_metadata=False)


class Pair:
    """The same sharded setup in both packages: .j (JAX) and .t (port),
    each with grid, mesh, sgrid and the data array ``da``."""

    def __init__(self, axes, mapping=None, seed=0):
        mapping = mapping or {"xc": "x", "xg": "x"}
        a = np.random.RandomState(seed + 100).rand(NY, NX)
        size = int(np.prod(list(axes.values())))
        self.j = self._side(xgcm_tpu, jpar, jpar.make_mesh(axes, devices=jax.devices()[:size]),
                            mapping, a, seed)
        self.t = self._side(xtt, tpar, tpar.make_mesh(axes, devices=CPU8), mapping, a, seed)

    @staticmethod
    def _side(pkg, par, mesh, mapping, a, seed):
        grid = _grid(pkg, seed)
        return types.SimpleNamespace(
            pkg=pkg, par=par, mesh=mesh, grid=grid,
            sgrid=par.ShardedGrid(grid, mesh, mapping),
            da=pkg.GriddedArray(a, ("yc", "xc"), name="t"))

    def both(self, fn):
        return fn(self.j), fn(self.t)


def _match(j, t, rtol=RTOL):
    assert t.dims == j.dims
    assert_close(t, j, rtol=rtol)


@pytest.mark.parametrize("op", ["interp", "diff", "min", "max"])
@pytest.mark.parametrize("boundary", ["periodic", "fill", "extend"])
def test_builtin_ops_sharded(op, boundary):
    p = Pair({"x": 4})
    j, t = p.both(lambda s: getattr(s.sgrid, op)(s.sgrid.shard(s.da), "X", boundary=boundary))
    _match(j, t)
    single = getattr(p.t.grid, op)(p.t.da, "X", boundary=boundary)
    assert torch.equal(t.data.full_tensor(), single.data)  # the ring route, bit for bit


def _wide(a):
    return a[..., 4:] - a[..., :-4] + a[..., 1:-3]


def test_width2_custom_ufunc():
    p = Pair({"x": 4})
    kw = dict(axis=[("X",)], signature="(X:center)->(X:left)",
              boundary_width={"X": (2, 2)}, boundary="periodic")
    _match(*p.both(lambda s: s.sgrid.apply_as_grid_ufunc(_wide, s.sgrid.shard(s.da), **kw)))


def _lap(a):
    return a[..., 2:] - 2 * a[..., 1:-1] + a[..., :-2]


def test_decorated_ufunc_through_sharded_engine():
    p = Pair({"x": 4})

    def run(s):
        lap = s.pkg.as_grid_ufunc(signature="(ax1:center)->(ax1:center)",
                                  boundary_width={"ax1": (1, 1)})(_lap)
        return s.par.sharded_apply_as_grid_ufunc(
            lap.ufunc, s.sgrid.shard(s.da), axis=[("X",)], grid=s.grid,
            signature=lap.signature, mesh=s.mesh, dim_to_mesh_axis=s.sgrid.dim_to_mesh_axis,
            boundary_width=lap.boundary_width, boundary="extend")

    _match(*p.both(run))


def _diff_and_interp(a):
    return a[..., 1:] - a[..., :-1], 0.5 * (a[..., 1:] + a[..., :-1])


def test_multi_output_ufunc():
    p = Pair({"x": 4})
    kw = dict(axis=[("X",)], signature="(X:center)->(X:left),(X:left)",
              boundary_width={"X": (1, 0)}, boundary="periodic")
    (j1, j2), (t1, t2) = p.both(
        lambda s: s.sgrid.apply_as_grid_ufunc(_diff_and_interp, s.sgrid.shard(s.da), **kw))
    _match(j1, t1)
    _match(j2, t2)


def _stencil2d(a):
    return a[..., 1:, 1:] - a[..., :-1, :-1]


def test_mixed_sharded_and_local_axes():
    """X sharded, Y replicated: the Y padding stays local while X rides the
    ring, in one kernel application."""
    p = Pair({"x": 4})
    kw = dict(axis=[("Y", "X")], signature="(Y:center,X:center)->(Y:left,X:left)",
              boundary_width={"Y": (1, 0), "X": (1, 0)}, boundary="periodic")
    _match(*p.both(lambda s: s.sgrid.apply_as_grid_ufunc(_stencil2d, s.sgrid.shard(s.da),
                                                         **kw)))


def test_batch_dim_parallel_with_core_sharded():
    """2D mesh: batch data-parallel axis x spatial halo axis."""
    p = Pair({"b": 2, "x": 4}, {"batch": "b", "xc": "x", "xg": "x"})
    db = np.random.RandomState(5).rand(4, NY, NX)

    def run(s):
        d = s.pkg.GriddedArray(db, ("batch", "yc", "xc"), name="t")
        return s.sgrid.diff(s.sgrid.shard(d), "X", boundary="fill", fill_value=2.0)

    j, t = p.both(run)
    _match(j, t)
    assert t.data.spec == ("b", None, "x")


def test_inner_outer_positions_rejected():
    p = Pair({"x": 4})
    for s in (p.j, p.t):
        with pytest.raises(NotImplementedError, match="center/left/right"):
            s.sgrid.apply_as_grid_ufunc(
                lambda a: a[..., 1:-1], s.sgrid.shard(s.da), axis=[("X",)],
                signature="(X:center)->(X:inner)", boundary_width={"X": (0, 0)})


def test_pad_after_and_other_component_rejected():
    p = Pair({"x": 4})
    s = p.t
    kw = dict(axis=[("X",)], grid=s.grid, signature="(X:center)->(X:left)", mesh=s.mesh,
              dim_to_mesh_axis=s.sgrid.dim_to_mesh_axis)
    with pytest.raises(NotImplementedError, match="pad_before_func=False"):
        tpar.sharded_apply_as_grid_ufunc(lambda a: a, s.da, pad_before_func=False, **kw)
    with pytest.raises(NotImplementedError, match="other_component"):
        tpar.sharded_apply_as_grid_ufunc(lambda a: a, s.da, other_component={"X": s.da}, **kw)


def test_derivative_matches():
    p = Pair({"x": 4})
    _match(*p.both(lambda s: s.sgrid.derivative(s.sgrid.shard(s.da), "X")))


def test_integrate_average_match():
    p = Pair({"x": 4})
    _match(*p.both(lambda s: s.sgrid.integrate(s.sgrid.shard(s.da), "X")))
    _match(*p.both(lambda s: s.sgrid.average(s.sgrid.shard(s.da), "X")))


def test_cumint_matches():
    p = Pair({"x": 4})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _match(*p.both(lambda s: s.sgrid.cumint(s.sgrid.shard(s.da), "X", boundary="fill")))


def test_metric_weighted_sharded():
    p = Pair({"x": 4})
    _match(*p.both(lambda s: s.sgrid.interp(s.sgrid.shard(s.da), "X", boundary="extend",
                                            metric_weighted="X")))


def test_transform_delegates_and_guards():
    nz = 8
    rng = np.random.RandomState(9)
    d, th = rng.rand(NX, nz), np.sort(rng.rand(NX, nz), axis=-1) * 10
    target = np.linspace(0, 10, 5)

    def run(pkg, par, mesh):
        ds = pkg.Dataset(coords={"zc": ("zc", np.arange(nz) + 0.5),
                                 "xc": ("xc", np.arange(NX) + 0.5),
                                 "xg": ("xg", np.arange(NX) * 1.0)})
        g = pkg.Grid(ds, coords={"Z": {"center": "zc"}, "X": {"center": "xc", "left": "xg"}},
                     periodic=False, autoparse_metadata=False)
        sg = par.ShardedGrid(g, mesh, {"xc": "x", "xg": "x"})
        da = pkg.GriddedArray(d, ("xc", "zc"), name="data")
        theta = pkg.GriddedArray(th, ("xc", "zc"), name="theta")
        out = sg.transform(da, "Z", target, target_data=theta, method="linear",
                           mask_edges=False)
        sg_z = par.ShardedGrid(g, mesh, {"zc": "x"})
        with pytest.raises(NotImplementedError, match="sharded dimension"):
            sg_z.transform(da, "Z", target, target_data=theta, method="linear")
        return out

    _match(run(xgcm_tpu, jpar, jpar.make_mesh({"x": 4}, devices=jax.devices()[:4])),
           run(xtt, tpar, tpar.make_mesh({"x": 4}, devices=CPU8)))


def test_uneven_shard_rejected():
    p = Pair({"x": 3})
    for s in (p.j, p.t):
        with pytest.raises(ValueError, match="does not divide evenly"):
            s.sgrid.diff(s.da, "X", boundary="periodic")


def _w6(a):
    return a[..., 12:] - a[..., :-12] + a[..., 6:-6]


def _w9(a):
    return a[..., 18:] - a[..., :-18]


@pytest.mark.parametrize("boundary", ["periodic", "fill", "extend", "extrapolate"])
def test_width_exceeds_shard(boundary):
    """8 shards of 4 elements; width 6 spans two neighbours."""
    p = Pair({"x": 8})
    kw = dict(axis=[("X",)], signature="(X:center)->(X:left)", boundary_width={"X": (6, 6)},
              boundary=boundary, fill_value=1.5)
    _match(*p.both(lambda s: s.sgrid.apply_as_grid_ufunc(_w6, s.sgrid.shard(s.da), **kw)))


def test_width_spanning_three_shards():
    p = Pair({"x": 8})
    kw = dict(axis=[("X",)], signature="(X:center)->(X:left)", boundary_width={"X": (9, 9)},
              boundary="periodic")
    _match(*p.both(lambda s: s.sgrid.apply_as_grid_ufunc(_w9, s.sgrid.shard(s.da), **kw)))


@pytest.mark.parametrize("boundary,expect", [
    ("extend", [0.0, 0.0, 1.0]),
    ("extrapolate", [-1.0, 0.0, 1.0]),
    ("fill", [-7.0, 0.0, 1.0]),
    ("periodic", [7.0, 0.0, 1.0]),
])
def test_first_shard_halo(boundary, expect):
    """ring_halo_pad on one-element shards: the global edge PAIR spans two
    shards."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from xgcm_tpu.parallel.halo import ring_halo_pad as jring

    jm = jpar.make_mesh({"zm": 8}, devices=jax.devices()[:8])
    j = np.asarray(shard_map(lambda d: jring(d, 0, (1, 1), "zm", boundary, -7.0), mesh=jm,
                             in_specs=P("zm"), out_specs=P("zm"))(np.arange(8.0)))
    tm = tpar.make_mesh({"zm": 8}, devices=CPU8)
    t = tpar.shard_map(lambda b: tpar.ring_halo_pad(b, 0, (1, 1), tm, "zm", boundary, -7.0),
                       tm, (tpar.PartitionSpec("zm"),), tpar.PartitionSpec("zm"))(
        torch.arange(8.0, dtype=torch.float64))
    t = np.asarray(t)
    assert t.shape == (24,)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(t[:3], expect)
    np.testing.assert_allclose(t[9:12], [2.0, 3.0, 4.0])


# --------------------------------------------- test_sharded_grid_surface.py
N = 8


def _surface(pkg, par, mesh):
    rng = np.random.RandomState(7)
    ds = pkg.Dataset(
        coords={
            "xc": ("xc", np.arange(N) + 0.5, {"axis": "X"}),
            "xg": ("xg", np.arange(N) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
            "yc": ("yc", np.arange(N) + 0.5, {"axis": "Y"}),
            "yg": ("yg", np.arange(N) * 1.0, {"axis": "Y", "c_grid_axis_shift": -0.5}),
        },
        data_vars={
            "u": (("yc", "xg"), rng.rand(N, N)),
            "v": (("yg", "xc"), rng.rand(N, N)),
            "tr": (("yc", "xc"), rng.rand(N, N)),
            "dxc": (("yc", "xc"), np.full((N, N), 2.0)),
        },
    )
    grid = pkg.Grid(ds)
    sg = par.ShardedGrid(grid, mesh, {"xc": "xm", "xg": "xm", "yc": "ym", "yg": "ym"})
    return ds, grid, sg


def _surfaces():
    return (_surface(xgcm_tpu, jpar, jpar.make_mesh({"xm": 4, "ym": 2},
                                                    devices=jax.devices()[:8])),
            _surface(xtt, tpar, tpar.make_mesh({"xm": 4, "ym": 2}, devices=CPU8)))


@pytest.mark.parametrize("name", ["diff_2d_vector", "interp_2d_vector"])
def test_vector_wrappers_match(name):
    outs = []
    for (ds, grid, sg), par in zip(_surfaces(), (jpar, tpar)):
        u, v = ds["u"], ds["v"]
        svec = {"X": par.shard_gridded(u, sg.mesh, {"xg": "xm", "yc": "ym"}),
                "Y": par.shard_gridded(v, sg.mesh, {"xc": "xm", "yg": "ym"})}
        with pytest.warns(DeprecationWarning):
            outs.append(getattr(sg, name)(svec, boundary="fill"))
    j, t = outs
    assert set(t) == set(j)
    for k in j:
        _match(j[k], t[k])


def test_interp_like_matches():
    outs = []
    for (ds, grid, sg), par in zip(_surfaces(), (jpar, tpar)):
        u_sh = par.shard_gridded(ds["u"], sg.mesh, {"xg": "xm", "yc": "ym"})
        outs.append(sg.interp_like(u_sh, ds["tr"], boundary="extend"))
        assert sg.interp_like(u_sh, u_sh) is u_sh  # already on like's positions
    _match(*outs)


def test_metrics_delegation_and_coords_for():
    outs = []
    for (ds, grid, sg), par in zip(_surfaces(), (jpar, tpar)):
        sg.set_metrics(("X",), ["dxc"])
        tr = ds["tr"]
        np.testing.assert_allclose(np.asarray(sg.get_metric(tr, ("X",)).data), 2.0)
        outs.append(sg.derivative(par.shard_gridded(tr, sg.mesh, {"xc": "xm"}), "X"))
        assert set(sg.coords_for(tr)) == set(grid.coords_for(tr))
    _match(*outs)


def test_vector_wrappers_on_face_sharded_grid_are_refused():
    """test_sharded_grid_surface.py's vector wrappers on a face x rows
    sharded cubed sphere: each component takes the face-sharded route and
    equals JAX's sharded wrapper within the JAX test's rtol = 1e-12."""
    ds, fc = cubed_sphere_dataset(n=N)
    tds = xtt.from_numpy_dataset(ds)
    grid = xtt.Grid(tds, face_connections=fc)
    mesh = tpar.make_mesh({"f": 2, "ym": 4}, devices=CPU8)
    sg = tpar.ShardedGrid(grid, mesh, {"face": "f", "y": "ym", "yl": "ym"})
    svec = {"X": tpar.shard_gridded(tds["u"], mesh, {"face": "f", "y": "ym"}),
            "Y": tpar.shard_gridded(tds["v"], mesh, {"face": "f", "yl": "ym"})}
    jgrid = xgcm_tpu.Grid(ds, face_connections=fc)
    jmesh = jpar.make_mesh({"f": 2, "ym": 4}, devices=jax.devices()[:8])
    jsg = jpar.ShardedGrid(jgrid, jmesh, {"face": "f", "y": "ym", "yl": "ym"})

    def jax_wrapper(u, v):
        out = jsg.interp_2d_vector({"X": xgcm_tpu.GriddedArray(u, ds["u"].dims),
                                    "Y": xgcm_tpu.GriddedArray(v, ds["v"].dims)},
                                   boundary="fill")
        return {k: o.data for k, o in out.items()}

    with pytest.warns(DeprecationWarning):
        want = jax.jit(jax_wrapper)(ds["u"].data, ds["v"].data)
    with pytest.warns(DeprecationWarning):
        expected = jgrid.interp_2d_vector({"X": ds["u"], "Y": ds["v"]}, boundary="fill")
    with pytest.warns(DeprecationWarning):
        out = sg.interp_2d_vector(svec, boundary="fill")
    for k in expected:
        assert out[k].dims == expected[k].dims
        assert_close(out[k], np.asarray(want[k]), rtol=1e-12)
        assert_close(out[k], expected[k], rtol=1e-12)
