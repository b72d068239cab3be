"""The port's sharded C-grid diagnostics against xgcm_tpu.parallel: every
case of tests/test_sharded_diagnostics.py.  One halo round == the
sequential sharded ops == the single-device Grid ops.

Each test runs the JAX call on conftest's 8-device CPU mesh and the port
on ``make_mesh(..., devices=[torch.device("cpu")] * 8)``, on the same numpy
inputs.  The JAX tests assert ``assert_allclose``'s default rtol = 1e-7;
the port is held to that against JAX, and bit for bit against its own
sequential sharded ops and single-device Grid ops (the same stencils in
the same order).
"""

import jax
import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu.parallel as jpar
import xgcm_tpu_torch as xtt
import xgcm_tpu_torch.parallel as tpar
from tests.torch_parity import assert_bitwise, assert_close
from xgcm_tpu.parallel.diagnostics import sharded_cgrid_diagnostics as jdiag
from xgcm_tpu_torch.parallel.diagnostics import sharded_cgrid_diagnostics as tdiag

CPU8 = [torch.device("cpu")] * 8
NX, NY = 32, 16
RTOL = 1e-7  # numpy.testing.assert_allclose's default, the JAX tests'


def _grid(pkg):
    ds = pkg.Dataset(coords={
        "xc": ("xc", np.arange(NX) + 0.5),
        "xg": ("xg", np.arange(NX) * 1.0),
        "yc": ("yc", np.arange(NY) + 0.5),
        "yg": ("yg", np.arange(NY) * 1.0),
    })
    return pkg.Grid(ds, coords={"X": {"center": "xc", "left": "xg"},
                                "Y": {"center": "yc", "left": "yg"}},
                    autoparse_metadata=False)


def _uv(pkg, lead=()):
    rng = np.random.RandomState(17)
    shape = tuple(3 for _ in lead) + (NY, NX)
    u = pkg.GriddedArray(rng.rand(*shape), (*lead, "yc", "xg"), name="u")
    v = pkg.GriddedArray(rng.rand(*shape), (*lead, "yg", "xc"), name="v")
    return u, v


def _expected(grid, u, v, boundary, fill_value=None):
    kw = dict(boundary=boundary, fill_value=fill_value)
    zeta = grid.diff(v, "X", **kw) - grid.diff(u, "Y", **kw)
    div = grid.diff(u, "X", to="center", **kw) + grid.diff(v, "Y", to="center", **kw)
    u_c = grid.interp(u, "X", to="center", **kw)
    v_c = grid.interp(v, "Y", to="center", **kw)
    return zeta, div, 0.5 * (u_c * u_c + v_c * v_c)


def _run(axes, mapping, boundary, fill_value=None, lead=()):
    size = int(np.prod(list(axes.values())))
    ju, jv = _uv(xgcm_tpu, lead)
    tu, tv = _uv(xtt, lead)
    tg = _grid(xtt)
    j = jdiag(_grid(xgcm_tpu), ju, jv, jpar.make_mesh(axes, devices=jax.devices()[:size]),
              mapping, boundary=boundary, fill_value=fill_value)
    t = tdiag(tg, tu, tv, tpar.make_mesh(axes, devices=CPU8), mapping, boundary=boundary,
              fill_value=fill_value)
    one = _expected(tg, tu, tv, boundary, fill_value)
    for got, want, single in zip(t, j, one):
        assert got.dims == want.dims == single.dims
        assert isinstance(got.data, tpar.ShardedTensor)
        assert_close(got, want, rtol=RTOL)
        assert_bitwise(got, single)
    return t


@pytest.mark.parametrize("boundary", ["periodic", "fill", "extend"])
def test_fused_equals_sequential_x_sharded(boundary):
    _run({"x": 4}, {"xc": "x", "xg": "x"}, boundary, 1.5)


def test_fused_equals_sequential_2d_mesh():
    z, d, k = _run({"x": 4, "y": 2}, {"xc": "x", "xg": "x", "yc": "y", "yg": "y"}, "periodic")
    assert z.data.spec == ("y", "x")


def test_fused_equals_sequential_sharded_ops():
    """One halo round == the chain of ShardedGrid ops it replaces."""
    tu, tv = _uv(xtt)
    tg = _grid(xtt)
    mesh = tpar.make_mesh({"x": 4}, devices=CPU8)
    mapping = {"xc": "x", "xg": "x"}
    sg = tpar.ShardedGrid(tg, mesh, mapping)
    fused = tdiag(tg, tu, tv, mesh, mapping, boundary="periodic")
    kw = dict(boundary="periodic")
    sz = sg.diff(tv, "X", **kw) - sg.diff(tu, "Y", **kw)
    sd = sg.diff(tu, "X", to="center", **kw) + sg.diff(tv, "Y", to="center", **kw)
    u_c = sg.interp(tu, "X", to="center", **kw)
    v_c = sg.interp(tv, "Y", to="center", **kw)
    sk = 0.5 * (u_c * u_c + v_c * v_c)
    for got, exp in zip(fused, (sz, sd, sk)):
        assert_bitwise(got, exp)


def test_batch_dims_ride_along():
    _run({"b": 2, "x": 4}, {"xc": "x", "xg": "x"}, "extend", lead=("t",))


def test_wrong_staggering_rejected():
    tg = _grid(xtt)
    u = xtt.GriddedArray(np.random.rand(NY, NX), ("yc", "xc"), name="u")
    v = xtt.GriddedArray(np.random.rand(NY, NX), ("yg", "xc"), name="v")
    mesh = tpar.make_mesh({"x": 4}, devices=CPU8)
    with pytest.raises(ValueError, match="C-grid staggering"):
        tdiag(tg, u, v, mesh, {"xc": "x", "xg": "x"})


def test_face_grids_are_sent_to_apply_many():
    """Ring halos cannot serve face connections: both packages refuse a
    face grid with the same message, which sends the caller to
    ShardedGrid.apply_many."""
    from tests.datasets import cubed_sphere_dataset

    ds, fc = cubed_sphere_dataset(n=4)
    msgs = []
    for pkg, diag, mesh in ((xgcm_tpu, jdiag, jpar.make_mesh({"f": 2}, devices=jax.devices()[:2])),
                            (xtt, tdiag, tpar.make_mesh({"f": 2}, devices=CPU8))):
        data = ds if pkg is xgcm_tpu else xtt.from_numpy_dataset(ds)
        grid = pkg.Grid(data, face_connections=fc)
        u = pkg.GriddedArray(np.zeros((6, 4, 4)), ("face", "y", "xl"))
        v = pkg.GriddedArray(np.zeros((6, 4, 4)), ("face", "yl", "x"))
        with pytest.raises(NotImplementedError, match="ShardedGrid.apply_many") as info:
            diag(grid, u, v, mesh, {"face": "f"})
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
