"""The port's count_collectives against xgcm_tpu.utils.count_collectives:
the budgets tests/test_inspection.py pins, and the count of every sharded
program of this layer equal to the number of collectives in the jaxpr of
its JAX counterpart (on conftest's 8-device CPU mesh; the port on
``make_mesh(..., devices=[torch.device("cpu")] * 8)``).

Not ported: ``test_static_count_through_scan``.  JAX counts a trace, so a
collective in a ``lax.scan`` body counts once; eager torch has no trace,
and the port counts one run, so a collective in a Python loop counts once
per pass.
"""

import jax
import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu.parallel as jpar
import xgcm_tpu_torch as xtt
import xgcm_tpu_torch.parallel as tpar
import tests.torch_parity  # noqa: F401  (the port's host data on the CPU)
from xgcm_tpu.utils import count_collectives as jcount
from xgcm_tpu_torch.utils import count_collectives as tcount
from xgcm_tpu_torch.parallel.diagnostics import sharded_cgrid_diagnostics as tdiag
from xgcm_tpu.parallel.diagnostics import sharded_cgrid_diagnostics as jdiag

CPU8 = [torch.device("cpu")] * 8


def _cgrid(pkg, nx=16, ny=16):
    ds = pkg.Dataset(coords={
        "xc": ("xc", np.arange(nx) + 0.5, {"axis": "X"}),
        "xg": ("xg", np.arange(nx) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
        "yc": ("yc", np.arange(ny) + 0.5, {"axis": "Y"}),
        "yg": ("yg", np.arange(ny) * 1.0, {"axis": "Y", "c_grid_axis_shift": -0.5}),
    })
    return pkg.Grid(ds)


def _uv(ny=16, nx=16):
    rng = np.random.RandomState(3)
    return rng.rand(ny, nx), rng.rand(ny, nx)


def _setup(pkg, par, axes, mapping):
    size = int(np.prod(list(axes.values())))
    devices = jax.devices()[:size] if par is jpar else CPU8
    mesh = par.make_mesh(axes, devices=devices)
    grid = _cgrid(pkg)
    return grid, mesh, par.ShardedGrid(grid, mesh, mapping)


MAP2 = {"xc": "x", "xg": "x", "yc": "y", "yg": "y"}


def test_single_diff_budget():
    """One sharded diff at boundary_width (1,0) = exactly 1 ppermute."""
    u, v = _uv()
    _, _, sg = _setup(xtt, tpar, {"x": 2, "y": 2}, MAP2)
    vv = xtt.GriddedArray(v, ("yg", "xc"))
    counts = tcount(lambda: sg.diff(vv, "X"))
    assert counts.get("ppermute", 0) == 1, counts
    assert counts["total"] == 1, counts


def test_vorticity_expression_budget():
    """zeta = diff(v,X) - diff(u,Y): two one-sided ring exchanges."""
    u, v = _uv()
    _, _, sg = _setup(xtt, tpar, {"x": 2, "y": 2}, MAP2)
    uu, vv = xtt.GriddedArray(u, ("yc", "xg")), xtt.GriddedArray(v, ("yg", "xc"))
    counts = tcount(lambda: sg.diff(vv, "X") - sg.diff(uu, "Y"))
    assert counts["total"] == 2, counts


def _program(name):
    """(jax function of numpy arrays, port function of the same) for one
    sharded program of the layer."""
    def build(pkg, par):
        GA = pkg.GriddedArray
        if name.startswith("diff_"):
            grid, mesh, sg = _setup(pkg, par, {"x": 2, "y": 2}, MAP2)
            bc = name.split("_", 1)[1]
            return lambda v: sg.diff(GA(v, ("yg", "xc")), "X", boundary=bc).data
        if name.startswith("cumsum_"):
            grid, mesh, sg = _setup(pkg, par, {"x": 4}, {"xc": "x", "xg": "x"})
            bc = name.split("_", 1)[1]
            return lambda v: sg.cumsum(GA(v, ("yc", "xc")), "X", to="left", boundary=bc).data
        if name == "wide_halo":
            grid, mesh, sg = _setup(pkg, par, {"x": 8}, {"xc": "x", "xg": "x"})

            def f(v):
                return sg.apply_as_grid_ufunc(
                    lambda a: a[..., 6:] - a[..., :-6], GA(v, ("yc", "xc")), axis=[("X",)],
                    signature="(X:center)->(X:center)", boundary_width={"X": (3, 3)},
                    boundary="extend").data
            return f
        if name == "diagnostics":
            grid, mesh, sg = _setup(pkg, par, {"x": 2, "y": 2}, MAP2)
            diag = jdiag if pkg is xgcm_tpu else tdiag

            def f(u, v):
                return [o.data for o in diag(grid, GA(u, ("yc", "xg")), GA(v, ("yg", "xc")),
                                             mesh, MAP2, boundary="fill")]
            return f
        if name == "batch_diff":
            grid, mesh, sg = _setup(pkg, par, {"b": 4}, {"yc": "b"})
            return lambda v: sg.diff(GA(v, ("yc", "xc")), "X").data
        raise KeyError(name)

    return build(xgcm_tpu, jpar), build(xtt, tpar)


@pytest.mark.parametrize("name", ["diff_periodic", "diff_fill", "diff_extend",
                                  "diff_extrapolate", "cumsum_periodic", "cumsum_fill",
                                  "cumsum_extend", "wide_halo", "diagnostics", "batch_diff"])
def test_count_equals_jax(name):
    """The port makes a collective wherever the JAX program does: extend
    and extrapolate gather the global edge pair (two all_gathers) even for
    a one-wide halo, a periodic shifted cumsum gathers the last input, and
    the batch route makes none."""
    jf, tf = _program(name)
    u, v = _uv()
    args = (u, v) if name == "diagnostics" else (v,)
    j = jcount(jf, *args)
    t = tcount(tf, *(torch.as_tensor(a) for a in args))
    assert t == j, (t, j)
