"""The port's face-sharded cumsum against xgcm_tpu.

The cases of tests/test_face_sharded_cumsum.py and test_face_sharded_3d.py's
cumsum cases: a ring of four (non-square) faces with straight and reversed
links, faces on one mesh axis and the rows and columns on others, the
shifting and the non-shifting position pairs, bool data (int64 offsets),
and the refusal of axis-swapping connections.  Tolerance: the JAX tests'
own, rtol = 1e-12 against the single-device ``Grid.cumsum``; the port's
per-shard prefix sum runs in XLA's blocked order, so on faces held whole it
equals JAX bit for bit.  The collective budget equals JAX's.
"""

import jax
import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu.parallel as jpar
import xgcm_tpu_torch as xtt
import xgcm_tpu_torch.parallel as tpar
from tests.datasets import cubed_sphere_dataset
from tests.test_torch_face_sharded_ops import sprinkle_nonfinite
from tests.torch_parity import assert_bitwise, assert_close
from xgcm_tpu.utils import count_collectives as jax_count
from xgcm_tpu_torch.utils.inspection import count_collectives as torch_count

CPU8 = [torch.device("cpu")] * 8


def _ring(pkg, ny=8, nx=12, reversed_link=False):
    ds = pkg.Dataset(coords={
        "x": ("x", np.arange(nx) + 0.5, {"axis": "X"}),
        "xl": ("xl", np.arange(nx) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
        "y": ("y", np.arange(ny) + 0.5, {"axis": "Y"}),
        "yl": ("yl", np.arange(ny) * 1.0, {"axis": "Y", "c_grid_axis_shift": -0.5}),
        "face": ("face", np.arange(4)),
    })
    if reversed_link:
        fc = {"face": {0: {"X": (None, (1, "X", False))},
                       1: {"X": ((0, "X", False), (2, "X", True))},
                       2: {"X": ((3, "X", False), (1, "X", True))},
                       3: {"X": (None, (2, "X", False))}}}
    else:
        fc = {"face": {i: {"X": (((i - 1) % 4, "X", False), ((i + 1) % 4, "X", False))}
                       for i in range(4)}}
    return pkg.Grid(ds, face_connections=fc)


def _both(a, dims):
    return xgcm_tpu.GriddedArray(a, dims, name="c"), xtt.GriddedArray(a, dims, name="c")


MESHES = {
    "f4": ({"f": 4}, {}),
    "f4r2": ({"f": 4, "r": 2}, {"interior_mesh_axis": "r"}),
    "f2r2c2": ({"f": 2, "r": 2, "c": 2}, {"interior_mesh_axis": "r", "interior_mesh_axis_x": "c"}),
}


def _spec(kw, dims):
    spec = {"face": "f"}
    if "interior_mesh_axis" in kw:
        spec.update({d: "r" for d in dims if d.startswith("y")})
    if "interior_mesh_axis_x" in kw:
        spec.update({d: "c" for d in dims if d.startswith("x")})
    return spec


@pytest.mark.parametrize("reversed_link", [False, True])
@pytest.mark.parametrize("boundary", ["fill", "extend", "periodic"])
@pytest.mark.parametrize("axis", ["X", "Y"])
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_shifting_cumsum_matches_single_device(mesh_key, axis, boundary, reversed_link):
    """center -> left: the per-shard prefix sum, the totals of the earlier
    shards where the summed dim is sharded, the trim emulation and one
    strip exchange; NaN and infinities on face edges."""
    axes, kw = MESHES[mesh_key]
    rng = np.random.RandomState(3)
    a = sprinkle_nonfinite(rng, rng.rand(4, 8, 12))
    dims = ("face", "y", "x")
    ja, ta = _both(a, dims)
    jg, tg = _ring(xgcm_tpu, reversed_link=reversed_link), _ring(xtt, reversed_link=reversed_link)
    mesh = tpar.make_mesh(axes, devices=CPU8)
    sh = tpar.shard_gridded(ta, mesh, _spec(kw, dims))
    got = tpar.sharded_face_cumsum(tg, sh, axis, mesh, "f", "X", "Y", to="left",
                                   boundary=boundary, **kw)
    want = jg.cumsum(ja, axis, to="left", boundary=boundary)
    assert got.dims == want.dims
    assert_close(got, want, rtol=1e-12)  # test_face_sharded_cumsum.py's rtol
    if mesh_key == "f4":
        assert_bitwise(got, want)  # whole faces: XLA's blocked order


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_noshift_pair(mesh_key):
    """left -> center needs no pad at all."""
    axes, kw = MESHES[mesh_key]
    a = np.random.RandomState(5).rand(4, 8, 12)
    dims = ("face", "y", "xl")
    ja, ta = _both(a, dims)
    mesh = tpar.make_mesh(axes, devices=CPU8)
    got = tpar.sharded_face_cumsum(_ring(xtt), tpar.shard_gridded(ta, mesh, _spec(kw, dims)),
                                   "X", mesh, "f", "X", "Y", to="center", boundary="fill", **kw)
    assert_close(got, _ring(xgcm_tpu).cumsum(ja, "X", to="center", boundary="fill"), rtol=1e-12)


def test_interior_sharded_bool():
    """Bool cumsum with the summed dim sharded: the offsets keep the
    cumsum's int64, as JAX's do."""
    a = np.random.RandomState(7).rand(4, 8, 12) > 0.4
    ja, ta = _both(a, ("face", "y", "x"))
    mesh = tpar.make_mesh({"f": 4, "r": 2}, devices=CPU8)
    sh = tpar.shard_gridded(ta, mesh, {"face": "f", "y": "r"})
    got = tpar.sharded_face_cumsum(_ring(xtt), sh, "Y", mesh, "f", "X", "Y", to="left",
                                   boundary="fill", interior_mesh_axis="r")
    assert_bitwise(got, _ring(xgcm_tpu).cumsum(ja, "Y", to="left", boundary="fill"))


@pytest.mark.parametrize("mesh", ["f4", "3d"])
def test_through_sharded_grid(mesh):
    axes, spec = {"f4": ({"f": 4}, {"face": "f"}),
                  "3d": ({"f": 2, "r": 2, "c": 2},
                         {"face": "f", "y": "r", "yl": "r", "x": "c", "xl": "c"})}[mesh]
    a = np.random.RandomState(3).rand(4, 8, 12)
    ja, ta = _both(a, ("face", "y", "x"))
    sg = tpar.ShardedGrid(_ring(xtt), tpar.make_mesh(axes, devices=CPU8), spec)
    got = sg.cumsum(sg.shard(ta), "X", to="left", boundary="fill")
    assert_close(got, _ring(xgcm_tpu).cumsum(ja, "X", to="left", boundary="fill"), rtol=1e-12)
    # and the shard-level entry point dispatches the face-connected axis
    got = tpar.sharded_cumsum(_ring(xtt), sg.shard(ta), "X", sg.mesh, spec, to="left",
                              boundary="fill")
    assert_close(got, _ring(xgcm_tpu).cumsum(ja, "X", to="left", boundary="fill"), rtol=1e-12)


def test_matches_jax_sharded_cumsum():
    """Against xgcm_tpu.parallel.sharded_face_cumsum itself (under
    jax.jit) on the face x rows x cols mesh."""
    a = np.random.RandomState(3).rand(4, 8, 12)
    jmesh = jpar.make_mesh({"f": 2, "r": 2, "c": 2}, devices=jax.devices()[:8])
    kw = dict(to="left", boundary="fill", interior_mesh_axis="r", interior_mesh_axis_x="c")
    jg = _ring(xgcm_tpu)
    want = jax.jit(lambda d: jpar.sharded_face_cumsum(
        jg, xgcm_tpu.GriddedArray(d, ("face", "y", "x")), "Y", jmesh, "f", "X", "Y", **kw).data)(a)
    mesh = tpar.make_mesh({"f": 2, "r": 2, "c": 2}, devices=CPU8)
    ta = tpar.shard_gridded(xtt.GriddedArray(a, ("face", "y", "x")), mesh,
                            {"face": "f", "y": "r", "x": "c"})
    got = tpar.sharded_face_cumsum(_ring(xtt), ta, "Y", mesh, "f", "X", "Y", **kw)
    assert_close(got, np.asarray(want), rtol=1e-12)


def test_swap_connections_raise():
    ds, fc = cubed_sphere_dataset(n=8)
    grid = xtt.Grid(xtt.from_numpy_dataset(ds), face_connections=fc)
    mesh = tpar.make_mesh({"f": 6}, devices=CPU8)
    da = xtt.GriddedArray(np.random.rand(6, 8, 8), ("face", "y", "x"))
    with pytest.raises(NotImplementedError, match="swap"):
        tpar.sharded_face_cumsum(grid, tpar.shard_gridded(da, mesh, {"face": "f"}), "X", mesh,
                                 "f", "X", "Y", to="left", boundary="fill")


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_collective_budget_matches_jax(mesh_key):
    """JAX's budget: one strip all_gather (a psum first where in-face dims
    are sharded), the totals' all_gather where the summed dim is, and the
    ring exchange of the pre-pad; no all-to-all, no face gathered."""
    axes, kw = MESHES[mesh_key]
    a = np.random.RandomState(3).rand(4, 8, 12)
    n = int(np.prod(list(axes.values())))
    jmesh = jpar.make_mesh(axes, devices=jax.devices()[:n])
    jg, tg = _ring(xgcm_tpu), _ring(xtt)
    j = jax_count(lambda d: jpar.sharded_face_cumsum(
        jg, xgcm_tpu.GriddedArray(d, ("face", "y", "x")), "X", jmesh, "f", "X", "Y", to="left",
        boundary="fill", **kw).data, a)
    mesh = tpar.make_mesh(axes, devices=CPU8)
    ta = xtt.GriddedArray(a, ("face", "y", "x"))
    t = torch_count(lambda: tpar.sharded_face_cumsum(tg, ta, "X", mesh, "f", "X", "Y",
                                                     to="left", boundary="fill", **kw))
    assert t == {("psum" if "psum" in k else k): v for k, v in j.items()}
    assert "all_to_all" not in t
