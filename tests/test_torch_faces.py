"""Face-connected grids of the port against xgcm_tpu, on the CPU.

The same numpy inputs go through both packages: Grid construction and its
errors, the generic halo assembly (``core.padding.pad``), the fused face
path (kernel E's plain version on the CPU) for every op, axis and boundary,
vector components with ``other_component``, the 2-D vector wrappers, and
the fuzz cases of ``tests/test_fuzz_faces.py`` with NaN and infinities on
the face edges.  Each op is a single IEEE operation on the same operands in
both packages, so f64 and f32 results must be equal value for value: same
NaN footprint, +0.0 and -0.0 counted equal (JAX's strip select turns a
selected -0.0 into +0.0; the port's plain slices keep it).  The port's fused
path must also equal its own generic engine the same way.
"""

import warnings

import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu_torch as xtt
from tests.datasets import cubed_sphere_dataset
from tests.torch_parity import assert_bitwise, to_numpy
from xgcm_tpu.core.padding import pad as jax_pad
from xgcm_tpu_torch.core import gridops
from xgcm_tpu_torch.core.padding import BOUNDARY_TO_PAD_MODE, _pad_axis, pad
from xgcm_tpu_torch.core.topology import basic_edge_line
from xgcm_tpu_torch.ops import fused

OPS = ("diff", "interp", "min", "max")
BCS = ("periodic", "fill", "extend", "extrapolate")


def _generic(package, op, to="left", frm="center"):
    return getattr(package, f"{op}_{frm}_to_{to}")


def _cubed(n=6, **kwargs):
    """(JAX grid, port grid, JAX dataset) of the cubed-sphere fixture."""
    ds, fc = cubed_sphere_dataset(n=n)
    kwargs.setdefault("periodic", False)
    g_j = xgcm_tpu.Grid(ds, face_connections=fc, **kwargs)
    g_t = xtt.Grid(xtt.from_numpy_dataset(ds), face_connections=fc, **kwargs)
    return g_j, g_t, ds


def _pair(a, dims, name=None):
    """The same numpy values as a JAX and a port GriddedArray."""
    a = np.ascontiguousarray(a)
    return (xgcm_tpu.GriddedArray(a, dims, name=name),
            xtt.GriddedArray(torch.as_tensor(a), dims, name=name))


def _check(r_t, r_j):
    assert r_t.dims == r_j.dims
    assert_bitwise(r_t, r_j)


# ---------------------------------------------------------------------------
# fused == generic == JAX (tests/test_fused_face_equivalence.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("boundary", BCS)
@pytest.mark.parametrize("axis", ["X", "Y"])
@pytest.mark.parametrize("op", OPS)
def test_face_ops_match_jax_and_generic(op, axis, boundary, dtype):
    g_j, g_t, _ = _cubed()
    a_j, a_t = _pair(np.random.RandomState(0).rand(6, 6, 6).astype(dtype), ("face", "y", "x"))
    kw = dict(to="left", boundary=boundary, fill_value=2.5)
    r_t = getattr(g_t, op)(a_t, axis, **kw)
    _check(r_t, getattr(g_j, op)(a_j, axis, **kw))
    generic = _generic(gridops, op)(g_t, a_t, axis=[(axis,)], boundary=boundary, fill_value=2.5)
    _check(r_t, generic)


def test_face_leading_batch_dim():
    g_j, g_t, _ = _cubed(n=5)
    a_j, a_t = _pair(np.random.RandomState(1).rand(3, 6, 5, 5), ("time", "face", "y", "x"))
    r_t = g_t.diff(a_t, "X", boundary="fill")
    assert r_t.dims == ("time", "face", "y", "xl")
    _check(r_t, g_j.diff(a_j, "X", boundary="fill"))
    _check(r_t, gridops.diff_center_to_left(g_t, a_t, axis=[("X",)], boundary="fill"))


def test_face_odd_dim_order():
    g_j, g_t, _ = _cubed(n=5)
    a_j, a_t = _pair(np.random.RandomState(2).rand(5, 6, 5), ("y", "face", "x"))
    r_t = g_t.diff(a_t, "X", boundary="extend")
    assert r_t.dims == ("y", "face", "xl")
    _check(r_t, g_j.diff(a_j, "X", boundary="extend"))
    _check(r_t, gridops.diff_center_to_left(g_t, a_t, axis=[("X",)], boundary="extend"))


def test_extra_kwargs_force_generic_engine(monkeypatch):
    g_j, g_t, _ = _cubed(n=5)
    a_j, a_t = _pair(np.random.RandomState(3).rand(6, 5, 5), ("face", "y", "x"))
    fast = g_t.diff(a_t, "X", boundary="fill")

    def refuse(*args, **kwargs):
        raise AssertionError("the fused face path ran")

    monkeypatch.setattr(fused, "fused_face_shift_op", refuse)
    generic = g_t.diff(a_t, "X", boundary="fill", dask="forbidden")
    _check(generic, fast)
    _check(generic, g_j.diff(a_j, "X", boundary="fill", dask="forbidden"))


def test_scalar_with_other_component():
    g_j, g_t, _ = _cubed(n=5)
    rng = np.random.RandomState(4)
    a_j, a_t = _pair(rng.rand(6, 5, 5), ("face", "y", "x"))
    o_j, o_t = _pair(rng.rand(6, 5, 5), ("face", "yl", "x"))
    plain = g_t.diff(a_t, "X", boundary="fill")
    for extra in ({}, {"dask": "forbidden"}):
        got = g_t.diff(a_t, "X", boundary="fill", other_component={"Y": o_t}, **extra)
        _check(got, plain)
        _check(got, g_j.diff(a_j, "X", boundary="fill", other_component={"Y": o_j}, **extra))


@pytest.mark.parametrize("boundary", BCS)
@pytest.mark.parametrize("op", ["diff", "interp"])
def test_vector_fused_matches_jax_and_generic(op, boundary):
    g_j, g_t, _ = _cubed()
    rng = np.random.RandomState(5)
    u_j, u_t = _pair(rng.rand(6, 6, 6), ("face", "y", "x"), "u")
    v_j, v_t = _pair(rng.rand(6, 6, 6), ("face", "y", "x"), "v")
    for vec_axis, (arr_j, arr_t), (par_j, par_t), ax in [
        ("X", (u_j, u_t), (v_j, v_t), "X"),
        ("Y", (v_j, v_t), (u_j, u_t), "Y"),
        ("X", (u_j, u_t), (v_j, v_t), "Y"),
        ("Y", (v_j, v_t), (u_j, u_t), "X"),
    ]:
        other = "Y" if vec_axis == "X" else "X"
        kw = dict(to="left", boundary=boundary)
        r_t = getattr(g_t, op)({vec_axis: arr_t}, ax, other_component={other: par_t}, **kw)
        r_j = getattr(g_j, op)({vec_axis: arr_j}, ax, other_component={other: par_j}, **kw)
        _check(r_t, r_j)
        generic = _generic(gridops, op)(g_t, {vec_axis: arr_t}, axis=[(ax,)],
                                        boundary=boundary, other_component={other: par_t})
        _check(r_t, generic)


def test_vector_2d_wrappers_match_jax_and_generic():
    g_j, g_t, _ = _cubed()
    rng = np.random.RandomState(9)
    u_j, u_t = _pair(rng.rand(6, 6, 6), ("face", "y", "xl"), "u")
    v_j, v_t = _pair(rng.rand(6, 6, 6), ("face", "yl", "x"), "v")
    for name in ("diff_2d_vector", "interp_2d_vector"):
        with pytest.warns(DeprecationWarning):
            out_t = getattr(g_t, name)({"X": u_t, "Y": v_t}, boundary="fill")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            out_j = getattr(g_j, name)({"X": u_j, "Y": v_j}, boundary="fill")
        op = name.split("_")[0]
        exp_u = _generic(gridops, op, "center", "left")(
            g_t, {"X": u_t}, axis=[("X",)], boundary="fill", other_component={"Y": v_t})
        exp_v = _generic(gridops, op, "center", "left")(
            g_t, {"Y": v_t}, axis=[("Y",)], boundary="fill", other_component={"X": u_t})
        for k, exp in (("X", exp_u), ("Y", exp_v)):
            _check(out_t[k], out_j[k])
            _check(out_t[k], exp)


# ---------------------------------------------------------------------------
# construction, halos and rotations (tests/test_faceconnections.py)
# ---------------------------------------------------------------------------

N = 8
FC_XX = {"face": {0: {"X": (None, (1, "X", False))}, 1: {"X": ((0, "X", False), None)}}}
FC_XY = {"face": {0: {"X": (None, (1, "Y", False))}, 1: {"Y": ((0, "X", False), None)}}}


def _two_face_ds():
    rng = np.random.RandomState(10)
    return xgcm_tpu.Dataset(
        coords={
            "x": ("x", np.arange(N, dtype=float), {"axis": "X"}),
            "xl": ("xl", np.arange(N) - 0.5, {"axis": "X", "c_grid_axis_shift": -0.5}),
            "y": ("y", np.arange(N, dtype=float), {"axis": "Y"}),
            "yl": ("yl", np.arange(N) - 0.5, {"axis": "Y", "c_grid_axis_shift": -0.5}),
            "face": ("face", np.arange(2)),
        },
        data_vars={
            "data_c": (("face", "y", "x"), rng.rand(2, N, N)),
            "u": (("face", "xl", "y"), rng.rand(2, N, N)),
            "v": (("face", "x", "yl"), rng.rand(2, N, N)),
        },
    )


def _two_face_grids(fc, **kwargs):
    ds = _two_face_ds()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return (xgcm_tpu.Grid(ds, face_connections=fc, **kwargs),
                xtt.Grid(xtt.from_numpy_dataset(ds), face_connections=fc, **kwargs), ds)


def _links(grid):
    """Each axis's attached links with the Axis objects named."""
    return {
        name: (ax._facedim, {
            f: tuple(None if c is None else (c[0], c[1].name, c[2]) for c in lr)
            for f, lr in (ax._face_connections or {}).items()
        })
        for name, ax in grid.axes.items()
    }


@pytest.mark.parametrize("fc", [FC_XX, FC_XY], ids=["x_to_x", "x_to_y"])
def test_create_connected_grid(fc):
    g_j, g_t, _ = _two_face_grids(fc)
    assert _links(g_t) == _links(g_j)
    assert g_t._facedim == "face" and g_t._face_connections is fc
    source_axis = g_t.axes["Y" if fc is FC_XY else "X"]
    assert g_t.axes["X"]._face_connections[0][1][1] is source_axis


@pytest.mark.parametrize(
    "fc, error, match",
    [
        ({"notface": FC_XX["face"]}, ValueError, "does not exist in the dataset"),
        ({"face": {0: {"X": (None, (1, "X", False))}, 1: {"X": ((0, "X", True), None)}}},
         ValueError, "Face link mismatch"),
        ({"face": {0: {"X": (None, (1, "X", False))}}}, KeyError, "Couldn't find a face link"),
        ({"face": {0: {"X": (None, (5, "X", False))}, 5: {"X": ((0, "X", False), None)}}},
         IndexError, "not a valid index"),
        ({"face": {0: {"X": (None, (1, "Z", False))}, 1: {"Z": ((0, "X", False), None)}}},
         KeyError, "not a valid axis"),
        ({"face": FC_XX["face"], "other": {}}, ValueError, "Only one face dimension"),
    ],
    ids=["wrong_facedim", "inconsistent_link", "missing_link", "bad_index", "bad_axis",
         "two_facedims"],
)
def test_bad_connections_raise_as_jax(fc, error, match):
    ds = _two_face_ds()
    with pytest.raises(error, match=match):
        xgcm_tpu.Grid(ds, face_connections=fc)
    with pytest.raises(error, match=match):
        xtt.Grid(xtt.from_numpy_dataset(ds), face_connections=fc)


@pytest.mark.parametrize("fc", [FC_XX, FC_XY], ids=["x_to_x", "x_to_y_rotated"])
@pytest.mark.parametrize("op", ["diff", "interp"])
def test_two_face_ops_match_jax(fc, op):
    g_j, g_t, ds = _two_face_grids(fc, periodic=False)
    a_j, a_t = _pair(np.asarray(ds["data_c"].data), ("face", "y", "x"))
    for axis in ("X", "Y"):
        _check(getattr(g_t, op)(a_t, axis, boundary="fill"),
               getattr(g_j, op)(a_j, axis, boundary="fill"))
    c = np.asarray(ds["data_c"].data)
    if fc is FC_XX and op == "diff":
        # face 1's left halo is face 0's last column
        d = to_numpy(g_t.diff(a_t, "X", boundary="fill"))
        np.testing.assert_array_equal(d[1, :, 0], c[1, :, 0] - c[0, :, -1])


@pytest.mark.parametrize("boundary", ["periodic", "fill"])
def test_tangential_sign_flip(boundary):
    g_j, g_t, ds = _two_face_grids(FC_XY, boundary=boundary, fill_value=1, periodic=False)
    u_np = np.zeros((2, N, N)) + np.array([-2.0, -1.0])[:, None, None]
    v_np = np.ones((2, N, N))
    u_j, u_t = _pair(u_np, ("face", "xl", "y"))
    v_j, v_t = _pair(v_np, ("face", "x", "yl"))
    out = g_t.interp({"Y": v_t}, "X", other_component={"X": u_t})
    np.testing.assert_array_equal(to_numpy(out), 1.0)
    _check(out, g_j.interp({"Y": v_j}, "X", other_component={"X": u_j}))


def test_vector_2d_on_rotated_faces_match_jax():
    g_j, g_t, ds = _two_face_grids(FC_XY)
    u_j, u_t = _pair(np.asarray(ds["u"].data), ("face", "xl", "y"))
    v_j, v_t = _pair(np.asarray(ds["v"].data), ("face", "x", "yl"))
    u, v = np.asarray(ds["u"].data), np.asarray(ds["v"].data)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for name in ("interp_2d_vector", "diff_2d_vector"):
            kw = dict(to="center", boundary="fill", fill_value=100)
            out_t = getattr(g_t, name)({"X": u_t, "Y": v_t}, **kw)
            out_j = getattr(g_j, name)({"X": u_j, "Y": v_j}, **kw)
            for k in ("X", "Y"):
                _check(out_t[k], out_j[k])
        # the last point of u picks up the rotated partner component
        d = to_numpy(out_t["X"])
        np.testing.assert_array_equal(d[0, -1, :], -u[0, -1, :] + v[1, ::-1, 0])


def test_vector_op_errors_match_jax():
    g_j, g_t, ds = _two_face_grids(FC_XY)
    u_j, u_t = _pair(np.asarray(ds["u"].data), ("face", "xl", "y"))
    v_j, v_t = _pair(np.asarray(ds["v"].data), ("face", "x", "yl"))
    for g, u, v in ((g_j, u_j, v_j), (g_t, u_t, v_t)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with pytest.raises(NotImplementedError):
                g.interp_2d_vector({"X": v, "Y": u}, to="left", boundary="fill")
            with pytest.raises(NotImplementedError, match="defined at center"):
                g.interp_2d_vector({"X": xtt.GriddedArray(torch.zeros(2, N, N), ("face", "x", "y"))
                                    if g is g_t else
                                    xgcm_tpu.GriddedArray(np.zeros((2, N, N)), ("face", "x", "y")),
                                    "Y": v})
            with pytest.raises(ValueError, match="two key/value pairs"):
                g.diff_2d_vector({"X": u})
        with pytest.raises(ValueError, match="requires `other_component` input"):
            g.diff({"X": u}, "X", other_component=None)


def test_cubed_sphere_face_index_diff():
    g_j, g_t, _ = _cubed(n=4, periodic=None)
    f = np.broadcast_to(np.arange(6.0)[:, None, None], (6, 4, 4)).copy()
    a_j, a_t = _pair(f, ("face", "y", "x"))
    dx, dy = to_numpy(g_t.diff(a_t, "X")), to_numpy(g_t.diff(a_t, "Y"))
    np.testing.assert_array_equal(dx[:, 0, 0], [-3, 1, 1, 1, 1, 2])
    np.testing.assert_array_equal(dy[:, 0, -1], [-4, -3, -2, -1, 2, 5])
    _check(g_t.diff(a_t, "X"), g_j.diff(a_j, "X"))
    _check(g_t.diff(a_t, "Y"), g_j.diff(a_j, "Y"))


def test_halo_contents_every_edge():
    g_j, g_t, _ = _cubed(n=4, periodic=None)
    ds, fc = cubed_sphere_dataset(n=4)
    f = np.broadcast_to(np.arange(6.0)[:, None, None], (6, 4, 4)).copy()
    a_j, a_t = _pair(f, ("face", "y", "x"))
    kw = dict(boundary={"X": "fill", "Y": "fill"}, fill_value=np.nan)
    p_t = pad(a_t, g_t, {"X": (1, 1), "Y": (1, 1)}, **kw)
    _check(p_t, jax_pad(a_j, g_j, {"X": (1, 1), "Y": (1, 1)}, **kw))
    p = to_numpy(p_t)
    for face in range(6):
        (left_x, right_x), (down_y, up_y) = fc["face"][face]["X"], fc["face"][face]["Y"]
        np.testing.assert_array_equal(p[face, 1:-1, 0], left_x[0])
        np.testing.assert_array_equal(p[face, 1:-1, -1], right_x[0])
        np.testing.assert_array_equal(p[face, 0, 1:-1], down_y[0])
        np.testing.assert_array_equal(p[face, -1, 1:-1], up_y[0])


@pytest.mark.parametrize("widths", [{"X": (2, 2)}, {"X": (0, 2)}, {"X": (2, 1), "Y": (1, 2)}])
@pytest.mark.parametrize("fc", [FC_XX, FC_XY], ids=["x_to_x", "x_to_y"])
def test_wide_halos_match_jax(fc, widths):
    g_j, g_t, _ = _two_face_grids(fc, periodic=False)
    f = np.arange(2 * N * N, dtype=float).reshape(2, N, N)
    a_j, a_t = _pair(f, ("face", "y", "x"))
    p_t = pad(a_t, g_t, widths, boundary="fill", fill_value=-1.0)
    _check(p_t, jax_pad(a_j, g_j, widths, boundary="fill", fill_value=-1.0))
    if fc is FC_XY and widths == {"X": (0, 2)}:
        p = to_numpy(p_t)
        np.testing.assert_array_equal(p[0, :, N], f[1, 0, ::-1])
        np.testing.assert_array_equal(p[0, :, N + 1], f[1, 1, ::-1])


def test_wide_halo_custom_ufunc_takes_generic_engine():
    """A width-2 grid ufunc on the cubed sphere: the generic engine's halos
    of a vector component (partner strips, signs) equal the JAX package's."""
    g_j, g_t, _ = _cubed(n=5)
    rng = np.random.RandomState(11)
    u_j, u_t = _pair(rng.rand(6, 5, 5), ("face", "y", "x"))
    v_j, v_t = _pair(rng.rand(6, 5, 5), ("face", "y", "x"))

    def wide(a):
        return a[..., 2:] - a[..., :-2]

    for g, u, v in ((g_j, u_j, v_j), (g_t, u_t, v_t)):
        out = g.apply_as_grid_ufunc(wide, {"Y": v}, axis=[("X",)], signature="(X:center)->(X:center)",
                                    boundary_width={"X": (1, 1)}, other_component={"X": u})
        if g is g_j:
            r_j = out
        else:
            r_t = out
    _check(r_t, r_j)


def test_z_op_on_face_connected_grid():
    n, nz = 4, 5
    ds, fc = cubed_sphere_dataset(n=n)
    ds2 = xgcm_tpu.Dataset(coords={
        **ds.coords,
        "zc": ("zc", np.arange(nz) + 0.5, {"axis": "Z"}),
        "zl": ("zl", np.arange(nz) * 1.0, {"axis": "Z", "c_grid_axis_shift": -0.5}),
    })
    g_j = xgcm_tpu.Grid(ds2, face_connections=fc, periodic=False)
    g_t = xtt.Grid(xtt.from_numpy_dataset(ds2), face_connections=fc, periodic=False)
    a = np.random.RandomState(12).rand(6, nz, n, n)
    a_j, a_t = _pair(a, ("face", "zc", "y", "x"))
    out = g_t.diff(a_t, "Z", boundary="extend")
    assert out.dims == ("face", "zl", "y", "x")
    ap = np.concatenate([a[:, :1], a], axis=1)
    np.testing.assert_array_equal(to_numpy(out), ap[:, 1:] - ap[:, :-1])
    _check(out, g_j.diff(a_j, "Z", boundary="extend"))


def test_face_dim_without_coordinate():
    n = 4
    coords = {
        "x": ("x", np.arange(n, dtype=float), {"axis": "X"}),
        "xl": ("xl", np.arange(n) - 0.5, {"axis": "X", "c_grid_axis_shift": -0.5}),
        "y": ("y", np.arange(n, dtype=float), {"axis": "Y"}),
        "yl": ("yl", np.arange(n) - 0.5, {"axis": "Y", "c_grid_axis_shift": -0.5}),
    }
    g_j = xgcm_tpu.Grid(xgcm_tpu.Dataset(coords=coords, dims={"face": 2}),
                        face_connections=FC_XX, periodic=False)
    g_t = xtt.Grid(xtt.Dataset(coords=coords, dims={"face": 2}), face_connections=FC_XX,
                   periodic=False)
    a = np.random.RandomState(13).rand(2, n, n)
    a_j, a_t = _pair(a, ("face", "y", "x"))
    d = g_t.diff(a_t, "X", boundary="fill")
    np.testing.assert_array_equal(to_numpy(d)[1, :, 0], a[1, :, 0] - a[0, :, -1])
    _check(d, g_j.diff(a_j, "X", boundary="fill"))


def test_vector_interp_on_cubed_sphere_matches_jax():
    g_j, g_t, ds = _cubed(n=4)
    u_j, u_t = _pair(np.asarray(ds["u"].data), ("face", "y", "xl"))
    v_j, v_t = _pair(np.asarray(ds["v"].data), ("face", "yl", "x"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        kw = dict(to="center", boundary="fill", fill_value=0.0)
        out_t = g_t.interp_2d_vector({"X": u_t, "Y": v_t}, **kw)
        out_j = g_j.interp_2d_vector({"X": u_j, "Y": v_j}, **kw)
    for k in ("X", "Y"):
        assert out_t[k].dims == ("face", "y", "x")
        _check(out_t[k], out_j[k])


def test_grad_through_cubed_sphere_diff_matches_jax():
    """Autograd through the fused face path (kernel E's plain version and
    the strip gather) equals jax.grad; the gradient sums the same terms in
    another order, so it is held to 1e-12 relative, not bitwise."""
    import jax
    import jax.numpy as jnp

    g_j, g_t, _ = _cubed(n=4)
    a = np.random.RandomState(14).rand(6, 4, 4)

    def loss_j(x):
        return jnp.sum(g_j.diff(xgcm_tpu.GriddedArray(x, ("face", "y", "x")), "X",
                                boundary="fill").data ** 2)

    x = torch.as_tensor(a).requires_grad_()
    (g_t.diff(xtt.GriddedArray(x, ("face", "y", "x")), "X", boundary="fill").data ** 2
     ).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jax.grad(loss_j)(jnp.asarray(a))),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("nx", [1, 2, 5])
@pytest.mark.parametrize("ny", [1, 2, 5])
@pytest.mark.parametrize("side", [0, 1, 2, 3])
@pytest.mark.parametrize("boundary", BCS)
def test_basic_edge_line_is_the_pads_one_wide_line(boundary, side, ny, nx):
    """The halo line of an unconnected edge on both routes of kernel E
    (``core/topology.basic_edge_line``) is the line ``_pad_axis`` pads one
    wide beyond the side, on both axes, before and after, at every length;
    where the pad refuses (extrapolating before a one-long axis), so does
    the line."""
    b = torch.randn((3, ny, nx), generator=torch.Generator().manual_seed(side),
                    dtype=torch.float64)
    axis = 2 if side < 2 else 1
    before = side % 2 == 0
    try:
        want = _pad_axis(b, axis, (1, 0) if before else (0, 1), BOUNDARY_TO_PAD_MODE[boundary],
                         2.5).select(axis, 0 if before else -1)
    except RuntimeError:
        with pytest.raises(RuntimeError):
            basic_edge_line(b, side, boundary, 2.5)
        return
    got = basic_edge_line(b, side, boundary, 2.5)
    assert got.shape == want.shape and torch.equal(got, want)


# ---------------------------------------------------------------------------
# routing of the fused face path
# ---------------------------------------------------------------------------


def test_face_path_runs_kernel_e_wrapper_and_caches_the_plan(monkeypatch):
    g_j, g_t, _ = _cubed()
    calls = []
    real = fused.face_shift

    def counting(*args, **kwargs):
        calls.append(args[2:])
        return real(*args, **kwargs)

    monkeypatch.setattr(fused, "face_shift", counting)
    a_j, a_t = _pair(np.random.RandomState(15).rand(6, 6, 6), ("face", "y", "x"))
    for axis in ("X", "Y", "X"):
        g_t.diff(a_t, axis)
    assert calls == [("diff", "left", True), ("diff", "left", False), ("diff", "left", True)]
    assert list(g_t._face_plans) == [("X", "Y", torch.device("cpu"), 6)]


def test_kernel_errors_are_not_swallowed(monkeypatch):
    """A failing kernel raises through the Grid op: nothing quietly turns
    it into the generic engine."""
    _, g_t, _ = _cubed()

    def broken(*args, **kwargs):
        raise ValueError("kernel failed")

    monkeypatch.setattr(fused, "face_shift", broken)
    a = xtt.GriddedArray(torch.rand(6, 6, 6, dtype=torch.float64), ("face", "y", "x"))
    with pytest.raises(ValueError, match="kernel failed"):
        g_t.diff(a, "X")


def test_non_square_faces_take_generic_engine(monkeypatch):
    ds = xgcm_tpu.Dataset(coords={
        "x": ("x", np.arange(6) + 0.5, {"axis": "X"}),
        "xl": ("xl", np.arange(6.0), {"axis": "X", "c_grid_axis_shift": -0.5}),
        "y": ("y", np.arange(4) + 0.5, {"axis": "Y"}),
        "yl": ("yl", np.arange(4.0), {"axis": "Y", "c_grid_axis_shift": -0.5}),
        "face": ("face", np.arange(2)),
    })
    g_j = xgcm_tpu.Grid(ds, face_connections=FC_XX, periodic=False)
    g_t = xtt.Grid(xtt.from_numpy_dataset(ds), face_connections=FC_XX, periodic=False)

    def refuse(*args, **kwargs):
        raise AssertionError("kernel E ran on non-square faces")

    monkeypatch.setattr(fused, "face_shift", refuse)
    a_j, a_t = _pair(np.random.RandomState(16).rand(2, 4, 6), ("face", "y", "x"))
    for axis in ("X", "Y"):
        _check(g_t.diff(a_t, axis), g_j.diff(a_j, axis))


def test_integer_input_takes_generic_engine():
    g_j, g_t, _ = _cubed(n=4)
    a = np.random.RandomState(17).randint(-9, 9, size=(6, 4, 4)).astype(np.int64)
    a_j, a_t = _pair(a, ("face", "y", "x"))
    for op in ("diff", "interp", "max"):
        r_t = getattr(g_t, op)(a_t, "Y", boundary="extend")
        assert r_t.dtype == (torch.float64 if op == "interp" else torch.int64)
        _check(r_t, getattr(g_j, op)(a_j, "Y", boundary="extend"))


# ---------------------------------------------------------------------------
# fuzz (tests/test_fuzz_faces.py)
# ---------------------------------------------------------------------------


def _sprinkle_nonfinite(rng, a):
    """NaN and +-inf at random cells, most of them on face edges (the halo
    sources)."""
    flat = a.reshape(-1, *a.shape[-2:])
    ny, nx = a.shape[-2:]
    for _ in range(int(rng.randint(1, 5))):
        b = rng.randint(flat.shape[0])
        val = float(rng.choice([np.nan, np.inf, -np.inf]))
        if rng.rand() < 0.7:
            side = rng.randint(4)
            if side == 0:
                flat[b, rng.randint(ny), 0] = val
            elif side == 1:
                flat[b, rng.randint(ny), nx - 1] = val
            elif side == 2:
                flat[b, 0, rng.randint(nx)] = val
            else:
                flat[b, ny - 1, rng.randint(nx)] = val
        else:
            flat[b, rng.randint(ny), rng.randint(nx)] = val
    return a


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_cubed_sphere_dispatch(seed):
    rng = np.random.RandomState(200 + seed)
    n = int(rng.choice([4, 5, 6, 8]))
    g_j, g_t, _ = _cubed(n=n)
    op = str(rng.choice(list(OPS)))
    axis = str(rng.choice(["X", "Y"]))
    boundary = str(rng.choice(list(BCS)))
    fill = float(rng.randn())
    dims, shape = ["face", "y", "x"], [6, n, n]
    if rng.rand() < 0.5:
        dims, shape = ["time"] + dims, [3] + shape
    order = rng.permutation(len(dims))
    dims_p = tuple(np.array(dims)[order])
    a_j, a_t = _pair(rng.rand(*np.array(shape)[order]), dims_p)
    kw = dict(to="left", boundary=boundary, fill_value=fill)
    r_t = getattr(g_t, op)(a_t, axis, **kw)
    _check(r_t, getattr(g_j, op)(a_j, axis, **kw))
    _check(r_t, _generic(gridops, op)(g_t, a_t, axis=[(axis,)], boundary=boundary,
                                      fill_value=fill))


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_cubed_sphere_vector_dispatch(seed):
    rng = np.random.RandomState(300 + seed)
    n = int(rng.choice([4, 6]))
    g_j, g_t, _ = _cubed(n=n)
    op = str(rng.choice(["diff", "interp"]))
    axis = str(rng.choice(["X", "Y"]))
    boundary = str(rng.choice(["fill", "extend", "periodic"]))
    vec_axis = str(rng.choice(["X", "Y"]))
    other = "Y" if vec_axis == "X" else "X"
    a_j, a_t = _pair(rng.rand(6, n, n), ("face", "y", "x"), "a")
    b_j, b_t = _pair(rng.rand(6, n, n), ("face", "y", "x"), "b")
    kw = dict(to="left", boundary=boundary)
    r_t = getattr(g_t, op)({vec_axis: a_t}, axis, other_component={other: b_t}, **kw)
    _check(r_t, getattr(g_j, op)({vec_axis: a_j}, axis, other_component={other: b_j}, **kw))


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_llc_dispatch(seed):
    from xgcm_tpu.grids import llc_grid as jax_llc

    rng = np.random.RandomState(400 + seed)
    n = int(rng.choice([4, 8]))
    _, g_j = jax_llc(n=n)
    _, g_t = xtt.grids.llc_grid(n=n)
    op = str(rng.choice(list(OPS)))
    axis = str(rng.choice(["X", "Y"]))
    boundary = str(rng.choice(["fill", "extend"]))
    a_j, a_t = _pair(rng.rand(13, n, n), ("face", "y", "x"))
    r_t = getattr(g_t, op)(a_t, axis, to="left", boundary=boundary)
    _check(r_t, getattr(g_j, op)(a_j, axis, to="left", boundary=boundary))
    _check(r_t, _generic(gridops, op)(g_t, a_t, axis=[(axis,)], boundary=boundary))


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_cubed_sphere_nonfinite(seed):
    rng = np.random.RandomState(500 + seed)
    n = int(rng.choice([6, 8, 144, 160]))
    g_j, g_t, _ = _cubed(n=n)
    op = str(rng.choice(["diff", "interp"]))
    axis = str(rng.choice(["X", "Y"]))
    boundary = str(rng.choice(list(BCS)))
    a_j, a_t = _pair(_sprinkle_nonfinite(rng, rng.rand(6, n, n)), ("face", "y", "x"))
    r_t = getattr(g_t, op)(a_t, axis, to="left", boundary=boundary)
    _check(r_t, getattr(g_j, op)(a_j, axis, to="left", boundary=boundary))
    _check(r_t, _generic(gridops, op)(g_t, a_t, axis=[(axis,)], boundary=boundary))


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_vector_nonfinite(seed):
    rng = np.random.RandomState(600 + seed)
    n = int(rng.choice([6, 144]))
    g_j, g_t, _ = _cubed(n=n)
    op = str(rng.choice(["diff", "interp"]))
    axis = str(rng.choice(["X", "Y"]))
    vec_axis = str(rng.choice(["X", "Y"]))
    other = "Y" if vec_axis == "X" else "X"
    a_j, a_t = _pair(_sprinkle_nonfinite(rng, rng.rand(6, n, n)), ("face", "y", "x"), "a")
    b_j, b_t = _pair(_sprinkle_nonfinite(rng, rng.rand(6, n, n)), ("face", "y", "x"), "b")
    kw = dict(to="left", boundary="fill")
    r_t = getattr(g_t, op)({vec_axis: a_t}, axis, other_component={other: b_t}, **kw)
    _check(r_t, getattr(g_j, op)({vec_axis: a_j}, axis, other_component={other: b_j}, **kw))
    _check(r_t, _generic(gridops, op)(g_t, {vec_axis: a_t}, axis=[(axis,)], boundary="fill",
                                      other_component={other: b_t}))
