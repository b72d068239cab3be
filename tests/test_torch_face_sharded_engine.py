"""Custom grid ufuncs on face-sharded grids: the port's sharded engine with
the face strip exchange against xgcm_tpu.

The cases of tests/test_face_sharded_custom.py,
test_face_sharded_nonface_axis.py and test_face_sharded_3d.py's custom and
width-limit cases: width-2 kernels along either in-face axis, a 9-point
kernel that reads the corner halo cells (mixed boundary conditions
included), vector components at width 2 across swapped edges, a sharded Z
axis on a face grid, and integer data, on face, face x rows and face x rows
x cols meshes of CPU shards.  The JAX tests hold the sharded engine to the
single-device engine with rtol = 1e-12; the port's engine computes each
shard's cells with the same operations on the same halo values, so here it
equals JAX's single-device engine value for value (NaN footprint
identical), and on a set of cases JAX's own sharded engine (under
``jax.jit``, whose fused sums sit within the JAX tests' rtol = 1e-12 of
the eager engine's).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu.parallel as jpar
import xgcm_tpu_torch as xtt
import xgcm_tpu_torch.parallel as tpar
from tests.datasets import cubed_sphere_dataset, llc_dataset
from tests.test_torch_face_sharded_ops import assert_values, sprinkle_nonfinite
from tests.torch_parity import assert_close

CPU8 = [torch.device("cpu")] * 8
N = 8
SPEC_2D = {"face": "f", "y": "r", "yl": "r"}
SPEC_3D = {"face": "f", "y": "r", "yl": "r", "x": "c", "xl": "c"}


def smooth5(a):
    """Width-(2,2) 5-point running mean along the last axis."""
    return 0.2 * (a[..., :-4] + a[..., 1:-3] + a[..., 2:-2] + a[..., 3:-1] + a[..., 4:])


def ninepoint(a):
    """Width-(1,1) x (1,1) 9-point mean over the last two axes: reads the
    corner halo cells."""
    nx = a.shape[-2] - 2
    ny = a.shape[-1] - 2
    s = 0.0
    for dx in range(3):
        for dy in range(3):
            s = s + a[..., dx: nx + dx, dy: ny + dy]
    return s / 9.0


def smooth3(a):
    return (a[..., :-2] + a[..., 1:-1] + a[..., 2:]) / 3.0


def cross_xz(a):
    """Width-(1,1) on the last two axes (X then Z)."""
    mid = a[..., 1:-1, 1:-1]
    return (mid + a[..., :-2, 1:-1] + a[..., 2:, 1:-1] + a[..., 1:-1, :-2]
            + a[..., 1:-1, 2:]) / 5.0


@functools.lru_cache(maxsize=None)
def _grids(name):
    ds, fc = {"cs": cubed_sphere_dataset, "llc": llc_dataset}[name](n=N)
    rng = np.random.RandomState(31 if name == "cs" else 37)
    nf = ds["data_c"].shape[0]
    fields = {k: sprinkle_nonfinite(rng, rng.rand(nf, N, N)) for k in ("c", "u", "v")}
    return (xgcm_tpu.Grid(ds, face_connections=fc),
            xtt.Grid(xtt.from_numpy_dataset(ds), face_connections=fc), fields)


DIMS = {"c": ("face", "y", "x"), "u": ("face", "y", "xl"), "v": ("face", "yl", "x")}


def _pair(name, key):
    fields = _grids(name)[2]
    return (xgcm_tpu.GriddedArray(fields[key], DIMS[key], name=key),
            xtt.GriddedArray(fields[key], DIMS[key], name=key))


def _sg(name, axes, spec):
    return tpar.ShardedGrid(_grids(name)[1], tpar.make_mesh(axes, devices=CPU8), spec)


CUSTOM = {
    # name: (grid, mesh axes, spec, func, kwargs)
    "width2-X-fill-f6": ("cs", {"f": 6}, {"face": "f"}, smooth5,
                         dict(axis=[("X",)], signature="(X:center)->(X:center)",
                              boundary_width={"X": (2, 2)}, boundary="fill")),
    "width2-X-extend-f6": ("cs", {"f": 6}, {"face": "f"}, smooth5,
                           dict(axis=[("X",)], signature="(X:center)->(X:center)",
                                boundary_width={"X": (2, 2)}, boundary="extend")),
    "width2-Y-llc-f8": ("llc", {"f": 8}, {"face": "f"}, smooth5,
                        dict(axis=[("Y",)], signature="(Y:center)->(Y:center)",
                             boundary_width={"Y": (2, 2)}, boundary="fill")),
    "corner-fill-f3": ("cs", {"f": 3}, {"face": "f"}, ninepoint,
                       dict(axis=[("X", "Y")], signature="(X:center,Y:center)->(X:center,Y:center)",
                            boundary_width={"X": (1, 1), "Y": (1, 1)}, boundary="fill")),
    "corner-mixed-f3": ("cs", {"f": 3}, {"face": "f"}, ninepoint,
                        dict(axis=[("X", "Y")],
                             signature="(X:center,Y:center)->(X:center,Y:center)",
                             boundary_width={"X": (1, 1), "Y": (1, 1)},
                             boundary={"X": "fill", "Y": "extend"})),
    "width2-Y-extend-f2r2": ("cs", {"f": 2, "r": 2}, SPEC_2D, smooth5,
                             dict(axis=[("Y",)], signature="(Y:center)->(Y:center)",
                                  boundary_width={"Y": (2, 2)}, boundary="extend")),
    "corner-fill-f2r2": ("cs", {"f": 2, "r": 2}, SPEC_2D, ninepoint,
                         dict(axis=[("X", "Y")],
                              signature="(X:center,Y:center)->(X:center,Y:center)",
                              boundary_width={"X": (1, 1), "Y": (1, 1)}, boundary="fill")),
    "width2-X-3d": ("cs", {"f": 2, "r": 2, "c": 2}, SPEC_3D, smooth5,
                    dict(axis=[("X",)], signature="(X:center)->(X:center)",
                         boundary_width={"X": (2, 2)}, boundary="extend")),
    "width2-Y-3d": ("cs", {"f": 2, "r": 2, "c": 2}, SPEC_3D, smooth5,
                    dict(axis=[("Y",)], signature="(Y:center)->(Y:center)",
                         boundary_width={"Y": (2, 2)}, boundary="extend")),
    "corner-fill-3d": ("cs", {"f": 2, "r": 2, "c": 2}, SPEC_3D, ninepoint,
                       dict(axis=[("X", "Y")], signature="(X:center,Y:center)->(X:center,Y:center)",
                            boundary_width={"X": (1, 1), "Y": (1, 1)}, boundary="fill")),
    "corner-mixed-3d": ("cs", {"f": 2, "r": 2, "c": 2}, SPEC_3D, ninepoint,
                        dict(axis=[("X", "Y")],
                             signature="(X:center,Y:center)->(X:center,Y:center)",
                             boundary_width={"X": (1, 1), "Y": (1, 1)},
                             boundary={"X": "fill", "Y": "extend"})),
    "corner-periodic-llc-3d": ("llc", {"f": 2, "r": 2, "c": 2}, SPEC_3D, ninepoint,
                               dict(axis=[("X", "Y")],
                                    signature="(X:center,Y:center)->(X:center,Y:center)",
                                    boundary_width={"X": (1, 1), "Y": (1, 1)},
                                    boundary="periodic")),
}


@pytest.mark.parametrize("case", list(CUSTOM))
def test_custom_ufunc_matches_single_device(case):
    name, axes, spec, func, kw = CUSTOM[case]
    jgrid = _grids(name)[0]
    ja, ta = _pair(name, "c")
    got = _sg(name, axes, spec).apply_as_grid_ufunc(func, ta, **kw)
    assert_values(got, jgrid.apply_as_grid_ufunc(func, ja, **kw))


@pytest.mark.parametrize("case", ["corner-mixed-3d", "width2-Y-llc-f8", "corner-fill-f2r2"])
def test_custom_ufunc_matches_jax_sharded_engine(case):
    name, axes, spec, func, kw = CUSTOM[case]
    jgrid, _, fields = _grids(name)
    n = int(np.prod(list(axes.values())))
    jsg = jpar.ShardedGrid(jgrid, jpar.make_mesh(axes, devices=jax.devices()[:n]), spec)
    want = jax.jit(lambda a: jsg.apply_as_grid_ufunc(
        func, xgcm_tpu.GriddedArray(a, DIMS["c"]), **kw).data)(fields["c"])
    got = _sg(name, axes, spec).apply_as_grid_ufunc(func, _pair(name, "c")[1], **kw)
    # the JAX tests' rtol: XLA compiles the jitted kernel's sums as one
    # fused program, one ulp from the eager single-device engine's
    assert_close(got, np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("mesh", ["f6", "f2r2", "3d"])
def test_vector_width2(mesh):
    """Vector components at width 2 across swapped-axis connections
    (partner strips and sign rules) through the engine."""
    axes, spec = {"f6": ({"f": 6}, {"face": "f"}), "f2r2": ({"f": 2, "r": 2}, SPEC_2D),
                  "3d": ({"f": 2, "r": 2, "c": 2}, SPEC_3D)}[mesh]
    jgrid = _grids("cs")[0]
    (ju, tu), (jv, tv) = _pair("cs", "u"), _pair("cs", "v")
    kw = dict(axis=[("X",)], signature="(X:left)->(X:left)", boundary_width={"X": (2, 2)},
              boundary="fill")
    got = _sg("cs", axes, spec).apply_as_grid_ufunc(smooth5, {"X": tu},
                                                    other_component=[{"Y": tv}], **kw)
    assert_values(got, jgrid.apply_as_grid_ufunc(smooth5, {"X": ju},
                                                 other_component=[{"Y": jv}], **kw))


@pytest.mark.parametrize("dtype", ["int32", "uint16", "int64"])
@pytest.mark.parametrize("op", ["diff", "min"])
def test_integer_data_takes_the_engine(dtype, op):
    """Integer data is not kernel E's: the built-in op takes the engine
    with the strip exchange, and keeps JAX's dtype and values."""
    jgrid, tgrid, _ = _grids("cs")
    a = np.random.RandomState(9).permutation(6 * N * N).reshape(6, N, N).astype(dtype)
    sg = tpar.ShardedGrid(tgrid, tpar.make_mesh({"f": 2, "r": 2}, devices=CPU8), SPEC_2D)
    for axis in ("X", "Y"):
        got = getattr(sg, op)(xtt.GriddedArray(torch.from_numpy(a.copy()), DIMS["c"]), axis,
                              boundary="fill")
        assert_values(got, getattr(jgrid, op)(xgcm_tpu.GriddedArray(a, DIMS["c"]), axis,
                                              boundary="fill"))


def test_width_exceeds_rows_per_shard():
    ds, fc = cubed_sphere_dataset(n=4)
    grid = xtt.Grid(xtt.from_numpy_dataset(ds), face_connections=fc)
    sg = tpar.ShardedGrid(grid, tpar.make_mesh({"f": 2, "r": 2, "c": 2}, devices=CPU8), SPEC_3D)
    da = xtt.GriddedArray(np.random.rand(6, 4, 4), ("face", "y", "x"))
    with pytest.raises(ValueError, match="per interior shard"):
        sg.apply_as_grid_ufunc(smooth5, sg.shard(da), axis=[("X",)],
                               signature="(X:center)->(X:center)",
                               boundary_width={"X": (3, 3)}, boundary="fill")


def test_width_exceeds_columns_per_shard():
    """Non-square faces (ny = 8 > nx = 4): the rows check passes, the
    columns check catches the halo."""
    from tests.test_torch_face_sharded_ops import _nonsquare_ring

    grid = _nonsquare_ring(xtt, ny=8, nx=4)
    sg = tpar.ShardedGrid(grid, tpar.make_mesh({"f": 2, "r": 2, "c": 2}, devices=CPU8), SPEC_3D)
    da = xtt.GriddedArray(np.random.rand(4, 8, 4), ("face", "y", "x"))
    with pytest.raises(ValueError, match="columns per interior shard"):
        sg.apply_as_grid_ufunc(smooth5, sg.shard(da), axis=[("X",)],
                               signature="(X:center)->(X:center)",
                               boundary_width={"X": (3, 3)}, boundary="fill")


# ------------------------------------------- test_face_sharded_nonface_axis
@functools.lru_cache(maxsize=None)
def _cs_with_z(nz=8):
    _, fc = cubed_sphere_dataset(n=N)
    rng = np.random.RandomState(3)
    data = rng.rand(6, nz, N, N)
    out = []
    for pkg in (xgcm_tpu, xtt):
        ds = pkg.Dataset(coords={
            "x": ("x", np.arange(N) + 0.5, {"axis": "X"}),
            "xl": ("xl", np.arange(N) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
            "y": ("y", np.arange(N) + 0.5, {"axis": "Y"}),
            "yl": ("yl", np.arange(N) * 1.0, {"axis": "Y", "c_grid_axis_shift": -0.5}),
            "z": ("z", np.arange(nz) + 0.5, {"axis": "Z"}),
            "zl": ("zl", np.arange(nz) * 1.0, {"axis": "Z", "c_grid_axis_shift": -0.5}),
            "face": ("face", np.arange(6)),
        })
        out.append((pkg.Grid(ds, face_connections=fc),
                    pkg.GriddedArray(data, ("face", "z", "y", "x"), name="data_c")))
    return out


Z_CASES = {
    "z-sharded-fill": ({"f": 2, "zm": 4}, {"face": "f", "z": "zm"}, smooth3,
                       dict(axis=[("Z",)], signature="(Z:center)->(Z:center)",
                            boundary_width={"Z": (1, 1)}, boundary="fill")),
    "z-sharded-extend": ({"f": 2, "zm": 4}, {"face": "f", "z": "zm"}, smooth3,
                         dict(axis=[("Z",)], signature="(Z:center)->(Z:center)",
                              boundary_width={"Z": (1, 1)}, boundary="extend")),
    "z-and-face-axis": ({"f": 2, "zm": 4}, {"face": "f", "z": "zm"}, cross_xz,
                        dict(axis=[("X", "Z")],
                             signature="(X:center,Z:center)->(X:center,Z:center)",
                             boundary_width={"X": (1, 1), "Z": (1, 1)}, boundary="fill")),
    "z-unsharded": ({"f": 6}, {"face": "f"}, smooth3,
                    dict(axis=[("Z",)], signature="(Z:center)->(Z:center)",
                         boundary_width={"Z": (1, 1)}, boundary="extend")),
    "z-without-face-mapping": ({"zm": 8}, {"z": "zm"}, smooth3,
                               dict(axis=[("Z",)], signature="(Z:center)->(Z:center)",
                                    boundary_width={"Z": (1, 1)}, boundary="extend")),
    "z-and-x-without-face-mapping": ({"zm": 8}, {"z": "zm"}, cross_xz,
                                     dict(axis=[("X", "Z")],
                                          signature="(X:center,Z:center)->(X:center,Z:center)",
                                          boundary_width={"X": (1, 1), "Z": (1, 1)},
                                          boundary="fill")),
}


@pytest.mark.parametrize("case", list(Z_CASES))
def test_sharded_nonface_axis_on_face_grid(case):
    """A Z axis sharded on its own mesh axis rides ring halos (shard-interior
    edges carry neighbour data), beside or without the face route."""
    axes, spec, func, kw = Z_CASES[case]
    (jgrid, ja), (tgrid, ta) = _cs_with_z()
    mesh = tpar.make_mesh(axes, devices=CPU8)
    sg = tpar.ShardedGrid(tgrid, mesh, spec)
    sh = tpar.shard_gridded(ta, mesh, {d: m for d, m in spec.items() if d in ta.dims})
    assert_values(sg.apply_as_grid_ufunc(func, sh, **kw),
                  jgrid.apply_as_grid_ufunc(func, ja, **kw))


def test_sharded_inface_without_face_mapping_raises_clearly():
    """Direct engine use with a sharded face-connected dim and no face
    mapping gets the explicit error, as in JAX."""
    (_, _), (tgrid, ta) = _cs_with_z()
    mesh = tpar.make_mesh({"ym": 8}, devices=CPU8)
    sh = tpar.shard_gridded(ta, mesh, {"y": "ym"})
    with pytest.raises(NotImplementedError, match="face-connected dims"):
        tpar.sharded_apply_as_grid_ufunc(
            smooth3, sh, axis=[("Y",)], grid=tgrid, signature="(Y:center)->(Y:center)",
            mesh=mesh, dim_to_mesh_axis={"y": "ym"}, boundary_width={"Y": (1, 1)},
            boundary="fill")


def test_apply_many_on_face_grid_matches_jax():
    """``apply_many`` on a face-sharded grid with Z over its own mesh axis
    (faces over ``f``, Z over ``zm``) equals JAX's ``sharded_apply_many``
    (under ``jax.jit``; the JAX tests' rtol = 1e-12 for a custom ufunc)
    with JAX's collectives, and gathers nothing."""
    from xgcm_tpu.utils import count_collectives as jax_count
    from xgcm_tpu_torch.utils.inspection import count_collectives as torch_count

    (jgrid, ja), (tgrid, ta) = _cs_with_z()
    spec = {"face": "f", "z": "zm"}
    kw = dict(func=smooth3, axis=[("Z",)], signature="(Z:center)->(Z:center)",
              boundary_width={"Z": (1, 1)}, boundary="extend")
    jsg = jpar.ShardedGrid(jgrid, jpar.make_mesh({"f": 2, "zm": 4}, devices=jax.devices()[:8]),
                           spec)
    sg = tpar.ShardedGrid(tgrid, tpar.make_mesh({"f": 2, "zm": 4}, devices=CPU8), spec)

    def jfn(a):
        [out] = jsg.apply_many([dict(args=xgcm_tpu.GriddedArray(a, ja.dims), **kw)])
        return out.data

    data = np.asarray(ja.data)
    want = jax.jit(jfn)(data)
    box = []
    tpar.reset_assembly_count()
    cc = torch_count(lambda: box.extend(sg.apply_many([dict(args=ta, **kw)])))
    assert tpar.assembly_count() == 0
    [got] = box
    assert isinstance(got.data, tpar.ShardedTensor) and got.dims == ta.dims
    assert_close(got, np.asarray(want), rtol=1e-12)
    assert_values(got, jgrid.apply_as_grid_ufunc(smooth3, ja, **{
        k: v for k, v in kw.items() if k != "func"}))
    assert cc == jax_count(jfn, data)


@pytest.mark.parametrize("mesh_key", ["f2", "f2r2", "f2c2", "f2r2c2"])
@pytest.mark.parametrize("by", ["periodic", "fill", "extend", "extrapolate"])
@pytest.mark.parametrize("bx", ["periodic", "fill", "extend", "extrapolate"])
def test_one_allocation_prepad_equals_two_pads(mesh_key, by, bx):
    """The face route's uniform pre-pad fills one tensor per block; it
    equals the two successive pads it replaces (the local boundary
    condition or ring halos per axis, the second axis reading the first's
    corners) bit for bit, in either order, for float64 with NaN and for
    uint16, with the same collectives."""
    from xgcm_tpu_torch.ops.stencils import wrapping
    from xgcm_tpu_torch.parallel.collectives import COLLECTIVES, coords
    from xgcm_tpu_torch.parallel.face_sharded import _prepad
    from xgcm_tpu_torch.parallel.halo import pad_axis_local_or_ring

    axes = {"f2": {"f": 2}, "f2r2": {"f": 2, "r": 2}, "f2c2": {"f": 2, "c": 2},
            "f2r2c2": {"f": 2, "r": 2, "c": 2}}[mesh_key]
    mesh = tpar.make_mesh(axes, devices=CPU8)
    steps = {"y": (-2, "r" if "r" in axes else None, by, 1.5),
             "x": (-1, "c" if "c" in axes else None, bx, 2.5)}
    rng = np.random.RandomState(5)
    for dtype in (torch.float64, torch.uint16):
        blocks = np.empty(mesh.devices.shape, dtype=object)
        for c in coords(mesh):
            a = rng.randn(2, 3, 4, 5) * 50
            a[0, 0, 0, 0] = np.nan
            blocks[c] = (torch.from_numpy(a) if dtype == torch.float64
                         else torch.from_numpy(np.nan_to_num(a)).to(torch.int64).to(dtype))
        for w in (1, 2):
            for order in (("y", "x"), ("x", "y")):
                COLLECTIVES.clear()
                got = _prepad(blocks, w, mesh, [steps[k] for k in order])
                got_cc = dict(COLLECTIVES)
                COLLECTIVES.clear()
                want = blocks
                for k in order:
                    axis, mesh_axis, bnd, fv = steps[k]
                    want = pad_axis_local_or_ring(want, axis, (w, w), mesh, mesh_axis, bnd, fv)
                assert got_cc == dict(COLLECTIVES)
                for c in coords(mesh):
                    g, e = wrapping(got[c]), wrapping(want[c])
                    assert got[c].dtype == want[c].dtype and g.shape == e.shape
                    if g.is_floating_point():
                        assert torch.equal(g.isnan(), e.isnan())
                        assert torch.equal(torch.signbit(g), torch.signbit(e))
                        g, e = g.nan_to_num(), e.nan_to_num()
                    assert torch.equal(g, e), (dtype, w, order, c)
