"""The port's face-sharded route for the built-in ops against xgcm_tpu.

The cases of tests/test_face_sharded_{general,vector,3d}.py,
test_sharding.py::TestFaceSharded, test_sharding_2d.py's face routing and
test_fuzz_sharded_routing.py's face-grid sweep: the cubed sphere and the
13-face LLC on face, face x rows and face x rows x cols meshes of CPU
shards (``make_mesh(..., devices=["cpu"] * n)``), scalars and vector
components, every basic boundary, with NaN and +-inf on face edges (the
non-finite face fuzz).  The JAX tests hold the sharded route to the
single-device op; here the port's sharded result equals JAX's
single-device op value for value (NaN footprint identical, +-0 equal), and
on a set of cases JAX's own sharded route too (run under ``jax.jit``:
eager ``shard_map`` takes tens of seconds a call on the CPU).  The plan
compiler, the axis roles and the collective budget
(``utils.count_collectives``) equal JAX's.
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
from tests.torch_parity import to_numpy
from xgcm_tpu.utils import count_collectives as jax_count
from xgcm_tpu_torch.utils.inspection import count_collectives as torch_count

CPU8 = [torch.device("cpu")] * 8
N = 8
DATASETS = {"cs": cubed_sphere_dataset, "llc": llc_dataset}
MESHES = {
    "f2": ({"f": 2}, {"face": "f"}),
    "f3": ({"f": 3}, {"face": "f"}),
    "f4": ({"f": 4}, {"face": "f"}),
    "f8": ({"f": 8}, {"face": "f"}),
    "f2r2": ({"f": 2, "r": 2}, {"face": "f", "y": "r", "yl": "r"}),
    "f2r2c2": ({"f": 2, "r": 2, "c": 2},
               {"face": "f", "y": "r", "yl": "r", "x": "c", "xl": "c"}),
}
BOUNDARIES = ["periodic", "fill", "extend", "extrapolate"]


def sprinkle_nonfinite(rng, a):
    """NaN/+-inf at random cells, biased toward face edges (the halo
    sources), as test_fuzz_faces.py's non-finite fuzz places them."""
    flat = a.reshape(-1, *a.shape[-2:])
    ny, nx = a.shape[-2:]
    for _ in range(int(rng.randint(3, 8))):
        b = rng.randint(flat.shape[0])
        val = float(rng.choice([np.nan, np.inf, -np.inf]))
        if rng.rand() < 0.7:
            side = rng.randint(4)
            r, c = rng.randint(ny), rng.randint(nx)
            idx = ((r, 0), (r, nx - 1), (0, c), (ny - 1, c))[side]
            flat[(b,) + idx] = val
        else:
            flat[b, rng.randint(ny), rng.randint(nx)] = val
    return a


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(JAX grid, port grid, numpy fields) of one face grid: a scalar on
    (face, y, x) and the C-grid u, v, each with non-finite edge cells."""
    ds, fc = DATASETS[name](n=N)
    tds = xtt.from_numpy_dataset(ds)
    rng = np.random.RandomState(17 if name == "cs" else 23)
    nf = ds["data_c"].shape[0]
    fields = {k: sprinkle_nonfinite(rng, rng.rand(nf, N, N)) for k in ("c", "u", "v")}
    return (xgcm_tpu.Grid(ds, face_connections=fc), xtt.Grid(tds, face_connections=fc), fields,
            {"c": ("face", "y", "x"), "u": ("face", "y", "xl"), "v": ("face", "yl", "x")})


def _arrays(name, key):
    _, _, fields, dims = _setup(name)
    return (xgcm_tpu.GriddedArray(fields[key], dims[key], name=key),
            xtt.GriddedArray(fields[key], dims[key], name=key))


def _sgrid(name, mesh_key):
    axes, spec = MESHES[mesh_key]
    _, tgrid, _, _ = _setup(name)
    return tpar.ShardedGrid(tgrid, tpar.make_mesh(axes, devices=CPU8), spec)


def _jax_sgrid(name, mesh_key):
    axes, spec = MESHES[mesh_key]
    jgrid = _setup(name)[0]
    mesh = jpar.make_mesh(axes, devices=jax.devices()[: int(np.prod(list(axes.values())))])
    return jpar.ShardedGrid(jgrid, mesh, spec)


def assert_values(got, want):
    """Same dims and shape, equal values (NaN footprint identical, +-0
    equal)."""
    if hasattr(want, "dims"):
        assert got.dims == want.dims, (got.dims, want.dims)
    g, w = to_numpy(got), to_numpy(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------- plan and roles
@pytest.mark.parametrize("n_total", [None, 16])
@pytest.mark.parametrize("name", ["cs", "llc"])
def test_compile_face_plan_matches_jax(name, n_total):
    """One plan compiler: the port's core/topology.compile_face_plan (re-
    exported from parallel.face_sharded) gives JAX's arrays, dummy rows
    included."""
    jgrid, tgrid, _, _ = _setup(name)
    j = jpar.compile_face_plan(jgrid, "X", "Y", n_faces_total=n_total)
    t = tpar.compile_face_plan(tgrid, "X", "Y", n_faces_total=n_total)
    assert tpar.face_sharded.compile_face_plan is xtt.core.topology.compile_face_plan
    for field in ("connected", "src_face", "src_side", "tang_flip", "sign_ortho", "sign_tang",
                  "swap"):
        a, b = getattr(t, field), getattr(j, field)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mapping", [
    {"face": "f"}, {"face": "f", "y": "r", "yl": "r"}, {"face": "f", "x": "c", "xl": "c"},
    {"face": "f", "y": "r", "yl": "r", "x": "c", "xl": "c"}, {"y": "r"},
])
def test_face_axis_roles_match_jax(mapping):
    jgrid, tgrid, _, _ = _setup("cs")
    dims = ("face", "y", "x")
    j = jpar.face_axis_roles(jgrid, mapping, dims, strict=False)
    t = tpar.face_axis_roles(tgrid, mapping, dims, strict=False)
    assert (None if t is None else tuple(t)) == (None if j is None else tuple(j))


# ------------------------------------------- built-in ops, every layout
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("axis", ["X", "Y"])
@pytest.mark.parametrize("op", ["diff", "interp", "min", "max"])
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("name", ["cs", "llc"])
def test_builtin_op_matches_single_device(name, mesh_key, op, axis, boundary):
    """Kernel E's route (its plain version here): every mesh layout, with
    dummy faces for the cubed sphere on 4 and 8 face shards and for the
    LLC on 2, 3, 4 and 8."""
    jgrid = _setup(name)[0]
    ja, ta = _arrays(name, "c")
    sg = _sgrid(name, mesh_key)
    got = getattr(sg, op)(sg.shard(ta) if name == "cs" else ta, axis, boundary=boundary)
    assert_values(got, getattr(jgrid, op)(ja, axis, boundary=boundary))


@pytest.mark.parametrize("axis", ["X", "Y"])
@pytest.mark.parametrize("component", ["X", "Y"])
@pytest.mark.parametrize("op", ["diff", "interp"])
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("name", ["cs", "llc"])
def test_vector_op_matches_single_device(name, mesh_key, op, component, axis):
    """A vector component with its partner: swapped edges read the
    partner's strips with the sign rules, on every layout."""
    jgrid = _setup(name)[0]
    own, other = ("u", "v") if component == "X" else ("v", "u")
    other_axis = "Y" if component == "X" else "X"
    (ja, ta), (jp, tp) = _arrays(name, own), _arrays(name, other)
    sg = _sgrid(name, mesh_key)
    got = getattr(sg, op)({component: ta}, axis, boundary="fill",
                          other_component={other_axis: tp})
    want = getattr(jgrid, op)({component: ja}, axis, boundary="fill",
                              other_component={other_axis: jp})
    assert_values(got, want)


# ----------------------------------------------- against JAX's sharded route
JAX_CASES = {
    "cs-f6-diff-X-fill": ("cs", {"f": 6}, {"face": "f"}, "diff", "X", "fill", None),
    "cs-f3r2-interp-Y-extend": ("cs", {"f": 3, "r": 2}, {"face": "f", "y": "r", "yl": "r"},
                                "interp", "Y", "extend", None),
    "cs-3d-vector-diff-X": ("cs", {"f": 2, "r": 2, "c": 2}, MESHES["f2r2c2"][1], "diff", "X",
                            "fill", "X"),
    "llc-f4-diff-Y-fill": ("llc", {"f": 4}, {"face": "f"}, "diff", "Y", "fill", None),
    "llc-f4r2-max-X-extrapolate": ("llc", {"f": 4, "r": 2}, {"face": "f", "y": "r", "yl": "r"},
                                   "max", "X", "extrapolate", None),
    "llc-f8-vector-interp-Y": ("llc", {"f": 8}, {"face": "f"}, "interp", "Y", "fill", "Y"),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_builtin_op_matches_jax_sharded_route(case):
    name, axes, spec, op, axis, boundary, component = JAX_CASES[case]
    jgrid, tgrid, fields, dims = _setup(name)
    n = int(np.prod(list(axes.values())))
    jsg = jpar.ShardedGrid(jgrid, jpar.make_mesh(axes, devices=jax.devices()[:n]), spec)
    tsg = tpar.ShardedGrid(tgrid, tpar.make_mesh(axes, devices=CPU8), spec)
    own, other = ("u", "v") if component == "X" else ("v", "u") if component else ("c", None)

    def call(pkg, sg, a, b):
        arr = pkg.GriddedArray(a, dims[own])
        if component is None:
            return getattr(sg, op)(arr, axis, boundary=boundary)
        return getattr(sg, op)({component: arr}, axis, boundary=boundary,
                               other_component={"Y" if component == "X" else "X":
                                                pkg.GriddedArray(b, dims[other])})

    b = fields[other] if other else fields[own]
    want = jax.jit(lambda a, b: call(xgcm_tpu, jsg, a, b).data)(fields[own], b)
    got = call(xtt, tsg, fields[own], b)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_float32_extrapolate_matches_jax_route_by_route():
    """In float32 an extrapolated face edge rounds differently on the
    sharded route (the pre-pad's x0 - (x1 - x0)) and on the single-device
    one (2 x0 - x1), in JAX as in the port: each port route equals JAX's
    same route bit for bit."""
    ds, fc = llc_dataset(n=24)
    jgrid = xgcm_tpu.Grid(ds, face_connections=fc)
    tgrid = xtt.Grid(xtt.from_numpy_dataset(ds), face_connections=fc)
    a = np.random.RandomState(0).randn(13, 24, 24).astype(np.float32)
    dims = ("face", "y", "x")
    jmesh = jpar.make_mesh({"f": 4}, devices=jax.devices()[:4])
    j_sharded = jax.jit(lambda x: jpar.sharded_face_op(
        jgrid, "diff", xgcm_tpu.GriddedArray(x, dims), "Y", jmesh, "f", "X", "Y",
        boundary="extrapolate").data)(a)
    j_single = jgrid.diff(xgcm_tpu.GriddedArray(a, dims), "Y", boundary="extrapolate")
    t_sharded = tpar.sharded_face_op(
        tgrid, "diff", xtt.GriddedArray(torch.from_numpy(a), dims), "Y",
        tpar.make_mesh({"f": 4}, devices=CPU8), "f", "X", "Y", boundary="extrapolate")
    t_single = tgrid.diff(xtt.GriddedArray(torch.from_numpy(a), dims), "Y", boundary="extrapolate")
    np.testing.assert_array_equal(to_numpy(t_sharded), np.asarray(j_sharded))
    np.testing.assert_array_equal(to_numpy(t_single), to_numpy(j_single))
    assert not np.array_equal(np.asarray(j_sharded), to_numpy(j_single))


# -------------------------------------------------------- collective budget
@pytest.mark.parametrize("vector", [False, True])
@pytest.mark.parametrize("boundary", ["fill", "extend"])
@pytest.mark.parametrize("mesh_key", ["f4", "f2r2", "f2r2c2"])
@pytest.mark.parametrize("name", ["cs", "llc"])
def test_collective_budget_matches_jax(name, mesh_key, boundary, vector):
    """The same psum / all_gather / ppermute counts as JAX's program (its
    jaxpr names the psum ``psum_invariant``): the strip pool, and the ring
    exchange of both in-face axes that the uniform pre-pad makes."""
    _, _, fields, dims = _setup(name)
    jsg, tsg = _jax_sgrid(name, mesh_key), _sgrid(name, mesh_key)

    def call(pkg, sg, u, v):
        if vector:
            return sg.diff({"X": pkg.GriddedArray(u, dims["u"])}, "X", boundary=boundary,
                           other_component={"Y": pkg.GriddedArray(v, dims["v"])})
        return sg.interp(pkg.GriddedArray(u, dims["c"]), "Y", boundary=boundary)

    j = jax_count(lambda u, v: call(xgcm_tpu, jsg, u, v).data, fields["u"], fields["v"])
    t = torch_count(lambda: call(xtt, tsg, fields["u"], fields["v"]))
    j = {("psum" if "psum" in k else k): v for k, v in j.items()}
    assert t == j


# ---------------------------------------------------- test_sharding.py cases
def test_face_index_diff_sharded():
    """The cubed-sphere neighbour-difference golden values, with the face
    dim over 6 shards (TestFaceSharded)."""
    ds, fc = cubed_sphere_dataset(n=8)
    grid = xtt.Grid(xtt.from_numpy_dataset(ds), face_connections=fc, periodic=False)
    mesh = tpar.make_mesh({"f": 6}, devices=CPU8)
    face_field = xtt.GriddedArray(
        np.broadcast_to(np.arange(6, dtype=float)[:, None, None], (6, 8, 8)).copy(),
        ("face", "y", "x"))
    out = tpar.sharded_face_op(grid, "diff", tpar.shard_gridded(face_field, mesh, {"face": "f"}),
                               "X", mesh, "f", "X", "Y", boundary="fill")
    arr = to_numpy(out)
    np.testing.assert_array_equal(arr[:, 0, 0], [-3, 1, 1, 1, 1, 2])
    np.testing.assert_array_equal(arr[:, -1, 0], [-3, 1, 1, 1, 1, 2])


def test_sharded_grid_face_routing():
    """test_sharding_2d.py: a family grid (grids.cubed_sphere_grid) on six
    face shards routes through the face exchange; the result stays
    sharded and nothing is assembled."""
    from xgcm_tpu.grids import cubed_sphere_grid

    _, jgrid = cubed_sphere_grid(n=8)
    _, tgrid = xtt.grids.cubed_sphere_grid(n=8)
    sg = tpar.ShardedGrid(tgrid, tpar.make_mesh({"f": 6}, devices=CPU8), {"face": "f"})
    a = np.random.RandomState(2).rand(6, 8, 8)
    sh = sg.shard(xtt.GriddedArray(a, ("face", "y", "x")))
    tpar.reset_assembly_count()
    out = sg.diff(sh, "X", boundary="fill")
    assert isinstance(out.data, tpar.ShardedTensor) and tpar.assembly_count() == 0
    assert_values(out, jgrid.diff(xgcm_tpu.GriddedArray(a, ("face", "y", "x")), "X",
                                  boundary="fill"))


FUZZ_MAPPINGS = [
    {"face": "a"},
    {"face": "a", "y": "b", "yl": "b"},
    {"y": "a", "yl": "a"},  # in-face sharded, face not: the fall-through
    {},
]


@pytest.mark.parametrize("mapping", range(len(FUZZ_MAPPINGS)))
@pytest.mark.parametrize("op", ["interp", "diff"])
def test_face_grid_routing_fuzz(op, mapping):
    """test_fuzz_sharded_routing.py's face sweep on a {a: 2, b: 4} mesh."""
    mapping = FUZZ_MAPPINGS[mapping]
    jgrid, tgrid, _, _ = _setup("cs")
    ja, ta = _arrays("cs", "c")
    mesh = tpar.make_mesh({"a": 2, "b": 4}, devices=CPU8)
    sg = tpar.ShardedGrid(tgrid, mesh, mapping)
    sh = tpar.shard_gridded(ta, mesh, {d: m for d, m in mapping.items() if d in ta.dims})
    for axis in ("X", "Y"):
        assert_values(getattr(sg, op)(sh, axis, boundary="fill"),
                      getattr(jgrid, op)(ja, axis, boundary="fill"))


# -------------------------------------------------- non-square ring faces
def _nonsquare_ring(pkg, ny=6, nx=10, reversed_link=False):
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


@pytest.mark.parametrize("reversed_link", [False, True])
@pytest.mark.parametrize("boundary", ["fill", "extend", "periodic"])
@pytest.mark.parametrize("axis", ["X", "Y"])
@pytest.mark.parametrize("mesh_key", ["f4", "f2r2c2"])
def test_nonsquare_ring_faces(mesh_key, axis, boundary, reversed_link):
    """Straight (and reversed) links between non-square faces, on face and
    face x rows x cols meshes (TestNonSquareFaces, TestNonSquare3D)."""
    axes = {"f4": {"f": 4}, "f2r2c2": {"f": 2, "r": 2, "c": 2}}[mesh_key]
    spec = {"f4": {"face": "f"}, "f2r2c2": MESHES["f2r2c2"][1]}[mesh_key]
    a = sprinkle_nonfinite(np.random.RandomState(4), np.random.RandomState(5).rand(4, 6, 10))
    jgrid, tgrid = _nonsquare_ring(xgcm_tpu, reversed_link=reversed_link), _nonsquare_ring(
        xtt, reversed_link=reversed_link)
    sg = tpar.ShardedGrid(tgrid, tpar.make_mesh(axes, devices=CPU8), spec)
    got = sg.interp(sg.shard(xtt.GriddedArray(a, ("face", "y", "x"))), axis, boundary=boundary)
    assert_values(got, jgrid.interp(xgcm_tpu.GriddedArray(a, ("face", "y", "x")), axis,
                                    boundary=boundary))


def test_swap_requires_square_faces():
    ny, nx = 6, 10
    fc = {"face": {0: {"X": (None, (1, "Y", False))}, 1: {"Y": ((0, "X", False), None)}}}
    a = np.random.rand(2, ny, nx)
    for pkg, par, mesh in ((xgcm_tpu, jpar, jpar.make_mesh({"f": 2}, devices=jax.devices()[:2])),
                           (xtt, tpar, tpar.make_mesh({"f": 2}, devices=CPU8))):
        ds = pkg.Dataset(coords={
            "x": ("x", np.arange(nx) + 0.5, {"axis": "X"}),
            "xl": ("xl", np.arange(nx) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
            "y": ("y", np.arange(ny) + 0.5, {"axis": "Y"}),
            "yl": ("yl", np.arange(ny) * 1.0, {"axis": "Y", "c_grid_axis_shift": -0.5}),
            "face": ("face", np.arange(2)),
        })
        grid = pkg.Grid(ds, face_connections=fc)
        with pytest.raises(ValueError, match="square"):
            par.sharded_face_op(grid, "diff", pkg.GriddedArray(a, ("face", "y", "x")), "X", mesh,
                                "f", "X", "Y", boundary="fill")


# ------------------------------------------ test_face_sharded_vector.py
FC_XY = {"face": {0: {"X": (None, (1, "Y", False))}, 1: {"Y": ((0, "X", False), None)}}}


def _two_faces(pkg, **kw):
    ds = pkg.Dataset(coords={
        "x": ("x", np.arange(N, dtype=float), {"axis": "X"}),
        "xl": ("xl", np.arange(N) - 0.5, {"axis": "X", "c_grid_axis_shift": -0.5}),
        "y": ("y", np.arange(N, dtype=float), {"axis": "Y"}),
        "yl": ("yl", np.arange(N) - 0.5, {"axis": "Y", "c_grid_axis_shift": -0.5}),
        "face": ("face", np.arange(2)),
    })
    return pkg.Grid(ds, face_connections=FC_XY, periodic=False, **kw)


def test_tangential_sign_flip_sharded():
    """The all-ones invariant (reference test_faceconnections.py) with the
    faces on two shards."""
    grid = _two_faces(xtt, boundary="fill", fill_value=1)
    mesh = tpar.make_mesh({"f": 2}, devices=CPU8)
    u = xtt.GriddedArray(np.zeros((2, N, N)) + np.array([-2.0, -1.0])[:, None, None],
                         ("face", "y", "xl"))
    v = xtt.GriddedArray(np.ones((2, N, N)), ("face", "yl", "x"))
    out = tpar.sharded_face_op(grid, "interp", {"Y": tpar.shard_gridded(v, mesh, {"face": "f"})},
                               "X", mesh, "f", "X", "Y",
                               other_component={"X": tpar.shard_gridded(u, mesh, {"face": "f"})})
    np.testing.assert_array_equal(to_numpy(out), 1.0)


def test_missing_other_component_raises():
    grid = _two_faces(xtt)
    mesh = tpar.make_mesh({"f": 2}, devices=CPU8)
    v = xtt.GriddedArray(np.ones((2, N, N)), ("face", "yl", "x"))
    with pytest.raises(ValueError, match="requires `other_component`"):
        tpar.sharded_face_op(grid, "interp", {"Y": v}, "X", mesh, "f", "X", "Y")


def test_dummy_faces_are_dropped_from_the_result():
    """13 LLC faces on 4 shards: 16 faces ride the mesh, the result holds
    the 13 real ones, on the mesh's first device."""
    jgrid, _, _, _ = _setup("llc")
    ja, ta = _arrays("llc", "c")
    sg = _sgrid("llc", "f4")
    out = sg.diff(ta, "X", boundary="fill")
    assert out.data.shape == (13, N, N) and not isinstance(out.data, tpar.ShardedTensor)
    assert_values(out, jgrid.diff(ja, "X", boundary="fill"))


def test_replicated_sharded_tensor_assembles_to_a_tensor():
    """A face dim that does not divide its mesh axis stays replicated
    (``shard_gridded`` warns), and assembling such a ShardedTensor gives
    the global tensor, a copy on the mesh's first device."""
    mesh = tpar.make_mesh({"f": 4}, devices=CPU8)
    a = np.random.RandomState(8).rand(6, 8, 8)
    with pytest.warns(UserWarning, match="replicating"):
        sh = tpar.shard_gridded(xtt.GriddedArray(a, ("face", "y", "x")), mesh, {"face": "f"})
    full = sh.data.full_tensor()
    assert isinstance(full, torch.Tensor) and not isinstance(full, tpar.ShardedTensor)
    assert full.data_ptr() != sh.data.blocks[0].data_ptr()
    np.testing.assert_array_equal(full.numpy(), a)
