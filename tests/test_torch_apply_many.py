"""The port's ``sharded_apply_many`` against xgcm_tpu's.

The ten cases of tests/test_apply_many.py, with
test_face_sharded_3d.py::test_apply_many_one_exchange and
test_face_sharded_nonface_axis.py::test_apply_many_sharded_z_on_face_grid:
the C-grid batch against the fused diagnostics, ops of several widths that
share one pad, face-sharded scalar and vector batches, specs by name, the
cumsum refusal, Z batches on a face grid with and without the face dim
mapped.  Each batch takes the same seeded numpy inputs (non-finite values
on face edges for the face grids) through JAX's ``sharded_apply_many``,
run under ``jax.jit`` on the CPU mesh (eager face ``shard_map`` takes 5-50
s a call), and through the port's on CPU shards.  The port equals JAX value
for value (NaN footprint identical, +-0 equal: the strip sites keep -0.0
where JAX's give +0.0) for the gridops ufuncs, and within the JAX tests'
rtol = 1e-12 for the custom ones, whose sums XLA fuses; it makes JAX's
collectives (``utils.count_collectives``) and assembles no input.  Each
result also equals the port's single-op sharded call and JAX's
single-device Grid op value for value.
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
from tests.test_torch_face_sharded_engine import cross_xz, smooth3, smooth5
from tests.test_torch_face_sharded_ops import assert_values, sprinkle_nonfinite
from tests.torch_parity import assert_close, to_numpy
from xgcm_tpu.utils import count_collectives as jax_count
from xgcm_tpu_torch.utils.inspection import count_collectives as torch_count

CPU8 = [torch.device("cpu")] * 8
N = 8
SPEC_3D = {"face": "f", "y": "r", "yl": "r", "x": "c", "xl": "c"}
C_GRID = {"xc": "x", "xg": "x", "yc": "y", "yg": "y"}


# ------------------------------------------------------------------ grids
@functools.lru_cache(maxsize=None)
def _grids(kind):
    """(JAX grid, port grid, {name: (numpy data, dims)}) of one test grid."""
    if kind == "cgrid":
        nx = ny = 16
        coords = {
            "xc": ("xc", np.arange(nx) + 0.5, {"axis": "X"}),
            "xg": ("xg", np.arange(nx) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
            "yc": ("yc", np.arange(ny) + 0.5, {"axis": "Y"}),
            "yg": ("yg", np.arange(ny) * 1.0, {"axis": "Y", "c_grid_axis_shift": -0.5}),
        }
        rng = np.random.RandomState(7)
        fields = {"u": (rng.rand(ny, nx), ("yc", "xg")), "v": (rng.rand(ny, nx), ("yg", "xc"))}
        return (xgcm_tpu.Grid(xgcm_tpu.Dataset(coords=coords)),
                xtt.Grid(xtt.Dataset(coords=coords)), fields)
    ds, fc = (llc_dataset if kind == "llc" else cubed_sphere_dataset)(n=N)
    rng = np.random.RandomState(41)
    if kind in ("cs", "llc"):
        nf = 13 if kind == "llc" else 6
        fields = {k: (sprinkle_nonfinite(rng, rng.rand(nf, N, N)), dims) for k, dims in
                  (("c", ("face", "y", "x")), ("u", ("face", "y", "xl")),
                   ("v", ("face", "yl", "x")))}
        return (xgcm_tpu.Grid(ds, face_connections=fc),
                xtt.Grid(xtt.from_numpy_dataset(ds), face_connections=fc), fields)
    nz = 8  # "csz": the cubed sphere with a Z axis
    coords = {
        "x": ("x", np.arange(N) + 0.5, {"axis": "X"}),
        "xl": ("xl", np.arange(N) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
        "y": ("y", np.arange(N) + 0.5, {"axis": "Y"}),
        "yl": ("yl", np.arange(N) * 1.0, {"axis": "Y", "c_grid_axis_shift": -0.5}),
        "z": ("z", np.arange(nz) + 0.5, {"axis": "Z"}),
        "zl": ("zl", np.arange(nz) * 1.0, {"axis": "Z", "c_grid_axis_shift": -0.5}),
        "face": ("face", np.arange(6)),
    }
    fields = {"q": (sprinkle_nonfinite(rng, rng.rand(6, nz, N, N)), ("face", "z", "y", "x"))}
    return (xgcm_tpu.Grid(xgcm_tpu.Dataset(coords=coords), face_connections=fc),
            xtt.Grid(xtt.Dataset(coords=coords), face_connections=fc), fields)


def _explicit(pkg, name, arg, axis, **kw):
    """A spec with the gridops ufunc ``name`` given by func/signature."""
    op = getattr(pkg.core.gridops, name)
    return dict(func=op.ufunc, args=[arg], axis=[(axis,)], signature=op.signature,
                boundary_width=op.boundary_width, **kw)


def _diag_specs(pkg, a):
    """The zeta/div/ke op set as generic specs (6 ops, 2 inputs)."""
    u, v = a["u"], a["v"]
    return [_explicit(pkg, "diff_center_to_left", v, "X"),
            _explicit(pkg, "diff_center_to_left", u, "Y"),
            _explicit(pkg, "diff_left_to_center", u, "X"),
            _explicit(pkg, "diff_left_to_center", v, "Y"),
            _explicit(pkg, "interp_left_to_center", u, "X"),
            _explicit(pkg, "interp_left_to_center", v, "Y")]


def _custom(func, arg, axes, widths, boundary):
    return dict(func=func, args=arg, axis=[tuple(axes)],
                signature="(" + ",".join(f"{a}:center" for a in axes) + ")->("
                + ",".join(f"{a}:center" for a in axes) + ")",
                boundary_width=widths, boundary=boundary)


def face_analysis_specs(pkg, a):
    """The eight ops of chip_smoke.py's face analysis, by name: the two
    scalar theta diffs, the two vector diffs of zeta, and the vector diffs
    and interps of the divergence and of the 2-D vector interp."""
    t, u, v = a["c"], a["u"], a["v"]
    return [dict(op="diff", args=t, axis="X"),
            dict(op="diff", args=t, axis="Y"),
            dict(op="diff", args={"X": v}, axis="X", other_component={"Y": u}),
            dict(op="diff", args={"Y": u}, axis="Y", other_component={"X": v}),
            dict(op="diff", args={"X": u}, axis="X", other_component={"Y": v}),
            dict(op="diff", args={"Y": v}, axis="Y", other_component={"X": u}),
            dict(op="interp", args={"X": u}, axis="X", to="center", other_component={"Y": v}),
            dict(op="interp", args={"Y": v}, axis="Y", to="center", other_component={"X": u})]


# name: (grid, mesh axes, mapping, specs(pkg, arrays), through ShardedGrid, exact)
CASES = {
    # TestApplyManyCGrid
    "cgrid-diagnostics-2x2": ("cgrid", {"x": 2, "y": 2}, C_GRID, _diag_specs, False, True),
    "mixed-widths-x4": ("cgrid", {"x": 4}, {"xc": "x", "xg": "x"}, lambda pkg, a: [
        _explicit(pkg, "interp_left_to_center", a["u"], "X"),
        dict(func=smooth5, args=[a["u"]], axis=[("X",)], signature="(X:left)->(X:left)",
             boundary_width={"X": (2, 2)}),
    ], False, False),
    # TestApplyManyFaces
    "face-batch-f6": ("cs", {"f": 6}, {"face": "f"}, lambda pkg, a: [
        _explicit(pkg, "diff_center_to_left", a["c"], "X", boundary="fill"),
        _explicit(pkg, "interp_center_to_left", a["c"], "Y", boundary="fill"),
    ], False, True),
    "sharded-grid-api-f3": ("cs", {"f": 3}, {"face": "f"}, lambda pkg, a: [
        _explicit(pkg, "diff_center_to_left", a["c"], "X", boundary="extend"),
        _explicit(pkg, "diff_center_to_left", a["c"], "Y", boundary="extend"),
    ], True, True),
    # TestApplyManyVector
    "face-vector-batch-f6": ("cs", {"f": 6}, {"face": "f"}, lambda pkg, a: [
        {**_explicit(pkg, "diff_left_to_center", {"X": a["u"]}, "X", boundary="fill"),
         "other_component": [{"Y": a["v"]}]},
        {**_explicit(pkg, "diff_left_to_center", {"Y": a["v"]}, "Y", boundary="fill"),
         "other_component": [{"X": a["u"]}]},
    ], True, True),
    # TestNameBasedSpecs
    "named-ops-2x2": ("cgrid", {"x": 2, "y": 2}, C_GRID, lambda pkg, a: [
        dict(op="diff", args=a["v"], axis="X"),
        dict(op="interp", args=a["u"], axis="X", to="center"),
        dict(op="max", args=a["v"], axis="Y", boundary="extend"),
    ], True, True),
    "named-vector-f6": ("cs", {"f": 6}, {"face": "f"}, lambda pkg, a: [
        dict(op="diff", args={"X": a["u"]}, axis="X", to="center", boundary="fill",
             other_component=[{"Y": a["v"]}]),
    ], True, True),
    # test_apply_many_face_grid_z_batch_without_face_mapping
    "z-batch-without-face-mapping": ("csz", {"zm": 8}, {"z": "zm"}, lambda pkg, a: [
        dict(op="diff", args=a["q"], axis="X", boundary="fill"),
        dict(op="interp", args=a["q"], axis="Y", boundary="fill"),
    ], True, True),
    # test_face_sharded_3d.py::test_apply_many_one_exchange
    "one-exchange-3d": ("cs", {"f": 2, "r": 2, "c": 2}, SPEC_3D, lambda pkg, a: [
        dict(func=pkg.core.gridops.diff_center_to_left.ufunc, args=a["c"], axis=[("X",)],
             signature="(X:center)->(X:left)", boundary_width={"X": (1, 0)}, boundary="fill"),
        dict(func=pkg.core.gridops.interp_center_to_left.ufunc, args=a["c"], axis=[("Y",)],
             signature="(Y:center)->(Y:left)", boundary_width={"Y": (1, 0)}, boundary="fill"),
    ], True, True),
    # test_face_sharded_nonface_axis.py::test_apply_many_sharded_z_on_face_grid
    "sharded-z-on-face-grid": ("csz", {"f": 2, "zm": 4}, {"face": "f", "z": "zm"},
                               lambda pkg, a: [
        _custom(smooth3, a["q"], ("Z",), {"Z": (1, 1)}, "extend"),
        _custom(cross_xz, a["q"], ("X", "Z"), {"X": (1, 1), "Z": (1, 1)}, "fill"),
    ], True, False),
    # chip_smoke.py's batch: the 13-face LLC over 4 shards (16 faces with
    # the dummy ones)
    "face-analysis-llc-f4": ("llc", {"f": 4}, {"face": "f"}, face_analysis_specs, True, True),
}


def _meshes(axes):
    n = int(np.prod(list(axes.values())))
    return jpar.make_mesh(axes, devices=jax.devices()[:n]), tpar.make_mesh(axes, devices=CPU8)


def _apply(pkg, par, grid, mesh, spec, specs, via_sg):
    if via_sg:
        return par.ShardedGrid(grid, mesh, spec).apply_many(specs)
    return par.sharded_apply_many(specs, grid=grid, mesh=mesh, dim_to_mesh_axis=spec)


def _single(g, spec, pkg):
    """One spec as the single op of ``g`` (a Grid or a ShardedGrid): the
    named Grid op, or ``apply_as_grid_ufunc``."""
    args = spec["args"] if isinstance(spec["args"], list) else [spec["args"]]
    oc = spec.get("other_component")
    if "op" in spec:
        kw = {k: spec[k] for k in ("to", "boundary", "fill_value") if k in spec}
        if oc is not None:
            kw["other_component"] = oc[0] if isinstance(oc, list) else oc
        return getattr(g, spec["op"])(args[0], spec["axis"], **kw)
    kw = {k: spec[k] for k in ("boundary", "fill_value", "other_component") if k in spec}
    return g.apply_as_grid_ufunc(spec["func"], *args, axis=spec["axis"],
                                 signature=spec["signature"],
                                 boundary_width=spec["boundary_width"], **kw)


def _run(case):
    """(port results, port collectives, JAX results under jit, JAX
    collectives, JAX grid, port ShardedGrid, JAX arrays, port arrays)."""
    kind, axes, spec, specs, via_sg, _ = CASES[case]
    jgrid, tgrid, fields = _grids(kind)
    jmesh, tmesh = _meshes(axes)
    names = list(fields)

    def jfn(*datas):
        a = {k: xgcm_tpu.GriddedArray(d, fields[k][1], name=k) for k, d in zip(names, datas)}
        return tuple(o.data for o in _apply(xgcm_tpu, jpar, jgrid, jmesh, spec,
                                            specs(xgcm_tpu, a), via_sg))

    datas = [fields[k][0] for k in names]
    want = jax.jit(jfn)(*datas)
    jcc = jax_count(jfn, *datas)
    sg = tpar.ShardedGrid(tgrid, tmesh, spec)
    # 13 faces do not divide 4 shards: the inputs stay whole, and each
    # result's real faces are assembled once (the dummy faces dropped)
    dummy = kind == "llc"
    ta = {k: xtt.GriddedArray(d, dims, name=k) for k, (d, dims) in fields.items()}
    if not dummy:
        ta = {k: sg.shard(a) for k, a in ta.items()}
    box = []
    tpar.reset_assembly_count()
    tcc = torch_count(lambda: box.extend(_apply(xtt, tpar, tgrid, tmesh, spec,
                                                specs(xtt, ta), via_sg)))
    # no input gathered, no result assembled but for dropping dummy faces
    assert tpar.assembly_count() == (len(box) if dummy else 0)
    ja = {k: xgcm_tpu.GriddedArray(d, dims, name=k) for k, (d, dims) in fields.items()}
    return box, tcc, want, jcc, jgrid, sg, ja, ta


@pytest.mark.parametrize("case", list(CASES))
def test_apply_many_matches_jax(case):
    """Each op of the batch equals JAX's batch (under jax.jit) and JAX's
    single-device op, with JAX's collective count; each result stays
    sharded."""
    kind, _, _, specs, _, exact = CASES[case]
    got, tcc, want, jcc, jgrid, sg, ja, ta = _run(case)
    assert tcc == {("psum" if "psum" in k else k): v for k, v in jcc.items()}
    assert len(got) == len(want)
    for g, w, js, ts in zip(got, want, specs(xgcm_tpu, ja), specs(xtt, ta)):
        assert isinstance(g.data, tpar.ShardedTensor) != (kind == "llc")
        if exact:
            assert_values(g, np.asarray(w))
        else:
            # XLA fuses the custom ufunc's sums (the JAX tests' rtol)
            assert_close(g, np.asarray(w), rtol=1e-12)
        assert_values(g, _single(jgrid, js, xgcm_tpu))
        assert_values(g, _single(sg, ts, xtt))


def test_face_analysis_batch_budget():
    """The face analysis's eight ops pad five distinct (input, boundary
    conditions, vector role) keys: theta once for its two diffs (one
    all_gather of its strip pool), and u and v once in each of their two
    vector roles (X component with Y partner, and the reverse; two
    all_gathers each, the partner's pool too): nine all_gathers, where the
    eight separate ops make fourteen (chip_smoke.py's FACE_BATCH_BUDGET)."""
    _, tcc, _, jcc, *_ = _run("face-analysis-llc-f4")
    assert tcc == jcc == {"all_gather": 9, "total": 9}


def test_diagnostics_batch_matches_fused_program():
    """TestApplyManyCGrid: zeta, div and ke from the six-op batch equal
    the hand-fused sharded diagnostics (assert_allclose's default, the
    JAX test's), and the batch makes the fused program's collectives where
    the chain of six separate ops makes more, in both packages."""
    jgrid, tgrid, fields = _grids("cgrid")
    jmesh, tmesh = _meshes({"x": 2, "y": 2})
    (u, udims), (v, vdims) = fields["u"], fields["v"]

    def many(pkg, par, grid, mesh, ud, vd):
        a = {"u": pkg.GriddedArray(ud, udims), "v": pkg.GriddedArray(vd, vdims)}
        return tuple(o.data for o in par.sharded_apply_many(
            _diag_specs(pkg, a), grid=grid, mesh=mesh, dim_to_mesh_axis=C_GRID))

    def fused(pkg, par, grid, mesh, ud, vd):
        out = par.sharded_cgrid_diagnostics(grid, pkg.GriddedArray(ud, udims),
                                            pkg.GriddedArray(vd, vdims), mesh, C_GRID)
        return tuple(o.data for o in out)

    def chained(pkg, par, grid, mesh, ud, vd):
        sg = par.ShardedGrid(grid, mesh, C_GRID)
        uu, vv = pkg.GriddedArray(ud, udims), pkg.GriddedArray(vd, vdims)
        return (sg.diff(vv, "X").data, sg.diff(uu, "Y").data,
                sg.diff(uu, "X", to="center").data, sg.diff(vv, "Y", to="center").data,
                sg.interp(uu, "X", to="center").data, sg.interp(vv, "Y", to="center").data)

    names = ("ppermute", "all_gather", "all_to_all")
    counts = {}
    for label, fn in (("many", many), ("fused", fused), ("chained", chained)):
        j = jax_count(functools.partial(fn, xgcm_tpu, jpar, jgrid, jmesh), u, v,
                      names=names)["total"]
        t = torch_count(fn, xtt, tpar, tgrid, tmesh, u, v, names=names)["total"]
        assert t == j, (label, t, j)
        counts[label] = t
    assert counts["many"] == counts["fused"] == 4 < counts["chained"]

    dvdx, dudy, dudx, dvdy, u_c, v_c = many(xtt, tpar, tgrid, tmesh, u, v)
    ez, ed, ek = fused(xtt, tpar, tgrid, tmesh, u, v)
    for got, want in ((dvdx - dudy, ez), (dudx + dvdy, ed),
                      (0.5 * (u_c * u_c + v_c * v_c), ek)):
        assert_close(got, want, rtol=1e-7)


def test_mixed_widths_pad_once():
    """An interp (width (0, 1)) and a five-point smoother (width (2, 2))
    on one input share one pad at (2, 2): two ppermutes in all."""
    got, tcc, *_ = _run("mixed-widths-x4")
    assert tcc == {"ppermute": 2, "total": 2}


def test_cumsum_is_refused():
    """Prefix sums have their own collective plan: both packages refuse a
    cumsum spec with the same message."""
    jgrid, tgrid, fields = _grids("cgrid")
    jmesh, tmesh = _meshes({"x": 2})
    u, dims = fields["u"]
    msgs = []
    for pkg, par, grid, mesh in ((xgcm_tpu, jpar, jgrid, jmesh), (xtt, tpar, tgrid, tmesh)):
        sg = par.ShardedGrid(grid, mesh, {"xc": "x", "xg": "x"})
        with pytest.raises(ValueError, match="cumsum") as info:
            sg.apply_many([dict(op="cumsum", args=sg.shard(pkg.GriddedArray(u, dims)),
                                axis="X")])
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("spec", [
    dict(op="diff", axis=("X", "Y")),
    dict(op="diff", axis="X"),
])
def test_face_grid_refusals_match_jax(spec):
    """On a face grid whose face dim is local: a name-based spec over two
    axes, and vector components, are refused with JAX's errors."""
    jgrid, tgrid, fields = _grids("cs")
    jmesh, tmesh = _meshes({"y": 2})
    msgs = []
    for pkg, par, grid, mesh in ((xgcm_tpu, jpar, jgrid, jmesh), (xtt, tpar, tgrid, tmesh)):
        a = {k: pkg.GriddedArray(d, dims) for k, (d, dims) in fields.items()}
        args = a["c"] if isinstance(spec["axis"], tuple) else {"X": a["u"]}
        with pytest.raises((ValueError, NotImplementedError)) as info:
            par.sharded_apply_many([{**spec, "args": args, "other_component": [{"Y": a["v"]}]}],
                                   grid=grid, mesh=mesh, dim_to_mesh_axis={"z": "y"})
        msgs.append((type(info.value), str(info.value)))
    assert msgs[0] == msgs[1]


def test_sharded_face_connected_dim_without_face_mapping_is_refused():
    """A sharded in-face dim with the face dim local has no shard-local
    halo: JAX's NotImplementedError."""
    jgrid, tgrid, fields = _grids("cs")
    jmesh, tmesh = _meshes({"r": 2})
    c, dims = fields["c"]
    msgs = []
    for pkg, par, grid, mesh in ((xgcm_tpu, jpar, jgrid, jmesh), (xtt, tpar, tgrid, tmesh)):
        with pytest.raises(NotImplementedError) as info:
            par.sharded_apply_many([dict(op="diff", args=pkg.GriddedArray(c, dims), axis="X")],
                                   grid=grid, mesh=mesh, dim_to_mesh_axis={"y": "r"})
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] and "face-connected dims" in msgs[1]


def test_empty_batch():
    jgrid, tgrid, _ = _grids("cgrid")
    jmesh, tmesh = _meshes({"x": 2})
    assert tpar.sharded_apply_many([], grid=tgrid, mesh=tmesh, dim_to_mesh_axis={}) == []
    assert jpar.sharded_apply_many([], grid=jgrid, mesh=jmesh, dim_to_mesh_axis={}) == []
