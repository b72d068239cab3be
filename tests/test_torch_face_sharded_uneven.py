"""The padded layout of the sharded layer: 13 LLC faces over four shards.

A face dim that its mesh axis does not divide stays sharded: 4 faces a
block, the last block 1 real face and 3 dummy ones as its padding.  Here,
on four logical CPU shards, ``llc_grid(n=8)`` fields of 3 levels in the
(z, face, y, x) layout, float32 and float64, with NaN and +-inf on face
edges: ``ShardedGrid.shard`` places them so, the face analysis of the
benchmark's ``levels-4gpu`` cell (eight calls and the arithmetic between
their results) equals the single-device ``Grid`` calls bit for bit with no
assembly, nothing shows a dummy face, and the ``xtt.sharded.*`` spans and
``TRANSPORT["peer_bytes"]`` count what the layer does.
"""

import importlib.util
import pathlib
import warnings

import numpy as np
import pytest
import torch

import xgcm_tpu_torch as xtt
import xgcm_tpu_torch.parallel as tpar
import tests.torch_parity  # noqa: F401  (the port's host data on the CPU)
from xgcm_tpu_torch.parallel import collectives
from xgcm_tpu_torch.utils import reset_spans, span_totals

N, NZ, SHARDS, FACES = 8, 3, 4, 13
FPD = -(-FACES // SHARDS)
DTYPES = [torch.float32, torch.float64]
ROOT = pathlib.Path(__file__).resolve().parents[1]
DIMS = {"theta": ("z", "face", "y", "x"), "u": ("z", "face", "y", "xl"),
        "v": ("z", "face", "yl", "x")}


def _nonfinite_edges(x):
    """NaN, +inf and -inf on the halo sources of faces 0, 6, 9 and 12 on
    every level (the benchmark's ``nonfinite_face_edges``)."""
    x[..., 0, 5, 0] = float("nan")
    x[..., 6, N - 1, 5] = float("inf")
    x[..., 9, 3, N - 1] = -float("inf")
    x[..., 12, 0, N - 3] = float("nan")
    return x


def _fields(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: _nonfinite_edges(torch.randn((NZ, FACES, N, N), generator=g, dtype=dtype))
            for k in DIMS}


def _setup(dtype):
    _, grid = xtt.grids.llc_grid(n=N)
    mesh = tpar.make_mesh({"f": SHARDS}, devices=[torch.device("cpu")] * SHARDS)
    sg = tpar.ShardedGrid(grid, mesh, {"face": "f"})
    plain = {k: xtt.GriddedArray(v, DIMS[k], name=k) for k, v in _fields(dtype).items()}
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the face dim is sharded, not replicated
        placed = {k: sg.shard(a) for k, a in plain.items()}
    return grid, sg, plain, placed


def _calls(G, a):
    """The eight calls of the face analysis and the arithmetic between their
    results, by name (``recipes/face-analysis-levels.py``)."""
    t, u, v = a["theta"], a["u"], a["v"]
    out = {"dtheta_dx": G.diff(t, "X"), "dtheta_dy": G.diff(t, "Y"),
           "dv_dx": G.diff({"X": v}, "X", other_component={"Y": u}),
           "du_dy": G.diff({"Y": u}, "Y", other_component={"X": v}),
           "du_dx": G.diff({"X": u}, "X", other_component={"Y": v}),
           "dv_dy": G.diff({"Y": v}, "Y", other_component={"X": u})}
    out["zeta"] = out["dv_dx"] - out["du_dy"]
    out["div"] = out["du_dx"] + out["dv_dy"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        vec = G.interp_2d_vector({"X": u, "Y": v}, to="center")
    out["u_c"], out["v_c"] = vec["X"], vec["Y"]
    return out


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _assert_bitwise(got, want):
    assert got.dims == want.dims
    full = got.data.full_tensor() if isinstance(got.data, tpar.ShardedTensor) else got.data
    assert full.dtype == want.data.dtype and full.shape == want.data.shape
    assert torch.equal(_bits(full), _bits(want.data))


@pytest.fixture(scope="module", params=DTYPES, ids=["f32", "f64"])
def analysis(request):
    """(single-device results, sharded results, the placed inputs, the
    plain inputs, assemblies during the sharded analysis)."""
    grid, sg, plain, placed = _setup(request.param)
    tpar.reset_assembly_count()
    got = _calls(sg, placed)
    assemblies = tpar.assembly_count()
    return _calls(grid, plain), got, placed, plain, assemblies


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_shard_places_the_padded_layout(dtype):
    """13 faces over 4 shards: a ShardedTensor of 13 faces in its shape, 4 a
    block, the last block's 3 dummy faces zeros, placed with no warning."""
    _, _, plain, placed = _setup(dtype)
    for k, a in placed.items():
        st = a.data
        assert isinstance(st, tpar.ShardedTensor) and st.padded
        assert st.shape == (NZ, FACES, N, N) and st.spec == (None, "f", None, None)
        assert [tuple(b.shape) for b in st.blocks] == [(NZ, FPD, N, N)] * SHARDS
        assert [st.block_index((c,))[1] for c in range(SHARDS)] == [
            slice(0, 4), slice(4, 8), slice(8, 12), slice(12, 13)]
        assert torch.equal(st.blocks[-1][:, 1:], torch.zeros((NZ, 3, N, N), dtype=dtype))
        assert torch.equal(_bits(st.full_tensor()), _bits(plain[k].data))


@pytest.mark.parametrize("name", ["dtheta_dx", "dtheta_dy", "dv_dx", "du_dy", "du_dx", "dv_dy",
                                  "zeta", "div", "u_c", "v_c"])
def test_each_call_equals_the_single_device_grid(analysis, name):
    """Each of the eight calls, ``zeta = a - b`` and ``div = a + b``: a
    padded ShardedTensor equal to the single-device ``Grid`` call bit for
    bit."""
    want, got, *_ = analysis
    assert isinstance(got[name].data, tpar.ShardedTensor) and got[name].data.padded
    assert [b.shape[1] for b in got[name].data.blocks] == [FPD] * SHARDS
    _assert_bitwise(got[name], want[name])


def test_the_analysis_assembles_nothing(analysis):
    assert analysis[-1] == 0


def test_no_dummy_face_shows(analysis):
    """``full_tensor``, ``np.asarray``, ``.cpu()``, a sum and an index into
    the face dim show the 13 real faces, never a dummy one, while the last
    block's padding is not what they show."""
    want, got, *_ = analysis
    st, w = got["zeta"].data, want["zeta"].data
    st.blocks[-1][:, 1:] = 1e30  # the padding: never read
    assert tuple(st.full_tensor().shape) == (NZ, FACES, N, N)
    assert np.asarray(st).shape == (NZ, FACES, N, N)
    assert torch.equal(_bits(st.cpu()), _bits(w))
    assert torch.equal(st.nan_to_num(0.0, 0.0, 0.0).sum(), w.nan_to_num(0.0, 0.0, 0.0).sum())
    assert torch.equal(_bits(st[1, 12]), _bits(w[1, 12]))
    assert torch.equal(_bits(st[:, -1]), _bits(w[:, -1]))
    with pytest.raises(IndexError):
        st[0, 13]


def test_plain_operand_on_the_last_block(analysis):
    """A plain tensor combined with a padded result is sliced to each
    block, and padded on the last: right on the last block's real face."""
    want, got, *_ = analysis
    g = torch.Generator().manual_seed(7)
    plain = torch.rand((FACES, 1, N), generator=g, dtype=want["div"].data.dtype)
    out = got["div"].data * plain
    assert isinstance(out, tpar.ShardedTensor) and out.padded
    assert torch.equal(_bits(out.real_block((3,))), _bits((want["div"].data * plain)[:, 12:]))
    assert torch.equal(_bits(out.full_tensor()), _bits(want["div"].data * plain))


def test_min_max_and_apply_many_read_the_padded_inputs():
    """``min``, ``max`` and a batch through ``apply_many`` read the padded
    inputs as they are and give padded results equal to the single-device
    calls, with no assembly."""
    from xgcm_tpu_torch.core import gridops

    grid, sg, plain, placed = _setup(torch.float64)
    tpar.reset_assembly_count()
    mn = sg.min(placed["theta"], "X")
    mx = sg.max(placed["theta"], "Y")
    specs = [dict(func=op.ufunc, args=[placed["theta"]], axis=[(axis,)],
                  signature=op.signature, boundary_width=op.boundary_width)
             for op, axis in ((gridops.diff_center_to_left, "X"),
                              (gridops.interp_center_to_left, "Y"))]
    batch = sg.apply_many(specs)
    assert tpar.assembly_count() == 0
    _assert_bitwise(mn, grid.min(plain["theta"], "X"))
    _assert_bitwise(mx, grid.max(plain["theta"], "Y"))
    _assert_bitwise(batch[0], grid.diff(plain["theta"], "X"))
    _assert_bitwise(batch[1], grid.interp(plain["theta"], "Y"))
    assert all(isinstance(r.data, tpar.ShardedTensor) and r.data.padded
               for r in (mn, mx, *batch))


def _reference():
    path = ROOT / "benchmark" / "reference" / "face-analysis-levels.py"
    spec = importlib.util.spec_from_file_location("face_analysis_levels_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_agrees_with_the_benchmark_reference():
    """The float64 analysis against ``benchmark/reference/face-analysis-levels.py``
    level by level and face by face: within float64 rounding, non-finite
    values in the same places."""
    _, sg, plain, placed = _setup(torch.float64)
    got = _calls(sg, placed)
    inputs = {k: a.data for k, a in plain.items()}
    checked = 0
    for name, (z, f), want in _reference().blocks(inputs, "f64"):
        have = got[name].data[z, f]
        assert have.shape == want.shape
        assert torch.equal(torch.isnan(have), torch.isnan(want))
        fin = torch.isfinite(want)
        assert torch.equal(have[~fin].nan_to_num(), want[~fin].nan_to_num())
        torch.testing.assert_close(have[fin], want[fin], rtol=1e-14, atol=1e-14)
        checked += 1
    assert checked == 6 * NZ * FACES


def test_spans_and_peer_bytes():
    """Under ``torch.profiler`` one analysis opens ``xtt.sharded.strip_pool``
    once a scalar op and twice a vector op (14), ``xtt.sharded.halo_lines``
    once a block an op (32), ``xtt.sharded.blockwise`` for the views and the
    arithmetic, and neither ``xtt.sharded.assemble`` nor
    ``xtt.sharded.place``; the strip pools' gathers copy each block's strips
    to the three other shards: ``TRANSPORT["peer_bytes"]``."""
    _, sg, _, placed = _setup(torch.float64)
    collectives.TRANSPORT.clear()
    reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _calls(sg, placed)
    calls = {n: t["calls"] for n, t in span_totals().items() if n.startswith("xtt.sharded.")}
    reset_spans()
    assert calls["xtt.sharded.strip_pool"] == 14
    assert calls["xtt.sharded.halo_lines"] == 8 * SHARDS
    assert calls["xtt.sharded.blockwise"] >= 2
    assert "xtt.sharded.assemble" not in calls and "xtt.sharded.place" not in calls
    stack = NZ * FPD * 4 * 1 * N * 8  # (z, fpd, 4 sides, width 1, L) float64
    assert collectives.TRANSPORT["peer_bytes"] == 14 * SHARDS * (SHARDS - 1) * stack
    # an assembly and a placement open their spans
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tpar.reset_assembly_count()
        placed["theta"].data.full_tensor()
        sg.shard(xtt.GriddedArray(torch.zeros((NZ, FACES, N, N)), DIMS["theta"]))
        assembled = tpar.assembly_count()
    calls = {n: t["calls"] for n, t in span_totals().items() if n.startswith("xtt.sharded.")}
    reset_spans()
    assert calls["xtt.sharded.assemble"] == assembled == 1
    assert calls["xtt.sharded.place"] >= 1


def test_shard_map_keeps_the_padding():
    """A padded operand through ``shard_map``: an output dim of the padded
    block length on that mesh axis keeps the global length, so its padding
    stays hidden."""
    from xgcm_tpu_torch.parallel.collectives import map_blocks
    from xgcm_tpu_torch.parallel.sharded_tensor import distribute

    mesh = tpar.make_mesh({"f": SHARDS}, devices=[torch.device("cpu")] * SHARDS)
    x = _fields(torch.float64)["theta"]
    spec = tpar.PartitionSpec(None, "f", None, None)
    st = distribute(x, mesh, spec, padded=[1])
    out = tpar.shard_map(lambda b: map_blocks(lambda t: 2.0 * t, b, mesh=mesh), mesh, [spec],
                         spec)(st)
    assert out.padded and out.shape == x.shape
    assert torch.equal(_bits(out.full_tensor()), _bits(2.0 * x))
