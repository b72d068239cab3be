"""The ECCO v4r4 heat budget on ``grids.ecco_llc_grid`` and the route of
length-preserving ops along an axis that no face connection names.

On the CPU: the budget of ``benchmark/recipes/ecco-heat-budget.py`` at
n = 12, nz = 5, nt = 3 (land columns included) against the plain reference
``benchmark/reference/ecco-heat-budget.py``, each term with its NaN
positions exact; every fusable op and position pair along Z on a
face-connected grid takes kernel A, opens no generic face pad and equals
the generic engine bit for bit, NaN and infinities included; one Z diff
against the JAX package's single-device route.  On a CUDA card (tests
marked ``cuda``, skipped elsewhere): the Z route launches A and equals the
CPU result, E on 90-wide faces takes its scalar route, and the budget at
n = 90, nz = 50, nt = 2 agrees with the reference.  The module imports no
JAX (the parity case imports it inside), so the card's machine runs it
with ``--noconftest -m cuda``.
"""

import json
import pathlib
import sys
import time
import warnings

import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (the port's host data on the CPU)
import xgcm_tpu_torch as xtt
from xgcm_tpu_torch.core import device as port_device
from xgcm_tpu_torch.core import gridops, padding
from xgcm_tpu_torch.ops import fused
from xgcm_tpu_torch.ops.kernels import build, face_shift

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
TERMS = ("G_total", "G_advection", "G_diffusion", "G_forcing")
SEED = 2**31 + 4111  # more than 32 signed bits hold
BCS = ("fill", "extend", "extrapolate", "periodic")
# position pairs along Z, by the names of its dims
Z_DIMS = {"center": "k", "left": "k_l", "right": "k_u"}


def _budget(sizes, device):
    """(outputs, inputs, reference module) of one step of the cell's
    recipe at ``sizes`` on ``device``; set-up adds the grid's static fields
    to the inputs."""
    cell = harness.Cell(SPEC, "ecco-budget", sizes=sizes)
    from benchmark import inputs as inputs_mod

    gen = torch.Generator(device=device).manual_seed(SEED % 2**63)
    made = inputs_mod.make_inputs(cell.traffic["inputs"], cell.sizes, gen, device)
    state = cell.recipe.setup(xtt, cell.sizes, made, device)
    with torch.no_grad():
        out = cell.recipe.step(xtt, state, torch.profiler.record_function)
    return out, made, cell.reference


def _check_term(name, got, reference_blocks, hfacc, rel):
    """The port's ``got`` against the reference's blocks of ``name``: the
    same NaN positions, no infinity, the largest gap over the largest
    magnitude below ``rel``; NaN exactly on dry cells (land columns for
    G_total)."""
    want = torch.cat([w for n, _, w in reference_blocks if n == name]).to(got.device)
    got = got.double()
    assert got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isfinite(want[~torch.isnan(want)]).all()
    finite = torch.isfinite(want)
    gap = (got[finite] - want[finite]).abs().max()
    assert gap <= rel * want[finite].abs().max(), float(gap / want[finite].abs().max())
    dry = (hfacc == 0)
    if name == "G_total":
        dry = dry.all(0, keepdim=True).expand_as(dry)  # land columns
    assert torch.equal(torch.isnan(got), dry.expand_as(got))


@pytest.mark.parametrize("term", TERMS)
def test_budget_matches_reference(term):
    """Each term of the budget at n = 12, nz = 5, nt = 3 on the CPU: f32
    against the float64 reference within 1e-5 of the term's largest
    magnitude (its round-off reads ~1e-7), with NaN where the reference
    has NaN, on the dry cells."""
    sizes = {"nx": 12, "ny": 12, "nz": 5, "nt": 3, "nt_snp": 4}
    out, made, ref = _budget(sizes, torch.device("cpu"))
    hfacc = made["hFacC"]
    assert (hfacc == 0).all(0).any() and (hfacc > 0).any()  # land and sea
    _check_term(term, out[term], list(ref.blocks(made, "f64", months=2)), hfacc, 1e-5)


def test_budget_opens_no_generic_face_pad(monkeypatch):
    """A step launches E four times and A twice (their plain versions on
    the CPU) and falls to the generic face pad nowhere."""
    calls = {"face_shift": 0, "shift": 0}
    for name in calls:
        real = getattr(fused, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(fused, name, counted)
    cell = harness.Cell(SPEC, "ecco-budget", sizes={"nx": 8, "ny": 8, "nz": 4, "nt": 2,
                                                     "nt_snp": 3})
    from benchmark import inputs as inputs_mod

    made = inputs_mod.make_inputs(cell.traffic["inputs"], cell.sizes,
                                  torch.Generator().manual_seed(1), torch.device("cpu"))
    state = cell.recipe.setup(xtt, cell.sizes, made, torch.device("cpu"))
    calls.update(face_shift=0, shift=0)
    before = padding.FACE_PADS["calls"]
    cell.recipe.step(xtt, state, torch.profiler.record_function)
    assert padding.FACE_PADS["calls"] == before
    assert calls == cell.recipe.LAUNCHES == {"face_shift": 4, "shift": 2}


def test_ecco_llc_grid_names_and_fields():
    """The v4r4 native names on five axes, the LLC connections on ``tile``,
    and the static fields as coordinates."""
    ra = np.full((13, 6, 6), 1e9)
    ds, grid = xtt.grids.ecco_llc_grid(n=6, nz=4, nt=2, rA=ra, drF=np.full(4, 10.0))
    assert {a: dict(grid.axes[a].coords) for a in grid.axes} == {
        "X": {"center": "i", "left": "i_g"}, "Y": {"center": "j", "left": "j_g"},
        "Z": {"center": "k", "left": "k_l", "right": "k_u", "outer": "k_p1"},
        "T": {"center": "time", "outer": "time_snp"}}
    assert grid._facedim == "tile" and grid._face_axes == ["X", "Y"]
    assert ds.sizes == {"i": 6, "i_g": 6, "j": 6, "j_g": 6, "k": 4, "k_l": 4, "k_u": 4,
                        "k_p1": 5, "time": 2, "time_snp": 3, "tile": 13}
    assert ds["rA"].dims == ("tile", "j", "i") and np.array_equal(ds["rA"].values, ra)
    assert "hFacC" not in ds and "Depth" not in ds


def _same_bits(a, b):
    """Equal bit for bit, any NaN counted as one NaN."""
    a, b = a.data, b.data
    assert a.dtype == b.dtype and a.shape == b.shape
    canon = torch.tensor(float("nan"), dtype=a.dtype)
    view = torch.int32 if a.dtype == torch.float32 else torch.int64
    a = torch.where(torch.isnan(a), canon, a).view(view)
    b = torch.where(torch.isnan(b), canon, b).view(view)
    assert torch.equal(a, b)


def _z_field(pos, dtype, seed=0):
    """(time, Z position, tile, j, i) values with NaN, +inf and -inf at the
    top, inside and at the bottom of the levels."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 5, 13, 4, 4), generator=g, dtype=torch.float64)
    x[0, 0, 3, 1, 2] = float("nan")
    x[1, 2, 7, 0, 0] = float("inf")
    x[0, 4, 12, 3, 3] = -float("inf")
    x[1, 4, 0, 2, 1] = float("nan")
    return xtt.GriddedArray(x.to(dtype), ("time", Z_DIMS[pos], "tile", "j", "i"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("boundary", BCS)
@pytest.mark.parametrize("pair", sorted(fused.FUSABLE_PAIRS))
@pytest.mark.parametrize("op", fused.FUSABLE_OPS)
def test_z_ops_on_faces_equal_the_generic_engine(op, pair, boundary, dtype, monkeypatch):
    """Along Z on a face-connected grid, bit for bit equal to the generic
    engine, which pads every face: through kernel A's route (its plain
    version here) with no generic face pad, but for ``extrapolate``, which
    stays on the generic engine (it extrapolates as x0 - (x1 - x0), A as
    2 x0 - x1, and the two round apart)."""
    frm, to = pair
    _, grid = xtt.grids.ecco_llc_grid(n=4, nz=5, nt=2)
    a = _z_field(frm, dtype)
    taken = []
    real = fused.fused_shift_op
    monkeypatch.setattr(fused, "fused_shift_op",
                        lambda *args, **kw: taken.append(args[1:4]) or real(*args, **kw))
    before = padding.FACE_PADS["calls"]
    kw = dict(to=to, boundary=boundary, fill_value=2.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = getattr(grid, op)(a, "Z", **kw)
    on_a = boundary != "extrapolate"
    assert taken == ([(1, op, fused.FUSABLE_PAIRS[pair])] if on_a else [])
    assert padding.FACE_PADS["calls"] == before + (0 if on_a else 1)
    generic = getattr(gridops, f"{op}_{frm}_to_{to}")(
        grid, a, axis=[("Z",)], boundary=boundary, fill_value=2.5)
    assert got.dims == generic.dims == ("time", Z_DIMS[to], "tile", "j", "i")
    _same_bits(got, generic)


def test_face_ops_keep_e():
    """Along X and Y the face grid still takes E (its plain version here):
    the Z route leaves the face axes as they were."""
    _, grid = xtt.grids.ecco_llc_grid(n=4, nz=5, nt=2)
    u = xtt.GriddedArray(torch.randn(2, 5, 13, 4, 4), ("time", "k", "tile", "j", "i_g"))
    v = xtt.GriddedArray(torch.randn(2, 5, 13, 4, 4), ("time", "k", "tile", "j_g", "i"))
    before = padding.FACE_PADS["calls"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        fast = grid.diff_2d_vector({"X": u, "Y": v}, boundary="fill")
    assert padding.FACE_PADS["calls"] == before
    for axis, comp, partner in (("X", u, v), ("Y", v, u)):
        generic = gridops.diff_left_to_center(
            grid, {axis: comp}, axis=[(axis,)], boundary="fill",
            other_component={"Y" if axis == "X" else "X": partner})
        _same_bits(fast[axis], generic)
    assert padding.FACE_PADS["calls"] == before + 2


def test_z_diff_matches_jax_single_device():
    """The budget's vertical diff (k_l to k, fill) on the LLC face grid
    equals the JAX package's single-device route value for value."""
    import xgcm_tpu

    from tests.torch_parity import assert_bitwise

    n, nz = 4, 5
    coords = {
        "i": np.arange(n), "i_g": np.arange(n), "j": np.arange(n), "j_g": np.arange(n),
        "k": np.arange(nz), "k_l": np.arange(nz), "tile": np.arange(13),
    }
    axes = {"X": {"center": "i", "left": "i_g"}, "Y": {"center": "j", "left": "j_g"},
            "Z": {"center": "k", "left": "k_l"}}
    fc = {"tile": xtt.grids.LLC_CONNECTIONS["face"]}
    w = _z_field("left", torch.float64, seed=3).data.numpy()[0]
    dims = ("k_l", "tile", "j", "i")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        g_j = xgcm_tpu.Grid(xgcm_tpu.Dataset(coords={k: (k, v) for k, v in coords.items()}),
                            coords=axes, face_connections=fc, periodic=False,
                            autoparse_metadata=False)
        want = g_j.diff(xgcm_tpu.GriddedArray(w, dims), "Z", boundary="fill")
    _, g_t = xtt.grids.ecco_llc_grid(n=n, nz=nz, nt=1)
    got = g_t.diff(xtt.GriddedArray(torch.as_tensor(w), dims), "Z", boundary="fill")
    assert got.dims == tuple(want.dims) == ("k", "tile", "j", "i")
    assert_bitwise(got, want)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda(monkeypatch):
    """The card, with host data going to it for the test's duration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(port_device, "_default", torch.device("cuda"))
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("boundary", ("fill", "extend", "periodic"))
@pytest.mark.parametrize("pair", sorted(fused.FUSABLE_PAIRS))
@pytest.mark.parametrize("op", fused.FUSABLE_OPS)
def test_z_route_launches_a_on_card(op, pair, boundary, cuda):
    """Along Z on the face grid, on the card: one launch of A, no generic
    face pad, and the CPU's result (A's plain version) bit for bit."""
    frm, to = pair
    _, grid = xtt.grids.ecco_llc_grid(n=90, nz=5, nt=2)
    a = xtt.GriddedArray(torch.randn(2, 5, 13, 90, 90),
                         ("time", Z_DIMS[frm], "tile", "j", "i"))
    a.data[0, 0, 3, 1, 2] = float("nan")
    a.data[1, 4, 12, 89, 89] = float("inf")
    a.data[0, 4, 0, 0, 0] = -float("inf")
    kw = dict(to=to, boundary=boundary, fill_value=2.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = getattr(grid, op)(a, "Z", **kw)
        build.reset_launch_counts()
        before = padding.FACE_PADS["calls"]
        got = getattr(grid, op)(a.with_data(a.data.to(cuda)), "Z", **kw)
        torch.cuda.synchronize()
        assert build.launch_counts()["shift"] == 1
        assert build.launch_counts()["face_shift"] == 0
        assert padding.FACE_PADS["calls"] == before
        _same_bits(got.with_data(got.data.cpu()), want)
        # the generic engine on the card, bit for bit too
        generic = getattr(gridops, f"{op}_{frm}_to_{to}")(
            grid, a.with_data(a.data.to(cuda)), axis=[("Z",)], boundary=boundary,
            fill_value=2.5)
    _same_bits(got.with_data(got.data.cpu()), generic.with_data(generic.data.cpu()))


@pytest.mark.cuda
def test_face_shift_on_90_wide_faces_takes_the_scalar_route(cuda):
    """E on LLC90's 90-wide faces, with the budget's leading dims: every
    launch on the scalar route, equal to the CPU result."""
    _, grid = xtt.grids.ecco_llc_grid(n=90, nz=3, nt=2)
    u = torch.randn(2, 3, 13, 90, 90)
    v = torch.randn(2, 3, 13, 90, 90)
    dims_u, dims_v = ("time", "k", "tile", "j", "i_g"), ("time", "k", "tile", "j_g", "i")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = grid.diff_2d_vector({"X": xtt.GriddedArray(u, dims_u),
                                    "Y": xtt.GriddedArray(v, dims_v)}, boundary="fill")
        routes = dict(face_shift.ROUTES)
        got = grid.diff_2d_vector({"X": xtt.GriddedArray(u.to(cuda), dims_u),
                                   "Y": xtt.GriddedArray(v.to(cuda), dims_v)}, boundary="fill")
    torch.cuda.synchronize()
    assert {k: face_shift.ROUTES[k] - routes[k] for k in routes} == {
        "rows": 0, "planes": 0, "scalar": 2}
    for axis in ("X", "Y"):
        _same_bits(got[axis].with_data(got[axis].data.cpu()), want[axis])


@pytest.mark.cuda
def test_budget_on_card_matches_reference(cuda):
    """The budget at n = 90, nz = 50, nt = 2 on the card against the float64
    reference (on the card), each term within 1e-5 of its largest
    magnitude, NaN on the dry cells."""
    t0 = time.perf_counter()
    out, made, ref = _budget({"nt": 2, "nt_snp": 3}, cuda)
    blocks = list(ref.blocks(made, "f64", months=2))
    for term in TERMS:
        _check_term(term, out[term], blocks, made["hFacC"], 1e-5)
    assert time.perf_counter() - t0 < 600
