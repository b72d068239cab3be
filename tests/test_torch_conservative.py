"""The port's conservative vertical transform against xgcm_tpu: the
reference case table through ``Grid.transform``, ``interp_1d_conservative``
on random columns (NaN bounds and data, degenerate cells, cells on a bin
edge; increasing, decreasing, non-monotonic and 16-bit bins; dense and deep
paths), kernels G's and H's plain versions against ``_conservative_rebin``
and the Pallas kernels in interpret mode (also on infinite bounds, whose
NaN geometry G and H treat differently, and on cells that touch or sit on
the bin edges), the kernel routes driven through
the plain versions, and gradients.  NaN footprints must be identical; values
agree to 1e-12 in float64 and 1e-6 in float32 (the JAX test's own 1e-5 for
the Pallas kernels in interpret mode), and to one unit in the last place of
the 16-bit types for bfloat16/float16 data, which both packages sum in
float32 and round once."""

import warnings

import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu_torch as xtt
from tests.test_torch_transform import _case_inputs
from tests.test_transform_cases import CASES
from tests.torch_parity import assert_bitwise, assert_close, to_numpy
from xgcm_tpu.ops import transform as jax_tf
from xgcm_tpu_torch.ops import transform as torch_tf
from xgcm_tpu_torch.ops.kernels import conservative as kg

TOL = {np.float64: 1e-12, np.float32: 1e-6}
CONSERVATIVE_CASES = [k for k, c in CASES.items() if c["kwargs"]["method"] == "conservative"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", CONSERVATIVE_CASES)
def test_conservative_cases_match(name, dtype):
    case = CASES[name]
    g_j, da_j, t_j, kw_j = _case_inputs(case, dtype, xgcm_tpu, tensor=False)
    g_t, da_t, t_t, kw_t = _case_inputs(case, dtype, xtt, tensor=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out_j = g_j.transform(da_j, "Z", t_j, **kw_j)
    if case.get("warns"):
        with pytest.warns(UserWarning, match=case["warns"]):
            out_t = g_t.transform(da_t, "Z", t_t, **kw_t)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out_t = g_t.transform(da_t, "Z", t_t, **kw_t)
    assert (out_t.dims, out_t.name) == (out_j.dims, out_j.name)
    assert out_t.dtype == torch.float64 if dtype == np.float64 else torch.float32
    assert_close(out_t, out_j, rtol=TOL[dtype], atol=TOL[dtype])
    expected = np.asarray(case["expected"], dtype=float)
    np.testing.assert_allclose(to_numpy(out_t).astype(float), expected, rtol=1e-5, atol=1e-5)


def test_conservative_errors_match():
    case = CASES["conservative_depth_depth"]
    g_t, da_t, t_t, _ = _case_inputs(case, np.float64, xtt, tensor=True)
    with pytest.raises(ValueError, match="reassociate"):
        g_t.transform(da_t, "Z", t_t, method="linear", reassociate=True)
    with pytest.raises(ValueError, match="not monotonic"):
        g_t.transform(da_t, "Z", np.array([0.0, 10, 5, 80]), method="conservative")
    target2d = xtt.GriddedArray(np.zeros((2, 5)), ("eta", "s"), name="s")
    with pytest.raises(NotImplementedError):
        g_t.transform(da_t, "Z", target2d, target_dim="s", method="conservative")
    ds = xtt.Dataset(coords={"z": ("z", np.array([5.0, 25.0, 60.0]))})
    g_no_outer = xtt.Grid(ds, coords={"Z": {"center": "z"}}, periodic=False,
                          autoparse_metadata=False)
    with pytest.raises(RuntimeError, match="outer"):
        g_no_outer.transform(da_t, "Z", t_t, method="conservative")


def _cells(cols, n, dtype, seed):
    """Raw bounds (cols, n + 1) and cells (cols, n): monotone columns with
    NaN bound tails and heads (single-NaN cells), NaN data, degenerate cells
    (one on a bin edge), descending columns, all-NaN and unsorted columns."""
    rng = np.random.RandomState(seed)
    th = np.sort(rng.rand(cols, n + 1), -1) * 20
    ph = rng.rand(cols, n) * 4 - 1
    th[0:4, n - 2:] = np.nan
    th[4:6, :2] = np.nan
    ph[6:9, 3] = np.nan
    th[9:12, 5] = th[9:12, 4]
    th[12, 4] = th[12, 5] = 7.5  # a degenerate cell exactly on an interior edge
    th[13:15] = th[13:15, ::-1]
    th[15:17] = np.nan
    rng.shuffle(th[17])  # unsorted bounds: cells in both directions
    th[18, 6] = 10.0  # a bound exactly on an edge
    return th.astype(dtype), ph.astype(dtype)


EDGES = np.linspace(-2.0, 22.0, 9)  # 7.5 and 10.0 are edges


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("direction", ["increasing", "decreasing"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_interp_1d_conservative_matches(dtype, direction, deep, monkeypatch):
    if deep:
        monkeypatch.setattr(jax_tf, "_DENSE_MEMB_BUDGET", 0)
        monkeypatch.setattr(kg, "_DENSE_MEMB_BUDGET", 0)
    th, ph = _cells(24, 10, dtype, seed=0)
    edges = EDGES.astype(dtype)
    if direction == "decreasing":
        edges = edges[::-1].copy()
    j = to_numpy(jax_tf.interp_1d_conservative(ph, th, edges))
    t = to_numpy(torch_tf.interp_1d_conservative(torch.as_tensor(ph), torch.as_tensor(th),
                                                 edges))
    assert t.dtype == dtype
    assert_close(t, j, rtol=TOL[dtype], atol=TOL[dtype])
    # the bins untouched by any valid cell are NaN, and only those
    assert np.isnan(t[15:17]).all() and not np.isnan(t[20]).all()


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_interp_1d_conservative_16bit_matches(dtype, deep, monkeypatch):
    import jax.numpy as jnp

    if deep:
        monkeypatch.setattr(jax_tf, "_DENSE_MEMB_BUDGET", 0)
        monkeypatch.setattr(kg, "_DENSE_MEMB_BUDGET", 0)
    th, ph = _cells(24, 10, np.float32, seed=1)
    th_t, ph_t, e_t = (torch.as_tensor(a).to(dtype) for a in (th, ph, EDGES.astype(np.float32)))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    # the same rounded inputs for both packages
    th_j, ph_j, e_j = (jnp.asarray(a.float().numpy()).astype(jdt) for a in (th_t, ph_t, e_t))
    t = torch_tf.interp_1d_conservative(ph_t, th_t, e_t)
    j = jax_tf.interp_1d_conservative(ph_j, th_j, np.asarray(e_j))
    assert t.dtype == dtype
    ulp = 2.0**-7 if dtype == torch.bfloat16 else 2.0**-10
    assert_close(t.float(), np.asarray(j.astype(jnp.float32)), rtol=ulp, atol=1e-3)


def test_interp_1d_conservative_validation_matches():
    th, ph = _cells(24, 10, np.float64, seed=2)
    for args in ((ph, th[:, :-1], EDGES), (ph, th, EDGES[::-1][[0, 2, 1, 3]]),
                 (ph, th, EDGES[None, :])):
        with pytest.raises(ValueError) as err_j:
            jax_tf.interp_1d_conservative(*args)
        with pytest.raises(ValueError) as err_t:
            torch_tf.interp_1d_conservative(*(torch.as_tensor(np.ascontiguousarray(a))
                                              for a in args))
        assert str(err_t.value) == str(err_j.value)


def test_reassociate_accepted_and_equal_on_cpu():
    th, ph = _cells(24, 10, np.float32, seed=3)
    args = (torch.as_tensor(ph), torch.as_tensor(th), EDGES.astype(np.float32))
    assert_bitwise(torch_tf.interp_1d_conservative(*args, reassociate=True),
                   torch_tf.interp_1d_conservative(*args))
    case = CASES["conservative_depth_dens_on_bounds"]
    g_t, da_t, t_t, kw_t = _case_inputs(case, np.float64, xtt, tensor=True)
    assert_bitwise(g_t.transform(da_t, "Z", t_t, reassociate=True, **kw_t),
                   g_t.transform(da_t, "Z", t_t, **kw_t))


def _bounds_layouts(pkg, wrap, th, ph, edges, mod):
    """The named-dim wrapper on (zo, col) bounds and (zc, col) cells."""
    return mod.conservative_interpolation(
        pkg.GriddedArray(wrap(ph), ("zc", "col"), name="q"),
        pkg.GriddedArray(wrap(th), ("zo", "col"), name="th"),
        pkg.GriddedArray(wrap(edges), ("sigma",)),
        "zc", "zo", "sigma",
    )


@pytest.mark.parametrize("kernel_route", [False, True])
def test_columns_first_layout_matches(kernel_route, monkeypatch):
    if kernel_route:
        monkeypatch.setattr(torch_tf, "_KERNEL_DEVICE", "cpu")
    th, ph = _cells(24, 9, np.float32, seed=4)
    edges = EDGES.astype(np.float32)
    o_j = _bounds_layouts(xgcm_tpu, lambda a: a, th.T.copy(), ph.T.copy(), edges, jax_tf)
    o_t = _bounds_layouts(xtt, torch.as_tensor, th.T.copy(), ph.T.copy(), edges, torch_tf)
    assert o_t.dims == o_j.dims == ("sigma", "col")
    assert_close(o_t, o_j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("direction", ["increasing", "decreasing"])
def test_kernel_route_through_plain_matches(direction, monkeypatch):
    """The kernel route (columns flattened to (cols, n) views, the
    wrapper, the flip) on CPU tensors, where the wrapper runs kernel G's
    plain version, against the JAX package; lead dims broadcast."""
    monkeypatch.setattr(torch_tf, "_KERNEL_DEVICE", "cpu")
    rng = np.random.RandomState(5)
    th = np.sort(rng.rand(1, 5, 8), -1).astype(np.float32) * 20  # broadcast lead dim
    ph = rng.rand(3, 5, 7).astype(np.float32)
    edges = EDGES.astype(np.float32)
    if direction == "decreasing":
        edges = edges[::-1].copy()
    j = to_numpy(jax_tf.interp_1d_conservative(ph, th, edges))
    t = torch_tf.interp_1d_conservative(torch.as_tensor(ph), torch.as_tensor(th), edges)
    assert_close(t, j, rtol=1e-6, atol=1e-6)


def test_plain_g_matches_rebin_and_pallas():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from xgcm_tpu.ops.pallas_transform import conservative_fused

    th, ph = _cells(48, 12, np.float32, seed=6)
    edges = np.linspace(-2, 23, 17).astype(np.float32)
    edges[7] = th[9, 4]  # an edge on a degenerate cell
    mine = kg._conservative_plain(*(torch.as_tensor(a) for a in (th, ph, edges)))
    ref, cnt = jax_tf._conservative_rebin(jnp.asarray(ph), jnp.asarray(th[:, :-1]),
                                          jnp.asarray(th[:, 1:]), jnp.asarray(edges))
    assert_close(mine, np.asarray(jnp.where(cnt > 0, ref, jnp.nan)), rtol=1e-6, atol=1e-6)
    with pltpu.force_tpu_interpret_mode():
        pallas = conservative_fused(jnp.asarray(th), jnp.asarray(ph), jnp.asarray(edges))
    assert_close(mine, np.asarray(pallas), rtol=1e-5, atol=1e-6)
    # the wrapper on CPU tensors is the plain version, in either layout
    args = [torch.as_tensor(a) for a in (th, ph, edges)]
    assert_bitwise(kg.conservative_rebin(*args), mine)
    assert_bitwise(kg.conservative_rebin(*args, out_T=True).T, mine)


def test_plain_h_matches_singles_and_pallas():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from xgcm_tpu.ops.pallas_transform import conservative_fused_multi

    rng = np.random.RandomState(17)
    th, _ = _cells(32, 10, np.float32, seed=7)
    phis = [rng.rand(32, 10).astype(np.float32) for _ in range(3)]
    phis[1][4:10, 3] = np.nan  # variable-specific NaN data
    edges = np.linspace(-2, 23, 11).astype(np.float32)
    th_t, e_t = torch.as_tensor(th), torch.as_tensor(edges)
    multi = kg._conservative_multi_plain(th_t, [torch.as_tensor(p) for p in phis], e_t)
    for o, p in zip(multi, phis):
        assert_bitwise(o, kg._conservative_plain(th_t, torch.as_tensor(p), e_t))
    with pltpu.force_tpu_interpret_mode():
        pallas = conservative_fused_multi(jnp.asarray(th), tuple(jnp.asarray(p) for p in phis),
                                          jnp.asarray(edges))
    for o, pj in zip(multi, pallas):
        assert_close(o, np.asarray(pj), rtol=1e-5, atol=1e-6)
    wrapped = kg.conservative_rebin_multi(th_t, [torch.as_tensor(p) for p in phis], e_t,
                                          out_T=True)
    for o, w in zip(multi, wrapped):
        assert_bitwise(w.T, o)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_plain_h_16bit_matches_singles(dtype):
    th, ph = _cells(20, 8, np.float32, seed=8)
    th_t, e_t = torch.as_tensor(th).to(dtype), torch.as_tensor(EDGES).to(dtype)
    phis = [torch.as_tensor(ph).to(dtype), torch.as_tensor(ph[::-1].copy()).to(dtype)]
    for o, p in zip(kg._conservative_multi_plain(th_t, phis, e_t), phis):
        assert o.dtype == dtype
        assert_bitwise(o, kg._conservative_plain(th_t, p, e_t))


def test_gradient_matches_jax():
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(9)
    th = np.sort(rng.rand(6, 9), -1) * 20
    th[1] = th[1, ::-1]
    ph = rng.rand(6, 8)
    edges = np.linspace(-1.0, 21.0, 6)
    w = rng.rand(6, 5)

    def loss_j(ph_, th_):
        out = jax_tf.interp_1d_conservative(ph_, th_, edges)
        return jnp.sum(jnp.where(jnp.isnan(out), 0.0, out) * w)

    g_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(ph), jnp.asarray(th))
    ins = [torch.tensor(a, requires_grad=True) for a in (ph, th)]
    out = torch_tf.interp_1d_conservative(*ins, edges)
    (torch.where(torch.isnan(out), 0.0, out) * torch.as_tensor(w)).sum().backward()
    for a_t, a_j in zip(ins, g_j):
        assert_close(a_t.grad, a_j, rtol=1e-12, atol=1e-12)


def _special_columns():
    """Raw bounds (12, 5) with infinite bounds and cells that touch or sit
    on the edges ``SPECIAL_EDGES``, and two fields: random data, and the
    same with NaN in the cells whose geometry an infinite bound makes NaN."""
    inf, nan = np.inf, np.nan
    th = np.array([
        [-inf, 1, 2, 3, 4],  # tmin = -inf: every bin NaN
        [0.5, 1, 2, 3, inf],  # tmax = +inf: the cell deposits 0
        [1, 2, 3, inf, inf],  # an [inf, inf] cell
        [-inf, -inf, 1, 2, 3],  # a [-inf, -inf] cell
        [nan, -inf, 1, 2, 3],  # a cell degenerate at -inf
        [1, 2, 3, inf, nan],  # a cell degenerate at +inf
        [4, 3, 2, 1, -inf],  # descending, -inf at the bottom
        [1, 2, inf, 3, 4],  # +inf inside: both its cells deposit 0
        [0.5, 1.5, 2.5, 3.5, 4.5],  # every bound on an edge: cells touch the bins
        [1.5, 1.5, 2.5, 2.5, 3.0],  # degenerate cells on interior edges
        [nan, 2.5, 3.0, 3.5, nan],  # degenerate end cells on edges
        [3.5, 3.0, 2.5, 2.0, 1.5],  # descending, touching
    ], dtype=np.float32)
    rng = np.random.RandomState(21)
    ph = rng.rand(12, 4).astype(np.float32) + 0.5
    ph_nan = ph.copy()
    ph_nan[[0, 3, 4], 0] = ph_nan[[3, 4], 1] = np.nan
    ph_nan[[2, 5, 6], 3] = ph_nan[7, 1] = np.nan
    return th, [ph, ph_nan]


SPECIAL_EDGES = np.array([0.5, 1.5, 2.5, 3.5, 10.0], dtype=np.float32)


def test_plain_g_matches_rebin_on_infinite_and_touching_columns():
    """Kernel G's plain version lets the NaN of an infinite bound's
    geometry through, as jnp.clip does: every bin of such a column is NaN,
    unless the cell's datum is NaN (G leaves that cell out)."""
    import jax.numpy as jnp

    th, phis = _special_columns()
    e_t = torch.as_tensor(SPECIAL_EDGES)
    for ph in phis:
        mine = kg._conservative_plain(torch.as_tensor(th), torch.as_tensor(ph), e_t)
        ref, cnt = jax_tf._conservative_rebin(jnp.asarray(ph), jnp.asarray(th[:, :-1]),
                                              jnp.asarray(th[:, 1:]), jnp.asarray(SPECIAL_EDGES))
        assert_close(mine, np.asarray(jnp.where(cnt > 0, ref, jnp.nan)), rtol=1e-6, atol=1e-6)
    plain = [kg._conservative_plain(torch.as_tensor(th), torch.as_tensor(p), e_t) for p in phis]
    poisoned = [0, 2, 3, 4, 5, 6]
    assert torch.isnan(plain[0][poisoned]).all()
    assert not torch.isnan(plain[1][poisoned]).all(-1).any()
    assert not torch.isnan(plain[0][[1, 7, 8, 9, 10, 11]]).all(-1).any()


def test_plain_h_matches_pallas_on_infinite_and_touching_columns():
    """Kernel H's plain version against the Pallas kernel in interpret
    mode: H takes the geometry from the bounds alone, so a NaN datum in a
    cell with an infinite bound still makes its column NaN (where G's bins
    stay finite)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from xgcm_tpu.ops.pallas_transform import conservative_fused_multi

    th, phis = _special_columns()
    th_t, e_t = torch.as_tensor(th), torch.as_tensor(SPECIAL_EDGES)
    multi = kg._conservative_multi_plain(th_t, [torch.as_tensor(p) for p in phis], e_t)
    with pltpu.force_tpu_interpret_mode():
        pallas = conservative_fused_multi(jnp.asarray(th), tuple(jnp.asarray(p) for p in phis),
                                          jnp.asarray(SPECIAL_EDGES))
    for o, pj in zip(multi, pallas):
        assert_close(o, np.asarray(pj), rtol=1e-5, atol=1e-6)
    poisoned = [0, 2, 3, 4, 5, 6]
    assert torch.isnan(multi[1][poisoned]).all()
    single = kg._conservative_plain(th_t, torch.as_tensor(phis[1]), e_t)
    assert not torch.isnan(single[poisoned]).all(-1).any()
