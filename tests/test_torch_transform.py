"""The port's linear/log vertical transform against xgcm_tpu: the
reference case table through ``Grid.transform``, ``interp_1d_linear`` on
random NaN-carrying columns (dense and deep paths), kernel C's plain
version against ``_fused_ref_jnp`` and the Pallas kernel in interpret mode,
and gradients.  NaN footprints must be identical; values agree to 1e-12 in
float64 and 1e-6 in float32."""

import warnings

import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu_torch as xtt
from tests.test_transform_cases import CASES
from tests.torch_parity import assert_close, to_numpy
from xgcm_tpu.ops import transform as jax_tf
from xgcm_tpu_torch.ops import transform as torch_tf
from xgcm_tpu_torch.ops.kernels.interp_linear import _fused_ref_torch, interp_linear

TOL = {np.float64: 1e-12, np.float32: 1e-6}
LINEAR_CASES = [k for k, c in CASES.items() if c["kwargs"]["method"] != "conservative"]


def _case_inputs(case, dtype, pkg, tensor):
    """Grid, data, target and kwargs of one case, built by ``pkg``."""
    wrap = torch.as_tensor if tensor else (lambda a: a)
    coords = {k: (k, np.asarray(v, dtype=dtype)) for k, v in case["coords"].items()}
    ds = pkg.Dataset(coords=coords)
    grid = pkg.Grid(ds, coords={"Z": case["positions"]}, periodic=False,
                    autoparse_metadata=False)
    dim, values = case["data"]
    da = pkg.GriddedArray(wrap(np.asarray(values, dtype=dtype)), (dim,), name="data")
    kwargs = dict(case["kwargs"])
    if "target_data" in case:
        tdim, tvals, tname = case["target_data"]
        kwargs["target_data"] = pkg.GriddedArray(
            wrap(np.asarray(tvals, dtype=dtype)), (tdim,), name=tname)
    target = case["target"]
    if isinstance(target, tuple):
        tdims, tvals = target
        tdims = (tdims,) if isinstance(tdims, str) else tdims
        target = pkg.GriddedArray(wrap(np.asarray(tvals, dtype=dtype)), tdims, name=tdims[-1])
    else:
        target = np.asarray(target, dtype=dtype)
    return grid, da, target, kwargs


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", LINEAR_CASES)
def test_transform_cases_match(name, dtype):
    case = CASES[name]
    g_j, da_j, t_j, kw_j = _case_inputs(case, dtype, xgcm_tpu, tensor=False)
    g_t, da_t, t_t, kw_t = _case_inputs(case, dtype, xtt, tensor=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out_j = g_j.transform(da_j, "Z", t_j, **kw_j)
        out_t = g_t.transform(da_t, "Z", t_t, **kw_t)
    assert (out_t.dims, out_t.name) == (out_j.dims, out_j.name)
    assert_close(out_t, out_j, rtol=TOL[dtype], atol=TOL[dtype])
    expected = np.asarray(case["expected"], dtype=float)
    got = to_numpy(out_t).astype(float)
    keep = ~np.isnan(got)
    np.testing.assert_allclose(got[keep], expected[keep], rtol=1e-5, atol=1e-6)


def _columns(cols, n, dtype, seed):
    """Monotone columns with NaN heads/tails, NaN data, descending and
    all-NaN columns and duplicate knots; phi random."""
    rng = np.random.RandomState(seed)
    th = np.sort(rng.rand(cols, n), -1) * 30
    ph = rng.rand(cols, n)
    th[0:3, n - 4:] = np.nan
    ph[0:3, n - 4:] = np.nan
    th[3:6, :3] = np.nan
    th[6:8, :] = np.nan
    th[8:14] = th[8:14, ::-1]
    th[12:14, :2] = np.nan
    th[14:16, 4] = th[14:16, 5]
    # evenly spaced knots wider apart than the targets, so NaN data at a
    # valid knot surely brackets a target (and, at knot 0, the low clamp)
    th[16:18] = np.linspace(-2.0, 33.0, n)
    ph[16, n // 2] = np.nan
    ph[17, 0] = np.nan
    return th.astype(dtype), ph.astype(dtype)


@pytest.mark.parametrize("mask_edges", [False, True])
@pytest.mark.parametrize("per_column_target", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_interp_1d_linear_matches(dtype, per_column_target, mask_edges):
    th, ph = _columns(24, 12, dtype, seed=0)
    rng = np.random.RandomState(1)
    tt = np.linspace(-3, 34, 17).astype(dtype)
    if per_column_target:
        tt = np.sort(rng.rand(24, 9) * 36 - 3, -1).astype(dtype)
    tt[..., 3] = np.nan
    kw = dict(mask_edges=mask_edges)
    j, t = (to_numpy(jax_tf.interp_1d_linear(ph, th, tt, **kw)),
            to_numpy(torch_tf.interp_1d_linear(torch.as_tensor(ph), torch.as_tensor(th),
                                               torch.as_tensor(tt), **kw)))
    assert_close(t, j, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_interp_1d_linear_deep_path_matches(dtype, monkeypatch):
    monkeypatch.setattr(jax_tf, "_DENSE_MEMB_BUDGET", 0)
    monkeypatch.setattr(torch_tf, "_DENSE_MEMB_BUDGET", 0)
    th, ph = _columns(20, 10, dtype, seed=2)
    tt = np.linspace(-2, 33, 11).astype(dtype)
    j = to_numpy(jax_tf.interp_1d_linear(ph, th, tt, bypass_checks=False))
    t = to_numpy(torch_tf.interp_1d_linear(*(torch.as_tensor(a) for a in (ph, th, tt))))
    assert_close(t, j, rtol=TOL[dtype], atol=TOL[dtype])


def test_broadcast_lead_dims_and_log_match():
    rng = np.random.RandomState(3)
    th = np.sort(rng.rand(1, 5, 8), -1) + 0.5  # broadcast over the first lead dim
    ph = rng.rand(4, 5, 8)
    tt = np.linspace(0.4, 1.6, 6)
    for kw in (dict(), dict(logarithmic=True), dict(bypass_checks=True)):
        j = to_numpy(jax_tf.interp_1d_linear(ph, th, tt, **kw))
        t = to_numpy(torch_tf.interp_1d_linear(*(torch.as_tensor(a) for a in (ph, th, tt)),
                                               **kw))
        assert_close(t, j, rtol=1e-12, atol=1e-12)


def test_columns_first_layout_matches():
    rng = np.random.RandomState(4)
    n, cols = 7, 10
    th = np.sort(rng.rand(n, cols), 0)
    ph = rng.rand(n, cols)
    tt = np.linspace(0.1, 0.9, 5)
    outs = []
    for pkg, wrap in ((xgcm_tpu, lambda a: a), (xtt, torch.as_tensor)):
        outs.append(pkg_linear(pkg, wrap, th, ph, tt))
    (o_j, o_t) = outs
    assert o_t.dims == o_j.dims == ("sigma", "col")
    assert_close(o_t, o_j, rtol=1e-12, atol=1e-12)


def pkg_linear(pkg, wrap, th, ph, tt):
    mod = jax_tf if pkg is xgcm_tpu else torch_tf
    return mod.linear_interpolation(
        pkg.GriddedArray(wrap(ph), ("zc", "col"), name="q"),
        pkg.GriddedArray(wrap(th), ("zc", "col"), name="th"),
        pkg.GriddedArray(wrap(tt), ("sigma",)),
        "zc", "zc", "sigma",
    )


@pytest.mark.parametrize("check_flip", [True, False])
@pytest.mark.parametrize("mask_edges", [False, True])
def test_plain_kernel_c_matches_jax_ref_and_pallas(mask_edges, check_flip):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from xgcm_tpu.ops.pallas_transform import _fused_ref_jnp, interp_linear_fused

    th, ph = _columns(32, 12, np.float32, seed=5)
    tt = np.linspace(-3, 34, 17).astype(np.float32)
    kw = dict(mask_edges=mask_edges, check_flip=check_flip)
    mine = to_numpy(_fused_ref_torch(*(torch.as_tensor(a) for a in (th, ph, tt)), **kw))
    ref = to_numpy(_fused_ref_jnp(jnp.asarray(th), jnp.asarray(ph), jnp.asarray(tt), **kw))
    assert_close(mine, ref, rtol=1e-6, atol=1e-6)
    with pltpu.force_tpu_interpret_mode():
        pallas = to_numpy(interp_linear_fused(
            jnp.asarray(th), jnp.asarray(ph), jnp.asarray(tt), tile_cols=16, **kw))
    assert_close(mine, pallas, rtol=1e-5, atol=1e-6)
    # the wrapper on CPU tensors is the plain version, in either layout
    wrapped = interp_linear(*(torch.as_tensor(a) for a in (th, ph, tt)), **kw)
    assert_close(wrapped, mine, rtol=0, atol=0)
    wrapped_T = interp_linear(*(torch.as_tensor(a) for a in (th, ph, tt)), **kw, out_T=True)
    assert_close(wrapped_T.T, mine, rtol=0, atol=0)


def test_gradient_matches_jax():
    import jax
    import jax.numpy as jnp

    from xgcm_tpu.ops.pallas_transform import _fused_ref_jnp

    rng = np.random.RandomState(6)
    th = np.sort(rng.rand(6, 8), -1) * 10
    th[1] = th[1, ::-1]
    ph = rng.rand(6, 8)
    tt = np.linspace(0.5, 9.5, 5)
    w = rng.rand(6, 5)

    def loss_j(th_, ph_, tt_):
        return jnp.sum(_fused_ref_jnp(th_, ph_, tt_) * w)

    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(jnp.asarray(th), jnp.asarray(ph), jnp.asarray(tt))
    ins = [torch.tensor(a, requires_grad=True) for a in (th, ph, tt)]
    (_fused_ref_torch(*ins) * torch.as_tensor(w)).sum().backward()
    for a_t, a_j in zip(ins, g_j):
        assert_close(a_t.grad, a_j, rtol=1e-12, atol=1e-12)
