"""The port's ``transform_multi`` against xgcm_tpu and against its own loop
of ``transform``: linear, log and conservative, in the (y, x, z) layout and
the columns-first (z, col) layout, with the routing cases (one array, more
than eight, mismatched dims, a periodic axis, a multi-dimensional target,
bounds not on ``outer``).  The multi-kernel routes run here through the
wrappers' plain versions, by letting CPU tensors take the kernel routes;
kernel F's plain version is held against V calls of kernel C's and against
``interp_linear_fused_multi`` in interpret mode, and gradients against
``jax.grad``.  Port vs JAX: identical NaN footprints, 1e-12 in float64 and
1e-6 in float32, except float32 ``log``, 1e-4: torch's and XLA's float32
logarithms differ by up to one unit in the last place, and the
interpolation weight divides by knot gaps of about 1e-2 in log space, which
amplifies that a hundredfold.  Port multi vs port loop: bitwise."""

import warnings

import numpy as np
import pytest
import torch

import xgcm_tpu
import xgcm_tpu_torch as xtt
from tests.torch_parity import assert_bitwise, assert_close
from xgcm_tpu_torch.ops import transform as torch_tf
from xgcm_tpu_torch.ops.kernels import conservative as kg
from xgcm_tpu_torch.ops.kernels import interp_linear as kc

NY, NX, NZ = 3, 4, 7
TOL = {np.float64: 1e-12, np.float32: 1e-6}


def _tol(method, dtype):
    return 1e-4 if (method, dtype) == ("log", np.float32) else TOL[dtype]


def _fields(dtype, seed, nv=4):
    """Density on centres and bounds with NaN tails, descending and all-NaN
    columns, and nv fields (T, S, u, v, ...) with a NaN datum, in (y, x, z)."""
    rng = np.random.RandomState(seed)
    sig_b = 24.0 + np.cumsum(rng.rand(NY, NX, NZ + 1) + 0.05, -1)
    sig_b[0, 0, NZ - 2:] = np.nan
    sig_b[0, 1] = sig_b[0, 1, ::-1]
    sig_b[1, 2] = np.nan
    sig_c = 0.5 * (sig_b[..., :-1] + sig_b[..., 1:])
    fields = [rng.rand(NY, NX, NZ) * (k + 1) for k in range(nv)]
    fields[-1][2, 3, 2] = np.nan
    return sig_c.astype(dtype), sig_b.astype(dtype), [f.astype(dtype) for f in fields]


def _setup(pkg, wrap, dtype, seed=0, nv=4, periodic=False):
    sig_c, sig_b, fields = _fields(dtype, seed, nv)
    ds = pkg.Dataset(coords={
        "zc": ("zc", np.arange(NZ, dtype=dtype) + 0.5),
        "zo": ("zo", np.arange(NZ + 1, dtype=dtype)),
    })
    grid = pkg.Grid(ds, coords={"Z": {"center": "zc", "outer": "zo"}},
                    periodic=periodic, autoparse_metadata=False)
    dims = ("y", "x", "zc")
    das = [pkg.GriddedArray(wrap(f), dims, name=nm)
           for f, nm in zip(fields, ["T", "S", "u", "v", "w5", "w6", "w7", "w8", "w9"])]
    sc = pkg.GriddedArray(wrap(sig_c), dims, name="sigma")
    sb = pkg.GriddedArray(wrap(sig_b), ("y", "x", "zo"), name="sigma")
    return grid, das, sc, sb


def _columns_first(pkg, wrap, dtype, seed=0, nv=3):
    """(zc, col) fields and (zc, col) / (zo, col) density."""
    sig_c, sig_b, fields = _fields(dtype, seed, nv)
    t = lambda a: wrap(np.ascontiguousarray(a.reshape(-1, a.shape[-1]).T))  # noqa: E731
    ds = pkg.Dataset(coords={"zc": ("zc", np.arange(NZ, dtype=dtype) + 0.5),
                             "zo": ("zo", np.arange(NZ + 1, dtype=dtype))})
    grid = pkg.Grid(ds, coords={"Z": {"center": "zc", "outer": "zo"}}, periodic=False,
                    autoparse_metadata=False)
    das = [pkg.GriddedArray(t(f), ("zc", "col"), name=f"q{k}") for k, f in enumerate(fields)]
    return (grid, das, pkg.GriddedArray(t(sig_c), ("zc", "col"), name="sigma"),
            pkg.GriddedArray(t(sig_b), ("zo", "col"), name="sigma"))


LEVELS = np.linspace(24.5, 29.0, 9)
BINS = np.linspace(24.0, 31.0, 8)


def _call(method, dtype):
    """(target, target_data picker) of one method."""
    target = (BINS if method == "conservative" else LEVELS).astype(dtype)
    if method == "log":
        return target, lambda sc, sb: sc
    return target, (lambda sc, sb: sb) if method == "conservative" else (lambda sc, sb: sc)


@pytest.fixture
def kernel_routes(monkeypatch):
    """CPU tensors take the kernel routes, whose wrappers then run their
    plain versions; counts the multi-wrapper calls."""
    monkeypatch.setattr(torch_tf, "_KERNEL_DEVICE", "cpu")
    calls = {"interp_linear_multi": 0, "conservative_rebin_multi": 0}
    for mod, name in ((kc, "interp_linear_multi"), (kg, "conservative_rebin_multi")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


def _jax_and_port(method, dtype, layout, **kw):
    target, pick = _call(method, dtype)
    builder = _setup if layout == "yxz" else _columns_first
    out = []
    for pkg, wrap in ((xgcm_tpu, lambda a: a), (xtt, torch.as_tensor)):
        grid, das, sc, sb = builder(pkg, wrap, dtype)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            multi = grid.transform_multi(das, "Z", target, target_data=pick(sc, sb),
                                         method=method, **kw)
            loop = [grid.transform(da, "Z", target, target_data=pick(sc, sb), method=method,
                                   **kw) for da in das]
        out.append((multi, loop))
    return out


@pytest.mark.parametrize("layout", ["yxz", "zcol"])
@pytest.mark.parametrize("method", ["linear", "log", "conservative"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_transform_multi_matches(dtype, method, layout):
    (m_j, _), (m_t, l_t) = _jax_and_port(method, dtype, layout)
    assert len(m_t) == len(m_j)
    for a_t, a_j, a_l in zip(m_t, m_j, l_t):
        assert (a_t.dims, a_t.name) == (a_j.dims, a_j.name) == (a_l.dims, a_l.name)
        assert_close(a_t, a_j, rtol=_tol(method, dtype), atol=_tol(method, dtype))
        assert_bitwise(a_t, a_l)


@pytest.mark.parametrize("layout", ["yxz", "zcol"])
@pytest.mark.parametrize("method", ["linear", "log", "conservative"])
def test_multi_kernel_route_matches(method, layout, kernel_routes):
    """float32: the F/H route (strided column views, out_T for
    columns-first, the flip of decreasing bins) against the JAX package
    and against the port's own single-kernel loop."""
    (m_j, _), (m_t, l_t) = _jax_and_port(method, np.float32, layout)
    name = "conservative_rebin_multi" if method == "conservative" else "interp_linear_multi"
    assert kernel_routes[name] == 1
    for a_t, a_j, a_l in zip(m_t, m_j, l_t):
        assert (a_t.dims, a_t.name) == (a_j.dims, a_j.name) == (a_l.dims, a_l.name)
        assert_close(a_t, a_j, rtol=_tol(method, np.float32), atol=_tol(method, np.float32))
        assert_bitwise(a_t, a_l)


def test_multi_kernel_route_decreasing_bins(kernel_routes):
    outs = []
    for pkg, wrap in ((xgcm_tpu, lambda a: a), (xtt, torch.as_tensor)):
        grid, das, _, sb = _setup(pkg, wrap, np.float32)
        outs.append(grid.transform_multi(das, "Z", BINS[::-1].astype(np.float32).copy(),
                                         target_data=sb, method="conservative"))
    assert kernel_routes["conservative_rebin_multi"] == 1
    for a_t, a_j in zip(*outs[::-1]):
        assert_close(a_t, a_j, rtol=1e-6, atol=1e-6)


def _routing_case(case):
    """(grid, das, target, kwargs, jax_kwargs) of one routing case, port
    and JAX, float32 (the dtype the kernels take)."""
    built = []
    for pkg, wrap in ((xgcm_tpu, lambda a: a), (xtt, torch.as_tensor)):
        nv = {"one": 1, "nine": 9}.get(case, 4)
        grid, das, sc, sb = _setup(pkg, wrap, np.float32, nv=nv,
                                   periodic=(case == "periodic"))
        kw = dict(target_data=sc)
        target = LEVELS.astype(np.float32)
        if case == "mismatched_dims":
            das[2] = das[2].transpose("x", "y", "zc")
        elif case == "multidim_target":
            rng = np.random.RandomState(3)
            t2 = np.sort(rng.rand(NX, 5) * 4 + 25, -1).astype(np.float32)
            target = pkg.GriddedArray(wrap(t2), ("x", "s"), name="s")
            kw["target_dim"] = "s"
        elif case == "bounds_not_on_outer":
            kw["method"] = "conservative"
            target = BINS.astype(np.float32)
        built.append((grid, das, target, kw))
    return built


ROUTING_CASES = ["one", "nine", "mismatched_dims", "multidim_target", "bounds_not_on_outer"]


@pytest.mark.parametrize("case", ROUTING_CASES)
def test_routing_cases_take_the_loop(case, kernel_routes):
    (g_j, d_j, t_j, kw_j), (g_t, d_t, t_t, kw_t) = _routing_case(case)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out_j = g_j.transform_multi(d_j, "Z", t_j, **kw_j)
        out_t = g_t.transform_multi(d_t, "Z", t_t, **kw_t)
        loop = [g_t.transform(da, "Z", t_t, **kw_t) for da in d_t]
    assert kernel_routes == {"interp_linear_multi": 0, "conservative_rebin_multi": 0}
    assert len(out_t) == len(out_j) == len(d_t)
    for a_t, a_j, a_l in zip(out_t, out_j, loop):
        assert a_t.dims == a_j.dims == a_l.dims
        assert_close(a_t, a_j, rtol=1e-6, atol=1e-6)
        assert_bitwise(a_t, a_l)


def test_routing_errors_match_the_loop(kernel_routes):
    (g_j, d_j, _, _), (g_t, d_t, _, _) = _routing_case("periodic")
    for g, d in ((g_j, d_j), (g_t, d_t)):
        with pytest.raises(ValueError, match="non-periodic"):
            g.transform_multi(d, "Z", LEVELS)
    (g_j, d_j, _, kw_j), (g_t, d_t, _, kw_t) = _routing_case("one")
    for g, d in ((g_j, d_j), (g_t, d_t)):
        assert g.transform_multi([], "Z", LEVELS) == []
        with pytest.raises(ValueError, match="reassociate"):
            g.transform_multi(d * 2, "Z", LEVELS, reassociate=True)
        with pytest.raises(ValueError, match="not monotonic"):
            g.transform_multi(d * 2, "Z", BINS[[0, 2, 1, 3]], method="conservative",
                              target_data=g._ds["zo"])
    assert kernel_routes == {"interp_linear_multi": 0, "conservative_rebin_multi": 0}


def _columns(cols, n, seed):
    """Monotone (sorted, some descending, NaN tails, all-NaN) columns and
    phis with a NaN datum, float32."""
    rng = np.random.RandomState(seed)
    th = np.sort(rng.rand(cols, n).astype(np.float32), -1) * 25
    th[0:8, n - 4:] = np.nan
    th[8:16] = th[8:16, ::-1]
    th[16:20, :] = np.nan
    return th


@pytest.mark.parametrize("mask_edges", [False, True])
def test_plain_kernel_f_matches_singles_and_pallas(mask_edges):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from xgcm_tpu.ops.pallas_transform import interp_linear_fused_multi

    rng = np.random.RandomState(21)
    th = _columns(32, 14, 21)
    phis = [rng.rand(32, 14).astype(np.float32) for _ in range(3)]
    tt = np.linspace(-2, 28, 13).astype(np.float32)
    th_t, tt_t = torch.as_tensor(th), torch.as_tensor(tt)
    multi = kc._fused_multi_ref_torch(th_t, [torch.as_tensor(p) for p in phis], tt_t,
                                      mask_edges)
    for o, p in zip(multi, phis):
        assert_bitwise(o, kc._fused_ref_torch(th_t, torch.as_tensor(p), tt_t, mask_edges))
    with pltpu.force_tpu_interpret_mode():
        pallas = interp_linear_fused_multi(jnp.asarray(th), tuple(jnp.asarray(p) for p in phis),
                                           jnp.asarray(tt), mask_edges=mask_edges, tile_cols=16)
    for o, pj in zip(multi, pallas):
        assert_close(o, np.asarray(pj), rtol=1e-6, atol=1e-6)
    wrapped = kc.interp_linear_multi(th_t, [torch.as_tensor(p) for p in phis], tt_t,
                                     mask_edges, out_T=True)
    for o, w in zip(multi, wrapped):
        assert_bitwise(w.T, o)


def test_plain_kernel_f_non_monotone_equals_singles():
    """On a non-monotone column kernel F, like V calls of kernel C, sums
    every matching interval (the JAX CPU reference is the per-variable
    loop, not the TPU kernel's last-writer-wins select)."""
    rng = np.random.RandomState(5)
    th = torch.as_tensor(rng.rand(16, 9).astype(np.float32) * 10)
    phis = [torch.as_tensor(rng.rand(16, 9).astype(np.float32)) for _ in range(4)]
    tt = torch.linspace(-1, 11, 10)
    t_cols = torch.sort(torch.as_tensor(rng.rand(16, 5).astype(np.float32)) * 10, -1).values
    for t in (tt, t_cols):
        for o, p in zip(kc._fused_multi_ref_torch(th, phis, t), phis):
            assert_bitwise(o, kc._fused_ref_torch(th, p, t))


def test_multi_gradients_match_jax():
    import jax
    import jax.numpy as jnp

    from xgcm_tpu.ops.pallas_transform import _fused_ref_jnp
    from xgcm_tpu.ops.transform import _conservative_rebin

    rng = np.random.RandomState(6)
    th = np.sort(rng.rand(6, 8), -1) * 10
    th[1] = th[1, ::-1]
    phis = [rng.rand(6, 8) for _ in range(2)]
    tt = np.linspace(0.5, 9.5, 5)
    thb = np.sort(rng.rand(6, 9), -1) * 10
    edges = np.linspace(-0.5, 10.5, 5)
    w = rng.rand(6, 5)
    w4 = rng.rand(6, 4)

    def loss_j(th_, thb_, *phs):
        lin = sum(jnp.sum(_fused_ref_jnp(th_, p, tt) * w) for p in phs)
        cons = 0.0
        for p in phs:
            out, cnt = _conservative_rebin(p, thb_[:, :-1], thb_[:, 1:], edges)
            cons = cons + jnp.sum(jnp.where(cnt > 0, out, 0.0) * w4)
        return lin + cons

    g_j = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (th, thb, *phis)))
    ins = [torch.tensor(a, requires_grad=True) for a in (th, thb, *phis)]
    lin = kc.interp_linear_multi(ins[0], ins[2:], torch.as_tensor(tt))
    cons = kg.conservative_rebin_multi(ins[1], ins[2:], torch.as_tensor(edges))
    loss = sum((o * torch.as_tensor(w)).sum() for o in lin)
    loss = loss + sum((torch.nan_to_num(o) * torch.as_tensor(w4)).sum() for o in cons)
    loss.backward()
    for a_t, a_j in zip(ins, g_j):
        assert_close(a_t.grad, a_j, rtol=1e-12, atol=1e-12)
