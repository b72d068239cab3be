"""The port's framework-free core against xgcm_tpu: signature parsing,
Axis/Grid construction (autoparsed and explicit), the parsers, and the
rule that no module of the port imports JAX or the JAX package."""

import ast
import pathlib

import numpy as np
import pytest

import xgcm_tpu
import xgcm_tpu_torch as xtt
from tests.test_parsers import cf_ds, comodo_ds, sgrid_2d_ds, sgrid_3d_ds
from tests.torch_parity import to_numpy
from xgcm_tpu.core.metrics import iterate_axis_combinations as jax_combos
from xgcm_tpu.parsers import metadata as jax_metadata
from xgcm_tpu_torch.core.metrics import iterate_axis_combinations as torch_combos
from xgcm_tpu_torch.parsers import metadata as torch_metadata

PORT_DIR = pathlib.Path(xtt.__file__).resolve().parent

SIGNATURES = [
    "(X:center)->(X:left)",
    "(X:left)->(X:center)",
    "(X:center),(Y:center)->(X:left,Y:right)",
    "(ax1:center)->(ax1:outer),(ax1:inner)",
    "()->()",
    "(X:center,Y:left)->()",
]


@pytest.mark.parametrize("sig", SIGNATURES)
def test_signature_parse_matches(sig):
    j = xgcm_tpu.GridUFuncSignature.from_string(sig)
    t = xtt.GridUFuncSignature.from_string(sig)
    assert (t.in_ax_names, t.in_ax_positions) == (j.in_ax_names, j.in_ax_positions)
    assert (t.out_ax_names, t.out_ax_positions) == (j.out_ax_names, j.out_ax_positions)
    assert str(t) == str(j)
    for other in SIGNATURES:
        assert t.equivalent(xtt.GridUFuncSignature.from_string(other)) == j.equivalent(
            xgcm_tpu.GridUFuncSignature.from_string(other)
        )


@pytest.mark.parametrize("bad", ["(X:middle)->(X:left)", "X:center->X:left", "(X:center)"])
def test_signature_errors_match(bad):
    with pytest.raises(ValueError):
        xgcm_tpu.GridUFuncSignature.from_string(bad)
    with pytest.raises(ValueError):
        xtt.GridUFuncSignature.from_string(bad)


@pytest.mark.parametrize("axes", [("X",), ("X", "Y"), ("X", "Y", "Z")])
def test_metric_combinations_match(axes):
    assert list(torch_combos(axes)) == list(jax_combos(axes))


def _axes_summary(grid):
    return {
        name: (dict(ax.coords), dict(ax.default_shifts), ax.boundary, ax.fill_value,
               ax.periodic)
        for name, ax in grid.axes.items()
    }


DATASETS = {"comodo": comodo_ds, "sgrid_2d": sgrid_2d_ds, "sgrid_3d": sgrid_3d_ds, "cf": cf_ds}


@pytest.mark.parametrize("name", list(DATASETS))
def test_parse_metadata_matches(name):
    ds_j = DATASETS[name]()
    ds_t = xtt.from_numpy_dataset(ds_j)
    out_j, kw_j = jax_metadata.parse_metadata(ds_j)
    out_t, kw_t = torch_metadata.parse_metadata(ds_t)
    assert kw_t == kw_j
    assert set(out_t.coords) == set(out_j.coords)
    for k in out_j.coords:
        np.testing.assert_array_equal(out_t.coords[k].values, to_numpy(out_j.coords[k]))


@pytest.mark.parametrize("name", list(DATASETS))
@pytest.mark.parametrize("periodic", [None, False, ["X"]])
def test_autoparsed_grid_matches(name, periodic):
    ds_j = DATASETS[name]()
    g_j = xgcm_tpu.Grid(ds_j, periodic=periodic)
    g_t = xtt.Grid(xtt.from_numpy_dataset(ds_j), periodic=periodic)
    assert _axes_summary(g_t) == _axes_summary(g_j)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(),
        dict(boundary="extend"),
        dict(boundary={"X": "fill", "Y": "extrapolate"}, fill_value={"X": 2.5}),
        dict(default_shifts={"X": {"center": "left"}}),
        dict(periodic=["Y"]),
    ],
)
def test_explicit_grid_matches(kwargs):
    ds_j = xgcm_tpu.Dataset(coords={
        "xc": ("xc", np.arange(6.0)), "xg": ("xg", np.arange(6.0)),
        "yc": ("yc", np.arange(5.0)), "yg": ("yg", np.arange(5.0)),
    })
    coords = {"X": {"center": "xc", "left": "xg"}, "Y": {"center": "yc", "left": "yg"}}
    g_j = xgcm_tpu.Grid(ds_j, coords=coords, autoparse_metadata=False, **kwargs)
    g_t = xtt.Grid(xtt.from_numpy_dataset(ds_j), coords=coords,
                   autoparse_metadata=False, **kwargs)
    assert _axes_summary(g_t) == _axes_summary(g_j)


def test_grid_construction_errors_match():
    with pytest.raises(ValueError, match="conflict with"):
        xtt.Grid(xtt.from_numpy_dataset(comodo_ds()), coords={"X": {"center": "XC"}})
    ds = xtt.Dataset(coords={"a": ("a", np.arange(3.0))})
    with pytest.raises(ValueError, match="more than one"):
        xtt.Grid(ds, coords={"X": {"center": "a"}, "Y": {"center": "a"}},
                 autoparse_metadata=False)
    with pytest.raises(ValueError, match="Could not determine Axis names"):
        xtt.Grid(ds, autoparse_metadata=False)


def test_unported_grid_features_raise():
    ds = xtt.from_numpy_dataset(comodo_ds())
    # face connections are ported: a face dim the dataset lacks raises the
    # JAX package's ValueError
    fc = {"face": {0: {"X": (None, None)}}}
    for grid_cls, data in ((xgcm_tpu.Grid, comodo_ds()), (xtt.Grid, ds)):
        with pytest.raises(ValueError, match="Face dimension face does not exist"):
            grid_cls(data, face_connections=fc)
    # metrics are ported: both packages register the same variables, and
    # raise the same KeyError for a variable the dataset lacks
    g_j = xgcm_tpu.Grid(comodo_ds(), metrics={("X",): ["XC"]})
    g_t = xtt.Grid(ds, metrics={("X",): ["XC"]})
    assert ({k: [v.name for v in vs] for k, vs in g_t._metrics.items()}
            == {k: [v.name for v in vs] for k, vs in g_j._metrics.items()})
    for grid_cls, data in ((xgcm_tpu.Grid, comodo_ds()), (xtt.Grid, ds)):
        with pytest.raises(KeyError, match="not found in dataset"):
            grid_cls(data, metrics={("X",): ["nonexistent"]})


def test_from_numpy_dataset_keeps_numpy_coords_and_tensor_vars():
    import torch

    ds = xtt.from_numpy_dataset(sgrid_2d_ds())
    assert isinstance(ds.coords["node_x"].data, np.ndarray)
    assert isinstance(ds["grid"].data, torch.Tensor)
    assert ds.attrs == {"Conventions": "SGRID-0.3.0"}
    assert ds["grid"].attrs["cf_role"] == "grid_topology"
    a = xtt.GriddedArray([[1.0, 2.0]], ("y", "x"), device="cpu")
    assert isinstance(a.data, torch.Tensor) and a.device == torch.device("cpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted(PORT_DIR.rglob("*.py")) + [PORT_DIR.parent / "chip_smoke.py"]
    offenders = [
        (p.name, mod)
        for p in files
        for mod in _imported_modules(p)
        if mod.split(".")[0] in ("jax", "jaxlib", "xgcm_tpu")
    ]
    assert offenders == []


@pytest.fixture
def no_card_no_request(monkeypatch):
    """A host without a CUDA card where the caller has not asked for the
    CPU."""
    import torch

    from xgcm_tpu_torch.core import device

    monkeypatch.setattr(device, "_default", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_host_data_without_card_or_cpu_request_raises(no_card_no_request):
    with pytest.raises(RuntimeError, match="set_default_device"):
        xtt.GriddedArray(np.ones(3), ("x",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xtt.Dataset(coords={"x": ("x", np.arange(3.0))}, data_vars={"a": ("x", [1.0, 2, 3])})
    with pytest.raises(RuntimeError, match="set_default_device"):
        xtt.from_numpy_dataset(sgrid_2d_ds())
    # coordinates stay host numpy and need no device
    ds = xtt.Dataset(coords={"z": ("z", np.arange(3.0) + 0.5), "zo": ("zo", np.arange(4.0))})
    assert isinstance(ds.coords["z"].data, np.ndarray)
    # numpy targets of transform raise too, never running on the CPU
    grid = xtt.Grid(ds, coords={"Z": {"center": "z", "outer": "zo"}}, periodic=False,
                    autoparse_metadata=False)
    with pytest.raises(RuntimeError, match="set_default_device"):
        grid.transform(xtt.GriddedArray(np.ones(3), ("z",)), "Z", np.array([0.5, 1.5]))


def test_cpu_request_puts_host_data_on_cpu(no_card_no_request):
    import torch

    a = xtt.GriddedArray(np.ones(3), ("x",), device="cpu")
    assert a.device == torch.device("cpu")
    ds = xtt.from_numpy_dataset(sgrid_2d_ds(), device="cpu")
    assert ds["grid"].data.device == torch.device("cpu")
    xtt.set_default_device("cpu")
    assert xtt.get_default_device() == torch.device("cpu")
    b = xtt.GriddedArray([[1.0, 2.0]], ("y", "x"))
    assert isinstance(b.data, torch.Tensor) and b.device == torch.device("cpu")
    ds = xtt.Dataset(coords={"x": ("x", np.arange(3.0))}, data_vars={"a": ("x", [1.0, 2, 3])})
    assert ds["a"].data.device == torch.device("cpu")
    assert isinstance(ds.coords["x"].data, np.ndarray)
    xtt.set_default_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xtt.get_default_device()


def test_tensor_keeps_its_device(no_card_no_request):
    import torch

    x = torch.arange(6.0).reshape(2, 3)
    a = xtt.GriddedArray(x, ("y", "x"))
    assert a.data is x
    # host operands join the tensor's device
    assert torch.equal((a + np.ones(3)).data, x + 1)
    ds = xtt.Dataset(coords={"x": ("x", np.arange(3.0))}, data_vars={"a": a})
    assert ds["a"].data is x
    ds = xtt.Dataset(coords={"zc": ("zc", np.arange(3.0) + 0.5), "zo": ("zo", np.arange(4.0))})
    grid = xtt.Grid(ds, coords={"Z": {"center": "zc", "outer": "zo"}}, periodic=False,
                    autoparse_metadata=False)
    q = xtt.GriddedArray(torch.tensor([1.0, 4.0, 0.0]), ("zc",), name="q")
    out = grid.transform(q, "Z", torch.tensor([0.0, 1.0, 2.5, 4.0]), method="conservative")
    assert out.device == torch.device("cpu")
    assert torch.allclose(out.data, torch.tensor([1.0, 4.0, 0.0], dtype=torch.float64))
