"""The port's host bridge (``xgcm_tpu_torch.core.device.to_device`` and
``to_host``) and ``entry.step``'s host in, host out contract.

On the CPU: ``step`` on host numpy gives host numpy equal word for word to
the tensor path and within the ``cgrid-step`` cell's limits of its plain
reference (``benchmark/reference/cgrid-step.py``), on the cell's own inputs
at a small size; an input changed in place changes the next results, and
the first results stay as they were; a tensor given to ``as_tensor`` opens
no bridge span; ``BRIDGE`` counts copies to a device other than the CPU
(the ``meta`` device stands in for one here) and nothing on the CPU.  The
``cuda`` cases hold the bridge's bytes and copies to the arrays' on the
card, and each site that copies a result to the host to one copy.
"""

import importlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (the CPU as the default device)
import xgcm_tpu_torch as xtt
from xgcm_tpu_torch.adapters.xarray_adapter import host_array
from xgcm_tpu_torch.core import device as port_device
from xgcm_tpu_torch.core.dataarray import as_tensor
from xgcm_tpu_torch.core.dataset import from_numpy_dataset
from xgcm_tpu_torch.core.device import BRIDGE, to_device, to_host
from xgcm_tpu_torch.entry import step
from xgcm_tpu_torch.utils import reset_spans, span_totals

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # the benchmark's generator, judge and reference
SIZES = {"ny": 40, "nx": 48, "nz": 12}
TARGETS = 5
SEED = 2**31 + 24


def cell_inputs(seed=SEED):
    """The ``cgrid-step`` traffic's inputs at 40 x 48 x 12 with 5 targets,
    as CPU tensors, and the traffic file."""
    from benchmark import inputs

    traffic = json.loads((ROOT / "benchmark" / "traffic" / "cgrid-step.json").read_text())
    spec = [dict(e, num=TARGETS) if e["name"] == "targets" else e for e in traffic["inputs"]]
    made = inputs.make_inputs(spec, SIZES, torch.Generator().manual_seed(seed),
                              torch.device("cpu"))
    return made, traffic


def host_copies(made):
    return [made[k].numpy().copy() for k in ("u", "v", "theta", "targets")]


def test_step_host_in_host_out_equals_tensor_path_and_reference():
    from benchmark import judge
    from benchmark.harness import load_module

    made, traffic = cell_inputs()
    host = step(*host_copies(made))
    want = step(made["u"], made["v"], made["theta"], made["targets"])
    for got, ref in zip(host, want):
        assert type(got) is np.ndarray and isinstance(ref, torch.Tensor)
        assert got.dtype == np.float32 and got.shape == tuple(ref.shape)
        np.testing.assert_array_equal(got.view(np.int32), ref.numpy().view(np.int32))
    outputs = {k: torch.from_numpy(a) for k, a in zip(("zeta", "div", "ke_on_theta"), host)}
    numbers = judge.compare_outputs(outputs, made, load_module("reference", "cgrid-step"))
    ok, checks = judge.verdict(numbers, traffic["limits"])
    assert ok, checks


def test_input_changed_in_place_changes_the_results():
    made, _ = cell_inputs()
    u, v, theta, targets = host_copies(made)
    first = [r.copy() for r in step(u, v, theta, targets)]
    u *= 2.0
    second = step(u, v, theta, targets)
    fresh = step(u.copy(), v, theta, targets)
    for a, b, c in zip(first, second, fresh):
        np.testing.assert_array_equal(b, c)
    assert not np.array_equal(first[0], second[0])  # zeta follows u
    assert not np.array_equal(first[2], second[2], equal_nan=True)  # ke follows u


def test_first_results_unchanged_after_a_second_call():
    made, _ = cell_inputs()
    first = step(*host_copies(made))
    kept = [r.copy() for r in first]
    other, _ = cell_inputs(SEED + 1)
    step(*host_copies(other))
    for r, k in zip(first, kept):
        np.testing.assert_array_equal(r.view(np.int32), k.view(np.int32))


def _bridge_spans():
    return {n: t for n, t in span_totals().items() if n.startswith("xtt.bridge.")}


def test_a_tensor_opens_no_bridge_span():
    x = torch.arange(6.0)
    reset_spans()
    before = BRIDGE.copy()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert as_tensor(x) is x
        assert as_tensor(x, "cpu") is x
        to_device(np.arange(3.0), "meta")  # the profiler sees a span where one opens
    spans = _bridge_spans()
    assert list(spans) == ["xtt.bridge.to_device"] and spans["xtt.bridge.to_device"]["calls"] == 1
    assert BRIDGE - before == {"h2d_bytes": 24, "h2d_copies": 1}


def test_bridge_counts_nothing_on_the_cpu():
    made, _ = cell_inputs()
    before = BRIDGE.copy()
    reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        a = np.arange(12, dtype=np.float32).reshape(3, 4)
        t = to_device(a, "cpu")
        assert t.device.type == "cpu" and np.shares_memory(t.numpy(), a)
        assert to_host(t) is not None
        xtt.GriddedArray(a, ("y", "x")).values
        step(*host_copies(made))
    assert BRIDGE == before
    assert _bridge_spans() == {}


@pytest.fixture
def xr():
    """The repo's xarray stub, with the port's adapter reloaded on it."""
    from tests import fake_xarray
    import xgcm_tpu_torch.adapters.xarray_adapter as ad

    old = sys.modules.get("xarray")
    sys.modules["xarray"] = fake_xarray
    importlib.reload(ad)
    try:
        yield fake_xarray, ad
    finally:
        if old is not None:
            sys.modules["xarray"] = old
        else:
            sys.modules.pop("xarray", None)
        importlib.reload(ad)


SITES = ["to_device", "as_tensor", "GriddedArray", "from_numpy_dataset", "dataset_from_xarray"]


@pytest.mark.parametrize("site", SITES)
def test_bridge_counts_copies_to_another_device(site, request, monkeypatch):
    """Every site that takes host data to a device copies through the
    bridge: one copy of the array's bytes to the ``meta`` device each."""
    a = np.arange(20, dtype=np.float64).reshape(4, 5)
    if site == "dataset_from_xarray":
        xr, ad = request.getfixturevalue("xr")
        monkeypatch.setattr(port_device, "_default", torch.device("meta"))
    before = BRIDGE.copy()
    if site == "to_device":
        out = to_device(a, "meta")
    elif site == "as_tensor":
        out = as_tensor(a, "meta")
    elif site == "GriddedArray":
        out = xtt.GriddedArray(a, ("y", "x"), device="meta").data
    elif site == "from_numpy_dataset":
        ds = xtt.Dataset(coords={"x": ("x", np.arange(5.0))}, data_vars={"t": (("y", "x"), a)})
        before = BRIDGE.copy()
        out = from_numpy_dataset(ds, device="meta")["t"].data
    else:
        ds = xr.Dataset({"t": (("y", "x"), a)}, coords={"x": ("x", np.arange(5.0))})
        out = ad.dataset_from_xarray(ds)["t"].data
    assert out.device.type == "meta" and out.dtype == torch.float64
    assert BRIDGE - before == {"h2d_bytes": a.nbytes, "h2d_copies": 1}


@pytest.fixture
def cuda(monkeypatch):
    """The card, with host data going to it for the test's duration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(port_device, "_default", torch.device("cuda"))
    return torch.device("cuda")


@pytest.mark.cuda
def test_step_on_card_counts_the_arrays_bytes(cuda):
    made, _ = cell_inputs()
    arrays = host_copies(made)
    before = BRIDGE.copy()
    host = step(*arrays)
    moved = BRIDGE - before
    assert moved == {"h2d_bytes": sum(a.nbytes for a in arrays), "h2d_copies": 4,
                     "d2h_bytes": sum(r.nbytes for r in host), "d2h_copies": 3}
    want = step(*(made[k].to(cuda) for k in ("u", "v", "theta", "targets")))
    for got, ref in zip(host, want):
        assert type(got) is np.ndarray
        np.testing.assert_array_equal(got.view(np.int32), ref.cpu().numpy().view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["to_host", "values", "host_array", "ShardedTensor.numpy"])
def test_result_sites_copy_once_on_card(cuda, site):
    x = torch.arange(24, dtype=torch.float32, device=cuda).reshape(4, 6)
    before = BRIDGE.copy()
    if site == "to_host":
        out = to_host(x)
    elif site == "values":
        out = xtt.GriddedArray(x, ("y", "x")).values
    elif site == "host_array":
        out = host_array(x)
    else:
        from xgcm_tpu_torch import parallel as par
        from xgcm_tpu_torch.parallel.sharded_tensor import distribute

        mesh = par.make_mesh({"x": 2}, devices=[cuda] * 2)
        out = distribute(x, mesh, (None, "x")).numpy()
    np.testing.assert_array_equal(out, np.arange(24, dtype=np.float32).reshape(4, 6))
    assert BRIDGE - before == {"d2h_bytes": 96, "d2h_copies": 1}
