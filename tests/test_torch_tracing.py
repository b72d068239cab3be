"""The port's own spans and counters (``xgcm_tpu_torch.utils.span``,
``build.FIRST_LAUNCH_S``) and the benchmark's readers of them.

On the CPU: a span does nothing but check while no profiler records; under
``torch.profiler`` spans are ``user_annotation`` ranges of the trace and
their host self times add up; the face analysis of an LLC grid opens the
spans its layers imply; every span of the package is named ``xtt.<layer>.``;
each reader on a synthetic trace; each benchmark cell's tiny traced
rehearsal reports the program's metrics listed for it; the first call of a
C entry is timed once.  On a CUDA card (``cuda``, skipped elsewhere): the
kernel wrappers' spans equal the launches counted over a traced window.
Imports no JAX, so the card's machine runs it with ``--noconftest``.
"""

import contextlib
import json
import pathlib
import re
import sys
import time
import warnings

import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (the port's host data on the CPU)
import xgcm_tpu_torch as xtt
from xgcm_tpu_torch import utils
from xgcm_tpu_torch.ops import transform as torch_tf
from xgcm_tpu_torch.ops.kernels import build
from xgcm_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness, trace  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY = {"llc4320-face": {"ny": 24, "nx": 32, "nz": 12},
        "llc4320-level": {"ny": 16, "nx": 16}}
PROGRAM_LAYERS = ("grid_api", "arith", "face_halo", "transform", "kernels")
SPAN_CALL = re.compile(r"""\bspan\(\s*["']([^"']+)["']""")


@pytest.fixture(autouse=True)
def _empty_table():
    utils.reset_spans()
    yield
    utils.reset_spans()


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof


@pytest.mark.parametrize("form", ["with", "decorator"])
def test_span_off_records_nothing(form, monkeypatch):
    """With no profiler, a span opens no ``record_function`` and adds
    nothing to the table."""
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    assert not torch.autograd._profiler_enabled()
    if form == "with":
        with utils.span("xtt.test.off"):
            x = torch.ones(3) + 1
    else:
        x = utils.span("xtt.test.off")(lambda: torch.ones(3) + 1)()
    assert float(x.sum()) == 6.0
    assert opened == [] and utils.span_totals() == {}


def test_nested_spans_are_user_annotations_with_additive_self_times(tmp_path):
    """Under the profiler, nested spans are ``user_annotation`` ranges of the
    Chrome trace, and their host self times add up to the outer range's
    duration: the outer span's self time leaves out its children's."""

    @utils.span("xtt.test.inner")
    def inner(seconds):
        time.sleep(seconds)

    def work():
        with utils.span("xtt.test.outer"):
            time.sleep(0.004)
            inner(0.003)
            with utils.span("xtt.test.leaf"):
                time.sleep(0.002)
                inner(0.001)

    _profiled(work)  # the first ranges of a process open slowly
    utils.reset_spans()
    prof = _profiled(work)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("name", "").startswith("xtt.test."):
            assert ev["cat"] == "user_annotation"
            ranges.setdefault(ev["name"], []).append(float(ev["dur"]))
    assert sorted(map(len, ranges.values())) == [1, 1, 2]
    totals = utils.span_totals()
    assert {n: t["calls"] for n, t in totals.items()} == {
        "xtt.test.outer": 1, "xtt.test.inner": 2, "xtt.test.leaf": 1}
    self_us = {n: t["self_s"] * 1e6 for n, t in totals.items()}
    # the spans' host clock runs inside each range; the gap is the range's
    # own opening and closing, microseconds
    outer_us, (leaf_us,) = ranges["xtt.test.outer"][0], ranges["xtt.test.leaf"]
    assert 0 <= outer_us - sum(self_us.values()) < 500
    children_us = ranges["xtt.test.inner"][0] + leaf_us
    assert self_us["xtt.test.outer"] >= 4000
    assert abs(self_us["xtt.test.outer"] - (outer_us - children_us)) < 500


def test_face_analysis_spans_on_llc_grid():
    """One step of the face analysis on ``llc_grid(n=8)``: six Grid diffs,
    the vector interpolation's two interps, eight halo gathers and eight
    calls of E's wrapper, two operators."""
    _, grid = xtt.grids.llc_grid(n=8)
    rng = np.random.default_rng(0)

    def field(dims):
        return xtt.GriddedArray(torch.tensor(rng.random((13, 8, 8)), dtype=torch.float32), dims)

    t, u, v = field(("face", "y", "x")), field(("face", "y", "xl")), field(("face", "yl", "x"))

    def step():
        grid.diff(t, "X")
        grid.diff(t, "Y")
        grid.diff({"X": v}, "X", other_component={"Y": u}) - grid.diff(
            {"Y": u}, "Y", other_component={"X": v})
        grid.diff({"X": u}, "X", other_component={"Y": v}) + grid.diff(
            {"Y": v}, "Y", other_component={"X": u})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            grid.interp_2d_vector({"X": u, "Y": v}, to="center")

    step()
    assert utils.span_totals() == {}
    _profiled(step)
    calls = {n: t["calls"] for n, t in utils.span_totals().items()}
    assert calls == {
        "xtt.grid_api.diff": 6, "xtt.grid_api.interp": 2, "xtt.grid_api.interp_2d_vector": 1,
        "xtt.face_halo.gather": 8, "xtt.kernels.face_shift": 8, "xtt.arith.binop": 2,
    }


def _recipe_span_names():
    names = set()
    for path in (ROOT / "benchmark" / "recipes").glob("*.py"):
        names |= set(SPAN_CALL.findall(path.read_text()))
    return names | {trace.STEP_SPAN}


def test_program_span_names():
    """Every span the package opens is ``xtt.<layer>.<what>`` of one of the
    layers, and none takes the benchmark's window span or a recipe's."""
    found = set()
    for path in (ROOT / "xgcm_tpu_torch").rglob("*.py"):
        found |= set(SPAN_CALL.findall(path.read_text()))
    assert len(found) >= 25
    assert "step" not in found and not found & _recipe_span_names()
    for name in found:
        parts = name.split(".")
        assert parts[0] == "xtt" and parts[1] in PROGRAM_LAYERS and len(parts) == 3, name


def _launch(ts, corr, cat="cuda_runtime", name="cudaLaunchKernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _device(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _reader(name):
    return harness.load_module("metrics", name)


def test_face_halo_device_ms_reader():
    """A device operation launched inside ``xtt.face_halo.gather`` counts in
    ``face_halo.device_ms``; E's kernel, launched after the span, does not."""
    ev = [
        _span("step", 0, 200), _span("grid.diff", 1, 150),
        _span("xtt.grid_api.diff", 2, 140), _span("xtt.face_halo.gather", 3, 20),
        _span("xtt.kernels.face_shift", 30, 10),
        _launch(4, 1), _launch(10, 2, name="cudaMemcpyAsync"), _launch(32, 3),
        _device("index_elementwise_kernel", 40, 7, 1),
        _device("Memcpy DtoD (Device -> Device)", 50, 3, 2, cat="gpu_memcpy"),
        _device("face_shift_kernel<float>", 60, 50, 3),
    ]
    tr = trace.reduce_trace(ev, steps=2)
    assert _reader("face_halo.device_ms").read(tr, None) == pytest.approx(0.005)
    # a program without the span gives nothing to read
    no_spans = [e for e in ev if not e["name"].startswith("xtt.")]
    assert _reader("face_halo.device_ms").read(trace.reduce_trace(no_spans, 2), None) is None
    assert tr.gaps[0][0] == "xtt.face_halo.gather"


def test_dtoh_copies_reader():
    """A ``Memcpy DtoH`` launched inside ``xtt.transform.host_sync`` counts in
    ``transform.dtoh_copies``; a step whose transforms launch no such copy
    reads 0, and a trace without the program's spans reads None."""
    ev = [
        _span("step", 0, 300), _span("xtt.grid_api.transform", 1, 250),
        _span("xtt.transform.transform", 2, 240), _span("xtt.transform.host_sync", 3, 30),
        _span("xtt.kernels.conservative", 40, 10),
        _launch(4, 1, name="cudaMemcpyAsync"), _launch(42, 2),
        _device("Memcpy DtoH (Device -> Pageable)", 10, 2, 1, cat="gpu_memcpy"),
        _device("conservative_kernel", 60, 100, 2),
    ]
    read = _reader("transform.dtoh_copies").read
    assert read(trace.reduce_trace(ev, steps=1), None) == 1.0
    no_copy = [e for e in ev if e.get("args", {}).get("correlation") != 1]
    assert read(trace.reduce_trace(no_copy, steps=1), None) == 0.0
    no_spans = [e for e in ev if not e["name"].startswith("xtt.")]
    assert read(trace.reduce_trace(no_spans, steps=1), None) is None


def test_host_readers(monkeypatch):
    """The host readers divide the table by the window's steps and leave
    out what they name; an empty table gives None."""
    tr = trace.Trace(steps=4, window_us=1.0, ops=[], busy_us=0.0, gaps=[])
    for name in ("grid_api.host_ms", "arith.host_ms", "face_halo.host_ms",
                 "transform.host_ms", "kernels.host_us_per_launch", "kernels.first_launch_s"):
        assert _reader(name).read(tr, None) is None, name
    monkeypatch.setattr(profiling, "_SPAN_TOTALS", {
        "xtt.grid_api.diff": [8, 0.004], "xtt.grid_api.entry_step": [4, 0.002],
        "xtt.transform.transform": [4, 0.001], "xtt.transform.host_sync": [4, 0.1],
        "xtt.kernels.shift": [24, 0.0024], "xtt.kernels.interp_linear": [4, 0.0004],
    })
    assert _reader("grid_api.host_ms").read(tr, None) == pytest.approx(1.5)
    assert _reader("grid_api.host_ms.noisy").read(tr, None) == pytest.approx(1.5)
    assert _reader("transform.host_ms").read(tr, None) == pytest.approx(0.25)
    assert _reader("kernels.host_us_per_launch").read(tr, None) == pytest.approx(100.0)
    assert _reader("arith.host_ms").read(tr, None) is None
    monkeypatch.setattr(build, "FIRST_LAUNCH_S", {"xt_shift": 0.5, "xt_interp_linear": 2.5})
    assert _reader("kernels.first_launch_s").read(tr, None) == pytest.approx(3.0)


def _listed(cell):
    """The program-span metrics of ``BENCHMARK.json`` listed for ``cell``:
    the host times that the CPU rehearsal can read.  ``kernels.first_launch_s``
    needs a C entry, which runs on the card only."""
    return {m["name"] for m in SPEC["per_layer"]
            if m["source"] == "program_span" and cell in m["workloads"]}


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_rehearsal_reports_program_metrics(name, monkeypatch):
    """A tiny traced CPU run of each cell, with the transforms routed through
    the kernel wrappers' plain versions as on the card: every program metric
    listed for the cell is reported, and the kernel wrappers' spans a step
    equal the recipe's launches."""
    monkeypatch.setattr(torch_tf, "_KERNEL_DEVICE", "cpu")
    config = next(w["config"] for w in SPEC["workloads"] if w["name"] == name)
    cell = harness.Cell(SPEC, name, sizes=TINY[config])
    line = harness.run_cell(cell, 2**31 + 977, 0.05, True, torch.device("cpu"),
                            time.perf_counter())
    assert line["correct"] is True
    want = _listed(name)
    assert want and want <= set(line["metrics"])
    assert all(line["metrics"][m]["value"] > 0 for m in want)
    calls = sum(t["calls"] for n, t in utils.span_totals().items()
                if n.startswith("xtt.kernels."))
    assert calls == line["attempted"] * sum(cell.recipe.LAUNCHES.values())


def test_first_launch_timed_once(monkeypatch):
    """``build.launch`` times the first call of each C entry and keeps it."""

    class Lib:
        def __init__(self):
            self.calls = []

        def __getattr__(self, name):
            def entry(*args):
                self.calls.append(name)
                time.sleep(0.002 if self.calls.count(name) == 1 else 0.0)
                return 0
            return entry

    lib = Lib()
    monkeypatch.setattr(build, "load_library", lambda: lib)
    monkeypatch.setattr(build.torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(build, "stream_ptr", lambda d: 0)
    monkeypatch.setattr(build, "FIRST_LAUNCH_S", {})
    for _ in range(3):
        build.launch("xt_shift", torch.device("cpu"), 1, 2)
    first = dict(build.FIRST_LAUNCH_S)
    build.launch("xt_face_shift", torch.device("cpu"))
    assert lib.calls == ["xt_shift"] * 3 + ["xt_face_shift"]
    assert set(build.FIRST_LAUNCH_S) == {"xt_shift", "xt_face_shift"}
    assert build.FIRST_LAUNCH_S["xt_shift"] == first["xt_shift"] >= 0.002
    build.reset_first_launches()
    assert build.FIRST_LAUNCH_S == {}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_spans_equal_launches_on_card(card):
    """Over a traced window of the analysis step, the face analysis and the
    density transforms on the card, the kernel wrappers' spans equal the
    launches ``build`` counts, each entry's first call is timed once, and
    later calls leave it as it was."""
    from xgcm_tpu_torch.entry import step

    gen = torch.Generator(device=card).manual_seed(0)
    ny, nx, nz = 32, 48, 10
    u, v = (torch.rand(ny, nx, device=card, generator=gen) for _ in range(2))
    theta = torch.sort(torch.rand(ny, nx, nz, device=card, generator=gen), -1).values
    targets = torch.linspace(0.1, 0.9, 6, device=card)
    _, grid = xtt.grids.llc_grid(n=8)
    f = xtt.GriddedArray(torch.rand(13, 8, 8, device=card, generator=gen), ("face", "y", "x"))
    ds = xtt.Dataset(coords={"zc": ("zc", np.arange(nz) + 0.5), "zo": ("zo", np.arange(nz + 1.0))})
    zgrid = xtt.Grid(ds, coords={"Z": {"center": "zc", "outer": "zo"}}, periodic=False,
                     autoparse_metadata=False)
    das = [xtt.GriddedArray(torch.rand(ny, nx, nz, device=card, generator=gen), ("y", "x", "zc"))
           for _ in range(3)]
    sb = xtt.GriddedArray(torch.sort(torch.rand(ny, nx, nz + 1, device=card, generator=gen),
                                     -1).values, ("y", "x", "zo"), name="sigma")
    edges = torch.linspace(0.0, 1.0, 5, device=card)

    def work():
        step(u, v, theta, targets)
        grid.diff(f, "X")
        zgrid.transform(das[0], "Z", edges, target_data=sb, method="conservative")
        zgrid.transform_multi(das, "Z", edges, target_data=sb, method="conservative")
        torch.cuda.synchronize(card)

    work()
    first = dict(build.FIRST_LAUNCH_S)
    assert {"xt_shift", "xt_interp_linear", "xt_face_shift", "xt_conservative"} <= set(first)
    assert all(s > 0 for s in first.values())
    build.reset_launch_counts()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    with prof:
        work()
    launched = {k: n for k, n in build.launch_counts().items() if n}
    spans = {n[len("xtt.kernels."):]: t["calls"] for n, t in utils.span_totals().items()
             if n.startswith("xtt.kernels.")}
    assert launched == spans == {"shift": 6, "interp_linear": 1, "face_shift": 1,
                                 "conservative": 1, "conservative_multi": 1}
    assert build.FIRST_LAUNCH_S == first
