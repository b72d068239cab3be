"""The ``face-step-host`` cell on the CPU at tiny sizes (ny = 24, nx = 32,
nz = 12), with the kernels' plain versions: it runs from two host snapshots
taken in turn and agrees with its reference; results left as tensors are
refused by the recipe; an answer altered by 1 % of its scale and a result
whose later blocks were never copied back (zeros) come out not correct; the
bridge's readers read what they should from a trace and nothing from a
program without the bridge; and no JAX is loaded.

    python -m pytest benchmark/tests/test_bench_face_step_host.py -q -p no:randomly
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness, trace  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "face-step-host"
TINY = {"ny": 24, "nx": 32, "nz": 12}
SEED = 2**31 + 2417  # more than 32 signed bits hold


def tiny_cell():
    return harness.Cell(SPEC, NAME, sizes=TINY)


def run(cell, traced=False, control=False, seed=SEED):
    return harness.run_cell(cell, seed, 0.05, traced, torch.device("cpu"),
                            time.perf_counter(), control=control)


def test_cell_runs_and_agrees_with_its_reference():
    line = run(tiny_cell())
    assert line["correct"] is True, line["checks"]
    want = {m["name"] for m in SPEC["end_to_end"] if NAME in m.get("workloads", [NAME])}
    assert set(line["metrics"]) == want and "setup_s" in want and len(want) >= 2
    assert set(line["checks"]) == {"zeta_err", "div_err", "ke_on_theta_err",
                                   "nonfinite_mismatch"}


def test_steps_take_the_two_snapshots_in_turn(monkeypatch):
    """Set-up makes two host snapshots of the seed's inputs with the same
    values in separate buffers; the steps read A, B, A: no step reads the
    buffers the step before it read."""
    import xgcm_tpu_torch as xtt
    from xgcm_tpu_torch import entry

    cell = tiny_cell()
    made = {"u": torch.randn(24, 32), "v": torch.randn(24, 32),
            "theta": torch.sort(torch.rand(24, 32, 12), -1).values,
            "targets": torch.linspace(0.1, 0.9, 5)}
    xtt.set_default_device("cpu")
    s = cell.recipe.setup(xtt, cell.sizes, made, torch.device("cpu"))
    a, b = s["snapshots"]
    for k, t in made.items():
        assert isinstance(a[k], np.ndarray) and np.array_equal(a[k], t.numpy())
        assert np.array_equal(a[k], b[k]) and not np.shares_memory(a[k], b[k])
        assert not np.shares_memory(a[k], t.numpy())
    seen = []
    step = entry.step
    monkeypatch.setattr(entry, "step", lambda u, *args, **kw: (seen.append(u), step(u, *args, **kw))[1])
    for _ in range(3):
        out = cell.recipe.step(xtt, s, torch.profiler.record_function)
    assert [x is a["u"] for x in seen] == [True, False, True]
    assert seen[1] is b["u"]
    assert all(isinstance(r, cell.recipe.HostResult) for r in out.values())


def test_results_left_as_tensors_are_refused(monkeypatch):
    """A program whose ``entry.step`` gives tensors for host inputs (the
    parent of the bridge) fails the run on its first step."""
    from xgcm_tpu_torch import entry

    step = entry.step

    def on_card(*args, **kw):
        return tuple(torch.as_tensor(r) for r in step(*args, **kw))

    monkeypatch.setattr(entry, "step", on_card)
    with pytest.raises(TypeError, match="not host numpy arrays"):
        run(tiny_cell())


def _altered(out):
    """One finite value of ζ moved by 1 % of ζ's largest finite magnitude."""
    z = out["zeta"].array.copy()
    finite = np.flatnonzero(np.isfinite(z))
    i = finite[finite.size // 2]
    z.flat[i] += 1e-2 * np.abs(z.flat[finite]).max()
    out["zeta"] = type(out["zeta"])(z, out["zeta"].device)
    return out


def _later_blocks_not_copied(out):
    """The energy's later half of rows never copied back: zeros."""
    k = out["ke_on_theta"].array.copy()
    k[k.shape[0] // 2:] = 0.0
    out["ke_on_theta"] = type(out["ke_on_theta"])(k, out["ke_on_theta"].device)
    return out


@pytest.mark.parametrize("fault", [_altered, _later_blocks_not_copied],
                         ids=["altered", "later_blocks_not_copied"])
def test_fault_is_caught(fault, monkeypatch):
    cell = tiny_cell()
    step = cell.recipe.step
    monkeypatch.setattr(cell.recipe, "step", lambda xtt, s, span: fault(dict(step(xtt, s, span))))
    assert run(cell)["correct"] is False


def test_control_is_not_correct():
    line = run(tiny_cell(), control=True)
    assert line["correct"] is False


def test_copy_work_of_a_face():
    """The bytes each way of a step at 4320² x 90 with 36 targets: 9.70 GB."""
    cell = tiny_cell()
    work = cell.recipe.copy_work({"u": (4320, 4320), "v": (4320, 4320),
                                  "theta": (4320, 4320, 90), "targets": (36,)})
    assert work == {"h2d": 6_867_763_344, "d2h": 2_836_684_800}


def _readers(cell):
    return {m["name"]: mod for m, mod in cell.per_layer}


def test_bridge_roofline_from_a_trace():
    """Each copy under its bridge span counts; a copy outside them, or a
    copy the other way under a span, does not."""
    cell = tiny_cell()
    cell.shapes = {"u": (24, 32), "v": (24, 32), "theta": (24, 32, 12), "targets": (36,)}
    cell.card = "test"
    work = sum(cell.recipe.copy_work(cell.shapes).values())
    least_us = work / 64e9 * 1e6
    ops = [trace.DeviceOp("Memcpy HtoD (Pageable -> Device)", 0.0, least_us,
                          ("step", "entry.step", "xtt.bridge.to_device")),
           trace.DeviceOp("Memcpy DtoH (Device -> Pageable)", 0.0, least_us,
                          ("step", "entry.step", "xtt.bridge.to_host")),
           trace.DeviceOp("Memcpy HtoD (Pageable -> Device)", 0.0, 1e6, ("step",)),
           trace.DeviceOp("Memcpy DtoH (Device -> Pageable)", 0.0, 1e6,
                          ("step", "xtt.bridge.to_device")),
           trace.DeviceOp("interp_linear_kernel", 0.0, 1e6, ("step", "xtt.bridge.to_host"))]
    tr = trace.Trace(steps=1, window_us=1e7, ops=ops, busy_us=1e7, gaps=[])
    roofline = [mod for name, mod in _readers(cell).items() if name.startswith("bridge_roofline")]
    assert len(roofline) == 1
    assert roofline[0].read(tr, cell) == pytest.approx(50.0)


def test_no_reading_from_a_program_without_the_bridge(monkeypatch):
    """A program that opens no ``xtt.bridge.*`` span and launches no copy
    under one (the parent of the bridge) gives no reading."""
    from benchmark import program_spans

    cell = tiny_cell()
    cell.shapes = {"theta": (24, 32, 12), "targets": (36,)}
    monkeypatch.setattr(program_spans, "_span_totals", lambda: {})
    tr = trace.Trace(steps=2, window_us=200.0, ops=[trace.DeviceOp("k", 0.0, 1.0, ("step",))],
                     busy_us=1.0, gaps=[])
    for name, mod in _readers(cell).items():
        if name.startswith("bridge"):
            assert mod.read(tr, cell) is None, name


def test_no_jax_after_the_cell():
    """In a fresh process: the cell runs correct, then no module whose
    top-level name is jax, jaxlib, flax or xgcm_tpu is loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.tests.test_bench_face_step_host import tiny_cell, run\n"
        "from benchmark import harness\n"
        "assert run(tiny_cell())['correct']\n"
        "print(harness.forbidden_modules())\n" % str(ROOT))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
