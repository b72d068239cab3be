"""The benchmark harness on the CPU at tiny sizes, with the kernels' plain
versions: every cell resolves to its files and runs, its reference agrees
with the port, its control and its planted faults come out not correct,
the result line has the contract's keys, no JAX is loaded, and a cell
added by files alone runs.  ``cuda`` tests run the cells on a card.

    python -m pytest benchmark/tests -q -p no:randomly
"""

import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness, trace  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
TINY = {"llc4320-face": {"ny": 24, "nx": 32, "nz": 12},
        "llc4320-level": {"ny": 16, "nx": 16}}
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
SEED = 2**31 + 977  # more than 32 signed bits hold


def tiny_cell(name):
    config = next(w["config"] for w in SPEC["workloads"] if w["name"] == name)
    return harness.Cell(SPEC, name, sizes=TINY[config])


def run(cell, traced=False, control=False, seed=SEED):
    return harness.run_cell(cell, seed, 0.05, traced, torch.device("cpu"),
                            time.perf_counter(), control=control)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_agrees_with_its_reference(name):
    line = run(tiny_cell(name))
    assert set(line) == LINE_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    want = {m["name"] for m in SPEC["end_to_end"] if name in m.get("workloads", [name])}
    assert set(line["metrics"]) == want
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_line(name):
    line = run(tiny_cell(name), traced=True)
    assert set(line) == LINE_KEYS | {"breakdown"} and list(line)[-1] == "checks"
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in bfloat16 in the program's place fails a number."""
    line = run(tiny_cell(name), control=True)
    assert line["correct"] is False
    failing = [k for k, c in line["checks"].items() if not c["value"] <= c["limit"]]
    assert failing


def _altered(out):
    name = next(k for k, v in out.items() if v.ndim >= 1)
    x = out[name].clone()
    flat = x.view(-1)
    finite = torch.nonzero(torch.isfinite(flat)).flatten()
    i = int(finite[finite.numel() // 2])
    flat[i] = flat[i] + 1e-2 * float(flat[finite].abs().max())
    out[name] = x
    return out


def _half(out):
    """The second half of each answer's rows (levels, faces) left out."""
    for k, v in out.items():
        if v.ndim >= 1:
            v = v.clone()
            v[v.shape[0] // 2:] = 0.0
            out[k] = v
    return out


def _unchanged(out):
    """Answers left as allocated, never computed."""
    return {k: torch.zeros_like(v) for k, v in out.items()}


FAULTS = {"altered": _altered, "half": _half, "unchanged": _unchanged}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault, monkeypatch):
    cell = tiny_cell(name)
    step = cell.recipe.step
    monkeypatch.setattr(cell.recipe, "step",
                        lambda xtt, s, span: FAULTS[fault](dict(step(xtt, s, span))))
    assert run(cell)["correct"] is False


def test_face_exchange_left_out_is_caught(monkeypatch):
    """The face analysis with every face connection's halo replaced by the
    boundary condition (the exchange between faces left out)."""
    cell = tiny_cell("level-faces")
    setup = cell.recipe.setup

    def no_exchange(*args):
        s = setup(*args)
        grid = s["grid"]
        plan_of = grid._face_plan

        def unconnected(*a, **k):
            plan = plan_of(*a, **k)
            return plan._replace(connected=torch.zeros_like(plan.connected))

        grid._face_plan = unconnected
        return s

    monkeypatch.setattr(cell.recipe, "setup", no_exchange)
    assert run(cell)["correct"] is False


def test_same_seed_same_inputs():
    from benchmark import inputs

    cell = tiny_cell("face-density")
    made = [inputs.make_inputs(cell.traffic["inputs"], cell.sizes,
                               torch.Generator().manual_seed(SEED % 2**63),
                               torch.device("cpu")) for _ in range(2)]
    for k in made[0]:
        assert torch.equal(made[0][k].nan_to_num(), made[1][k].nan_to_num())


def test_no_jax_after_every_cell():
    """In a fresh process: the harness and every cell's traffic, then no
    module whose top-level name is jax, jaxlib, flax or xgcm_tpu."""
    code = (
        "import sys, time, torch; sys.path.insert(0, %r)\n"
        "from benchmark.tests.test_bench_harness import CELLS, tiny_cell, run\n"
        "from benchmark import harness\n"
        "for c in CELLS: assert run(tiny_cell(c))['correct']\n"
        "print(harness.forbidden_modules())\n" % str(ROOT))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "face-step",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_cell_added_by_files_alone(tmp_path):
    """A throwaway cell (a configuration, a traffic mix and a per-layer
    metric, each a new file, and entries in BENCHMARK.json) in a copy of the
    benchmark runs without an edit to any file already there."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    config = json.loads((bench / "configs" / "llc4320-face.json").read_text())
    config.update(name="tiny-face", sizes={"faces": 1, "ny": 20, "nx": 20, "nz": 9})
    (bench / "configs" / "tiny-face.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "cgrid-step.json").read_text())
    traffic["inputs"][-1]["num"] = 7
    (bench / "traffic" / "cgrid-step-7.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "steps.count.py").write_text(
        "def read(trace, cell):\n    return float(trace.steps)\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(spec["configs"][0], name="tiny-face",
                                file="benchmark/configs/tiny-face.json"))
    spec["workloads"].append({"name": "tiny-step", "config": "tiny-face",
                              "traffic": "cgrid-step-7", "chips": 1, "why": "a test"})
    for metric in spec["end_to_end"]:
        if metric["name"] == "analysis_ms":
            metric["workloads"].append("tiny-step")
    spec["per_layer"].append({"name": "steps.count", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "analysis_ms", "workloads": ["tiny-step"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import json, sys, time, torch; sys.path[:0] = [%r, %r]\n"
        "from benchmark import harness\n"
        "assert harness.ROOT == __import__('pathlib').Path(%r)\n"
        "cell = harness.Cell(harness.load_json(harness.ROOT / 'BENCHMARK.json'), 'tiny-step')\n"
        "line = harness.run_cell(cell, 5, 0.05, True, torch.device('cpu'), time.perf_counter())\n"
        "print(json.dumps(line))\n" % (str(tmp_path), str(ROOT), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["steps.count"]["value"] >= 3


def test_trace_reduction():
    """Busy time is the union of device intervals (overlap counted once,
    copies counted), each operation is attributed to the span its launch
    ran in, and each gap is named by the span that launched the operation
    ending it."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "step", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "grid.diff", "ts": 1, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "arith", "ts": 40, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 1,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 3, "dur": 1,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 41, "dur": 1,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "face_shift_kernel<float>", "ts": 10, "dur": 20,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 25, "dur": 10,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel", "ts": 50, "dur": 30,
         "args": {"correlation": 3}},
    ]
    tr = trace.reduce_trace(ev, steps=1)
    assert tr.window_us == 100 and math.isclose(tr.busy_us, 55)
    assert [o.spans for o in tr.ops] == [("step", "grid.diff"), ("step", "grid.diff"),
                                          ("step", "arith")]
    assert tr.gaps == [("grid.diff", 10), ("arith", 15), ("outside spans", 20)]
    assert len(tr.ops_under("grid.diff", ("face_shift_kernel",))) == 1
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0] == ["elementwise_kernel", 30e-6]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_card(name, card):
    from xgcm_tpu_torch.ops.kernels import build

    build.build_library()
    cell = tiny_cell(name)
    line = harness.run_cell(cell, SEED, 0.2, False, card, time.perf_counter())
    assert line["correct"] is True, line["checks"]
    line = harness.run_cell(cell, SEED, 0.2, True, card, time.perf_counter())
    assert line["correct"] is True and line["device"]["busy_s"] > 0
