"""The ``levels-4gpu`` cell on the CPU at tiny sizes (ny = nx = 16, nz = 2)
on four logical shards, with the kernels' plain versions: it runs and
agrees with its reference, its traced line carries the sharded layer's
assemblies a step, its control and its planted faults (the strip exchange across the
shards left out, an answer altered by 1 % of its scale, a dummy face
leaked into a result) come out not correct, and no JAX is loaded.

    python -m pytest benchmark/tests/test_bench_levels_4gpu.py -q -p no:randomly
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
NAME = "levels-4gpu"
TINY = {"ny": 16, "nx": 16, "nz": 2}
SEED = 2**31 + 1013  # more than 32 signed bits hold


def tiny_cell():
    return harness.Cell(SPEC, NAME, sizes=TINY)


def run(cell, traced=False, control=False, seed=SEED):
    return harness.run_cell(cell, seed, 0.05, traced, torch.device("cpu"),
                            time.perf_counter(), control=control)


def test_cell_runs_and_agrees_with_its_reference():
    line = run(tiny_cell())
    assert line["correct"] is True, line["checks"]
    assert line["device"]["count"] == 4
    want = {m["name"] for m in SPEC["end_to_end"] if NAME in m.get("workloads", [NAME])}
    assert set(line["metrics"]) == want and "setup_s" in want
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


def test_results_stay_sharded():
    """The step's six results are 13-face ShardedTensors of the padded
    layout, and the step assembles nothing."""
    from xgcm_tpu_torch import parallel as par

    cell = tiny_cell()
    made = {k: torch.randn((2, 13, 16, 16)) for k in ("theta", "u", "v")}
    import xgcm_tpu_torch as xtt

    xtt.set_default_device("cpu")
    s = cell.recipe.setup(xtt, cell.sizes, made, torch.device("cpu"))
    par.reset_assembly_count()
    out = cell.recipe.step(xtt, s, torch.profiler.record_function)
    assert par.assembly_count() == 0
    assert all(isinstance(v, par.ShardedTensor) and v.padded and v.shape[1] == 13
               for v in out.values())


def test_traced_line_carries_the_program_metrics():
    """The traced line carries the sharded layer's assemblies a step, 0:
    the program opened its ``xtt.sharded.*`` spans and assembled nothing.
    The recipe's work for E is its 32 block launches."""
    cell = tiny_cell()
    line = run(cell, traced=True)
    assert line["correct"] is True
    assert line["metrics"] == {"sharded.assemblies": {"value": 0.0,
                                                      "unit": "assemblies/step"}}
    assert len(cell.recipe.kernel_work(cell.shapes)["face_shift"]) == 32


def test_no_reading_from_a_program_without_the_spans(monkeypatch):
    """A program that opens no ``xtt.sharded.*`` span (the parent of the
    padded layout) gives no reading, and the line leaves the metric out."""
    cell = tiny_cell()
    reader = dict((m["name"], mod) for m, mod in cell.per_layer)["sharded.assemblies"]
    monkeypatch.setattr(reader, "_layer_spans", lambda layer: {})
    tr = trace.Trace(steps=2, window_us=200.0, ops=[], busy_us=0.0, gaps=[])
    assert reader.read(tr, cell) is None


def test_control_is_not_correct():
    line = run(tiny_cell(), control=True)
    assert line["correct"] is False
    assert [k for k, c in line["checks"].items() if not c["value"] <= c["limit"]]


def _altered(out):
    """One finite value of one answer's real faces moved by 1 % of the
    answer's largest finite magnitude."""
    from xgcm_tpu_torch.parallel import ShardedTensor

    x = out["zeta"]
    blocks = np.empty(x.blocks.shape, dtype=object)
    for c in np.ndindex(x.blocks.shape):
        blocks[c] = x.blocks[c].clone()
    full = x.full_tensor()
    scale = float(full[torch.isfinite(full)].abs().max())
    b = blocks[(1,)]
    b[1, 2, 3, 4] = b[1, 2, 3, 4] + 1e-2 * scale
    out["zeta"] = ShardedTensor(blocks, x.mesh, x.spec, shape=x.shape)
    return out


def _dummy_leaked(out):
    """The last block's faces rolled by one: face 12 shows a dummy face."""
    from xgcm_tpu_torch.parallel import ShardedTensor

    x = out["div"]
    blocks = np.empty(x.blocks.shape, dtype=object)
    for c in np.ndindex(x.blocks.shape):
        blocks[c] = x.blocks[c]
    blocks[(3,)] = torch.roll(x.blocks[(3,)], 1, dims=1)
    out["div"] = ShardedTensor(blocks, x.mesh, x.spec, shape=x.shape)
    return out


@pytest.mark.parametrize("fault", [_altered, _dummy_leaked], ids=["altered", "dummy_leaked"])
def test_fault_is_caught(fault, monkeypatch):
    cell = tiny_cell()
    step = cell.recipe.step
    monkeypatch.setattr(cell.recipe, "step", lambda xtt, s, span: fault(dict(step(xtt, s, span))))
    line = run(cell)
    assert line["correct"] is False


def test_strip_exchange_left_out_is_caught(monkeypatch):
    """Each shard's strip pool holds its own faces' strips only (zeros for
    the faces of the other shards): every halo line across shards is
    wrong."""
    from xgcm_tpu_torch.parallel import face_sharded

    def own_only(blocks, mesh, axis_name, axis=0, tiled=False):
        ax = mesh.axis_index(axis_name)
        n = mesh.devices.shape[ax]
        out = np.empty(blocks.shape, dtype=object)
        for c in mesh.local_coords:
            parts = [blocks[c] if k == c[ax] else torch.zeros_like(blocks[c]) for k in range(n)]
            out[c] = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)
        return out

    monkeypatch.setattr(face_sharded, "all_gather", own_only)
    assert run(tiny_cell())["correct"] is False


def test_no_jax_after_the_cell():
    """In a fresh process: the cell runs correct, then no module whose
    top-level name is jax, jaxlib, flax or xgcm_tpu is loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.tests.test_bench_levels_4gpu import tiny_cell, run\n"
        "from benchmark import harness\n"
        "assert run(tiny_cell())['correct']\n"
        "print(harness.forbidden_modules())\n" % str(ROOT))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
