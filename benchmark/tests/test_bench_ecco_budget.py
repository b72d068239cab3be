"""The ``ecco-budget`` cell on the CPU at tiny sizes (n = 12, nz = 6,
nt = 3), with the kernels' plain versions: it runs and agrees with its
reference; its control and planted faults come out not correct (an answer
altered by 1 % of its scale, the exchange between tiles left out of the
horizontal convergence, the vertical convergence left out); the traced line
reads the cell's metrics; and no JAX is loaded.

    python -m pytest benchmark/tests/test_bench_ecco_budget.py -q -p no:randomly
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness, trace  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "ecco-budget"
TINY = {"ny": 12, "nx": 12, "nz": 6, "nt": 3, "nt_snp": 4}
SEED = 2**31 + 2609  # more than 32 signed bits hold
TERMS = {"G_total_err", "G_advection_err", "G_diffusion_err", "G_forcing_err",
         "nonfinite_mismatch"}


def tiny_cell():
    return harness.Cell(SPEC, NAME, sizes=TINY)


def run(cell, traced=False, control=False, seed=SEED):
    return harness.run_cell(cell, seed, 0.05, traced, torch.device("cpu"),
                            time.perf_counter(), control=control)


@pytest.mark.parametrize("seed", [SEED, 3_000_000_019])
def test_cell_runs_and_agrees_with_its_reference(seed):
    line = run(tiny_cell(), seed=seed)
    assert line["correct"] is True, line["checks"]
    want = {m["name"] for m in SPEC["end_to_end"] if NAME in m.get("workloads", [NAME])}
    assert set(line["metrics"]) == want and "setup_s" in want and len(want) >= 2
    assert set(line["checks"]) == TERMS
    assert all(c["value"] < 1e-6 for k, c in line["checks"].items() if k.endswith("_err"))


def test_control_is_not_correct():
    """The reference in bfloat16 in the program's place fails every term."""
    line = run(tiny_cell(), control=True)
    assert line["correct"] is False
    assert all(c["value"] > c["limit"] for k, c in line["checks"].items() if k.endswith("_err"))


def _altered(out):
    """One finite value of G_advection moved by 1 % of its largest finite
    magnitude."""
    g = out["G_advection"].clone()
    flat = g.view(-1)
    finite = torch.nonzero(torch.isfinite(flat)).flatten()
    i = int(finite[finite.numel() // 2])
    flat[i] = flat[i] + 1e-2 * float(flat[finite].abs().max())
    out["G_advection"] = g
    return out


def test_altered_answer_is_caught(monkeypatch):
    cell = tiny_cell()
    step = cell.recipe.step
    monkeypatch.setattr(cell.recipe, "step", lambda xtt, s, span: _altered(dict(step(xtt, s, span))))
    line = run(cell)
    assert line["correct"] is False
    assert line["checks"]["G_advection_err"]["value"] > line["checks"]["G_advection_err"]["limit"]


def test_exchange_left_out_is_caught(monkeypatch):
    """Every tile connection's halo replaced by the boundary's fill in the
    step's horizontal convergences (set-up's masks keep the connections)."""
    cell = tiny_cell()
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
    line = run(cell)
    assert line["correct"] is False
    for term in ("G_advection_err", "G_diffusion_err"):
        assert line["checks"][term]["value"] > line["checks"][term]["limit"]


def test_vertical_convergence_left_out_is_caught(monkeypatch):
    """Every diff along Z answered with zeros."""
    cell = tiny_cell()
    setup = cell.recipe.setup

    def flat(*args):
        s = setup(*args)
        grid = s["grid"]
        diff = grid.diff

        def no_z(da, axis, **kw):
            out = diff(da, axis, **kw)
            return out * 0.0 if axis == "Z" else out

        grid.diff = no_z
        return s

    monkeypatch.setattr(cell.recipe, "setup", flat)
    line = run(cell)
    assert line["correct"] is False
    for term in ("G_advection_err", "G_diffusion_err"):
        assert line["checks"][term]["value"] > line["checks"][term]["limit"]


def test_traced_line_reads_no_generic_face_pad():
    """The traced rehearsal is correct and reads ``face_pad.generic_calls``
    0; the kernels' rooflines need the card's trace and are left out."""
    line = run(tiny_cell(), traced=True)
    assert line["correct"] is True
    assert line["metrics"]["face_pad.generic_calls"]["value"] == 0
    assert {"busy_s", "window_s"} <= set(line["device"])


def test_rooflines_from_a_trace():
    """Each roofline reads its kernel's launches: E's over the four
    face-shift launches' least time, A's over the two shifts'."""
    from benchmark.roofline import bound

    cell = tiny_cell()
    cell.shapes = {"ADVx_TH": (156, 50, 13, 90, 90)}
    cell.card = "test"
    work = cell.recipe.kernel_work(cell.shapes)
    least = {k: sum(bound(b, f)[0] for b, f in v) for k, v in work.items()}
    assert least["face_shift"] == pytest.approx(4 * (2 * 821_340_000 + 9_126_000) * 4
                                                / 3.35e12 * 1e3)
    ops = [trace.DeviceOp("void face_shift_kernel_rows<float, 1>", 0.0,
                          least["face_shift"] * 1e3 / 2, ("step",)),
           trace.DeviceOp("void shift_planes<float, 4>", 0.0, least["shift"] * 1e3 * 4,
                          ("step",))]
    tr = trace.Trace(steps=1, window_us=1e7, ops=ops, busy_us=1e7, gaps=[])
    readers = {m["name"]: mod for m, mod in cell.per_layer}
    assert readers["face_shift_scalar_roofline"].read(tr, cell) == pytest.approx(200.0)
    assert readers["shift_levels_roofline"].read(tr, cell) == pytest.approx(25.0)


def test_no_jax_after_the_cell():
    """In a fresh process: the cell runs correct, then no module whose
    top-level name is jax, jaxlib, flax or xgcm_tpu is loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.tests.test_bench_ecco_budget import tiny_cell, run\n"
        "from benchmark import harness\n"
        "assert run(tiny_cell())['correct']\n"
        "print(harness.forbidden_modules())\n" % str(ROOT))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
