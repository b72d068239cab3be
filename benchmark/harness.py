"""One run of one cell of the benchmark of xgcm_tpu_torch.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the sizes (``sizes``) and where they come from;
* ``traffic/<traffic>.json``: the recipe that the mix runs (``recipe``), its
  inputs as kinds of :mod:`inputs` and the limit of each number compared
  (``limits``);
* ``recipes/<recipe>.py``: the user's calls into the port, each under a span
  of its own (``setup``, ``step``, ``kernel_work``, ``LAUNCHES``);
* ``reference/<recipe>.py``: the plain reference of the same answers
  (``blocks``), which imports nothing of the port;
* ``metrics/<metric>.py``: a reader (``read(trace, cell)``) of one
  per-layer metric, returning None where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import statistics
import sys
import time
from typing import Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "xgcm_tpu")  # top-level module names
WARMUP_STEPS = 2
TRACE_TARGET_S = 2.0  # the traced window's length, in steps of the warm-up's time
TRACE_STEPS = (3, 100)


def log(msg: str) -> None:
    print(msg, flush=True)


def load_module(kind: str, name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """``<bench_dir>/<kind>/<name>.py`` as a module."""
    path = bench_dir / kind / f"{name}.py"
    mod_name = f"bench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(path: pathlib.Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, spec: dict, workload: str, bench_dir: pathlib.Path = BENCH_DIR,
                 sizes: Optional[dict] = None):
        by_name = {w["name"]: w for w in spec["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = by_name[workload]
        self.name = workload
        self.chips = int(self.workload["chips"])
        self.config = load_json(bench_dir / "configs" / f"{self.workload['config']}.json")
        self.traffic = load_json(bench_dir / "traffic" / f"{self.workload['traffic']}.json")
        self.sizes = dict(self.config["sizes"], **(sizes or {}))
        self.recipe = load_module("recipes", self.traffic["recipe"], bench_dir)
        self.reference = load_module("reference", self.traffic["recipe"], bench_dir)
        self.end_to_end = [m for m in spec["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [(m, load_module("metrics", m["name"], bench_dir))
                          for m in spec["per_layer"]
                          if workload in m.get("workloads", [workload])
                          and m["moves"] in reported]


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def quantile95(values):
    """The 95th percentile by ``statistics.quantiles`` (exclusive method),
    the value itself for fewer than two."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20)[18]


def card_power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"not read ({exc.__class__.__name__})"


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             control: bool = False) -> dict:
    """Set up, warm up, run the window (or the traced window), judge the last
    step's outputs; returns the result line as a dict.  ``device`` is the
    torch device the inputs are made on; a CUDA device is measured, a CPU
    device only rehearses the run."""
    import torch

    from . import inputs as inputs_mod
    from . import judge, trace

    import xgcm_tpu_torch as xtt
    from xgcm_tpu_torch.ops.kernels import build

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    if on_card:
        build.load_library()
    else:
        xtt.set_default_device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed % (2**63))
    with torch.no_grad():
        made = inputs_mod.make_inputs(cell.traffic["inputs"], cell.sizes, gen, device)
    cell.shapes = {k: tuple(v.shape) for k, v in made.items()}
    state = {"run": cell.recipe.setup(xtt, cell.sizes, made, device)}
    span = torch.profiler.record_function
    last = {}

    def one_step(events=None):
        """One step; ``events``, a pair of CUDA events, time it on the card."""
        last.clear()  # the previous step's results go before this step runs
        if events:
            events[0].record()
        with torch.no_grad():
            out = cell.recipe.step(xtt, state["run"], span)
        if events:
            events[1].record()
        sync()
        last.update(out)

    warm = []
    for _ in range(WARMUP_STEPS):
        t0 = time.perf_counter()
        one_step()
        warm.append(time.perf_counter() - t0)
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; warm-up steps {[round(w * 1e3, 3) for w in warm]} ms")

    attempted, metrics, numbers, extra = 0, {}, None, {}
    if control:
        # the reference in bfloat16 in the program's place: no window
        last.clear()
        numbers = judge.compare_control(made, cell.reference)
    elif traced:
        steps = max(TRACE_STEPS[0], min(TRACE_STEPS[1], math.ceil(
            min(seconds, TRACE_TARGET_S) / max(warm[-1], 1e-6))))
        build.reset_launch_counts()
        tr = trace.traced_steps(one_step, steps, span)
        launches = build.launch_counts()
        cell.card = card_power_limit() if on_card else "cpu"
        attempted = steps
        for entry, reader in cell.per_layer:
            value = reader.read(tr, cell)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        extra = {"busy_s": tr.busy_us / 1e6, "window_s": tr.window_us / 1e6}
        log(f"traced window: {steps} steps, {tr.window_us / 1e6:.6f} s, device busy "
            f"{tr.busy_us / 1e6:.6f} s, {len(tr.ops)} device operations; launches "
            f"{_per_step(launches, steps)} a step (recipe: {cell.recipe.LAUNCHES})")
    else:
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        build.reset_launch_counts()
        times, dev_ms = [], []
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)) if on_card else None
            one_step(events)
            times.append(time.perf_counter())
            if events:
                dev_ms.append(events[0].elapsed_time(events[1]))
        window_s = time.perf_counter() - w0
        steps = len(times)
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        launches = build.launch_counts()
        step_ms = [(b - a) * 1e3 for a, b in zip([w0] + times[:-1], times)]
        attempted = steps
        values = {"setup_s": (setup_s, "s"), "analysis_ms": (window_s * 1e3 / steps, "ms"),
                  "analysis_p95_ms": (quantile95(step_ms), "ms"),
                  "peak_mem_gb": (peak / 1e9, "GB")}
        # "<quantity>.<group>" is the quantity for a group of cells under a
        # bound of its own
        metrics = {m["name"]: dict(zip(("value", "unit"), values[m["name"].split(".")[0]]))
                   for m in cell.end_to_end}
        log(f"window: {steps} steps in {window_s:.6f} s; host-clock step ms median "
            f"{statistics.median(step_ms):.4f}, p95 {quantile95(step_ms):.4f}, max "
            f"{max(step_ms):.4f}; peak {peak / 1e9:.4f} GB; launches "
            f"{_per_step(launches, steps)} a step (recipe: {cell.recipe.LAUNCHES})")
        if dev_ms:
            log(f"CUDA-event step ms median {statistics.median(dev_ms):.4f}, "
                f"p95 {quantile95(dev_ms):.4f}")
    memory_peak = max(setup_peak, torch.cuda.max_memory_allocated(device) if on_card else 0)
    device_line = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(memory_peak),
        **extra,
    }
    if on_card:
        log(f"card: {getattr(cell, 'card', None) or card_power_limit()}")

    # judge once the window has closed, the peak is read and the program's
    # state is freed
    state.clear()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if numbers is None:
        outputs = dict(last)
        last.clear()
        with torch.no_grad():
            numbers = judge.compare_outputs(outputs, made, cell.reference)
        del outputs
    sync()
    log(f"reference: {time.perf_counter() - t0:.3f} s")
    ok, checks = judge.verdict(numbers, cell.traffic.get("limits", {}))
    line = {"correct": ok, "attempted": attempted, "failed": 0 if ok else 1,
            "metrics": metrics, "device": device_line}
    if extra:
        line["breakdown"] = trace.breakdown(tr)
    line["checks"] = checks  # last: each number compared beside its limit
    return line


def _per_step(counts: dict, steps: int) -> dict:
    return {k: v / steps for k, v in counts.items() if v}
