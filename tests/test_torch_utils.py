"""The port's profiling helpers (``utils/profiling.py``) as
tests/test_utils.py tests the JAX package's, a trace written to disk, and
each module of this slice importing first without a cycle and without
JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

import tests.torch_parity  # noqa: F401  (the CPU as the default device)
from xgcm_tpu_torch.utils import device_time, throughput, trace


def test_device_time_runs():
    x = torch.as_tensor(np.random.rand(64, 64).astype(np.float32))
    secs = device_time(lambda a: a * 2.0, x, iters=5)
    assert secs > 0


def test_device_time_chains_the_calls():
    """Each call gets the previous chained output, after one warm-up run."""
    seen = []

    def fn(a):
        seen.append(float(a[0]))
        return a

    device_time(fn, torch.ones(3, dtype=torch.float64), iters=3, chain_eps=0.5)
    assert seen == [1.0, 1.5, 2.25] * 2


def test_throughput_reports_points():
    x = torch.as_tensor(np.random.rand(32, 32).astype(np.float32))
    out = throughput(lambda a: a + 1.0, x, iters=5)
    assert out["points_per_second"] > 0
    assert abs(out["points_per_second"] * out["seconds_per_iter"] - x.numel()) < 1
    assert throughput(lambda a: a, x, points=7, iters=2)["points_per_second"] > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.rand(16, 16)
    with trace(str(tmp_path / "tr")) as logdir:
        (x @ x).sum()
    assert logdir == str(tmp_path / "tr")
    [name] = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_import_orders_no_cycles_and_no_jax():
    """Each module of the slice can be imported first, and none imports
    JAX or the JAX package."""
    mods = (
        "xgcm_tpu_torch.adapters",
        "xgcm_tpu_torch.adapters.xarray_adapter",
        "xgcm_tpu_torch.ops",
        "xgcm_tpu_torch.ops.regridding",
        "xgcm_tpu_torch.utils",
        "xgcm_tpu_torch.utils.profiling",
    )
    check = ("bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'xgcm_tpu')]; "
             "assert not bad, bad")
    procs = [subprocess.Popen([sys.executable, "-c", f"import sys, {mod}; {check}"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for mod in mods]
    for mod, p in zip(mods, procs):
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, f"{mod}: {err[-500:]}"
