"""Profiling and micro-benchmark helpers.

The counterpart of :mod:`xgcm_tpu.utils.profiling`: a chained-execution
timer and a wrapper over ``torch.profiler`` traces.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

__all__ = ["device_time", "throughput", "trace"]


def device_time(
    fn: Callable[..., torch.Tensor],
    *args,
    iters: int = 30,
    chain_eps: float = 1e-20,
) -> float:
    """Seconds per execution of ``fn(*args)`` on the device of ``args[0]``.

    As in the JAX package, ``iters`` applications are chained (each
    iteration's first argument is ``x + chain_eps * out``, the previous
    output feeding the next call) and summed at the end, after one warm-up
    run.  ``fn`` maps tensors to one tensor broadcastable against its first
    argument.  On a CUDA tensor the loop is timed with CUDA events, on the
    CPU with ``time.perf_counter`` around the work and its result.

    Unlike JAX, whose loop is one compiled ``fori_loop`` dispatched once,
    eager torch launches every iteration's kernels one by one: the time per
    iteration includes their launch overhead and the chaining pass (a
    multiply and an add over the first argument).
    """
    first, rest = args[0], args[1:]

    def run():
        x = first
        for _ in range(iters):
            x = x + chain_eps * fn(x, *rest)
        return x.sum()

    float(run())  # warm-up and synchronise
    if first.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        total = run()
        end.record()
        float(total)
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    float(run())
    return (time.perf_counter() - t0) / iters


def throughput(
    fn: Callable[..., torch.Tensor], *args, points: Optional[int] = None, **kw
) -> Dict[str, float]:
    """Gridpoints per second of ``fn`` (``points`` defaults to the first
    argument's element count)."""
    secs = device_time(fn, *args, **kw)
    n = points if points is not None else args[0].numel()
    return {"seconds_per_iter": secs, "points_per_second": n / secs}


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace (CPU activity, and CUDA activity
    when a card is there) around a block of work, the device's work
    included (it synchronises before the trace ends), and write it as a Chrome
    trace ``trace_<pid>_<ns>.json`` into ``logdir`` (by default
    ``xgcm_tpu_torch_trace`` in the temporary directory).  Yields
    ``logdir``."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "xgcm_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's device work ends inside the trace
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )
