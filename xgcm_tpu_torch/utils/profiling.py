"""Profiling and micro-benchmark helpers.

The counterpart of :mod:`xgcm_tpu.utils.profiling`: a chained-execution
timer, a wrapper over ``torch.profiler`` traces, and the program's own
spans.

:func:`span` marks a layer boundary of the package (``xtt.<layer>.<what>``:
``grid_api``, ``arith``, ``face_halo``, ``transform``, ``kernels``).  While
a ``torch.profiler`` records, each span is a ``record_function`` range, so
it lands in the trace beside the card's kernels, copies and memsets, on
their clock, and it adds its call and its host self time to a table that
:func:`span_totals` reads.  While none records, a span costs one check of
the profiler's state and nothing else.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import _profiler_enabled

__all__ = ["device_time", "reset_spans", "span", "span_totals", "throughput", "trace"]

# name -> [calls, host self seconds] of the spans closed while a profiler
# recorded, since the last reset_spans()
_SPAN_TOTALS: Dict[str, List] = {}
_TOTALS_LOCK = threading.Lock()
_OPEN = threading.local()  # .frames: the open spans of this thread, innermost last


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
    ``xgcm_tpu_torch_trace`` in the temporary directory).  The package's
    ``xtt.*`` spans inside the block are in the trace, and their host self
    times in :func:`span_totals`.  Yields ``logdir``."""
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


def _open(name: str) -> list:
    record = torch.profiler.record_function(name)
    record.__enter__()
    frames = getattr(_OPEN, "frames", None)
    if frames is None:
        frames = _OPEN.frames = []
    frame = [name, record, 0.0, time.perf_counter()]  # name, range, child seconds, start
    frames.append(frame)
    return frame


def _close(frame: list) -> None:
    end = time.perf_counter()
    name, record, child_s, start = frame
    frames = _OPEN.frames
    frames.pop()
    took = end - start
    if frames:
        frames[-1][2] += took
    with _TOTALS_LOCK:
        totals = _SPAN_TOTALS.setdefault(name, [0, 0.0])
        totals[0] += 1
        totals[1] += took - child_s
    record.__exit__(None, None, None)


class span:
    """A span of the package named ``name``, as a context manager
    (``with span(name):``) or a decorator (``@span(name)``).

    While no ``torch.profiler`` records, it only checks that.  While one
    records, it opens ``torch.profiler.record_function(name)`` (a
    ``user_annotation`` range of the trace, on the device's clock) and adds
    to :func:`span_totals` one call and its host self time by
    ``time.perf_counter``: its duration less the durations of the spans
    opened inside it, so that the self times of nested spans add up to the
    outer span's duration.  A ``with`` takes a new span each time."""

    __slots__ = ("name", "_frame")

    def __init__(self, name: str):
        self.name = name
        self._frame = None

    def __enter__(self) -> "span":
        if _profiler_enabled():
            self._frame = _open(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        if self._frame is not None:
            frame, self._frame = self._frame, None
            _close(frame)
        return False

    def __call__(self, fn: Callable) -> Callable:
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            frame = _open(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _close(frame)

        return spanned


def span_totals() -> Dict[str, Dict[str, float]]:
    """``{name: {"calls": int, "self_s": float}}`` of every span closed
    while a profiler recorded since the last :func:`reset_spans`."""
    with _TOTALS_LOCK:
        return {name: {"calls": c, "self_s": s} for name, (c, s) in _SPAN_TOTALS.items()}


def reset_spans() -> None:
    """Empty the table that :func:`span_totals` reads."""
    with _TOTALS_LOCK:
        _SPAN_TOTALS.clear()
