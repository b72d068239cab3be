"""The traced window and its reduction to what the per-layer readers read.

One ``torch.profiler`` window (CPU and CUDA activity) over a few steps,
exported as a Chrome trace into a temporary directory and read back:

* device operations: kernels, memcpy and memset, each with its start,
  length and the benchmark span (``torch.profiler.record_function``) the
  host was in when it launched it (matched through the launch's
  correlation id);
* busy time: the union of the device operations' intervals inside the
  window, so that overlap on several streams counts once and copies count;
* idle gaps: the window minus that union, each named by the span the host
  was in when it launched the operation that ended the gap.

The window runs from the start of the first ``step`` span to the end of
the last; each step ends in a synchronise inside its span.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from typing import Callable, List, Optional, Tuple

STEP_SPAN = "step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_us: float
    dur_us: float
    spans: Tuple[str, ...]  # the host's spans at its launch, outermost first


@dataclasses.dataclass
class Trace:
    steps: int
    window_us: float
    ops: List[DeviceOp]
    busy_us: float
    gaps: List[Tuple[str, float]]  # (span, microseconds), one per gap

    def ops_under(self, span: Optional[str] = None, kernels=None):
        """The device operations launched inside ``span`` (any depth), whose
        names hold one of ``kernels``."""
        return [o for o in self.ops
                if (span is None or span in o.spans)
                and (kernels is None or any(k in o.name for k in kernels))]


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _spans_at(spans, times):
    """{t: names of the spans containing time t, outermost first} for each
    of ``times``; the spans nest, as one host thread opens them."""
    order = sorted(spans, key=lambda s: (s[0], -s[1]))
    found, stack, i = {}, [], 0
    for t in sorted(set(times)):
        while i < len(order) and order[i][0] <= t:
            stack.append((order[i][0] + order[i][1], order[i][2]))
            i += 1
        stack = [x for x in stack if x[0] >= t]
        found[t] = tuple(n for _, n in stack)
    return found


def reduce_trace(events, steps: int) -> Trace:
    """A :class:`Trace` from the Chrome trace's ``traceEvents``."""
    spans, launches, device = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat == "user_annotation":
            spans.append((float(ev["ts"]), float(ev["dur"]), ev["name"]))
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(ev["ts"])
        elif cat in DEVICE_CATS:
            device.append(ev)
    step_spans = [(s, d) for s, d, n in spans if n == STEP_SPAN]
    if not step_spans:
        return Trace(steps, 0.0, [], 0.0, [])
    w0 = min(s for s, _ in step_spans)
    w1 = max(s + d for s, d in step_spans)
    kept = [ev for ev in device
            if float(ev["ts"]) + float(ev.get("dur", 0.0)) >= w0 and float(ev["ts"]) <= w1]
    at = [launches.get(ev.get("args", {}).get("correlation")) for ev in kept]
    where = _spans_at(spans, [t for t in at if t is not None])
    ops = [DeviceOp(ev["name"], float(ev["ts"]), float(ev.get("dur", 0.0)),
                    where[t] if t is not None else ())
           for ev, t in zip(kept, at)]
    ops.sort(key=lambda o: o.start_us)
    merged = _union((max(o.start_us, w0), min(o.start_us + o.dur_us, w1)) for o in ops)
    busy = sum(e - s for s, e in merged)
    gaps, t = [], w0
    for s, e in merged:
        if s > t:
            gaps.append((s, t))
        t = max(t, e)
    if w1 > t:
        gaps.append((w1, t))
    starts = [o.start_us for o in ops]
    named = []
    for end, start in gaps:
        i = bisect.bisect_left(starts, end)
        spans_of = ops[i].spans if i < len(ops) else ()
        named.append((spans_of[-1] if spans_of else "outside spans", end - start))
    return Trace(steps, w1 - w0, ops, busy, named)


def traced_steps(run_step: Callable[[], None], steps: int, span) -> Trace:
    """Run ``steps`` steps under the profiler, each inside a ``step`` span,
    and reduce the trace."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(steps):
                with span(STEP_SPAN):
                    run_step()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce_trace(events, steps)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by the
    span the host was in, each in seconds over the traced window."""
    by_op, by_gap = {}, {}
    for o in trace.ops:
        by_op[o.name] = by_op.get(o.name, 0.0) + o.dur_us
    for name, us in trace.gaps:
        by_gap[name] = by_gap.get(name, 0.0) + us

    def ranked(d):
        return [[k[:120], v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_gap)}
