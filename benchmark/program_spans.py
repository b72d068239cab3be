"""What the readers of the program's own spans and counters share.

The port opens ``xtt.<layer>.<what>`` spans at its layer boundaries
(``xgcm_tpu_torch.utils.span``).  While the traced window's profiler
records, each span is a ``user_annotation`` range of the trace, so a device
operation carries the program's spans at its launch beside the benchmark's
(``DeviceOp.spans``), and the program adds each span's calls and host self
time to a table (``utils.span_totals()``).  The traced window is the one
profiled region of a run, so the table holds that window alone.  The build
module times the first call of each C entry in the process
(``build.FIRST_LAUNCH_S``).

A program without these spans or that counter (a commit before them) gives
every reader here nothing to read: it returns None and raises nothing.
"""


def _span_totals():
    try:
        from xgcm_tpu_torch.utils import span_totals
    except ImportError:
        return {}
    return span_totals()


def _layer_spans(layer, leave_out=()):
    """{name: {"calls", "self_s"}} of the layer's spans, ``leave_out`` left
    out."""
    prefix = f"xtt.{layer}."
    return {n: t for n, t in _span_totals().items()
            if n.startswith(prefix) and n not in leave_out}


def _report(metric, spans, steps):
    """Print each span's calls a step and the largest by self time."""
    calls = {n: t["calls"] / steps for n, t in sorted(spans.items())}
    largest = max(spans, key=lambda n: spans[n]["self_s"])
    print(f"{metric}: spans a step {calls}; largest {largest} "
          f"{spans[largest]['self_s'] * 1e3 / steps:.6f} ms a step", flush=True)


def host_ms(trace, cell, layer, leave_out=()):
    """Host self time a step of the layer's spans, in ms; None where the
    program opened none in the window."""
    spans = _layer_spans(layer, leave_out)
    if not spans or trace.steps == 0:
        return None
    _report(f"{layer}.host_ms", spans, trace.steps)
    return sum(t["self_s"] for t in spans.values()) * 1e3 / trace.steps


def host_us_per_launch(trace, cell):
    """Host self time of the kernel wrappers' spans over their calls, in
    us: checks, autograd's Function, the C call (on the CPU the plain
    version)."""
    spans = _layer_spans("kernels")
    calls = sum(t["calls"] for t in spans.values())
    if not calls or trace.steps == 0:
        return None
    _report("kernels.host_us_per_launch", spans, trace.steps)
    return sum(t["self_s"] for t in spans.values()) * 1e6 / calls


def first_launch_s(trace, cell):
    """The sum of the host seconds of each C entry's first call in the
    process; None where no C entry ran (the CPU) or the program does not
    time them."""
    try:
        from xgcm_tpu_torch.ops.kernels.build import FIRST_LAUNCH_S
    except ImportError:
        return None
    if not FIRST_LAUNCH_S:
        return None
    print("kernels.first_launch_s: " + ", ".join(
        f"{n} {s:.6f} s" for n, s in sorted(FIRST_LAUNCH_S.items())), flush=True)
    return sum(FIRST_LAUNCH_S.values())


def _under(trace, prefix):
    """The device operations launched inside a span whose name starts with
    ``prefix``."""
    return [o for o in trace.ops if any(s.startswith(prefix) for s in o.spans)]


def device_ms_under(trace, cell, prefix):
    """Device ms a step of the operations launched inside a span named
    ``prefix...``; None where the trace holds none."""
    ops = _under(trace, prefix)
    if not ops or trace.steps == 0:
        return None
    ms = sum(o.dur_us for o in ops) / 1e3 / trace.steps
    print(f"{prefix}*: {len(ops) / trace.steps:g} device operations a step, {ms:.6f} ms",
          flush=True)
    return ms


def copies_under(trace, cell, prefix, kind):
    """Operations named ``kind`` (e.g. ``Memcpy DtoH``) a step among those
    launched inside a span named ``prefix...``: 0 where such spans launched
    other work only; None where the trace holds nothing launched inside
    them."""
    ops = _under(trace, prefix)
    if not ops or trace.steps == 0:
        return None
    copies = [o for o in ops if kind in o.name]
    print(f"{prefix}*: {len(copies) / trace.steps:g} '{kind}' a step of "
          f"{len(ops) / trace.steps:g} device operations", flush=True)
    return len(copies) / trace.steps
