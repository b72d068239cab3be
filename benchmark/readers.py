"""What the per-layer readers in ``metrics/`` share: the port's kernel
names, the readers of a quantity that two metrics report for two groups of
cells (``<quantity>`` and ``<quantity>.noisy``), and the roofline share of
one kernel."""

from benchmark.roofline import bound

# the __global__ functions of xgcm_tpu_torch/csrc/: A, B, C and F, D, E, G and H
PORT_KERNELS = ("shift_rows", "shift_planes", "diagnostics_kernel", "interp_linear_kernel",
                "vorticity_kernel", "face_shift_kernel", "conservative_kernel")


def idle_share(trace, cell):
    """The share of the traced window in which no operation ran on the
    device: the window minus the union of every kernel's, memcpy's and
    memset's interval, over the window, in %."""
    if not trace.ops or trace.window_us <= 0:
        return None
    return 100.0 * (trace.window_us - trace.busy_us) / trace.window_us


def device_ops(trace, cell):
    """Device operations (kernels, memcpy, memset) a step: what the Grid
    API's dispatch of one analysis puts on the card."""
    if not trace.ops or trace.steps == 0:
        return None
    return len(trace.ops) / trace.steps


def torch_ms(trace, cell):
    """Device ms a step of every operation that is not one of the port's
    own kernels: PyTorch's elementwise passes, reductions, copies, index and
    cat."""
    if not trace.ops or trace.steps == 0:
        return None
    other = [o for o in trace.ops if not any(k in o.name for k in PORT_KERNELS)]
    return sum(o.dur_us for o in other) / 1e3 / trace.steps


def roofline_share(trace, cell, kernel, names, span=None):
    """The least time of ``kernel``'s work in a step (the recipe's shapes,
    :mod:`roofline`) over the device time a step of the operations named
    ``names`` launched inside ``span``, in %; None where the recipe runs no
    such work or the trace holds no such operation."""
    work = cell.recipe.kernel_work(cell.shapes).get(kernel)
    ops = trace.ops_under(span, names)
    if not work or not ops or trace.steps == 0:
        return None
    measured_ms = sum(o.dur_us for o in ops) / 1e3 / trace.steps
    least = [bound(b, f) for b, f in work]
    least_ms = sum(t for t, _ in least)
    print(f"{kernel}: least {least_ms:.6f} ms a step (bound by "
          f"{'/'.join(sorted({k for _, k in least}))}), measured {measured_ms:.6f} ms in "
          f"{len(ops) / trace.steps:g} launches a step [{cell.card}]", flush=True)
    if measured_ms <= 0:
        return None
    return 100.0 * least_ms / measured_ms
