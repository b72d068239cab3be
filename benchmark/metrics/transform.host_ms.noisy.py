"""``transform.host_ms`` in the cells that report ``analysis_ms.noisy``, whose
runs spread by several % between processes."""

from benchmark.program_spans import host_ms

LEAVE_OUT = ("xtt.transform.host_sync",)


def read(trace, cell):
    return host_ms(trace, cell, "transform", LEAVE_OUT)
