"""``grid_api.host_ms`` in the cells that report ``analysis_ms.noisy``, whose
runs spread by several % between processes."""

from benchmark.program_spans import host_ms


def read(trace, cell):
    return host_ms(trace, cell, "grid_api")
