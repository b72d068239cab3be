"""Host self time a step of the program's Grid API spans (``xtt.grid_api.*``:
``entry.step`` and the Grid methods' dispatch), in ms: the Python that
sits between the user's call and the layers below it.

In the cells that report ``analysis_ms``; ``grid_api.host_ms.noisy`` reads
the same in those that report ``analysis_ms.noisy``."""

from benchmark.program_spans import host_ms


def read(trace, cell):
    return host_ms(trace, cell, "grid_api")
