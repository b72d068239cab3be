"""Host self time a step of the program's metric calculus and arithmetic
spans (``xtt.arith.*``: ``get_metric``, ``integrate`` and the rest of the
calculus, the GriddedArray operators and reductions), in ms.

In the cells that report ``analysis_ms``; ``arith.host_ms.noisy`` reads
the same in those that report ``analysis_ms.noisy``."""

from benchmark.program_spans import host_ms


def read(trace, cell):
    return host_ms(trace, cell, "arith")
