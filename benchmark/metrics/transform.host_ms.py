"""Host self time a step of the program's transform-routing spans
(``xtt.transform.*`` but the bins' copy to the host, ``host_sync``), in ms:
the routing of ``ops/transform.py`` to C, F, G and H.

In the cells that report ``analysis_ms``; ``transform.host_ms.noisy``
reads the same in those that report ``analysis_ms.noisy``."""

from benchmark.program_spans import host_ms

LEAVE_OUT = ("xtt.transform.host_sync",)


def read(trace, cell):
    return host_ms(trace, cell, "transform", LEAVE_OUT)
