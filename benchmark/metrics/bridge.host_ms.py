"""Host self time a step of the program's host-bridge spans
(``xtt.bridge.to_device`` and ``xtt.bridge.to_host``, ``core/device.py``:
every copy between the host and the card), in ms."""

from benchmark.program_spans import host_ms


def read(trace, cell):
    return host_ms(trace, cell, "bridge")
