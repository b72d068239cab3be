"""Host self time a step of the program's face-halo spans
(``xtt.face_halo.*``: the strip gathers of ``ops/fused.py`` before each
launch of E), in ms."""

from benchmark.program_spans import host_ms


def read(trace, cell):
    return host_ms(trace, cell, "face_halo")
