"""Device ms a step of the operations launched inside the program's
face-halo spans (``xtt.face_halo.*``): the strip gathers that build E's halo
lines, which ``arith.torch_ms`` counts among the rest."""

from benchmark.program_spans import device_ms_under


def read(trace, cell):
    return device_ms_under(trace, cell, "xtt.face_halo.")
