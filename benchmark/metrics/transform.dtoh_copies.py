"""Copies from the card to the host a step (``Memcpy DtoH``) launched inside
the program's transform-routing spans (``xtt.transform.*``): the bins' copy
for the host's checks in ``_bin_edges``.  0 is a reading: the transforms
launched work and no such copy."""

from benchmark.program_spans import copies_under


def read(trace, cell):
    return copies_under(trace, cell, "xtt.transform.", "Memcpy DtoH")
