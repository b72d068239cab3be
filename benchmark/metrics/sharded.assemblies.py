"""Assemblies a step: calls of the program's ``xtt.sharded.assemble`` span
(every ``ShardedTensor.full_tensor``, a whole array gathered on the first
card, which is the card ``peak_mem_gb`` reads).  0 is a reading: the
sharded layer ran and assembled nothing.  None where the program opened no
``xtt.sharded.*`` span in the window."""

from benchmark.program_spans import _layer_spans


def read(trace, cell):
    spans = _layer_spans("sharded")
    if not spans or trace.steps == 0:
        return None
    calls = spans.get("xtt.sharded.assemble", {"calls": 0})["calls"]
    print(f"sharded.assemblies: {calls / trace.steps:g} a step", flush=True)
    return calls / trace.steps
