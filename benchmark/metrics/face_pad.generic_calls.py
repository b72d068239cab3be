"""Calls a step of the program's ``xtt.face_pad.generic`` span: the generic
engine's face-connection pad (``core/padding._pad_face_connections``),
which an op that the fused paths decline on a face-connected grid falls
to.  0 is a reading: the program has the span (its counter
``padding.FACE_PADS`` exists) and the window opened none.  None for a
program without them."""

from benchmark.program_spans import _layer_spans

SPAN = "xtt.face_pad.generic"


def read(trace, cell):
    try:
        from xgcm_tpu_torch.core.padding import FACE_PADS  # noqa: F401
    except ImportError:
        return None
    if trace.steps == 0:
        return None
    calls = _layer_spans("face_pad").get(SPAN, {"calls": 0})["calls"]
    print(f"face_pad.generic_calls: {calls / trace.steps:g} a step", flush=True)
    return calls / trace.steps
