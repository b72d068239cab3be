"""Plain reference of the face analysis of a slab of LLC levels, in plain
PyTorch: ``reference/face-analysis.py`` (loaded by its path, unchanged)
applied level by level to (z, face, y, x) inputs.  It yields each answer
level by level and face by face, ``(name, (z, f), values)``, so that the
judge holds one face of one level of the program's sharded output at a
time against it.
"""

import importlib.util
import pathlib

_PATH = pathlib.Path(__file__).with_name("face-analysis.py")
_spec = importlib.util.spec_from_file_location("bench_reference_face_analysis_of_levels", _PATH)
FACE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(FACE)


def blocks(inputs, precision):
    for z in range(inputs["theta"].shape[0]):
        level = {k: inputs[k][z] for k in ("theta", "u", "v")}
        for name, (f,), values in FACE.blocks(level, precision):
            yield name, (z, f), values
