"""Plain reference of the C-grid analysis step from host memory: the blocks
of ``cgrid-step.py`` beside this file, loaded by its path.  Where the inputs
and results live changes no answer."""

import importlib.util
import pathlib

_path = pathlib.Path(__file__).with_name("cgrid-step.py")
_spec = importlib.util.spec_from_file_location("bench_reference_cgrid_step_of_host", _path)
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)

blocks = _base.blocks
