# NOTE: only leaf modules here. diagnostics and transform import core.grid,
# and core.gridops imports ops.stencils, so importing them eagerly would
# create a circular import; reach them as xgcm_tpu_torch.ops.diagnostics etc.
from . import fused, stencils  # noqa: F401
